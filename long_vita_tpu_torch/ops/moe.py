"""Mixture-of-experts MLP: local mode, expert parallelism, and a routing
batch spread over the ranks that hold its tokens.

Counterpart of long_vita_tpu/ops/moe.py: a drop-in for the dense SwiGLU MLP
of a decoder layer that carries a router.

  - top-k softmax routing: f32 router logits, softmax, the k largest
    probabilities as the gates;
  - the Switch load-balancing loss: E * sum(fraction of routed copies per
    expert * mean router probability), over the routing batch;
  - capacity dispatch: each expert takes at most ``max(int(capacity_factor
    * N * k / E), k)`` of the N tokens' k routed copies of one routing
    batch (JAX :72-74), in token-major order (a cumsum over the flattened
    (token, k) copies, :87-92); a copy past capacity is dropped and
    contributes 0 (it falls through on the residual path).

JAX dispatches and combines with one-hot einsums ([E, N*k, C]); here the
copies are written into the [E, C, H] slot buffer by index (a dropped copy
to a spare slot C that is cut off before the experts run), each expert runs
its C slots through three bmm, and each kept copy reads its row back: the
same numbers, with no host sync. The combine takes the expert output row in
x's dtype times its f32 gate (JAX's promotion of bf16 x f32 to f32), sums
the k copies in f32 and casts to x's dtype.

A routing batch can span ranks (``seq_comm``: cp's sequence shards in
training, or cp serving's q-sharded chunk, JAX's global routing under
GSPMD): its token order is the ranks' in rank order, each rank's copies take
the global slot ids (the rank's cumsum plus an exclusive prefix of the
per-(row, expert) counts of the rows and ranks before it: one all-gather of
[B, E] counts), the capacity counts every rank's tokens, and the aux comes
from the statistics summed over the ranks (its gradient flows into each
rank's own tokens alone). Each rank fills the whole batch's [E, C, H]
buffer with its own copies (the other ranks' slots stay 0) and reads its
own back, so no rank needs another's rows. ``aux_share`` ranks that compute
the same aux from the same tokens (the tp ranks after sequence
parallelism's gather) scale its gradient by 1 / aux_share, so that the sum
over them counts it once.

Expert parallelism (``axis_name``, the expert communicator: JAX's EP axis,
dp) is JAX's :102-126: the rank holds E / ep experts, expert e on rank e //
(E / ep), and routes its own tokens as a batch of its own; the tiled
all_to_all over the buffer's expert dim (``_AllToAll``, an autograd
Function: the exchange is its own inverse, so its backward is the same
exchange) sends each expert's slots to its owner, which regroups them to
[E / ep, ep * C, H], runs its experts, and sends them back the same way, so
the owner's expert gradients cover every rank's tokens. Experts whose
intermediate dim is cut over tp (a tp shard) give each tp rank a partial
output, which the caller reduces over tp like the dense down_proj
(models/qwen2._mlp_block).

``stats()`` counts the calls, the routed copies and the dropped ones (each
rank its own; the drops accumulate on the device and are read by stats(),
so a call makes no host sync), under a lock (thread-ranks route at once).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from long_vita_tpu_torch.models.qwen2 import Dense, _frozen
from long_vita_tpu_torch.parallel.comm import Comm, reduce_from_tp

_STATS = {"calls": 0, "copies": 0}
_DROPPED: dict = {}  # device -> the count of copies dropped there, on it
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0
        _DROPPED.clear()


def stats() -> dict:
    """-> {"calls", "copies", "dropped"} since reset_stats (reads the
    devices' drop counts)."""
    with _STATS_LOCK:
        dropped = sum(int(d) for d in _DROPPED.values())
        return dict(_STATS, dropped=dropped)


class Experts(nn.Module):
    """The experts' SwiGLU weights in the JAX layout: gate and up [E, H, I],
    down [E, I, H] (on an expert-parallel or tp shard, the rank's E / ep
    experts and I / tp of their intermediate dim)."""

    def __init__(self, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
        super().__init__()
        self.gate = _frozen(gate)
        self.up = _frozen(up)
        self.down = _frozen(down)


class MoEParams(nn.Module):
    """router (weight [E, H]) and experts; a MoE decoder layer carries the
    same two attributes."""

    def __init__(self, router: Dense, experts: Experts):
        super().__init__()
        self.router, self.experts = router, experts


def init_moe_params(
    generator: torch.Generator,
    num_experts: int,
    hidden: int,
    intermediate: int,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> MoEParams:
    """Random init as the JAX package's (normal * 0.02), from ``generator``
    on ``device`` (the generator's device when None)."""
    device = torch.device(device) if device is not None else generator.device

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

    e, h, i = num_experts, hidden, intermediate
    return MoEParams(Dense(normal(e, h)),
                     Experts(normal(e, h, i), normal(e, h, i), normal(e, i, h)))


def _expert_mlp(experts: Experts, x: torch.Tensor) -> torch.Tensor:
    """x [E, C, H] -> [E, C, H]: each expert's SwiGLU on its slots."""
    gate = torch.bmm(x, experts.gate)
    up = torch.bmm(x, experts.up)
    return torch.bmm(F.silu(gate) * up, experts.down)


def route(router: Dense, xe: torch.Tensor, top_k: int):
    """Top-k softmax routing of the tokens xe [N, H]: f32 router logits
    (the product in x's dtype, as JAX's). -> (probs [N, E] f32, the gates
    [N, k], the expert ids [N, k])."""
    probs = torch.softmax(F.linear(xe, router.weight).float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    return probs, gate_vals, expert_ids


def moe_capacity(n_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert for one routing batch of n_tokens tokens (JAX
    :72-74)."""
    return max(int(capacity_factor * n_tokens * top_k / num_experts), top_k)


class _AllToAll(torch.autograd.Function):
    """The tiled all_to_all over dim 0 of ``comm`` (JAX's, split and concat
    axis 0): piece j to rank j, the pieces received in rank order. It is its
    own inverse, so the backward sends the gradient back the same way."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_to_all(x.contiguous(), 0, 0)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_to_all(g.contiguous(), 0, 0), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _expert_parallel(experts: Experts, expert_in: torch.Tensor, comm: Comm) -> torch.Tensor:
    """expert_in [E, C, H] (this rank's slots of every expert) -> each
    expert's SwiGLU on them, run on the expert's owner over ``comm``
    (expert e on rank e // (E / ep)): JAX :108-126."""
    ep, e_local = comm.size, experts.gate.shape[0]
    e, c, h = expert_in.shape
    if e_local * ep != e:
        raise ValueError(f"{e} experts over ep {ep}: the shard holds {e_local}")
    got = _AllToAll.apply(expert_in, comm)  # [ep * E_local, C, H], source-rank major
    got = got.reshape(ep, e_local, c, h).transpose(0, 1).reshape(e_local, ep * c, h)
    out = _expert_mlp(experts, got)
    out = out.reshape(e_local, ep, c, h).transpose(0, 1).reshape(e, c, h)
    return _AllToAll.apply(out, comm)  # back in this rank's expert order


def moe_mlp(
    params,
    x: torch.Tensor,
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    axis_name: Optional[Comm] = None,
    seq_comm: Optional[Comm] = None,
    aux_share: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H] -> (out [B, S, H] in x's dtype, the aux loss, an f32
    scalar). ``params``: anything with ``router`` and ``experts``
    (MoEParams, a MoE DecoderLayer). axis_name: the expert communicator
    (expert parallelism; the experts are the rank's E / ep), where JAX
    names a mesh axis. seq_comm: the ranks whose tokens (in rank order,
    each [B, S, H]) make one routing batch with this rank's, row by row;
    the aux is then the whole batch's on each. aux_share: see the module
    docstring. With experts cut over tp, out is this tp rank's partial
    sum."""
    if axis_name is not None and not isinstance(axis_name, Comm):
        raise TypeError(f"axis_name is the expert communicator (a parallel.comm.Comm), got "
                        f"{axis_name!r}")
    b, s, h = x.shape
    n = b * s
    xe = x.reshape(n, h)
    num_experts = params.router.weight.shape[0]
    seq = seq_comm if seq_comm is not None and seq_comm.size > 1 else None
    n_all = n * (seq.size if seq is not None else 1)
    capacity = moe_capacity(n_all, num_experts, top_k, capacity_factor)

    probs, gate_vals, expert_ids = route(params.router, xe, top_k)  # [N, E], [N, k], [N, k]

    onehot = F.one_hot(expert_ids.reshape(b, s * top_k), num_experts)  # [B, S*k, E]
    counts = onehot.sum(1)  # [B, E] copies of each row
    prob_sum = probs.sum(0)
    if aux_share > 1:
        prob_sum = _ScaleGrad.apply(prob_sum, 1.0 / aux_share)
    if seq is not None:
        every = seq.all_gather(counts[None], 0)  # [ranks, B, E]
        before, total = every[:seq.rank].sum(0), every.sum(0)
        prob_sum = reduce_from_tp(prob_sum, seq)
    else:
        before, total = torch.zeros_like(counts), counts
    fraction = total.sum(0).float() / (n_all * top_k)
    aux = num_experts * torch.sum(fraction * (prob_sum / n_all))

    # each copy's place in its expert's queue: the copies of the rows before
    # its row (every rank's), of the ranks before it on its row, then its own
    offset = torch.cumsum(total, 0) - total + before  # [B, E]
    queue = torch.cumsum(onehot, 1) - 1 + offset[:, None]
    slot = queue.gather(2, expert_ids.reshape(b, s * top_k, 1)).reshape(-1)  # [N*k], token-major
    keep = slot < capacity
    flat_ids = expert_ids.reshape(-1)
    with _STATS_LOCK:
        _STATS["calls"] += 1
        _STATS["copies"] += n * top_k
        _DROPPED[keep.device] = _DROPPED.get(keep.device, 0) + (n * top_k - keep.sum())

    # a dropped copy goes to a spare slot C, cut off before the experts run
    slot_w = torch.where(keep, slot, capacity)
    xk = xe.repeat_interleave(top_k, 0)  # [N*k, H]
    expert_in = xe.new_zeros((num_experts, capacity + 1, h)).index_put(
        (flat_ids, slot_w), xk)[:, :capacity]
    if axis_name is not None and axis_name.size > 1:
        expert_out = _expert_parallel(params.experts, expert_in, axis_name)
    else:
        expert_out = _expert_mlp(params.experts, expert_in)  # [E, C, H]
    rows = expert_out[flat_ids, slot_w.clamp(max=capacity - 1)]
    rows = torch.where(keep[:, None], rows, 0.0)
    out = (rows.float() * (gate_vals.reshape(-1) * keep)[:, None]).reshape(n, top_k, h).sum(1)
    return out.reshape(b, s, h).to(x.dtype), aux
