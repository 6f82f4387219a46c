"""Mixture-of-experts MLP, local mode (all experts on this device).

Counterpart of long_vita_tpu/ops/moe.py with ``axis_name=None``: a drop-in
for the dense SwiGLU MLP of a decoder layer that carries a router.

  - top-k softmax routing: f32 router logits, softmax, the k largest
    probabilities as the gates;
  - the Switch load-balancing loss: E * sum(fraction of routed copies per
    expert * mean router probability);
  - capacity dispatch: each expert takes at most ``max(int(capacity_factor
    * N * k / E), k)`` of the N tokens' k routed copies of one call (JAX
    :72-74), in token-major order (a cumsum over the flattened (token, k)
    copies, :87-92); a copy past capacity is dropped and contributes 0 (it
    falls through on the residual path).

JAX dispatches and combines with one-hot einsums ([E, N*k, C]); here each
copy is written to (and read back from) its (expert, slot) by index, which
gives the same numbers: the one-hot product has one nonzero term per output
(exact in any dtype) and a dropped copy gets 0 either way. The combine takes
the expert output row in x's dtype times its f32 gate (JAX's promotion of
bf16 x f32 to f32), sums the k copies in f32 and casts to x's dtype.

Expert parallelism (``axis_name``: experts over a mesh axis, tokens moved by
two all_to_alls) is not ported: it raises (ROADMAP §1 item 8).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from long_vita_tpu_torch.models.qwen2 import Dense, _frozen


class Experts(nn.Module):
    """The experts' SwiGLU weights in the JAX layout: gate and up [E, H, I],
    down [E, I, H] (one batched product each)."""

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
    """Slots per expert for one call over n_tokens tokens (JAX :72-74)."""
    return max(int(capacity_factor * n_tokens * top_k / num_experts), top_k)


def moe_mlp(
    params,
    x: torch.Tensor,
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    axis_name: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H] -> (out [B, S, H] in x's dtype, the aux loss, an f32
    scalar). ``params``: anything with ``router`` and ``experts`` (MoEParams,
    a MoE DecoderLayer)."""
    if axis_name is not None:
        raise NotImplementedError(
            "expert parallelism (moe_mlp over an expert axis) is not ported "
            "(ROADMAP §1 item 8)")
    b, s, h = x.shape
    n = b * s
    xe = x.reshape(n, h)
    num_experts = params.router.weight.shape[0]
    capacity = moe_capacity(n, num_experts, top_k, capacity_factor)

    probs, gate_vals, expert_ids = route(params.router, xe, top_k)  # [N, E], [N, k], [N, k]

    fraction = F.one_hot(expert_ids, num_experts).float().sum((0, 1)) / (n * top_k)
    aux = num_experts * torch.sum(fraction * probs.mean(0))

    flat_ids = expert_ids.reshape(-1)  # [N*k], token-major
    onehot = F.one_hot(flat_ids, num_experts)
    slot = (torch.cumsum(onehot, 0) * onehot - 1).amax(-1)  # place in its expert's queue
    keep = slot < capacity
    gates = gate_vals.reshape(-1) * keep

    # a dropped copy goes to a spare slot C, cut off before the experts run
    slot_w = torch.where(keep, slot, capacity)
    xk = xe.repeat_interleave(top_k, 0)  # [N*k, H]
    expert_in = xe.new_zeros((num_experts, capacity + 1, h)).index_put(
        (flat_ids, slot_w), xk)[:, :capacity]
    expert_out = _expert_mlp(params.experts, expert_in)  # [E, C, H]
    rows = expert_out[flat_ids, slot_w.clamp(max=capacity - 1)]
    rows = torch.where(keep[:, None], rows, 0.0)
    out = (rows.float() * gates[:, None]).reshape(n, top_k, h).sum(1)
    return out.reshape(b, s, h).to(x.dtype), aux
