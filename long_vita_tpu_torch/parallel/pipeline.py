"""Pipeline parallelism over a pp axis: GPipe and the interleaved schedule.

Counterpart of long_vita_tpu/parallel/pipeline.py. JAX runs one
shard_map program on every stage: per tick each stage applies its layers
to its in-flight microbatch, then the activation ``ppermute``s one stage
down (``_shift_down`` :26, no wraparound; ``_shift_ring`` :110 wraps for
the interleaved schedule), and autodiff of the scan gives the backward.
In the port each pp rank runs the same lockstep ticks on its own stage (the
shard_map body on one device), and the shift is an autograd Function over
the pp communicator (``_Shift``): its forward sends the stage's output to
the next stage and receives the previous stage's, its backward sends the
cotangent of what it received back upstream and receives the cotangent of
what it sent, so a single ``.backward()`` on every rank runs the schedule
in reverse, tick by tick in lockstep.

The schedules are JAX's. GPipe (``pipeline_apply`` :34): M microbatches in
M + pp - 1 ticks, stage s serving microbatch t - s at tick t, outputs from
the last stage. Interleaved (``pipeline_apply_interleaved`` :119): each
stage holds ``virtual`` chunks of Lv layers laid round-robin over the ring
(virtual stage j = c * pp + d holds global layers [j * Lv, (j + 1) * Lv)),
stored chunk-major (``interleave_permutation`` :263, ``permute_layer_stack``
:279); at tick T stage d serves unit u = T - d, microbatch m = (u // (pp *
v)) * pp + u % pp and chunk c = (u % (pp * v)) // pp; M % pp == 0. GPipe
is the interleaved schedule at v = 1, and both run through one loop here.

What differs, in form only:
  - the chain of ticks is threaded by a scalar token that every shift
    takes and returns: a stage whose last send's output nobody reads
    still runs that shift's backward, because the token chain ends in the
    ``anchor`` the caller adds (a zero) to its loss on every stage;
  - a bubble tick (a stage with no valid unit) computes nothing and its
    shift moves nothing, where JAX computes on zeros and discards the
    result; a shift is a point-to-point pair only where the sender holds
    a valid unit that the receiver takes, so GPipe's last stage sends
    nothing on any tick (JAX's no-wraparound shift) and the ring wraps
    only where a chunk goes on to the next one;
  - per-microbatch leaves every stage holds anyway (``local``: the
    decoder's positions, rope tables and segment ids) are read on each
    stage from its own copy instead of travelling with the activation;
  - the output stays on the last stage (JAX psums it to every stage).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from long_vita_tpu_torch.parallel.comm import Comm

# A fault for the gates that must catch it (tests, chip_smoke.py), never set
# in training: the shift's backward sends zeros upstream in place of the
# cotangent of what it received, so no gradient crosses a stage.
_SHIFT_BACKWARD_DROPPED = False


def interleave_permutation(n_layers: int, pp: int, virtual: int) -> list[int]:
    """perm[n] is the global layer stored at position n, where positions
    [d * (L / pp) + c * Lv + i] hold stage d's chunk c (virtual stage c *
    pp + d, global layers (c * pp + d) * Lv + i) (JAX :263)."""
    if n_layers % (pp * virtual):
        raise ValueError(f"{n_layers} layers % (pp {pp} * virtual {virtual}) != 0")
    l_v = n_layers // (pp * virtual)
    perm = []
    for d in range(pp):
        for c in range(virtual):
            base = (c * pp + d) * l_v
            perm.extend(range(base, base + l_v))
    return perm


def permute_layer_stack(layers, pp: int, virtual: int, inverse: bool = False):
    """The stacked layers laid out chunk-major (interleave_permutation), or
    back to canonical order with ``inverse`` (JAX :279): a tensor [L, ...]
    is indexed along dim 0, a list (or ModuleList) of layers reordered;
    ``virtual`` 1 returns ``layers`` itself."""
    if virtual <= 1:
        return layers
    n = layers.shape[0] if isinstance(layers, torch.Tensor) else len(layers)
    perm = interleave_permutation(n, pp, virtual)
    if inverse:
        perm = sorted(range(n), key=perm.__getitem__)
    if isinstance(layers, torch.Tensor):
        return layers[torch.as_tensor(perm, device=layers.device)]
    return type(layers)([layers[i] for i in perm])


def split_stages(layers, pp: int):
    """Check that the stacked layers divide into pp stages (JAX :309)."""
    n = layers.shape[0] if isinstance(layers, torch.Tensor) else len(layers)
    if n % pp:
        raise ValueError(f"{n} layers not divisible by pp={pp}")
    return layers


def stage_layers(n_layers: int, pp: int, virtual: int, stage: int) -> list[int]:
    """The global layers stage ``stage`` holds, in its storage order: its
    L / pp contiguous layers (GPipe), or its chunks chunk-major."""
    per = n_layers // pp
    return interleave_permutation(n_layers, pp, max(virtual, 1))[stage * per:(stage + 1) * per]


@dataclasses.dataclass
class Stage:
    """A rank's pipeline stage: ``comm`` the pp communicator (its rank the
    stage), ``virtual`` chunks of the ``n_layers``-layer decoder
    (Qwen2Params.pp on a stage's tree: its ``layers`` are layers(), in that
    order). ``stats`` counts the schedule's work (``reset_stats``): ticks,
    busy ticks (a unit computed), and the bytes sent and received by the
    shifts, forward and backward."""

    comm: Comm
    n_layers: int
    virtual: int = 1
    stats: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.reset_stats()

    @property
    def index(self) -> int:
        return self.comm.rank

    @property
    def size(self) -> int:
        return self.comm.size

    @property
    def first(self) -> bool:
        return self.comm.rank == 0

    @property
    def last(self) -> bool:
        return self.comm.rank == self.comm.size - 1

    def layers(self, stage: Optional[int] = None) -> list[int]:
        """The global layers of stage ``stage`` (default: this one), in
        storage order."""
        return stage_layers(self.n_layers, self.size, self.virtual,
                            self.index if stage is None else stage)

    def reset_stats(self) -> None:
        self.stats.update(ticks=0, busy=0, sent_bytes=0, received_bytes=0)


class _Shift(torch.autograd.Function):
    """One tick's move between stages: forward sends ``xs`` to stage
    ``dst`` and receives tensors of ``specs`` ((shape, dtype, device) of
    each travelling leaf, the same on every stage) from ``src`` (either
    None: nothing); backward sends the received tensors' cotangents to
    ``src`` and receives ``xs``' from ``dst``. Every stage makes one
    send_recv a leaf each tick, also with nothing to move. The token in
    and out keeps the ticks one chain (see the module docstring)."""

    @staticmethod
    def forward(ctx, comm, dst, src, specs, stats, token, *xs):
        ctx.comm, ctx.dst, ctx.src, ctx.specs, ctx.stats = comm, dst, src, specs, stats
        got = [comm.send_recv(xs[i] if dst is not None else None, dst, src, *spec)
               for i, spec in enumerate(specs)]
        got = [g for g in got if g is not None]
        _count(stats, xs, got)
        return (token.new_zeros(()), *got)

    @staticmethod
    def backward(ctx, g_token, *g_got):
        comm, dst, src = ctx.comm, ctx.dst, ctx.src
        if _SHIFT_BACKWARD_DROPPED:
            g_got = tuple(torch.zeros_like(g) for g in g_got)
        g_xs = [comm.send_recv(g_got[i].contiguous() if src is not None else None, src, dst,
                               *spec)
                for i, spec in enumerate(ctx.specs)]
        g_xs = [g for g in g_xs if g is not None]
        _count(ctx.stats, g_got if src is not None else (), g_xs)
        return (None, None, None, None, None, torch.zeros_like(g_token), *g_xs)


def _count(stats: Optional[dict], sent, received) -> None:
    if stats is not None:
        stats["sent_bytes"] += sum(x.nbytes for x in sent)
        stats["received_bytes"] += sum(x.nbytes for x in received)


def _unit(u: int, pp: int, virtual: int, m: int) -> Optional[tuple[int, int]]:
    """The (microbatch, chunk) of unit u, or None outside the schedule."""
    if u < 0:
        return None
    mb = (u // (pp * virtual)) * pp + u % pp
    return (mb, (u % (pp * virtual)) // pp) if mb < m else None


def _sends(stage: int, pp: int, virtual: int, unit) -> bool:
    """Whether the stage that serves ``unit`` hands its output on: all but
    the last virtual stage's (its output is the microbatch's result)."""
    return unit is not None and not (stage == pp - 1 and unit[1] == virtual - 1)


Tree = Union[torch.Tensor, dict]


def run_schedule(stage_params, microbatches: Optional[dict], body_fn: Callable, comm: Comm, *,
                 m: int, virtual: int = 1, specs: Optional[dict] = None,
                 local: Optional[dict] = None, stats: Optional[dict] = None):
    """The lockstep schedule on this rank's stage (``comm.rank`` of
    ``comm.size``). microbatches: {key: [M, ...]} of the travelling leaves,
    read on stage 0 only (None elsewhere); ``specs`` {key: (shape, dtype,
    device)} of one microbatch's travelling leaves, on every stage; local:
    {key: [M, ...]} of leaves every stage holds. body_fn(chunk_params,
    {**travelling, **local microbatch}) -> {key: tensor} of the travelling
    keys. -> ({key: [M, ...]} outputs on the last stage, None elsewhere;
    the anchor: a zero to add to the loss on every stage)."""
    pp, d = comm.size, comm.rank
    n_local = stage_params.shape[0] if isinstance(stage_params, torch.Tensor) else len(
        stage_params)
    if n_local % virtual:
        raise ValueError(f"a stage's {n_local} layers % virtual {virtual} != 0")
    if virtual > 1 and m % pp:
        raise ValueError(f"interleaved pipeline needs microbatches ({m}) % pp ({pp}) == 0")
    lv = n_local // virtual
    keys = list(specs)
    u_last = ((m - 1) // pp) * pp * virtual + (virtual - 1) * pp + (m - 1) % pp
    token = torch.zeros((), device=next(iter(specs.values()))[2],
                        requires_grad=torch.is_grad_enabled())
    ring: Optional[dict] = None
    outputs: dict = {}
    prev = (d - 1) % pp
    for t in range(u_last + pp):
        unit = _unit(t - d, pp, virtual, m)
        y = None
        if unit is not None:
            mb, c = unit
            x_in = ({k: microbatches[k][mb] for k in keys} if d == 0 and c == 0 else ring)
            tree = dict(x_in)
            if local:
                tree.update({k: v[mb] for k, v in local.items()})
            out = body_fn(stage_params[c * lv:(c + 1) * lv], tree)
            y = {k: out[k] for k in keys}
            if d == pp - 1 and c == virtual - 1:
                outputs[mb] = y
        send = _sends(d, pp, virtual, unit)
        recv = _sends(prev, pp, virtual, _unit(t - prev, pp, virtual, m))
        if stats is not None:
            stats["ticks"] += 1
            stats["busy"] += unit is not None
        token, *got = _Shift.apply(
            comm, (d + 1) % pp if send else None, prev if recv else None,
            [specs[k] for k in keys], stats, token, *([y[k] for k in keys] if send else []))
        ring = dict(zip(keys, got)) if recv else None
    if not outputs:
        return None, token
    return {k: torch.stack([outputs[i][k] for i in range(m)]) for k in keys}, token


def _tree(x: Tree) -> dict:
    return x if isinstance(x, dict) else {"x": x}


def _schedule(stage_params, microbatches: Tree, body_fn, comm, virtual):
    tree = _tree(microbatches)
    wrap = not isinstance(microbatches, dict)
    specs = {k: (v.shape[1:], v.dtype, v.device) for k, v in tree.items()}
    m = next(iter(tree.values())).shape[0]
    body = (lambda p, t: {"x": body_fn(p, t["x"])}) if wrap else body_fn
    out, anchor = run_schedule(stage_params, tree, body, comm, m=m, virtual=virtual,
                               specs=specs)
    if out is not None and wrap:
        out = out["x"]
    return out, anchor


def pipeline_apply(stage_params, microbatches: Tree, body_fn: Callable, comm: Comm):
    """GPipe (JAX :34): ``stage_params`` this stage's layers (a tensor
    [L / pp, ...] or a list of layers), ``microbatches`` a tensor [M, ...]
    or {key: [M, ...]} (every stage passes the same), body_fn(stage_params,
    microbatch) -> the same structure. -> (the [M, ...] outputs on the last
    stage, None elsewhere; the anchor to add to the loss on every stage)."""
    return _schedule(stage_params, microbatches, body_fn, comm, 1)


def pipeline_apply_interleaved(stage_params, microbatches: Tree, body_fn: Callable, comm: Comm,
                               virtual: int = 2):
    """The interleaved schedule (JAX :119): ``stage_params`` this stage's
    ``virtual`` chunks, chunk-major (permute_layer_stack); otherwise as
    pipeline_apply. Requires M % pp == 0."""
    return _schedule(stage_params, microbatches, body_fn, comm, virtual)


def ticks(m: int, pp: int, virtual: int = 1) -> int:
    """The schedule's lockstep ticks: M + pp - 1 for GPipe, M v + pp - 1
    interleaved (M % pp == 0)."""
    return ((m - 1) // pp) * pp * virtual + (virtual - 1) * pp + (m - 1) % pp + pp


def bubble_share(m: int, pp: int, virtual: int = 1) -> float:
    """The share of a stage's ticks that compute nothing: (pp - 1) / (M v +
    pp - 1) (each tick 1/v of GPipe's work)."""
    return 1.0 - m * virtual / ticks(m, pp, virtual)

