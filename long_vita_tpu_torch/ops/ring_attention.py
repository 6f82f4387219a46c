"""Ring attention with zigzag causal load balancing over a cp communicator.

Counterpart of long_vita_tpu/ops/ring_attention.py: ``ring_attention``
(:153), the pair compute (:177-272), the forward ``_ring_fwd`` (:273), the
backward with dK/dV carried around the ring with K/V (:396-495), and the
rotations and the double-ring window (:84-137).

The sequence is split into 2 * cp chunks and rank r holds chunks
(r, 2cp - 1 - r) (parallel/zigzag.py). At each ring step the kv pair owned
by rank w meets this rank's q chunks as one of: the causal diagonal (w ==
r: three pairs), or two full attends (q_b vs kv_c always, and q_a vs kv_c
when w < r, q_b vs kv_d when w > r). Each pair is K1 forward and K4 or K5
backward on CUDA (ops/attention_pair.py). JAX selects between the branches
with lax.cond and jnp.where on traced indices; here r and the step are
Python ints, so each step launches only the pairs it needs.

Accumulators follow JAX: the forward merges o in q's dtype and lse in f32
(merge_partials); the backward carries dq and the travelling dK/dV in f32,
adding each pair's gradients (in the input dtype, summed there first where
two pairs meet the same chunk) after widening them.

Double ring (``window`` W < cp ranks a window, the reference's
--cp-window-size): the forward sweeps W steps inside the window, then jumps
the sweep's starting K/V W ranks ahead; the backward takes JAX's uniform
schedule (W - 1 inner hops, then one diagonal hop of inner + 1 and window +
1) that returns every dK/dV accumulator to its owner after cp steps. A
rotation whose result would be discarded (the last forward hop, the last
backward hop of K/V) is not made.

``ring_fwd`` and ``ring_bwd`` are plain functions (the card's op-level
check calls them on each thread-rank, as autograd's single device thread
cannot run backward passes that wait for each other); ``ring_attention`` is
their torch.autograd.Function.
"""
from __future__ import annotations

from typing import Optional

import torch

from long_vita_tpu_torch.ops.attention_pair import merge_partials, pair_attn_bwd, pair_attn_fwd
from long_vita_tpu_torch.ops.flash_attention import NEG_INF
from long_vita_tpu_torch.parallel.comm import Comm


def _split2(x: Optional[torch.Tensor], dim: int = 1):
    if x is None:
        return None, None
    c = x.shape[dim] // 2
    return x.narrow(dim, 0, c), x.narrow(dim, c, c)


def _windows(comm: Comm, window: int) -> tuple[int, int, Comm]:
    """-> (ranks a window W, windows, the communicator of this rank's
    window). W = cp for window 0 or >= cp (the plain ring)."""
    cp = comm.size
    win = window if window and 0 < window < cp else cp
    if cp % win:
        raise ValueError(f"window {win} must divide ring size {cp}")
    n_win = cp // win
    wcomm = comm if n_win == 1 else comm.split(
        [[g * win + i for i in range(win)] for g in range(n_win)]
    )
    return win, n_win, wcomm


def _owner(r: int, o: int, i: int, win: int, n_win: int) -> int:
    """The rank whose kv this rank holds at sweep o, inner step i."""
    return ((r // win - o) % n_win) * win + (r % win - i) % win


def _shift(xs: tuple, comm: Comm, shift: int) -> tuple:
    return tuple(None if x is None else comm.ring_shift(x, shift) for x in xs)


def _fwd_step(q_a, q_b, qs_a, qs_b, kv, w: int, r: int):
    """One step's pairs -> (partial of chunk a or None, partial of chunk b)."""
    k, v, s = kv
    (k_c, k_d), (v_c, v_d), (s_c, s_d) = _split2(k), _split2(v), _split2(s)
    if w == r:
        part_a = pair_attn_fwd(q_a, k_c, v_c, causal=True, q_segment_ids=qs_a, kv_segment_ids=s_c)
        ob1, lb1 = pair_attn_fwd(q_b, k_c, v_c, causal=False, q_segment_ids=qs_b,
                                 kv_segment_ids=s_c)
        ob2, lb2 = pair_attn_fwd(q_b, k_d, v_d, causal=True, q_segment_ids=qs_b,
                                 kv_segment_ids=s_d)
        return part_a, merge_partials(ob1, lb1, ob2, lb2)
    ob1, lb1 = pair_attn_fwd(q_b, k_c, v_c, causal=False, q_segment_ids=qs_b, kv_segment_ids=s_c)
    if w > r:  # wrap: q_b also meets kv_d
        ob2, lb2 = pair_attn_fwd(q_b, k_d, v_d, causal=False, q_segment_ids=qs_b,
                                 kv_segment_ids=s_d)
        return None, merge_partials(ob1, lb1, ob2, lb2)
    part_a = pair_attn_fwd(q_a, k_c, v_c, causal=False, q_segment_ids=qs_a, kv_segment_ids=s_c)
    return part_a, (ob1, lb1)


def ring_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm: Comm,
             q_seg: Optional[torch.Tensor] = None, kv_seg: Optional[torch.Tensor] = None,
             window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, 2C, Hq, D], k/v [B, 2C, Hkv, D]: this rank's zigzag chunk pair;
    segment ids [B, 2C] (both or neither). -> (o [B, 2C, Hq, D] in q's
    dtype, lse [B, Hq, 2C] f32)."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both segment ids, or neither")
    r = comm.rank
    win, n_win, wcomm = _windows(comm, window)
    b, two_c, hq, _ = q.shape
    c = two_c // 2
    q_a, q_b = _split2(q)
    qs_a, qs_b = _split2(q_seg)
    o_a, o_b = torch.zeros_like(q_a), torch.zeros_like(q_b)
    lse_a = torch.full((b, hq, c), NEG_INF, dtype=torch.float32, device=q.device)
    lse_b = lse_a.clone()
    kv = (k, v, kv_seg)
    for o in range(n_win):
        kv_start = kv
        for i in range(win):
            part_a, part_b = _fwd_step(q_a, q_b, qs_a, qs_b, kv, _owner(r, o, i, win, n_win), r)
            if part_a is not None:
                o_a, lse_a = merge_partials(o_a, lse_a, *part_a)
            o_b, lse_b = merge_partials(o_b, lse_b, *part_b)
            if i < win - 1:
                kv = _shift(kv, wcomm, 1)
        if o < n_win - 1:
            kv = _shift(kv_start, comm, win)
    return torch.cat([o_a, o_b], 1), torch.cat([lse_a, lse_b], 2)


def _bwd_step(q_a, q_b, g_a, g_b, lse_a, lse_b, dl_a, dl_b, qs_a, qs_b, kv, w: int, r: int):
    """One step's pair gradients -> (dq_a or None, dq_b, dk, dv), f32 (dk,
    dv over the kv owner's whole chunk pair, None halves as zeros)."""
    k, v, s = kv
    (k_c, k_d), (v_c, v_d), (s_c, s_d) = _split2(k), _split2(v), _split2(s)

    def pair(qx, gx, lx, dx, kx, vx, qsx, sx, causal):
        return pair_attn_bwd(qx, kx, vx, gx, lx, dx, causal=causal, q_segment_ids=qsx,
                             kv_segment_ids=sx)

    def cat(a, b_):
        if a is None:
            a = torch.zeros_like(b_)
        if b_ is None:
            b_ = torch.zeros_like(a)
        return torch.cat([a, b_], 1)

    if w == r:
        dqa, dkc1, dvc1 = pair(q_a, g_a, lse_a, dl_a, k_c, v_c, qs_a, s_c, True)
        dqb1, dkc2, dvc2 = pair(q_b, g_b, lse_b, dl_b, k_c, v_c, qs_b, s_c, False)
        dqb2, dkd, dvd = pair(q_b, g_b, lse_b, dl_b, k_d, v_d, qs_b, s_d, True)
        return (dqa.float(), (dqb1 + dqb2).float(),
                cat((dkc1 + dkc2).float(), dkd.float()), cat((dvc1 + dvc2).float(), dvd.float()))
    dqb1, dkc1, dvc1 = pair(q_b, g_b, lse_b, dl_b, k_c, v_c, qs_b, s_c, False)
    if w > r:
        dq2, dk2, dv2 = pair(q_b, g_b, lse_b, dl_b, k_d, v_d, qs_b, s_d, False)
        return (None, dqb1.float() + dq2.float(),
                cat(dkc1.float(), dk2.float()), cat(dvc1.float(), dv2.float()))
    dq2, dk2, dv2 = pair(q_a, g_a, lse_a, dl_a, k_c, v_c, qs_a, s_c, False)
    return (dq2.float(), dqb1.float(),
            cat(dkc1.float() + dk2.float(), None), cat(dvc1.float() + dv2.float(), None))


def ring_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
             lse: torch.Tensor, do: torch.Tensor, comm: Comm,
             q_seg: Optional[torch.Tensor] = None, kv_seg: Optional[torch.Tensor] = None,
             window: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ring_fwd's o for the output gradient do
    [B, 2C, Hq, D], from its (o, lse), in the inputs' dtypes."""
    r = comm.rank
    win, n_win, wcomm = _windows(comm, window)
    c = q.shape[1] // 2
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B, Hq, 2C]
    q_a, q_b = _split2(q)
    g_a, g_b = _split2(do)
    lse_a, lse_b = _split2(lse, 2)
    dl_a, dl_b = _split2(delta, 2)
    qs_a, qs_b = _split2(q_seg)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = (k, v, kv_seg)
    dkv = (torch.zeros(k.shape, dtype=torch.float32, device=q.device),
           torch.zeros(v.shape, dtype=torch.float32, device=q.device))
    for o_ in range(n_win):
        for i in range(win):
            dqa, dqb, dk_new, dv_new = _bwd_step(
                q_a, q_b, g_a, g_b, lse_a, lse_b, dl_a, dl_b, qs_a, qs_b, kv,
                _owner(r, o_, i, win, n_win), r,
            )
            if dqa is not None:
                dq[:, :c] += dqa
            dq[:, c:] += dqb
            dkv[0].add_(dk_new)
            dkv[1].add_(dv_new)
            last = o_ == n_win - 1 and i == win - 1
            if i < win - 1:
                kv, dkv = _shift(kv, wcomm, 1), _shift(dkv, wcomm, 1)
            else:  # the diagonal hop (the plain ring: one hop of +1)
                if n_win > 1:
                    dkv = _shift(dkv, wcomm, 1)
                    kv = kv if last else _shift(kv, wcomm, 1)
                dkv = _shift(dkv, comm, win if n_win > 1 else 1)
                kv = kv if last else _shift(kv, comm, win if n_win > 1 else 1)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, comm, q_seg, kv_seg, window):
        o, lse = ring_fwd(q, k, v, comm, q_seg, kv_seg, window)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.comm, ctx.window = comm, window
        ctx.mark_non_differentiable(lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        dq, dk, dv = ring_bwd(q, k, v, o, lse, do, ctx.comm, q_seg, kv_seg, ctx.window)
        return dq, dk, dv, None, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    comm: Comm,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    window: int = 0,
) -> torch.Tensor:
    """Causal ring attention on this rank's zigzag chunk pair (q/k/v local
    [B, 2C, H, D], segment ids [B, 2C]) over ``comm``, the ring. -> local o
    [B, 2C, Hq, D]. Differentiable in q, k and v."""
    return _RingAttention.apply(q, k, v, comm, q_segment_ids, kv_segment_ids, window)
