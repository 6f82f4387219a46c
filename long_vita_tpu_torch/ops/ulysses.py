"""Ulysses (DeepSpeed-style) context parallelism: head-scatter all-to-all.

Counterpart of long_vita_tpu/ops/ulysses.py (:25-80). Each cp rank holds a
contiguous sequence shard; an all-to-all swaps the sharding from sequence
to heads, every rank runs causal attention over the FULL sequence for its
heads (K1 on CUDA, its backward K4 or K5), and a second all-to-all swaps
back. With GQA the kv heads are repeated up to cp when there are fewer of
them (JAX's ``_repeat_kv_heads``); cp must divide the q heads and the
(repeated) kv heads. No zigzag: every rank sees the whole sequence.

``ulysses_fwd`` / ``ulysses_bwd`` are plain functions (the card's op-level
check calls them per thread-rank); ``ulysses_attention`` is their
autograd.Function. ``head_parallel`` is the frame hybrid CP shares: the
all-to-alls around an inner attention given as a (forward, backward) pair.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from long_vita_tpu_torch.ops._target import on_cuda
from long_vita_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_reference,
)
from long_vita_tpu_torch.parallel.comm import Comm


def repeat_kv_heads(k: torch.Tensor, target: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, target, D] when Hkv < target (each kv head
    repeated in place, jnp.repeat's order); unchanged otherwise."""
    hkv = k.shape[2]
    if hkv >= target:
        return k
    if target % hkv:
        raise ValueError(f"kv heads {hkv} do not divide {target}")
    return k.repeat_interleave(target // hkv, dim=2)


def _unrepeat(dk: torch.Tensor, hkv: int) -> torch.Tensor:
    """The gradient of repeat_kv_heads: sum each kv head's copies."""
    b, s, h, d = dk.shape
    if h == hkv:
        return dk
    return dk.reshape(b, s, hkv, h // hkv, d).sum(3)


def head_parallel_fwd(q, k, v, comm: Comm, q_seg, kv_seg, inner_fwd: Callable):
    """Sequence-sharded q/k/v [B, s, H, D] -> head-sharded full sequences
    [B, s * size, H / size, D] over ``comm``, ``inner_fwd(qg, kg, vg, qs, ks)
    -> (og, lse)``, and back. -> (o [B, s, Hq, D], residuals)."""
    n = comm.size
    hq, hkv = q.shape[2], k.shape[2]
    if hq % n:
        raise ValueError(f"q heads {hq} not divisible by {n}")
    k, v = repeat_kv_heads(k, n), repeat_kv_heads(v, n)
    if k.shape[2] % n:
        raise ValueError(f"kv heads {k.shape[2]} not divisible by {n}")
    qg, kg, vg = (comm.all_to_all(x, 2, 1) for x in (q, k, v))
    qs = ks = None
    if q_seg is not None:
        # segment ids are head-agnostic: gather the sequence
        qs, ks = comm.all_gather(q_seg, 1), comm.all_gather(kv_seg, 1)
    og, lse = inner_fwd(qg, kg, vg, qs, ks)
    return comm.all_to_all(og, 1, 2), (qg, kg, vg, og, lse, qs, ks, hkv)


def head_parallel_bwd(res, do, comm: Comm, inner_bwd: Callable):
    """The backward of head_parallel_fwd: ``inner_bwd(qg, kg, vg, og, lse,
    dog, qs, ks) -> (dqg, dkg, dvg)`` between the transposed all-to-alls."""
    qg, kg, vg, og, lse, qs, ks, hkv = res
    dog = comm.all_to_all(do, 2, 1)
    dqg, dkg, dvg = inner_bwd(qg, kg, vg, og, lse, dog, qs, ks)
    dq = comm.all_to_all(dqg, 1, 2)
    dk = _unrepeat(comm.all_to_all(dkg, 1, 2), hkv)
    dv = _unrepeat(comm.all_to_all(dvg, 1, 2), hkv)
    return dq, dk, dv


class _HeadParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, fwd, bwd):
        o, res = fwd(q, k, v, q_seg, kv_seg)
        # the residual tensors go through save_for_backward, where saved-
        # tensor hooks (torch.utils.checkpoint's recompute) see and free them
        ctx.save_for_backward(*res[:-1])
        ctx.hkv, ctx.bwd = res[-1], bwd
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = ctx.bwd((*ctx.saved_tensors, ctx.hkv), do)
        return dq, dk, dv, None, None, None, None


def head_parallel(q, k, v, q_seg, kv_seg, fwd: Callable, bwd: Callable) -> torch.Tensor:
    """Differentiable ``fwd(q, k, v, q_seg, kv_seg) -> (o, res)`` with the
    backward ``bwd(res, do) -> (dq, dk, dv)``."""
    return _HeadParallel.apply(q, k, v, q_seg, kv_seg, fwd, bwd)


def _full_fwd(qg, kg, vg, qs, ks):
    if on_cuda(qg, kg, vg, qs, ks):
        with torch.no_grad():
            return flash_attention(qg, kg, vg, causal=True, q_segment_ids=qs,
                                   kv_segment_ids=ks, return_lse=True)
    return flash_attention_reference(qg, kg, vg, causal=True, q_segment_ids=qs,
                                     kv_segment_ids=ks)


def _full_bwd(qg, kg, vg, og, lse, dog, qs, ks):
    return flash_attention_bwd(qg, kg, vg, og, lse, dog, causal=True, q_segment_ids=qs,
                               kv_segment_ids=ks)


def ulysses_fwd(q, k, v, comm: Comm, q_seg=None, kv_seg=None):
    """-> (local o [B, S/cp, Hq, D], residuals for ulysses_bwd)."""
    return head_parallel_fwd(q, k, v, comm, q_seg, kv_seg, _full_fwd)


def ulysses_bwd(res, do, comm: Comm):
    """-> (dq, dk, dv) of the local shard."""
    return head_parallel_bwd(res, do, comm, _full_bwd)


def ulysses_attention(
    q: torch.Tensor,  # local [B, S/cp, Hq, D]
    k: torch.Tensor,  # local [B, S/cp, Hkv, D]
    v: torch.Tensor,
    comm: Comm,
    q_segment_ids: Optional[torch.Tensor] = None,  # local [B, S/cp]
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention over the whole (contiguously sharded) sequence by
    head-parallel all-to-alls over ``comm``. -> local o [B, S/cp, Hq, D]."""
    return head_parallel(
        q, k, v, q_segment_ids, kv_segment_ids,
        lambda *a: ulysses_fwd(*a[:3], comm, *a[3:]),
        lambda res, do: ulysses_bwd(res, do, comm),
    )
