"""Hybrid context parallelism: Ulysses lanes inside ring groups.

Counterpart of long_vita_tpu/ops/hybrid_cp.py (:27). The cp communicator
factors into cp / inner ring groups of ``inner`` contiguous ranks (the
lanes). An all-to-all inside each group swaps sequence sharding for head
sharding, zigzag ring attention then runs across the groups on chunks
``inner`` times larger (each lane rotating with the same lane of the other
groups), and a second all-to-all restores the layout. The sequence is
zigzag-permuted over the ring groups (``zigzag_permute(x, cp // inner)``)
before each rank takes its contiguous 1/cp.
"""
from __future__ import annotations

from typing import Optional

import torch

from long_vita_tpu_torch.ops.ring_attention import ring_bwd, ring_fwd
from long_vita_tpu_torch.ops.ulysses import head_parallel, head_parallel_bwd, head_parallel_fwd
from long_vita_tpu_torch.parallel.comm import Comm


def hybrid_comms(comm: Comm, inner: int) -> tuple[Comm, Comm]:
    """-> (this rank's lanes: its ring group, this rank's ring: the same
    lane of every group)."""
    cp = comm.size
    if cp % inner:
        raise ValueError(f"cp {cp} % inner {inner} != 0")
    groups = cp // inner
    lanes = comm.split([[g * inner + lane for lane in range(inner)] for g in range(groups)])
    ring = comm.split([[g * inner + lane for g in range(groups)] for lane in range(inner)])
    return lanes, ring


def hybrid_fwd(q, k, v, comm: Comm, inner: int, q_seg=None, kv_seg=None, window: int = 0):
    """-> (local o [B, S/cp, Hq, D], residuals for hybrid_bwd)."""
    lanes, ring = hybrid_comms(comm, inner)
    return head_parallel_fwd(
        q, k, v, lanes, q_seg, kv_seg,
        lambda qg, kg, vg, qs, ks: ring_fwd(qg, kg, vg, ring, qs, ks, window),
    )


def hybrid_bwd(res, do, comm: Comm, inner: int, window: int = 0):
    """-> (dq, dk, dv) of the local shard."""
    lanes, ring = hybrid_comms(comm, inner)
    return head_parallel_bwd(
        res, do, lanes,
        lambda qg, kg, vg, og, lse, dog, qs, ks: ring_bwd(qg, kg, vg, og, lse, dog, ring, qs,
                                                         ks, window),
    )


def hybrid_attention(
    q: torch.Tensor,  # local [B, S/cp, Hq, D]
    k: torch.Tensor,
    v: torch.Tensor,
    comm: Comm,
    inner: int = 2,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    window: int = 0,
) -> torch.Tensor:
    """Causal hybrid-CP attention over ``comm``; window: the double-ring
    window over the ring groups (0 = plain). -> local o."""
    return head_parallel(
        q, k, v, q_segment_ids, kv_segment_ids,
        lambda *a: hybrid_fwd(*a[:3], comm, inner, *a[3:], window=window),
        lambda res, do: hybrid_bwd(res, do, comm, inner, window),
    )
