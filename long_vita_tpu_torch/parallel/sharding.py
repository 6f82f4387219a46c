"""A rank's slice of a batch and of the activations.

Counterpart of long_vita_tpu/parallel/sharding.py ``batch_spec`` (:165,
P(dp, cp): batch rows over dp, sequence over cp) and ``activation_spec``
(:170, P(dp, cp, None)). JAX lays a global array out by such a spec; the
port's SPMD ranks each hold their piece, which these slices cut
(training/distributed.py feeds a rank's step with them). The
tensor-parallel parameter specs (:33-152) come with tp (ROADMAP §1, Tensor
parallelism).
"""
from __future__ import annotations

from long_vita_tpu_torch.parallel.mesh import Mesh


def rank_rows(mesh: Mesh, batch: int) -> slice:
    """The rows of a [batch, ...] array this rank holds: its dp index's
    1/dp of them."""
    dp = mesh.shape["dp"]
    if batch % dp:
        raise ValueError(f"batch {batch} % dp {dp} != 0")
    per = batch // dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def rank_seq(mesh: Mesh, seq_len: int) -> slice:
    """The positions of a [B, seq_len, ...] array this rank holds: its cp
    index's contiguous 1/cp of the (zigzag-permuted) sequence."""
    cp = mesh.shape["cp"]
    if seq_len % cp:
        raise ValueError(f"sequence {seq_len} % cp {cp} != 0")
    per = seq_len // cp
    return slice(mesh.cp_index * per, (mesh.cp_index + 1) * per)
