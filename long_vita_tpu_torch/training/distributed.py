"""Multi-process training support: the launch and the batch each rank feeds.

Counterpart of long_vita_tpu/training/distributed.py: ``maybe_initialize``
(:47), ``process_dp_rows`` (:97), ``make_global_batch`` (:185) and
``local_rows`` (:223). JAX builds global arrays from each host's rows; the
port has no global arrays: every rank walks the same stream of whole
(zigzag-permuted) batches, keeps the rows of its dp index (``local_rows``)
and the sequence shard of its cp index (``make_global_batch``), and the
step sums the loss over ranks. The tp ranks of one (dp, cp) index take
the same rows and the same cp shard: the sequence-parallel split into tp
slices happens inside the model (models/long_vita.py). The pp ranks of one
dp index take the same rows too (JAX's pp geometry feeds dp x pp rows, a
microbatch of pp on each dp rank): the first stage embeds them, the last
scores them, and every stage reads a microbatch's positions and segment
ids from them (models/qwen2._pipelined_decoder).

Launch with torchrun (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or the
JAX package's variables (LVT_COORDINATOR=host:port, LVT_NUM_PROCESSES,
LVT_PROCESS_ID), e.g. on one host with two GPUs:

    torchrun --nproc-per-node 2 -m long_vita_tpu_torch.training.train \\
        --config recipe.yaml      # mesh: {dp: 1, cp: 2}, {tp: 2} or {pp: 2}
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from long_vita_tpu_torch.parallel.comm import DEFAULT_TIMEOUT, DistComm, init_process_group
from long_vita_tpu_torch.parallel.mesh import Mesh
from long_vita_tpu_torch.parallel.sharding import rank_rows, rank_seq

logger = logging.getLogger(__name__)

# batch keys with one row per batch row (dim 0)
_ROW_KEYS = ("tokens", "positions", "segment_ids", "logit_positions", "labels")
# of those, the keys whose dim 1 is the sequence (sharded over cp)
_SEQ_KEYS = ("tokens", "positions", "segment_ids")


def maybe_initialize(timeout: float = DEFAULT_TIMEOUT) -> Optional[DistComm]:
    """Initialize torch.distributed from the environment, if it names a
    job of more than one process: torchrun's RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT, or LVT_COORDINATOR (host:port) /
    LVT_NUM_PROCESSES / LVT_PROCESS_ID. NCCL when CUDA is available, else
    gloo. -> the world's DistComm, or None for a one-process run."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return DistComm(timeout=timeout)
    coord = os.environ.get("LVT_COORDINATOR")
    if coord:
        world, rank = int(os.environ["LVT_NUM_PROCESSES"]), int(os.environ["LVT_PROCESS_ID"])
        init = f"tcp://{coord}"
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    else:
        return None
    if world <= 1:
        return None
    comm = init_process_group(rank, world, init, timeout=timeout)
    logger.info("torch.distributed initialized: rank %d of %d", rank, world)
    return comm


def process_dp_rows(mesh: Mesh, global_batch: int) -> tuple[int, int]:
    """[start, stop) of the global batch rows this rank feeds: its dp
    index's 1/dp of them (parallel/sharding.rank_rows), the same on every
    pp, cp and tp rank of that dp index."""
    rows = rank_rows(mesh, global_batch)
    return rows.start, rows.stop


def local_rows(batch: dict, mesh: Mesh, global_batch: int) -> dict:
    """A whole batch (numpy) -> this rank's dp rows: the row keys sliced,
    and the tiles whose scatter rows lie in them, with image_indices[0]
    rebased to the kept rows (every cp rank of the replica keeps them all:
    the frozen tower splits them over cp inside the forward)."""
    lo, hi = process_dp_rows(mesh, global_batch)
    out = dict(batch)
    for key in _ROW_KEYS:
        if batch.get(key) is not None:
            out[key] = np.asarray(batch[key])[lo:hi]
    idx = batch.get("image_indices")
    if idx is not None:
        idx = np.asarray(idx)
        keep = (idx[0, :, 0] >= lo) & (idx[0, :, 0] < hi)
        kept = np.array(idx[:, keep], copy=True)
        kept[0] -= lo
        out["image_indices"] = kept
        out["images"] = np.asarray(batch["images"])[keep]
        if not keep.any():
            out["images"] = out["image_indices"] = None
    return out


def make_global_batch(local_batch: dict, mesh: Mesh, device) -> dict:
    """This rank's rows (local_rows) -> the tensors its step takes, on
    ``device``: tokens, positions and segment ids cut to its cp index's
    contiguous 1/cp of the (permuted) sequence; logit_positions, labels,
    images and image_indices whole (positions index the whole sequence)."""
    out = {}
    for key, v in local_batch.items():
        if v is None:
            out[key] = None
            continue
        v = np.asarray(v)
        if key in _SEQ_KEYS:
            v = v[:, rank_seq(mesh, v.shape[1])]
        out[key] = torch.as_tensor(np.ascontiguousarray(v)).to(device)
    return out
