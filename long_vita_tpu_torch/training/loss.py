"""Language-model loss with the logits-masked head, and batch collation.

Counterpart of long_vita_tpu/training/loss.py (``cross_entropy``,
``make_logit_positions``) and of long_vita_tpu/data/dataset.py's ``Pack`` and
``collate_packs``. The JAX collation imports the JAX loss module, and
``long_vita_tpu.data`` needs yaml and PIL, none of which the GPU machine has:
the port carries its own copy here, numpy in and numpy out, so the training
path imports nothing of ``long_vita_tpu`` beyond ``config`` and
``constants``.

Labels are pre-shifted (labels[t] is the target of position t's logits) and
IGNORE_INDEX (-100) rows contribute nothing; the supervised rows are packed
into a static [B, budget] (logit_positions, labels) pair so that only those
rows reach the vocabulary GEMM.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from long_vita_tpu.constants import IGNORE_INDEX

logger = logging.getLogger(__name__)


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, M, V] (f32), labels [B, M] with IGNORE_INDEX masked ->
    (summed loss, token count), both f32 scalars (loss.py:27)."""
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, 0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum().float()


def make_logit_positions(
    labels: np.ndarray, budget: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack each row's supervised positions into [B, budget] (loss.py:111).

    -> (positions [B, budget] int32, packed labels [B, budget], dropped):
    positions past the budget are dropped and counted; unused slots hold
    position 0 and IGNORE_INDEX."""
    labels = np.asarray(labels)
    b, s = labels.shape
    budget = min(budget, s)
    pos = np.zeros((b, budget), np.int32)
    out = np.full((b, budget), IGNORE_INDEX, labels.dtype)
    dropped = 0
    for i in range(b):
        idx = np.nonzero(labels[i] != IGNORE_INDEX)[0]
        dropped += max(len(idx) - budget, 0)
        idx = idx[:budget]
        pos[i, : len(idx)] = idx
        out[i, : len(idx)] = labels[i, idx]
    return pos, out, dropped


@dataclasses.dataclass
class Pack:
    """One packed training row (the JAX data pipeline's Pack, dataset.py:160)."""

    tokens: np.ndarray  # [S] int32
    labels: np.ndarray  # [S] int32, IGNORE-masked
    position_ids: np.ndarray  # [S] int32 (restart per segment)
    segment_ids: np.ndarray  # [S] int32
    images: Optional[np.ndarray]  # [N, H, W, 3] or None
    image_indices: Optional[np.ndarray]  # [2, N, T] or None
    actual_seq_len: list[int] = dataclasses.field(default_factory=list)


def collate_packs(packs: list, logit_budget: int, on_drop: str = "error") -> dict:
    """Batch packs into the train-step contract (dataset.py:299): tokens,
    positions, segment_ids [B, S]; next-token labels shifted and masked across
    segment boundaries, packed into (logit_positions, labels) [B, budget];
    images concatenated on the tile dim and image_indices with their batch
    row rewritten. Any object with Pack's fields will do (the JAX Pack too).
    A budget that drops supervised rows raises unless on_drop="warn"."""
    tokens = np.stack([p.tokens for p in packs])
    full_labels = np.stack([p.labels for p in packs])
    positions = np.stack([p.position_ids for p in packs])
    segments = np.stack([p.segment_ids for p in packs])

    shifted = np.full_like(full_labels, IGNORE_INDEX)
    shifted[:, :-1] = full_labels[:, 1:]
    same_seg = segments[:, :-1] == segments[:, 1:]
    shifted[:, :-1] = np.where(same_seg, shifted[:, :-1], IGNORE_INDEX)

    logit_positions, packed_labels, dropped = make_logit_positions(shifted, logit_budget)
    if dropped:
        msg = (
            f"logit budget {logit_budget} dropped {dropped} supervised rows — "
            "raise the logit budget (dense-SFT stages want budget = seq_len) "
            "or allow the drop"
        )
        if on_drop == "error":
            raise ValueError(msg)
        logger.warning(msg)

    images = [p.images for p in packs if p.images is not None]
    indices = []
    for b, p in enumerate(packs):
        if p.image_indices is not None:
            idx = p.image_indices.copy()
            idx[0] = b
            indices.append(idx)
    return {
        "tokens": tokens,
        "positions": positions,
        "segment_ids": segments,
        "logit_positions": logit_positions,
        "labels": packed_labels,
        "images": np.concatenate(images, axis=0) if images else None,
        "image_indices": np.concatenate(indices, axis=1) if indices else None,
    }


def to_device(batch: dict, device) -> dict:
    """numpy batch -> torch tensors on ``device`` (None stays None)."""
    return {
        k: (torch.as_tensor(v).to(device) if v is not None else None)
        for k, v in batch.items()
    }
