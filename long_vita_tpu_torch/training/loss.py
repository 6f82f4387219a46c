"""Language-model loss with the logits-masked head, and batch collation.

Counterpart of long_vita_tpu/training/loss.py (``cross_entropy``,
``vocab_parallel_ce``, ``make_logit_positions``) and of long_vita_tpu/data/dataset.py's ``Pack`` and
``collate_packs``. The JAX collation imports the JAX loss module, and
``long_vita_tpu.data`` needs yaml and PIL, none of which the GPU machine has:
the port carries its own copy here, numpy in and numpy out, and imports
nothing of the JAX package.

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

from long_vita_tpu_torch.constants import IGNORE_INDEX

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


def _f32_logits_local(hidden: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[N, H] x [V, H] -> f32 [N, V]: one bf16 GEMM writing f32 on CUDA
    (f32 accumulation, as the head's _F32Logits), the widened operands
    elsewhere."""
    if w.dtype != torch.float32 and hidden.is_cuda:
        return torch.mm(hidden, w.t(), out_dtype=torch.float32)
    return hidden.float() @ w.float().t()


def _f32_product(g: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 g [N, K] x b [K, M] -> [N, M] in ``dtype``: on CUDA with a bf16
    b, g split into bf16 halves hi + lo (16 of its 24 mantissa bits) and
    each half one bf16 GEMM summed in f32, as the head's backward
    (models/qwen2._F32Logits); elsewhere in f32."""
    if b.dtype != torch.float32 and b.is_cuda:
        hi = g.to(b.dtype)
        lo = (g - hi.float()).to(b.dtype)
        return (torch.mm(hi, b, out_dtype=torch.float32)
                + torch.mm(lo, b, out_dtype=torch.float32)).to(dtype)
    return (g @ b.float()).to(dtype)


class _VocabParallelCE(torch.autograd.Function):
    """The per-row loss of vocab_parallel_ce: -> nll [N] (f32, 0 on masked
    rows), the same on every tp rank. Saves the rank's f32 logits; the
    backward is local (softmax minus one-hot, times the upstream gradient)
    but for the hidden rows' gradient, summed over tp."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, tp, tq):
        logits = _f32_logits_local(hidden, weight)  # [N, V/tp]
        if tq is not None:  # 2-D tp: partial logits of the rank's hidden slice
            logits = tq.all_reduce_sum(logits)
        vloc = logits.shape[1]
        # the max offset cancels, so it is taken without a gradient: the
        # rank's row max, then the max over tp (an exact all-gather)
        m = tp.all_gather(logits.amax(-1)[None], 0).amax(0)
        sumexp = tp.all_reduce_sum(torch.exp(logits - m[:, None]).sum(-1))
        logz = m + torch.log(sumexp)
        mask = labels != IGNORE_INDEX
        loc = torch.where(mask, labels, 0).long() - tp.rank * vloc
        mine = (loc >= 0) & (loc < vloc)
        gold_local = torch.take_along_dim(logits, loc.clamp(0, vloc - 1)[:, None], 1)[:, 0]
        gold = tp.all_reduce_sum(torch.where(mine, gold_local, torch.zeros_like(gold_local)))
        nll = (logz - gold) * mask
        ctx.tp = tp
        ctx.save_for_backward(hidden, weight, logits, logz, loc, mine & mask, mask)
        return nll

    @staticmethod
    def backward(ctx, g):
        hidden, weight, logits, logz, loc, hit, mask = ctx.saved_tensors
        scale = (g * mask).float()
        # softmax minus one-hot, times the upstream gradient, in place
        dlogits = logits.sub_(logz[:, None]).exp_()
        rows = torch.nonzero(hit)[:, 0]
        dlogits[rows, loc[rows]] -= 1.0
        dlogits.mul_(scale[:, None])
        d_hidden = d_weight = None
        if ctx.needs_input_grad[0]:
            d_hidden = ctx.tp.all_reduce_sum(_f32_product(dlogits, weight, hidden.dtype))
        if ctx.needs_input_grad[1]:
            d_weight = _f32_product(dlogits.t(), hidden, weight.dtype)
        return d_hidden, d_weight, None, None, None


def vocab_parallel_ce(
    weight: torch.Tensor, hidden: torch.Tensor, labels: torch.Tensor, tp, tq=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The budget rows' head GEMM and CE against the vocab-sharded head
    (loss.py:40, the reference's vocab-parallel CE): weight [V/tp, H], this
    rank's slice of lm_head (rank t holds ids [t V/tp, (t + 1) V/tp));
    hidden [..., H] and labels [...] the same rows on every rank of ``tp``
    (a Comm). Each rank forms its f32 logits [N, V/tp], the row max is the
    max over tp (held without a gradient), the sum of exponentials is
    summed over tp, and the gold logit comes from the one rank whose range
    holds the label (IGNORE_INDEX rows masked). -> (summed loss, count) of
    these rows, f32, the same on every tp rank: the caller sums them over
    dp x cp (disjoint rows). The rows' gradient is summed over tp in the
    backward, the weight's stays the rank's own. tq (2-D tp, where JAX
    takes its plain head, train_step.py:75-84): hidden is the rows' hidden
    slice and weight the rank's [V/tp, H/tq] block; the f32 partial logits
    are summed over tq first, so every tq rank goes on with the same logits
    and its gradient passes through that sum (each rank's rows and weight
    take theirs from it)."""
    flat = hidden.reshape(-1, hidden.shape[-1])
    labels = labels.reshape(-1)
    nll = _VocabParallelCE.apply(flat, weight, labels, tp, tq)
    return nll.sum(), (labels != IGNORE_INDEX).sum().float()


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
