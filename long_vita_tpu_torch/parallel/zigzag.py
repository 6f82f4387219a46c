"""Zigzag sequence permutation for causal context parallelism.

Counterpart of long_vita_tpu/parallel/zigzag.py (:22-63): the sequence
splits into 2 * cp chunks and rank r holds chunks (r, 2cp - 1 - r), so every
rank does the same causal work. One global permutation is applied before a
rank takes its contiguous 1/cp of the sequence; RoPE takes the original
positions, so nothing else needs to know.
"""
from __future__ import annotations

import numpy as np
import torch


def zigzag_order(num_chunks_half: int) -> np.ndarray:
    """Chunk order [r0, last, r1, last-1, ...] for cp ranks (2*cp chunks)."""
    cp = num_chunks_half
    order = []
    for r in range(cp):
        order += [r, 2 * cp - 1 - r]
    return np.asarray(order)


def zigzag_permutation(seq_len: int, cp: int) -> np.ndarray:
    """Index permutation: x_zigzag = x[perm]."""
    if seq_len % (2 * cp):
        raise ValueError(f"seq_len {seq_len} % 2*cp {2 * cp} != 0")
    c = seq_len // (2 * cp)
    chunks = np.arange(seq_len).reshape(2 * cp, c)
    return chunks[zigzag_order(cp)].reshape(-1)


def inverse_zigzag_permutation(seq_len: int, cp: int) -> np.ndarray:
    perm = zigzag_permutation(seq_len, cp)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return inv


def _take(x, idx: np.ndarray, axis: int):
    if isinstance(x, np.ndarray):
        return np.take(x, idx, axis=axis)
    return torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))


def zigzag_permute(x, cp: int, axis: int = 1):
    """Apply the zigzag permutation along ``axis`` (a numpy array or a
    tensor)."""
    if cp == 1:
        return x
    return _take(x, zigzag_permutation(x.shape[axis], cp), axis)


def zigzag_unpermute(x, cp: int, axis: int = 1):
    if cp == 1:
        return x
    return _take(x, inverse_zigzag_permutation(x.shape[axis], cp), axis)


def zigzag_positions(seq_len: int, cp: int) -> np.ndarray:
    """Position ids in zigzag order (what RoPE sees per shard)."""
    return zigzag_permutation(seq_len, cp)
