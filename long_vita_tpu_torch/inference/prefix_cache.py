"""Cross-request prefix KV caching.

Counterpart of long_vita_tpu/inference/prefix_cache.py. Snapshots of recent
prompts' KV caches let the engine resume prefill after the longest matching
prefix of a new prompt:

  - entries are full-size cache buffers (the engine's own shape), so a
    restore is a device copy with no slot arithmetic;
  - a match is exact on expanded token ids, capped at the entry's valid
    frontier, aligned down to the prefill-chunk grid and capped at
    true_len - 1, so the final prompt row is always recomputed;
  - media placeholder ids are the same for different images, so every entry
    also carries a fingerprint of the tile stack, which a hit must match;
  - snapshots are ``clone()``s (quantised scales included): the port writes
    its caches in place, so an entry must never alias a cache the engine
    still drives (``put`` copies in, ``match`` copies out).

No tokenizer is involved: keys are token ids and pixels.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from long_vita_tpu_torch.models.qwen2 import KVCache


def copy_cache(cache: KVCache) -> KVCache:
    """A copy of every buffer of ``cache`` (never aliases it)."""

    def cp(x):
        return None if x is None else x.clone()

    length = cache.length.clone() if hasattr(cache.length, "clone") else cache.length
    return KVCache(cp(cache.k), cp(cache.v), length, k_scale=cp(cache.k_scale),
                   v_scale=cp(cache.v_scale))


def media_fingerprint(images) -> str:
    """Fingerprint of a tile stack (numpy, or a host tensor, hashed through
    its bytes): its shape, dtype and a hash of a sample of about 16 tiles
    (every k-th, the first and the last)."""
    if images is None or getattr(images, "shape", (0,))[0] == 0:
        return ""
    if torch.is_tensor(images):
        t = images.detach().cpu().contiguous()
        shape, dtype = tuple(t.shape), str(t.dtype)
        arr = t.reshape(shape[0], -1).view(torch.uint8).numpy()  # a row of bytes a tile
    else:
        arr = np.asarray(images)
        shape, dtype = arr.shape, str(arr.dtype)
    n = arr.shape[0]
    step = max(1, n // 14)
    idx = sorted({0, n - 1, *range(0, n, step)})
    h = hashlib.blake2b(digest_size=16)
    h.update(str(shape).encode())
    h.update(dtype.encode())
    for i in idx:
        h.update(np.ascontiguousarray(arr[i]).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class _Entry:
    ids: np.ndarray    # [n] int32: prompt (+ generated) token ids
    media_key: str
    cache: KVCache     # full-size snapshot, length == frontier
    frontier: int      # number of valid kv slots
    tick: int = 0      # LRU clock


class PrefixCache:
    """LRU store of prompt KV snapshots, matched by token-id prefix."""

    def __init__(self, max_entries: int, chunk: int):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        self.max_entries = max_entries
        self.chunk = chunk
        self._entries: list[_Entry] = []
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, ids, media_key: str = "") -> Optional[tuple[KVCache, int]]:
        """Longest usable cached prefix of ``ids``: -> (a copy of the cache
        with length = start, start), start chunk-aligned and at least one
        chunk, or None."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        best, best_len = None, 0
        for e in self._entries:
            if e.media_key != media_key:
                continue
            n = min(len(ids), len(e.ids), e.frontier)
            if n <= 0:
                continue
            neq = np.nonzero(ids[:n] != e.ids[:n])[0]
            common = int(neq[0]) if neq.size else n
            if common > best_len:
                best, best_len = e, common
        start = min(best_len, len(ids) - 1) // self.chunk * self.chunk
        if best is None or start < self.chunk:
            self.misses += 1
            return None
        self._tick += 1
        best.tick = self._tick
        self.hits += 1
        self.tokens_saved += start
        return dataclasses.replace(copy_cache(best.cache), length=start), start

    def put(self, ids, cache: KVCache, frontier: int, media_key: str = "") -> None:
        """Snapshot ``cache`` (copied) for the prompt ``ids[:frontier]``. A
        snapshot whose ids prefix-match an entry at least as far as its
        frontier replaces it (the longer of the two stays), so multi-turn
        chat keeps one entry per session."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        frontier = min(frontier, len(ids))
        if frontier < self.chunk:
            return
        self._tick += 1
        snap = dataclasses.replace(copy_cache(cache), length=frontier)
        entry = _Entry(ids[:frontier].copy(), media_key, snap, frontier, self._tick)
        for i, e in enumerate(self._entries):
            if e.media_key != media_key:
                continue
            n = min(e.frontier, frontier)
            if np.array_equal(e.ids[:n], entry.ids[:n]):
                if frontier >= e.frontier:
                    self._entries[i] = entry
                else:
                    e.tick = self._tick  # keep the longer snapshot fresh
                return
        self._entries.append(entry)
        if len(self._entries) > self.max_entries:
            self._entries.sort(key=lambda e: e.tick)
            self._entries.pop(0)
