"""Traffic generators, one per kind, each reading a mix's parameters from
``traffic/<mix>.json``. Sizes and gaps are fixed sets of quantiles of the
mix's distributions that every seed draws in another order, so two seeds
give the same work; the seed picks the order and the content."""
from __future__ import annotations

import math

import numpy as np


def rng_of(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one purpose of one run (seeds past 32 bits)."""
    return np.random.default_rng([int(seed) & (2**63 - 1), *stream.encode()])


def quantiles(n: int, lo: float, hi: float, log: bool = False) -> np.ndarray:
    """n sizes at the quantiles (k + 0.5) / n of uniform [lo, hi] (of its
    logarithm with ``log``), rounded to whole numbers."""
    q = (np.arange(n) + 0.5) / n
    if log:
        vals = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    else:
        vals = lo + q * (hi - lo)
    return np.rint(vals).astype(np.int64)


def blocks(rng: np.random.Generator, block: np.ndarray, count: int) -> np.ndarray:
    """``count`` values: ``block`` repeated, each repetition in its own
    random order."""
    out = [rng.permutation(block) for _ in range(-(-count // len(block)))]
    return np.concatenate(out)[:count]


def frame_pool(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """n random uint8 RGB frames [n, size, size, 3]."""
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def words(rng: np.random.Generator, ids, n: int) -> tuple[str, list[int]]:
    """n one-id words: (their text, their ids)."""
    pick = rng.integers(0, len(ids.words), n)
    return "".join(ids.texts[i] for i in pick), [ids.words[i] for i in pick]
