"""Operations and bytes that the work needs, from its shapes and the
published widths, and the chip's peaks.

A kernel's roofline share is the least time the chip could take for the
work it did (operations over the peak rate or bytes over the peak bandwidth,
whichever is larger) over the time its kernels took. The work is what these
inputs need: causal attention counts the (query, key) pairs at or below the
diagonal of the true rows, whatever the chunking or padding; each input is
read once and each output written once (bf16, 2 bytes). A backward needs
four products per pair (dP, dV, dQ, dK); recomputing the scores is the
kernel's choice and is not counted. MFU counts the model's needed
operations: 2 per weight a token forward, 4 for a frozen weight trained
through (forward and the input's gradient), 6 for a trained one; no
recompute.

Peaks: NVIDIA H100 SXM, dense bf16 989 TFLOP/s, HBM 3.35 TB/s (at 700 W).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def pairs_causal(r0: int, r1: int) -> int:
    """(query, key) pairs of rows r0..r1-1 each attending keys 0..row."""
    return (r1 * (r1 + 1) - r0 * (r0 + 1)) // 2


def attn_fwd(n: dict, r0: int, r1: int) -> tuple[float, float]:
    """Causal attention of the decoder's rows r0..r1-1 over keys 0..r1-1
    (one layer): (flops, bytes)."""
    hq, hkv, d = n["hq"], n["hkv"], n["d"]
    flops = 4 * hq * d * pairs_causal(r0, r1)
    nbytes = BF16 * d * (2 * (r1 - r0) * hq + 2 * r1 * hkv)
    return flops, nbytes


def attn_bwd(n: dict, length: int) -> tuple[float, float]:
    """The backward of causal attention over one segment (one layer)."""
    hq, hkv, d = n["hq"], n["hkv"], n["d"]
    flops = 8 * hq * d * pairs_causal(0, length)
    nbytes = BF16 * d * length * (4 * hq + 4 * hkv)  # q, o, dO, dQ; k, v, dK, dV
    return flops, nbytes


def vit_attn(n: dict, tiles: int) -> tuple[float, float]:
    """The tower's full attention over ``tiles`` tiles, all its layers."""
    s = n["grid"] ** 2 + 1
    flops = 4 * n["vheads"] * n["vd"] * s * s * tiles * n["vl"]
    nbytes = BF16 * 4 * s * n["vh"] * tiles * n["vl"]
    return flops, nbytes


def layer_weights(n: dict) -> int:
    """Weights of one decoder layer's products."""
    h, i, hq, hkv, d = n["h"], n["i"], n["hq"], n["hkv"], n["d"]
    return h * hq * d * 2 + 2 * h * hkv * d + 3 * h * i


def vit_weights(n: dict) -> int:
    vh, vi = n["vh"], n["vi"]
    return n["vl"] * (4 * vh * vh + 2 * vh * vi) + vh * n["patch"] ** 2 * 3


def projector_weights(n: dict) -> int:
    return n["vh"] * n["shuffle"] * n["vh"] + n["vh"] * n["h"]


def tower_flops(n: dict, tiles: int) -> float:
    """Tower forward and projector over ``tiles`` tiles."""
    s = n["grid"] ** 2 + 1
    return (2 * vit_weights(n) * s * tiles + vit_attn(n, tiles)[0]
            + 2 * projector_weights(n) * n["tokens"] * tiles)


def serve_flops(n: dict, prompt: int, tiles: int, new_tokens: int) -> float:
    """A served request: the tower over its tiles, the decoder over the
    prompt and the fed-back tokens, attention causal over the context, the
    head at each generated token."""
    fed = prompt + max(new_tokens - 1, 0)
    return (tower_flops(n, tiles) + 2 * n["l"] * layer_weights(n) * fed
            + n["l"] * 4 * n["hq"] * n["d"] * pairs_causal(0, fed)
            + 2 * n["h"] * n["v"] * new_tokens)


def train_flops(n: dict, segments: list, supervised: int, tiles: int) -> float:
    """One stage-1 step over a packed row: frozen tower forward, trained
    projector, frozen decoder trained through (the input's gradient), its
    attention forward and backward inside each segment, the frozen head at
    the supervised rows."""
    s = n["grid"] ** 2 + 1
    tokens = sum(b - a for a, b in segments)
    attn = sum(attn_fwd(n, 0, b - a)[0] + attn_bwd(n, b - a)[0] for a, b in segments)
    return (2 * vit_weights(n) * s * tiles + vit_attn(n, tiles)[0]
            + 6 * projector_weights(n) * n["tokens"] * tiles
            + 4 * n["l"] * layer_weights(n) * tokens + n["l"] * attn
            + 4 * n["h"] * n["v"] * supervised)
