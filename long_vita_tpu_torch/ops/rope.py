"""Rotary position embeddings (HF non-interleaved / rotate-half convention).

Counterpart of long_vita_tpu/ops/rope.py:18-75, with the same f32 math.
"""
from __future__ import annotations

import torch


def rope_inv_freq(
    head_dim: int, theta: float, device: torch.device | None = None
) -> torch.Tensor:
    """[head_dim//2] inverse frequencies, f32.

    The power is taken in f64 and rounded once to f32 before the f32
    reciprocal; that reproduces the JAX package's f32 table bit for bit,
    where an f32 ``torch.pow`` is off by an ulp in some entries."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent.double()).float()


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for given positions.

    position_ids: int tensor [..., S]. Returns (cos, sin), each
    [..., S, head_dim] f32 in the duplicated-half layout."""
    inv_freq = rope_inv_freq(head_dim, theta, position_ids.device)
    angles = position_ids.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q: [B, S, Hq, D], k: [B, S, Hk, D]; cos/sin: [B, S, D] or [S, D].

    Half-split form: each output half is computed in f32 and cast to the
    input dtype before the concat (long_vita_tpu/ops/rope.py:64-73)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    half = q.shape[-1] // 2
    cos_h = cos[:, :, None, :half].float()  # [B, S, 1, D/2]
    sin_h = sin[:, :, None, :half].float()

    def _rot(x):
        x1 = x[..., :half].float()
        x2 = x[..., half:].float()
        return torch.cat(
            [
                (x1 * cos_h - x2 * sin_h).to(x.dtype),
                (x2 * cos_h + x1 * sin_h).to(x.dtype),
            ],
            dim=-1,
        )

    return _rot(q), _rot(k)
