"""Pixel-shuffle projector: ViT patch features -> the decoder's embedding space.

Counterpart of long_vita_tpu/models/projector.py: pixel_shuffle (scale 0.5)
on the [grid, grid] patch map (1024 patches -> 256 tokens a tile, 4x the
channels), then LayerNorm (eps 1e-5) and a bias-free two-layer exact-GELU MLP
into the decoder's hidden size.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.models.intern_vit import LayerNormParams, layer_norm
from long_vita_tpu_torch.models.qwen2 import Dense


class ProjectorParams(nn.Module):
    """The projector's weights (the JAX package's ``params["projector"]``)."""

    def __init__(self, *, pre_norm: LayerNormParams, fc1: Dense, fc2: Dense):
        super().__init__()
        self.pre_norm, self.fc1, self.fc2 = pre_norm, fc1, fc2


def pixel_shuffle(x: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """[N, W, H, C] -> [N, W*s, H*s, C/s^2], the JAX package's reshape and
    transpose order step for step: it fixes the channel order that the
    released projector weights expect."""
    n, w, h, c = x.shape
    hs, ws = int(h * scale), int(w * scale)
    x = x.reshape(n, w, hs, int(c / scale))
    x = x.permute(0, 2, 1, 3)  # [N, H*s, W, C/s]
    x = x.reshape(n, hs, ws, int(c / (scale * scale)))
    return x.permute(0, 2, 1, 3)  # [N, W*s, H*s, C/s^2]


def project_features(
    params: ProjectorParams, patch_features: torch.Tensor, cfg: LongVITAConfig
) -> torch.Tensor:
    """[N_tiles, grid*grid, vit_hidden] -> [N_tiles, tokens, lm_hidden]."""
    n, s, c = patch_features.shape
    grid = int(round(s**0.5))
    x = pixel_shuffle(patch_features.reshape(n, grid, grid, c), cfg.vision_downsample_ratio)
    x = x.reshape(n, -1, x.shape[-1])  # [N, tokens, 4 * vit_hidden]
    x = layer_norm(x, params.pre_norm.scale, params.pre_norm.bias, 1e-5)
    x = F.gelu(F.linear(x, params.fc1.weight))  # exact GELU
    return F.linear(x, params.fc2.weight)


def init_projector_params(
    generator: torch.Generator,
    cfg: LongVITAConfig,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> ProjectorParams:
    """Random init as the JAX package's (normal * 0.02 kernels, unit norm)."""
    device = torch.device(device) if device is not None else generator.device
    vit_h = cfg.vision.hidden_size
    in_dim = vit_h * int(1 / cfg.vision_downsample_ratio) ** 2

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

    return ProjectorParams(
        pre_norm=LayerNormParams(
            torch.ones(in_dim, dtype=dtype, device=device),
            torch.zeros(in_dim, dtype=dtype, device=device),
        ),
        fc1=Dense(normal(vit_h, in_dim)),
        fc2=Dense(normal(cfg.text.hidden_size, vit_h)),
    )
