"""LongVITA VLM on one device: InternViT + pixel-shuffle projector + Qwen2.5.

Counterpart of long_vita_tpu/models/long_vita.py: tiles are encoded, the CLS
token stripped and the patches projected; the projected rows are scattered
into the token embeddings at ``image_indices`` ([2, N_tiles, T] of (batch,
seq) positions); the decoder then runs as plain Qwen2.

Not ported here: the mesh paths (tile-sharded encode, the chunked merge, the
vocab-parallel embed), remat and the training-only freeze switches (ROADMAP:
port queue, multi-GPU and training).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.models import qwen2
from long_vita_tpu_torch.models.intern_vit import VisionParams, init_vit_params, intern_vit
from long_vita_tpu_torch.models.projector import (
    ProjectorParams,
    init_projector_params,
    project_features,
)
from long_vita_tpu_torch.models.qwen2 import KVCache, Qwen2Params


class LongVITAParams(nn.Module):
    """The VLM's weights: the JAX package's ``{"text", "vision", "projector"}``."""

    def __init__(self, *, text: Qwen2Params, vision: VisionParams, projector: ProjectorParams):
        super().__init__()
        self.text, self.vision, self.projector = text, vision, projector


def encode_images(
    params: LongVITAParams,
    images: torch.Tensor,
    cfg: LongVITAConfig,
    *,
    chunk: int = 0,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """[N_tiles, H, W, 3] -> [N_tiles, image_token_length, lm_hidden].

    ``chunk`` > 0 encodes the tiles in batches of ``chunk`` to bound the
    ViT's activation memory (the JAX package's lax.map over chunks). A last
    partial batch runs as it is: JAX pads it with zero tiles only because
    lax.map needs one shape, and every tile is encoded on its own, so the
    features are the same. attn_impl "short" selects the single-pass ViT
    attention kernel K3 (forward-only callers)."""

    def encode(tiles):
        feats = intern_vit(params.vision, tiles, cfg.vision, attn_impl=attn_impl)
        return project_features(params.projector, feats[:, 1:], cfg)  # strip CLS

    n = images.shape[0]
    if not chunk or n <= chunk:
        return encode(images)
    return torch.cat([encode(images[i : i + chunk]) for i in range(0, n, chunk)], 0)


def merge_image_embeddings(
    inputs_embeds: torch.Tensor,
    image_embeds: torch.Tensor,
    image_indices: torch.Tensor,
) -> torch.Tensor:
    """Scatter projected tile rows into the token embeddings.

    inputs_embeds [B, S, H]; image_embeds [N_tiles, T, H]; image_indices
    [2, N_tiles, T] of (batch, seq) positions. Returns a new tensor; index
    pairs outside [0, B) x [0, S) are dropped."""
    b, s, h = inputs_embeds.shape
    b_idx = image_indices[0].reshape(-1).to(torch.long)
    s_idx = image_indices[1].reshape(-1).to(torch.long)
    keep = (b_idx >= 0) & (b_idx < b) & (s_idx >= 0) & (s_idx < s)
    flat = image_embeds.reshape(-1, h).to(inputs_embeds.dtype)
    out = inputs_embeds.clone()
    out[b_idx[keep], s_idx[keep]] = flat[keep]
    return out


def long_vita_forward(
    params: LongVITAParams,
    input_ids: torch.Tensor,
    position_ids: torch.Tensor,
    cfg: LongVITAConfig,
    *,
    images: Optional[torch.Tensor] = None,
    image_indices: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    segment_ids: Optional[torch.Tensor] = None,
    logit_positions: Optional[torch.Tensor] = None,
    vision_chunk: int = 0,
    attn_impl: str = "auto",
    head: bool = True,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """The full VLM forward on one device.

    logit_positions: optional [B, M] positions whose rows alone reach the
    vocabulary head (the logits-masked head). head=False returns those
    (final-normed) hidden rows instead of logits. -> (logits [B, S or M,
    vocab] f32, or hidden rows; the cache at its new length, or None)."""
    inputs_embeds = qwen2.embed_tokens(params.text, input_ids)
    if images is not None:
        image_embeds = encode_images(
            params, images, cfg, chunk=vision_chunk, attn_impl=attn_impl
        )
        inputs_embeds = merge_image_embeddings(inputs_embeds, image_embeds, image_indices)
    hidden, new_cache = qwen2.qwen2_decoder(
        params.text, inputs_embeds, position_ids, cfg.text,
        kv_cache=kv_cache, segment_ids=segment_ids, attn_impl=attn_impl,
    )
    if logit_positions is not None:
        hidden = torch.take_along_dim(hidden, logit_positions[:, :, None].long(), dim=1)
    return (qwen2.lm_head(params.text, hidden) if head else hidden), new_cache


def init_long_vita_params(
    generator: torch.Generator,
    cfg: LongVITAConfig,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> LongVITAParams:
    """Random decoder, tower and projector (see each module's initializer)."""
    return LongVITAParams(
        text=qwen2.init_qwen2_params(generator, cfg.text, dtype, device),
        vision=init_vit_params(generator, cfg.vision, dtype, device),
        projector=init_projector_params(generator, cfg, dtype, device),
    )
