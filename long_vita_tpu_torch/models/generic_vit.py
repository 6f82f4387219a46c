"""The generic pre-LN vision transformer: the CLIP, SigLIP and EVA towers.

Counterpart of long_vita_tpu/models/generic_vit.py, the reference's
alternative vision towers (clip_vit_model.py, siglip_vit_model.py,
eva_vit_model.py and their presets): pre-LN GELU ViTs that differ in
geometry and a few switches (a CLS token, an LN on the embeddings, a final
LN, EVA's post-norm branches, layer scales, the activation):

  - CLIP ViT-L/14 (``clip_vit_300m``): 24 layers, 1024 wide, 16 heads of 64;
  - SigLIP so400m (``siglip_so400m``): 27 layers, 1152 wide, 16 heads of 72,
    no CLS token;
  - EVA-4B (``eva_4b``): 63 layers, 1792 wide, 16 heads of 112, post-norm.

Attention goes through ``ops.attention.dot_product_attention`` (non-causal,
impl "auto"): on the card the flash forward K1 and, for a trainable tower,
its backward K4/K5; the ragged head dims 72 and 112 are padded to 128 there
(ops/flash_attention.py), as the JAX package pads them for its Pallas
kernels. Parameters are nn.Modules with dense weights ``[out, in]`` (the JAX
kernels are ``[in, out]``; utils/convert.generic_vit_from_jax transposes),
the stacked ``[L, ...]`` layers a ModuleList; the patch embedding is the
patchify reshape and one GEMM, as in models/intern_vit.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from long_vita_tpu_torch.models.intern_vit import LayerNormParams, _dense, layer_norm
from long_vita_tpu_torch.models.qwen2 import Dense, _frozen
from long_vita_tpu_torch.ops.attention import dot_product_attention

ACTIVATIONS = ("gelu", "gelu_tanh", "quick_gelu")


@dataclasses.dataclass(frozen=True)
class GenericViTConfig:
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    image_size: int
    patch_size: int = 14
    add_class_token: bool = True
    use_layer_scale: bool = False
    pre_layernorm: bool = False  # CLIP: LN on the embeddings before the encoder
    final_layernorm: bool = False
    post_norm: bool = False  # EVA: LN on the branch outputs (eva_vit_model.py:46-60)
    hidden_act: str = "gelu"  # "gelu" | "gelu_tanh" (SigLIP) | "quick_gelu" (CLIP)
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.add_class_token else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def clip_vit_300m(image_size: int = 448) -> GenericViTConfig:
    """OpenAI CLIP ViT-L/14 (the reference's openai_300m): ln_pre kept, ln_post
    dropped (ckpt_converter_clip.py:39,59-62); HF eps 1e-5 and quick_gelu."""
    return GenericViTConfig(1024, 4096, 24, 16, image_size,
                            add_class_token=True, pre_layernorm=True,
                            hidden_act="quick_gelu", layer_norm_eps=1e-5)


def siglip_so400m(image_size: int = 384) -> GenericViTConfig:
    """SigLIP so400m: no CLS token; post_layernorm and the attention-pool head
    dropped (ckpt_converter_siglip.py:83-87); HF's gelu_pytorch_tanh."""
    return GenericViTConfig(1152, 4304, 27, 16, image_size,
                            add_class_token=False, hidden_act="gelu_tanh",
                            layer_norm_eps=1e-6)


def eva_4b(image_size: int = 448) -> GenericViTConfig:
    """EVA-4B (get_vision_model_args_eva_4b): post-norm residual branches,
    no final LN (eva_vit_model.py:146)."""
    return GenericViTConfig(1792, 15360, 63, 16, image_size,
                            add_class_token=True, post_norm=True)


class GenericViTLayer(nn.Module):
    def __init__(self, *, norm1: LayerNormParams, qkv: Dense, proj: Dense,
                 norm2: LayerNormParams, fc1: Dense, fc2: Dense,
                 ls1: Optional[torch.Tensor] = None, ls2: Optional[torch.Tensor] = None):
        super().__init__()
        self.norm1, self.qkv, self.proj = norm1, qkv, proj
        self.norm2, self.fc1, self.fc2 = norm2, fc1, fc2
        self.ls1 = _frozen(ls1) if ls1 is not None else None
        self.ls2 = _frozen(ls2) if ls2 is not None else None


class GenericViTParams(nn.Module):
    """The tower's weights: patch_embed (weight [H, p*p*3]), pos_embed
    [seq_len, H], cls_token [1, 1, H] with a CLS token, pre_norm and
    final_norm where the config has them, and the layers."""

    def __init__(self, *, patch_embed: Dense, pos_embed: torch.Tensor,
                 layers: list[GenericViTLayer], cls_token: Optional[torch.Tensor] = None,
                 pre_norm: Optional[LayerNormParams] = None,
                 final_norm: Optional[LayerNormParams] = None):
        super().__init__()
        self.patch_embed = patch_embed
        self.pos_embed = _frozen(pos_embed)
        self.cls_token = _frozen(cls_token) if cls_token is not None else None
        self.pre_norm, self.final_norm = pre_norm, final_norm
        self.layers = nn.ModuleList(layers)


def activation(name: str):
    if name == "quick_gelu":
        return lambda t: t * torch.sigmoid(1.702 * t)
    if name == "gelu_tanh":
        return lambda t: F.gelu(t, approximate="tanh")
    if name == "gelu":
        return F.gelu  # exact
    raise ValueError(f"unknown activation {name!r}; one of {ACTIVATIONS}")


def generic_vit_layer(layer: GenericViTLayer, x: torch.Tensor, cfg: GenericViTConfig,
                      attn_impl: str = "auto") -> torch.Tensor:
    """One pre-LN layer (post-norm with cfg.post_norm: the branches read the
    raw residual stream and their outputs are normalised before the add)."""
    b, s, h = x.shape
    nh, d, eps = cfg.num_attention_heads, cfg.head_dim, cfg.layer_norm_eps
    act = activation(cfg.hidden_act)
    n1, n2 = layer.norm1, layer.norm2
    y = x if cfg.post_norm else layer_norm(x, n1.scale, n1.bias, eps)
    q, k, v = _dense(layer.qkv, y).reshape(b, s, 3, nh, d).unbind(2)
    attn = dot_product_attention(q, k, v, causal=False, impl=attn_impl)
    attn = _dense(layer.proj, attn.reshape(b, s, h))
    if cfg.post_norm:
        attn = layer_norm(attn, n1.scale, n1.bias, eps)
    if cfg.use_layer_scale:
        attn = attn * layer.ls1
    x = x + attn
    y = x if cfg.post_norm else layer_norm(x, n2.scale, n2.bias, eps)
    y = _dense(layer.fc2, act(_dense(layer.fc1, y)))
    if cfg.post_norm:
        y = layer_norm(y, n2.scale, n2.bias, eps)
    if cfg.use_layer_scale:
        y = y * layer.ls2
    return x + y


def generic_vit(
    params: GenericViTParams,
    pixels: torch.Tensor,
    cfg: GenericViTConfig,
    *,
    remat: bool = False,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """[N, H, W, 3] NHWC pixels -> [N, seq, hidden] (CLS first when present).
    remat: each layer keeps only its input and runs again in the backward
    (the JAX package's jax.checkpoint around the scanned layer)."""
    n, hh, ww, c = pixels.shape
    p = cfg.patch_size
    gh, gw = hh // p, ww // p
    x = pixels.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, gh * gw, p * p * c).to(params.patch_embed.weight.dtype)
    x = _dense(params.patch_embed, x)
    if cfg.add_class_token:
        cls = params.cls_token.to(x.dtype).expand(n, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + params.pos_embed.to(x.dtype)[None]
    eps = cfg.layer_norm_eps
    if cfg.pre_layernorm:
        x = layer_norm(x, params.pre_norm.scale, params.pre_norm.bias, eps)
    for layer in params.layers:
        if remat:
            x = checkpoint(generic_vit_layer, layer, x, cfg, attn_impl, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = generic_vit_layer(layer, x, cfg, attn_impl)
    if cfg.final_layernorm:
        x = layer_norm(x, params.final_norm.scale, params.final_norm.bias, eps)
    return x


def init_generic_vit_params(
    generator: torch.Generator,
    cfg: GenericViTConfig,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GenericViTParams:
    """Random init as the JAX package's (normal * 0.02 kernels and
    embeddings, zero biases, unit norms and layer scales), drawn from
    ``generator`` on ``device`` (the generator's device when None) one matrix
    at a time, so the f32 draws never hold more than one beside the weights
    (EVA-4B is ~8.6 GB in bf16)."""
    device = torch.device(device) if device is not None else generator.device
    h, i, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    def dense(out_f, in_f):
        return Dense(normal(out_f, in_f), full(out_f, 0.0))

    def norm():
        return LayerNormParams(full(h, 1.0), full(h, 0.0))

    ls = cfg.use_layer_scale
    layers = [
        GenericViTLayer(norm1=norm(), qkv=dense(3 * h, h), proj=dense(h, h), norm2=norm(),
                        fc1=dense(i, h), fc2=dense(h, i),
                        ls1=full(h, 1.0) if ls else None, ls2=full(h, 1.0) if ls else None)
        for _ in range(cfg.num_hidden_layers)
    ]
    return GenericViTParams(
        patch_embed=dense(h, p * p * 3),
        pos_embed=normal(cfg.seq_len, h),
        layers=layers,
        cls_token=normal(1, 1, h) if cfg.add_class_token else None,
        pre_norm=norm() if cfg.pre_layernorm else None,
        final_norm=norm() if cfg.final_layernorm else None,
    )
