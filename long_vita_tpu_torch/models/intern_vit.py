"""InternViT-300M-448px vision encoder: parameters as nn.Modules, the forward
as plain functions.

Counterpart of long_vita_tpu/models/intern_vit.py: a patchify reshape and one
GEMM as the patch embedding (NHWC pixels, kernel [p*p*3, H]), a CLS token and
a learned position embedding, then pre-LayerNorm layers with per-channel layer
scales ls1/ls2, non-causal attention with a qkv bias and an exact-GELU MLP.

Differences from the JAX package, of form rather than of numbers: the stacked
``[L, ...]`` layers walked by ``lax.scan`` become a ``ModuleList`` (each layer
optionally under torch.utils.checkpoint), and dense weights are kept as
``[out, in]`` (utils/convert.py transposes). The patch
embedding stays one GEMM: a Conv2d would need its kernel permuted and would
run through cuDNN, in TF32 by default on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from long_vita_tpu_torch.config import VisionConfig
from long_vita_tpu_torch.models.qwen2 import Dense, _frozen
from long_vita_tpu_torch.ops.attention import dot_product_attention


class LayerNormParams(nn.Module):
    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = _frozen(scale)
        self.bias = _frozen(bias)


class VitLayer(nn.Module):
    def __init__(
        self, *, norm1: LayerNormParams, qkv: Dense, proj: Dense,
        ls1: torch.Tensor, norm2: LayerNormParams, fc1: Dense, fc2: Dense,
        ls2: torch.Tensor,
    ):
        super().__init__()
        self.norm1, self.qkv, self.proj = norm1, qkv, proj
        self.norm2, self.fc1, self.fc2 = norm2, fc1, fc2
        self.ls1 = _frozen(ls1)
        self.ls2 = _frozen(ls2)


class VitEmbeddings(nn.Module):
    def __init__(self, *, patch_embed: Dense, cls_token: torch.Tensor, pos_embed: torch.Tensor):
        super().__init__()
        self.patch_embed = patch_embed  # weight [H, p*p*3]
        self.cls_token = _frozen(cls_token)  # [1, 1, H]
        self.pos_embed = _frozen(pos_embed)  # [1 + grid^2, H]


class VisionParams(nn.Module):
    """The tower's weights (the JAX package's ``params["vision"]``)."""

    def __init__(self, *, embeddings: VitEmbeddings, layers: list[VitLayer]):
        super().__init__()
        self.embeddings = embeddings
        self.layers = nn.ModuleList(layers)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm in f32; scale and bias apply in f32 BEFORE the cast back to
    x's dtype (unlike qwen2.rms_norm, which multiplies after the cast)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _dense(entry: Dense, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel + bias, the bias added in x's dtype after the product."""
    out = F.linear(x, entry.weight)
    return out + entry.bias if entry.bias is not None else out


def patch_embed(entry: Dense, pixels: torch.Tensor, cfg: VisionConfig):
    """[N, H, W, 3] NHWC -> ([N, grid*grid, hidden], (gh, gw)) by a patchify
    reshape and one GEMM."""
    n, h, w, c = pixels.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    x = pixels.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, gh * gw, p * p * c).to(entry.weight.dtype)
    return _dense(entry, x), (gh, gw)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 (jax.image's CUBIC)."""
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def cubic_resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_in, n_out] f32: the weights jax.image.resize(method="cubic",
    antialias=True) gives one axis (jax.image.scale_and_translate's
    compute_weight_mat, translation 0): half-pixel centres; when the axis
    shrinks the kernel widens by the inverse scale (antialias); each output
    sample's weights are divided by their sum (so taps past the edge drop
    out), and a sample that lies outside the input gets none."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _interp_pos_embed(pos: torch.Tensor, src_grid: int, dst: tuple[int, int]):
    """Resample the learned [src*src, H] patch position embedding to the
    (gh, gw) patch grid of a tile of another size, as the JAX package does
    with jax.image.resize(method="cubic") in f32: Keys' cubic (a = -0.5,
    half-pixel centres), antialiased when the grid shrinks, one separable
    weight matrix per axis that changes size (cubic_resize_weights).
    F.interpolate(mode="bicubic") is another function (a = -0.75, clamped
    edges, no antialias)."""
    gh, gw = dst
    if (gh, gw) == (src_grid, src_grid):
        return pos
    grid = pos.float().reshape(src_grid, src_grid, pos.shape[-1])
    if gh != src_grid:
        grid = torch.einsum("ijh,ia->ajh", grid, cubic_resize_weights(src_grid, gh, pos.device))
    if gw != src_grid:
        grid = torch.einsum("ajh,jb->abh", grid, cubic_resize_weights(src_grid, gw, pos.device))
    return grid.reshape(gh * gw, -1).to(pos.dtype)


def vit_embeddings(emb: VitEmbeddings, pixels: torch.Tensor, cfg: VisionConfig):
    """-> [N, 1 + gh*gw, hidden], CLS prepended and the position embedding
    added."""
    x, (gh, gw) = patch_embed(emb.patch_embed, pixels, cfg)
    n = x.shape[0]
    cls = emb.cls_token.to(x.dtype).expand(n, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    pos = emb.pos_embed
    full_pos = torch.cat([pos[:1], _interp_pos_embed(pos[1:], cfg.grid, (gh, gw))], 0)
    return x + full_pos.to(x.dtype)[None]


def vit_layer(layer: VitLayer, x: torch.Tensor, cfg: VisionConfig, attn_impl: str):
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_eps

    y = layer_norm(x, layer.norm1.scale, layer.norm1.bias, eps)
    qkv = _dense(layer.qkv, y).reshape(b, s, 3, nh, d)
    q, k, v = qkv.unbind(2)
    attn = dot_product_attention(q, k, v, causal=False, impl=attn_impl)
    x = x + _dense(layer.proj, attn.reshape(b, s, h)) * layer.ls1

    y = layer_norm(x, layer.norm2.scale, layer.norm2.bias, eps)
    y = _dense(layer.fc2, F.gelu(_dense(layer.fc1, y)))  # exact GELU
    return x + y * layer.ls2


def intern_vit(
    params: VisionParams,
    pixels: torch.Tensor,
    cfg: VisionConfig,
    *,
    attn_impl: str = "auto",
    remat: bool = False,
) -> torch.Tensor:
    """Encode tiles: [N, H, W, 3] -> [N, 1 + gh*gw, hidden] (CLS included).
    remat: each layer keeps only its input for the backward and runs again
    there (the JAX package's per-layer jax.checkpoint, :113-114)."""
    x = vit_embeddings(params.embeddings, pixels, cfg)
    for layer in params.layers:
        if remat:
            x = checkpoint(vit_layer, layer, x, cfg, attn_impl, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = vit_layer(layer, x, cfg, attn_impl)
    return x


def init_vit_params(
    generator: torch.Generator,
    cfg: VisionConfig,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> VisionParams:
    """Random init as the JAX package's (normal * 0.02 kernels and embeddings,
    zero biases, unit norms, layer scales at initializer_factor), drawn from
    ``generator`` on ``device`` (the generator's device when None)."""
    device = torch.device(device) if device is not None else generator.device
    h, i, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    def dense(out_f, in_f, bias=True):
        return Dense(normal(out_f, in_f), full(out_f, 0.0) if bias else None)

    def norm():
        return LayerNormParams(full(h, 1.0), full(h, 0.0))

    layers = [
        VitLayer(
            norm1=norm(), qkv=dense(3 * h, h), proj=dense(h, h),
            ls1=full(h, cfg.initializer_factor), norm2=norm(),
            fc1=dense(i, h), fc2=dense(h, i), ls2=full(h, cfg.initializer_factor),
        )
        for _ in range(cfg.num_hidden_layers)
    ]
    emb = VitEmbeddings(
        patch_embed=dense(h, p * p * cfg.num_channels),
        cls_token=normal(1, 1, h),
        pos_embed=normal(cfg.num_patches + 1, h),
    )
    return VisionParams(embeddings=emb, layers=layers)
