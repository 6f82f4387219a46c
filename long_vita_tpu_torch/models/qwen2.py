"""Qwen2.5 decoder: parameters as nn.Modules, the forward as plain functions.

Counterpart of long_vita_tpu/models/qwen2.py (text path, dense, one device).
Architecture: RMSNorm (eps 1e-6), GQA attention with q/k/v bias and
rotate-half RoPE, SwiGLU MLP, untied lm_head.

Differences from the JAX package, all of form rather than of numbers:
  - the stacked ``[L, ...]`` parameter pytree scanned by ``lax.scan`` becomes
    a ``ModuleList`` of ``DecoderLayer``s walked by a Python loop, each layer
    optionally under torch.utils.checkpoint (remat);
  - parameters are created with requires_grad=False; training turns it on
    for what it differentiates (utils/convert.set_requires_grad);
  - dense weights are kept in ``nn.Linear`` orientation ``[out, in]`` (the
    JAX kernels are ``[in, out]``; utils/convert.py transposes);
  - the KV cache is a pair of preallocated ``[L, B, Smax, Hkv, D]`` buffers
    (int8 codes plus ``[L, B, Smax, Hkv, 1]`` f32 scales when quantized)
    written in place, where JAX threads a donated scan carry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from long_vita_tpu_torch.config import TextConfig
from long_vita_tpu_torch.ops._target import on_cuda
from long_vita_tpu_torch.ops.attention import (
    dot_product_attention,
    quant_prefill_attention,
    xla_attention_quant,
)
from long_vita_tpu_torch.ops.rope import apply_rope, rope_cos_sin

CacheLen = Union[int, torch.Tensor]


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """One projection: ``weight`` [out, in] and an optional ``bias`` [out]."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = _frozen(weight)
        self.bias = _frozen(bias) if bias is not None else None


class DecoderLayer(nn.Module):
    def __init__(
        self, *, input_norm, post_attn_norm, q_proj: Dense, k_proj: Dense,
        v_proj: Dense, o_proj: Dense, gate_proj: Dense, up_proj: Dense,
        down_proj: Dense,
    ):
        super().__init__()
        self.input_norm = _frozen(input_norm)
        self.post_attn_norm = _frozen(post_attn_norm)
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = q_proj, k_proj, v_proj, o_proj
        self.gate_proj, self.up_proj, self.down_proj = gate_proj, up_proj, down_proj


class Qwen2Params(nn.Module):
    """The text decoder's weights (the JAX package's ``params["text"]``)."""

    def __init__(
        self, *, embed: torch.Tensor, layers: list[DecoderLayer],
        final_norm: torch.Tensor, lm_head: Dense,
    ):
        super().__init__()
        self.embed = _frozen(embed)  # [V, H]
        self.layers = nn.ModuleList(layers)
        self.final_norm = _frozen(final_norm)
        self.lm_head = lm_head  # weight [V, H]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 variance; the weight multiplies the normalised x
    AFTER it is cast back to x's dtype (HF Qwen2RMSNorm numerics)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return weight * xf.to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """Preallocated cache: k/v are [L, B, Smax, Hkv, D], written in place.

    length: the number of valid positions — a Python int when it is
    batch-uniform, or a [B] integer tensor (ragged batched serving: each
    row's tokens stay packed from slot 0, writes land at each row's own
    frontier, and the causal mask hides what lies beyond it).

    An int8 cache (``zeros(..., quantize=True)``) stores int8 codes in k/v
    and one f32 scale per (token, kv head) in k_scale/v_scale
    [L, B, Smax, Hkv, 1]: about half the bytes per token of a bf16 cache."""

    k: torch.Tensor
    v: torch.Tensor
    length: CacheLen
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def zeros(
        cls, cfg: TextConfig, batch: int, max_len: int,
        dtype: torch.dtype = torch.bfloat16, device=None,
        quantize: bool = False,
    ) -> "KVCache":
        shape = (
            cfg.num_hidden_layers, batch, max_len,
            cfg.num_key_value_heads, cfg.head_dim,
        )
        if quantize:
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                length=0,
                k_scale=torch.zeros(shape[:-1] + (1,), device=device),
                v_scale=torch.zeros(shape[:-1] + (1,), device=device),
            )
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=0,
        )


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: [..., D] -> (int8 codes, f32 scale
    [..., 1]). scale = max(amax, 1e-8) / 127; codes round half to even and
    clip to +-127, bit for bit the JAX package's quantize_kv."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale


def _proj(entry: Dense, x: torch.Tensor) -> torch.Tensor:
    """A dense projection without its bias (callers add it in the param
    dtype after the product, as the JAX package does)."""
    return F.linear(x, entry.weight)


def _row_write(buf: torch.Tensor, new: torch.Tensor, cache_len: torch.Tensor) -> None:
    """buf [B, Smax, ...] <- new [B, s, ...] at per-row offsets cache_len [B].

    Positions past the buffer are DROPPED (the JAX scatter's mode="drop"):
    rows past capacity keep stepping in a ragged batch and their writes
    must not land anywhere."""
    b, s = new.shape[:2]
    idx = cache_len.to(torch.long)[:, None] + torch.arange(s, device=buf.device)[None]
    keep = (idx >= 0) & (idx < buf.shape[1])
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    buf[rows[keep], idx[keep]] = new[keep]


def _attention_block(
    layer: DecoderLayer,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: TextConfig,
    cache_kv: Optional[tuple],
    cache_len: Optional[CacheLen],
    position_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    attn_impl: str,
) -> torch.Tensor:
    b, s, _ = x.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    q = _proj(layer.q_proj, x) + layer.q_proj.bias
    k = _proj(layer.k_proj, x) + layer.k_proj.bias
    v = _proj(layer.v_proj, x) + layer.v_proj.bias
    q = q.reshape(b, s, hq, d)
    k = k.reshape(b, s, hkv, d)
    v = v.reshape(b, s, hkv, d)
    q, k = apply_rope(q, k, cos, sin)

    if cache_kv is not None:
        # views [B, Smax, Hkv, D] (scales [B, Smax, Hkv, 1]) of layer_idx
        ck_full, cv_full, ks_full, vs_full, layer_idx = cache_kv
        quant = ks_full is not None
        bufs = [ck_full[layer_idx], cv_full[layer_idx]]
        if quant:
            k_w, k_sc = quantize_kv(k)
            v_w, v_sc = quantize_kv(v)
            bufs += [ks_full[layer_idx], vs_full[layer_idx]]
            new = [k_w, v_w, k_sc, v_sc]
        else:
            new = [k.to(bufs[0].dtype), v.to(bufs[1].dtype)]
        if torch.is_tensor(cache_len):
            for buf, x_new in zip(bufs, new):
                _row_write(buf, x_new, cache_len)
            kv_valid = (cache_len + s).expand(b)
        else:
            # dynamic_update_slice semantics: the start clamps so the write fits
            start = min(max(cache_len, 0), bufs[0].shape[1] - s)
            for buf, x_new in zip(bufs, new):
                buf[:, start : start + s] = x_new
            kv_valid = torch.full((b,), cache_len + s, dtype=torch.long, device=x.device)
            # the frontier is known on the host: slots past it are masked in
            # any case, so attention is handed only the written prefix
            bufs = [buf[:, : cache_len + s] for buf in bufs]
        skv = bufs[0].shape[1]
        kv_positions = torch.arange(skv, device=x.device)[None].expand(b, skv)
        if quant:
            ck, cv, ks, vs = bufs
            if s > 1:
                out = quant_prefill_attention(
                    q, ck, ks, cv, vs, q_positions=position_ids,
                    kv_valid_len=kv_valid, impl=attn_impl,
                )
            else:
                out = xla_attention_quant(
                    q, ck, ks, cv, vs, q_positions=position_ids,
                    kv_positions=kv_positions, kv_valid_len=kv_valid,
                )
        else:
            out = dot_product_attention(
                q, bufs[0], bufs[1],
                causal=True,
                q_positions=position_ids,
                kv_positions=kv_positions,
                kv_valid_len=kv_valid,
                impl=attn_impl,
            )
    else:
        out = dot_product_attention(
            q, k, v,
            causal=True,
            q_positions=position_ids,
            kv_positions=position_ids,
            q_segment_ids=segment_ids,
            kv_segment_ids=segment_ids,
            impl=attn_impl,
        )
    return _proj(layer.o_proj, out.reshape(b, s, hq * d))


def _mlp_block(layer: DecoderLayer, x: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU."""
    gate = _proj(layer.gate_proj, x)
    up = _proj(layer.up_proj, x)
    return _proj(layer.down_proj, F.silu(gate) * up)


def decoder_layer(
    layer: DecoderLayer,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: TextConfig,
    cache_kv,
    cache_len,
    position_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    attn_impl: str,
) -> torch.Tensor:
    x = x + _attention_block(
        layer, rms_norm(x, layer.input_norm, cfg.rms_norm_eps), cos, sin, cfg,
        cache_kv, cache_len, position_ids, segment_ids, attn_impl,
    )
    return x + _mlp_block(layer, rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps))


def check_remat(remat) -> bool:
    """The JAX package's remat levels (qwen2._remat_policy :776): True or
    "full" recompute each layer in the backward (jax.checkpoint with
    nothing_saveable), False or None keep everything. -> whether to
    recompute. The selective levels raise until they are ported."""
    if remat in (True, "full"):
        return True
    if remat in (False, None):
        return False
    if remat in ("dots", "flash", "vit"):
        raise NotImplementedError(
            f"remat={remat!r} is not ported; the port recomputes whole layers "
            "(remat=True) (ROADMAP: port queue, training: selective remat)"
        )
    raise ValueError(f"unknown remat level {remat!r}")


def qwen2_decoder(
    params: Qwen2Params,
    inputs_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    cfg: TextConfig,
    *,
    kv_cache: Optional[KVCache] = None,
    segment_ids: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat: Union[bool, str] = False,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder. inputs_embeds [B, S, H]; position_ids [B|1, S].

    remat (True / "full"): without a cache, each layer keeps only its input
    for the backward and runs again there (torch.utils.checkpoint, the
    counterpart of jax.checkpoint with nothing_saveable).

    -> (final_norm(hidden) [B, S, H], the cache at length + S, or None).
    The cache's buffers are written in place; the returned KVCache shares
    them."""
    recompute = check_remat(remat) and kv_cache is None
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
    x = inputs_embeds
    cache_len = kv_cache.length if kv_cache is not None else None
    for i, layer in enumerate(params.layers):
        cache_kv = None
        if kv_cache is not None:
            cache_kv = (kv_cache.k, kv_cache.v, kv_cache.k_scale, kv_cache.v_scale, i)
        args = (layer, x, cos, sin, cfg, cache_kv, cache_len, position_ids,
                segment_ids, attn_impl)
        if recompute:
            x = checkpoint(decoder_layer, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = decoder_layer(*args)
    new_cache = None
    if kv_cache is not None:
        new_cache = dataclasses.replace(
            kv_cache, length=kv_cache.length + inputs_embeds.shape[1]
        )
    return rms_norm(x, params.final_norm, cfg.rms_norm_eps), new_cache


def embed_tokens(params: Qwen2Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Row lookup. Ids past the table clamp to its last row, as the JAX
    gather does (a finished row of a ragged batch feeds back eos, which
    lies past the vocabulary of the tiny test configuration)."""
    return F.embedding(input_ids.clamp(max=params.embed.shape[0] - 1), params.embed)


def lm_head(params: Qwen2Params, hidden: torch.Tensor) -> torch.Tensor:
    """Vocab logits in f32, as the JAX head's preferred_element_type=f32.

    A bf16 product rounded to bf16 before the argmax would be a different
    result, so: on CUDA the bf16 GEMM writes f32 directly (torch.mm with
    out_dtype=float32, f32 accumulation in cuBLAS; _F32Logits gives it a
    backward); elsewhere the operands are widened to f32 first, which is
    exact for bf16."""
    w = params.lm_head.weight  # [V, H]
    if w.dtype != torch.float32 and on_cuda(hidden, w):
        out = _F32Logits.apply(hidden.reshape(-1, hidden.shape[-1]), w)
        return out.reshape(*hidden.shape[:-1], w.shape[0])
    return F.linear(hidden.float(), w.float())


class _F32Logits(torch.autograd.Function):
    """flat [N, H] x weight [V, H] -> f32 logits [N, V] from one bf16 GEMM.
    torch.mm with out_dtype has no derivative, so the backward is written
    out, at the precision of JAX's transpose rule (an f32 product of the f32
    logit gradient and the bf16 operand, cast once to the operand's dtype):
    the gradient is split into two bf16 halves, hi = bf16(g) and lo =
    bf16(g - hi), which carry 16 of its 24 mantissa bits, and each product
    is the f32 sum of two bf16 GEMMs."""

    @staticmethod
    def forward(ctx, flat, w):
        ctx.save_for_backward(flat, w)
        return torch.mm(flat, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        flat, w = ctx.saved_tensors
        hi = g.to(w.dtype)
        lo = (g - hi.float()).to(w.dtype)

        def product(a_hi, a_lo, b, dtype):
            return (torch.mm(a_hi, b, out_dtype=torch.float32)
                    + torch.mm(a_lo, b, out_dtype=torch.float32)).to(dtype)

        d_flat = product(hi, lo, w, flat.dtype) if ctx.needs_input_grad[0] else None
        d_w = product(hi.t(), lo.t(), flat, w.dtype) if ctx.needs_input_grad[1] else None
        return d_flat, d_w


def init_qwen2_params(
    generator: torch.Generator,
    cfg: TextConfig,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Qwen2Params:
    """Random init as the JAX package's (normal * 0.02 weights, zero biases,
    unit norms), drawn from ``generator`` on ``device`` (the generator's
    device when None). One layer at a time, so the f32 draws never hold
    more than one matrix beside the bf16 weights."""
    if cfg.num_experts > 0 or cfg.lora_r > 0:
        raise NotImplementedError(
            "MoE and LoRA layers are ported later (ROADMAP: port queue, the rest)"
        )
    device = torch.device(device) if device is not None else generator.device
    h, i = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def dense(out_f, in_f, bias=False):
        w = torch.randn((out_f, in_f), generator=generator, device=device) * 0.02
        b = torch.zeros(out_f, dtype=dtype, device=device) if bias else None
        return Dense(w.to(dtype), b)

    def ones():
        return torch.ones(h, dtype=dtype, device=device)

    layers = [
        DecoderLayer(
            input_norm=ones(),
            post_attn_norm=ones(),
            q_proj=dense(hq * d, h, bias=True),
            k_proj=dense(hkv * d, h, bias=True),
            v_proj=dense(hkv * d, h, bias=True),
            o_proj=dense(h, hq * d),
            gate_proj=dense(i, h),
            up_proj=dense(i, h),
            down_proj=dense(h, i),
        )
        for _ in range(cfg.num_hidden_layers)
    ]
    embed = torch.randn((cfg.vocab_size, h), generator=generator, device=device) * 0.02
    return Qwen2Params(
        embed=embed.to(dtype),
        layers=layers,
        final_norm=ones(),
        lm_head=dense(cfg.vocab_size, h),
    )
