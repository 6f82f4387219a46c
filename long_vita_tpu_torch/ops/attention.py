"""Attention dispatch: the hand-written kernels on CUDA for prefill and the ViT,
plain grouped attention for decode and on the CPU.

Counterpart of long_vita_tpu/ops/attention.py. Masks come from positions,
segment ids and kv_valid_len with the finite NEG_INF = -2^30; nothing
quadratic is built outside the attention call itself. GQA stays grouped: q
is reshaped [B, Sq, Hkv, G, D] and K/V are never repeated.

An int8 KV cache (models/qwen2.py KVCache with scales) is read by
xla_attention_quant / decode_attention (one decode row) and
quant_prefill_attention (a prefill chunk; the int8 flash kernel K2 on CUDA).
Their bf16 casts follow the JAX functions even when the cache's companion
dtype is f32, so the CPU comparison in f32 holds them to the same numbers.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from long_vita_tpu_torch.ops._target import on_cuda

NEG_INF = -(2.0**30)  # large-but-finite: keeps masked softmax NaN-free in f32


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention (long_vita_tpu/ops/attention.py:29). f32 logits and
    softmax, p cast to v's dtype before P.V, output in q.dtype.

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D]. Positions default to arange;
    kv_valid_len: [B] valid cache slots (masks the tail). A bf16 operand is
    widened to f32 before each product, which is exact for the products and
    gives the f32 accumulation the JAX einsum's preferred_element_type asks
    for."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    dev = q.device

    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (
        1.0 / math.sqrt(d)
    )  # [B, Hkv, G, Sq, Skv]

    mask = None

    def _and(m, new):
        return new if m is None else m & new

    if causal:
        qpos = q_positions if q_positions is not None else torch.arange(sq, device=dev)[None]
        kpos = kv_positions if kv_positions is not None else torch.arange(skv, device=dev)[None]
        mask = _and(mask, kpos[:, None, :] <= qpos[:, :, None])  # [B|1, Sq, Skv]
    if q_segment_ids is not None:
        mask = _and(mask, q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    if kv_valid_len is not None:
        mask = _and(
            mask, torch.arange(skv, device=dev)[None, None, :] < kv_valid_len[:, None, None]
        )
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None], NEG_INF)

    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _scale_rows(scale: torch.Tensor) -> torch.Tensor:
    """Per-(token, head) scales [B, Skv, Hkv, 1] -> [B, Hkv, Skv] f32."""
    return scale[..., 0].permute(0, 2, 1).float()


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_valid_len: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token cache attention as two batched products per (batch row,
    kv head) (long_vita_tpu/ops/attention.py:103). q [B, 1, Hq, D]; k, v
    [B, Skv, Hkv, D], bf16/f32 or int8 codes with scales [B, Skv, Hkv, 1].
    q_positions [B, 1]; kv_valid_len [B].

    With scales: q and the codes are cast to bf16 before the first product,
    the k scale multiplies the f32 logits after it, and probs * v_scale is
    cast to bf16 before the second (the JAX dequant-fused contract). Without:
    the products follow the cache dtype, with f32 accumulation."""
    b, sq, hq, d = q.shape
    if sq != 1:
        raise ValueError(f"decode_attention is the Sq == 1 path, got Sq = {sq}")
    skv, hkv = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(b, hkv, hq // hkv, d)
    scale = 1.0 / math.sqrt(d)
    bf = torch.bfloat16
    if k_scale is not None:
        logits = torch.einsum("bhgd,bshd->bhgs", qg.to(bf).float(), k.to(bf).float())
        logits = logits * _scale_rows(k_scale)[:, :, None, :] * scale
    else:
        logits = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) * scale
    kpos = torch.arange(skv, device=q.device)[None]
    mask = (kpos <= q_positions[:, :1]) & (kpos < kv_valid_len[:, None])  # [B, Skv]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * _scale_rows(v_scale)[:, :, None, :]
    pdt = bf if v_scale is not None else v.dtype
    out = torch.einsum(
        "bhgs,bshd->bhgd", probs.to(pdt).float(), v.to(pdt).float()
    )
    return out.reshape(b, 1, hq, d).to(q.dtype)


def xla_attention_quant(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention against an int8 KV cache, the dequantisation folded
    into the products (long_vita_tpu/ops/attention.py:164): bf16 q and codes,
    logits * k_scale * 1/sqrt(D) after the first product, (probs * v_scale)
    cast to bf16 before the second. q [B, Sq, Hq, D]; codes [B, Skv, Hkv, D]
    int8; scales [B, Skv, Hkv, 1] f32. The bf16 casts hold for any q dtype,
    as in JAX."""
    b, sq, hq, d = q.shape
    skv, hkv = k_q.shape[1], k_q.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    dev, bf = q.device, torch.bfloat16
    logits = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.to(bf).float(), k_q.to(bf).float()
    )
    logits = logits * _scale_rows(k_scale)[:, :, None, None, :] * (1.0 / math.sqrt(d))
    qpos = q_positions if q_positions is not None else torch.arange(sq, device=dev)[None]
    kpos = kv_positions if kv_positions is not None else torch.arange(skv, device=dev)[None]
    mask = kpos[:, None, :] <= qpos[:, :, None]  # [B|1, Sq, Skv]
    if kv_valid_len is not None:
        mask = mask & (
            torch.arange(skv, device=dev)[None, None, :] < kv_valid_len[:, None, None]
        )
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs_scaled = (probs * _scale_rows(v_scale)[:, :, None, None, :]).to(bf)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs_scaled.float(), v_q.to(bf).float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def quant_prefill_attention(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_valid_len: torch.Tensor,
    impl: str = "auto",
) -> torch.Tensor:
    """Chunked-prefill attention against an int8 KV cache
    (long_vita_tpu/ops/attention.py:218). On CUDA with a chunk of 128 rows or
    more: the int8 flash kernel K2 (flash_attention_quant), which widens the
    cache tile by tile and never holds a dequantised cache. Elsewhere (the
    CPU, small chunks, or impl="xla"): dequantise to q's dtype and take the
    plain xla_attention, as the JAX package does off the TPU."""
    if impl != "xla" and on_cuda(q, k_q) and q.shape[1] >= 128:
        from long_vita_tpu_torch.ops.flash_attention import flash_attention_quant

        return flash_attention_quant(
            q, k_q, k_scale, v_q, v_scale,
            q_offset=q_positions[0, 0], kv_valid_len=kv_valid_len[0],
        )
    b, skv = q.shape[0], k_q.shape[1]
    k = (k_q.float() * k_scale).to(q.dtype)
    v = (v_q.float() * v_scale).to(q.dtype)
    return xla_attention(
        q, k, v, causal=True,
        q_positions=q_positions,
        kv_positions=torch.arange(skv, device=q.device)[None].expand(b, skv),
        kv_valid_len=kv_valid_len,
    )


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Main attention entry point (long_vita_tpu/ops/attention.py:254).
    Shapes as xla_attention; impl "auto" | "flash" | "short" | "xla".

    "short" is the ViT's single-pass kernel K3 (short_attention), chosen
    explicitly by forward-only callers (the serving encode): on CUDA, for
    non-causal attention without segments or kv_valid_len over one sequence
    of at most 2048 tokens; any other call routes as "auto" does."""
    if impl == "auto":
        impl = _pick_impl(q, k, causal, kv_valid_len)
    if impl == "short":
        if (
            on_cuda(q, k, v)
            and not causal
            and q_segment_ids is None
            and kv_valid_len is None
            and q.shape[1] == k.shape[1] <= 2048
        ):
            from long_vita_tpu_torch.ops.flash_attention import short_attention

            return short_attention(q, k, v)
        impl = _pick_impl(q, k, causal, kv_valid_len)
    if impl == "flash":
        from long_vita_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(
            q, k, v,
            causal=causal,
            q_positions=q_positions,
            kv_positions=kv_positions,
            q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids,
            kv_valid_len=kv_valid_len[0] if kv_valid_len is not None else None,
        )
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    return xla_attention(
        q, k, v,
        causal=causal,
        q_positions=q_positions,
        kv_positions=kv_positions,
        q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids,
        kv_valid_len=kv_valid_len,
    )


def _pick_impl(q, k, causal, kv_valid_len) -> str:
    """The JAX routing with "on TPU" read as "on CUDA": prefill-sized
    attention takes the flash kernel; decode and tiny shapes (Sq or
    Skv < 128) take xla_attention, which is bandwidth-bound there."""
    sq, skv = q.shape[1], k.shape[1]
    if not on_cuda(q, k):
        return "xla"
    if sq < 128 or skv < 128:
        return "xla"
    return "flash"
