"""Attention dispatch: the hand-written flash kernel on CUDA for prefill, plain
grouped attention for decode and on the CPU.

Counterpart of long_vita_tpu/ops/attention.py. Masks come from positions,
segment ids and kv_valid_len with the finite NEG_INF = -2^30; nothing
quadratic is built outside the attention call itself. GQA stays grouped: q
is reshaped [B, Sq, Hkv, G, D] and K/V are never repeated.
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
    Shapes as xla_attention; impl "auto" | "flash" | "xla"."""
    if impl == "short":
        raise NotImplementedError(
            "impl='short' is the ViT kernel K3 (_short_nc_kernel), ported with "
            "the vision front end (ROADMAP: port queue, vision with K3)"
        )
    if impl == "auto":
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
