"""Chunk-pair attention for ring attention: forward with lse, backward from
the global statistics, and the lse-weighted merge.

Counterpart of long_vita_tpu/ops/attention_pair.py: ``pair_attn_fwd``
(:54), ``pair_attn_bwd`` (:85), ``merge_partials`` (:122). Ring attention
decomposes global causal attention into (q chunk, kv chunk) pairs, each a
causal diagonal or a full attend. On CUDA the forward is K1
(``flash_attention`` with return_lse; segment ids passed through) and the
backward K4 or K5 (``flash_attention_bwd`` given the global lse and delta,
the JAX ``_bwd_pair_pallas`` :1105, K4 or K5 by ``bwd_uses_fused``). On the
CPU both take the kernels' plain versions.

A q row that sees no key of the pair (past the diagonal, or no shared
segment) gets o = 0 and lse = -2^30, the identity of merge_partials; the
kernels skip such tiles by their segment ranges, which is the work the
JAX ``_guarded_pair_fwd`` saves by its lax.cond (ring_attention.py:195).
"""
from __future__ import annotations

from typing import Optional

import torch

from long_vita_tpu_torch.ops._target import on_cuda
from long_vita_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_reference,
)


def pair_attn_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, Cq, Hq, D], k/v [B, Ck, Hkv, D] -> (o [B, Cq, Hq, D] in q's
    dtype, lse [B, Hq, Cq] f32). Not differentiable (the ring's backward
    calls pair_attn_bwd)."""
    if on_cuda(q, k, v, q_segment_ids, kv_segment_ids):
        with torch.no_grad():
            return flash_attention(
                q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                kv_segment_ids=kv_segment_ids, return_lse=True,
            )
    return flash_attention_reference(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
    )


def pair_attn_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pair's share (dq, dk, dv) of the gradient, exact because lse
    [B, Hq, Cq] and delta = rowsum(do * o_final) [B, Hq, Cq] are the global
    ones. -> gradients in the inputs' dtypes."""
    return flash_attention_bwd(
        q, k, v, None, lse, do, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, delta=delta,
    )


def merge_partials(o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor,
                   lse2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two attention partials, softmax-weighted by their lse: the
    weights and the sum in f32, o back in o1's dtype (JAX :122)."""
    lse = torch.logaddexp(lse1, lse2)  # [B, H, Cq]
    w1 = torch.exp(lse1 - lse).transpose(1, 2)[..., None]  # [B, Cq, H, 1]
    w2 = torch.exp(lse2 - lse).transpose(1, 2)[..., None]
    o = o1.float() * w1 + o2.float() * w2
    return o.to(o1.dtype), lse
