"""Token sampling: greedy / temperature / top-k / top-p.

Counterpart of long_vita_tpu/inference/sampler.py. ``SamplingParams`` is a
copy of the JAX package's (that module imports JAX). Randomness comes from a
``torch.Generator``; it draws other bits than ``jax.random`` from the same
seed, so only greedy decoding is token-identical across the two packages.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 0.0  # 0 = disabled
    greedy: bool = True
    max_new_tokens: int = 256
    stop_token_ids: tuple = ()  # extra stop tokens (stop_on_eol etc.)
    return_logprobs: bool = False


def truncate_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature, then top-k, then nucleus truncation: the logits the
    categorical draw sees, -inf where a token is cut."""
    if params.temperature != 1.0:
        logits = logits / params.temperature
    if params.top_k:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if params.top_p:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative prob exceeds top_p (always >= 1)
        cutoff_mask = cum - probs > params.top_p
        cutoff_logit = torch.where(cutoff_mask, torch.inf, sorted_logits).amin(
            dim=-1, keepdim=True
        )
        logits = logits.masked_fill(logits < cutoff_logit, -torch.inf)
    return logits


def sample(
    logits: torch.Tensor,  # [B, V] f32
    generator: torch.Generator,
    params: SamplingParams,
) -> torch.Tensor:
    """-> [B] int64 next tokens."""
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(truncate_logits(logits, params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
