"""Beam search decoding.

Counterpart of long_vita_tpu/inference/beam_search.py (reference
beam_search_and_post_process, long_vita_megatron/inference/
text_generation/generation.py:283-452 + beam_utils.py:17):
length-penalized log-prob scores, beams that emit the stop token are frozen,
search ends when the worst kept finished beam outscores any possible
continuation.

The prompt is prefilled once through ``engine.prefill`` (K1 or K2 chunks);
its cache is then repeated across the beams (bf16 or int8, with the scales)
and each beam step runs the port's ``qwen2_decoder`` on the engine's text
weights (``engine.text``: dense, int8 or int4). The JAX step is one jitted
function; here it runs eagerly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from long_vita_tpu_torch.models import qwen2
from long_vita_tpu_torch.models.qwen2 import KVCache


@dataclasses.dataclass
class BeamHypothesis:
    token_ids: list[int]
    score: float


def _length_penalty_score(logprob_sum: float, length: int, alpha: float) -> float:
    return logprob_sum / (max(length, 1) ** alpha)


def _rows(cache: KVCache, index: torch.Tensor, length) -> KVCache:
    """The cache with its batch rows taken at ``index`` (a repeat or a
    reorder of the beams)."""

    def take(x):
        return None if x is None else x.index_select(1, index)

    return KVCache(take(cache.k), take(cache.v), length,
                   k_scale=take(cache.k_scale), v_scale=take(cache.v_scale))


def beam_search(
    engine,
    input_ids,
    *,
    images=None,
    image_indices=None,
    beam_size: int = 4,
    max_new_tokens: int = 64,
    length_penalty: float = 1.0,
    num_return: int = 1,
) -> list[BeamHypothesis]:
    """Run beam search from a prompt. Returns hypotheses best-first."""
    text, cfg, dev = engine.text, engine.cfg, engine.device
    eos = engine.eos_id

    cache, last_hidden, true_len = engine.prefill(input_ids, images, image_indices)
    logits = qwen2.lm_head(text, last_hidden)[0].float().cpu().numpy()
    logprobs = logits - (np.log(np.sum(np.exp(logits - logits.max()))) + logits.max())

    top = np.argsort(logprobs)[::-1][:beam_size]
    beams = [([int(t)], float(logprobs[t])) for t in top]
    finished: list[BeamHypothesis] = []

    cache = _rows(cache, torch.zeros(beam_size, dtype=torch.long, device=dev), cache.length)

    pos = true_len
    for _ in range(max_new_tokens - 1):
        tokens = torch.as_tensor([[b[0][-1]] for b in beams], device=dev)
        embeds = qwen2.embed_tokens(text, tokens)
        hidden, cache = qwen2.qwen2_decoder(
            text, embeds, torch.full((len(beams), 1), pos, device=dev), cfg.text,
            kv_cache=cache, parallel=engine.parallel,
        )
        lp = torch.log_softmax(qwen2.lm_head(text, hidden[:, -1]), dim=-1)
        lp = lp.float().cpu().numpy()  # [beams, V]
        pos += 1

        # expand: all (beam, token) continuations
        totals = np.asarray([b[1] for b in beams])[:, None] + lp
        flat = totals.reshape(-1)
        top = np.argsort(flat)[::-1][: beam_size * 2]

        new_beams = []
        reorder = []
        for idx in top:
            b_idx, tok = divmod(int(idx), lp.shape[1])
            seq = beams[b_idx][0] + [tok]
            score = float(flat[idx])
            if tok == eos:
                finished.append(BeamHypothesis(
                    seq[:-1], _length_penalty_score(score, len(seq), length_penalty)
                ))
            elif len(new_beams) < beam_size:
                new_beams.append((seq, score))
                reorder.append(b_idx)
        if not new_beams:
            break
        beams = new_beams
        if reorder != list(range(cache.k.shape[1])):  # an identity keeps the buffers
            cache = _rows(cache, torch.as_tensor(reorder, device=dev), cache.length)

        if len(finished) >= beam_size:
            best_possible = _length_penalty_score(
                max(b[1] for b in beams), pos - true_len + 1, length_penalty
            )
            worst_kept = sorted((h.score for h in finished), reverse=True)[beam_size - 1]
            if worst_kept >= best_possible:
                break

    for seq, score in beams:
        finished.append(BeamHypothesis(
            seq, _length_penalty_score(score, len(seq), length_penalty)
        ))
    finished.sort(key=lambda h: h.score, reverse=True)
    return finished[:num_return]
