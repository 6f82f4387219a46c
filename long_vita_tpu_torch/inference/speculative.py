"""Prompt-lookup speculative decoding (lossless, greedy).

Counterpart of long_vita_tpu/inference/speculative.py. A verify step feeds k
tokens (the last emitted one and up to k - 1 drafts) through the decoder at
once against the cache and takes the model's greedy token after each; drafts
are kept while they equal it, and the token after the last kept draft is
emitted too. The stream equals plain greedy decode token for token (on the
CPU in f32; on the card the k-row attention products may sum in another
order than the one-row decode's). Drafts come from the prompt itself: the
tokens that followed the most recent earlier occurrence of the history's
trailing n-gram. No tokenizer is involved: everything is token ids.

Cache discipline: a verify step writes k rows at the frontier; rejected rows
lie past the new frontier, are masked, and are overwritten by the next step.
Every emitted token except the last (the bonus) has a valid kv row, the
frontier rule engine.generate's prefix-cache put relies on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view


def draft_tokens(history: np.ndarray, k: int, ngram_max: int = 3) -> np.ndarray:
    """Up to k continuation tokens by longest-suffix n-gram lookup: the
    tokens after the most recent earlier occurrence of the history's
    trailing n-gram (n = ngram_max .. 1); empty when none recurs."""
    h = np.asarray(history, np.int32).reshape(-1)
    for n in range(min(ngram_max, len(h) - 1), 0, -1):
        pat = h[-n:]
        windows = sliding_window_view(h[:-1], n)
        hits = np.nonzero((windows == pat).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + n
            cont = h[start:start + k]
            if cont.size:
                return cont.astype(np.int32)
    return np.empty(0, np.int32)


def speculative_decode(engine, history, token: int, pos: int, cache, budget: int,
                       stop_set: set, k: int):
    """Greedy-decode up to ``budget`` tokens with k-token verify steps.

    history: prompt ids + emitted tokens (the lookup corpus); token: the last
    emitted token, not yet fed; pos: its position (the cache length). ->
    (tokens, logprobs, cache), as the plain decode path: the tokens may end
    with a stop token, which the caller cuts."""
    slots = engine.cache_slots(cache)
    hist = np.asarray(history, np.int32).reshape(-1)
    out: list[int] = []
    lps: list[float] = []
    hit_stop = False
    while budget > 0 and pos + k <= slots and not hit_stop:
        drafts = draft_tokens(hist, k - 1)
        step = np.zeros(k, np.int64)
        step[0] = token
        step[1:1 + len(drafts)] = drafts
        outs, olps, cache = engine._verify_step(
            torch.as_tensor(step[None], device=engine.device), pos, cache
        )
        engine._spec_steps += 1
        outs = outs[0].cpu().numpy()
        olps = olps[0].cpu().numpy()
        j = 0  # drafts accepted while they equal the model's own argmax
        while j < len(drafts) and step[j + 1] == outs[j]:
            j += 1
        pos += j + 1  # kv rows written and valid: step[0 .. j]
        cache = dataclasses.replace(cache, length=pos)
        emitted = [int(t) for t in outs[:j + 1]]  # j accepted + 1 bonus
        emit_lps = [float(x) for x in olps[:j + 1]]
        stop_at = next((i for i, t in enumerate(emitted) if t in stop_set), None)
        if stop_at is not None:  # keep the stop: generate cuts there
            emitted, emit_lps = emitted[:stop_at + 1], emit_lps[:stop_at + 1]
            hit_stop = True
        take = min(len(emitted), budget)
        out += emitted[:take]
        lps += emit_lps[:take]
        budget -= take
        token = int(outs[j])  # the bonus: emitted, its kv not yet written
        hist = np.concatenate([hist, outs[:j + 1].astype(np.int32)])
    if budget > 0 and not hit_stop:
        # the tail: too few free cache slots for a whole verify step
        toks, tlps, cache, _ = engine._decode_run(
            torch.tensor([[token]], device=engine.device),
            torch.full((1,), pos, device=engine.device), cache,
            torch.Generator(device=engine.device).manual_seed(0),
            _greedy_sp(engine, stop_set), budget,
            torch.zeros(1, dtype=torch.bool, device=engine.device),
        )
        out += [int(t) for t in toks[0]]
        lps += [float(x) for x in tlps[0]]
    return out, lps, cache


def _greedy_sp(engine, stop_set):
    from long_vita_tpu_torch.inference.sampler import SamplingParams

    return SamplingParams(greedy=True, stop_token_ids=tuple(stop_set - {engine.eos_id}))
