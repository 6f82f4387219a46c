"""Continuous (iteration-level) batching: a slot-pool decode scheduler.

Counterpart of long_vita_tpu/inference/continuous.py. A fixed pool of
KV-cache slots decodes in short segments ("ticks"), and new requests join
at any segment boundary, on the engine's ragged per-row cache frontier:

  - one shared [L, B, Smax] cache (``engine._make_cache(batch=max_slots)``)
    and per-slot lengths; inactive slots ride the decode loop masked done
    (their writes land past their slot's frontier, where the next
    occupant's insert or the mask hides them);
  - admission: a chunked prefill into a 1-row staging cache
    (``engine.start_prefill`` / ``prefill_step`` / ``finish_prefill``),
    then its rows are copied in place into the slot's row of the pool (k,
    v, and the scales of an int8 cache);
  - all rows in flight share one SamplingParams (the server groups
    requests by sampling key, as the window batcher does);
  - a tick is ``engine._decode_scan_masked`` over the whole pool, run
    eagerly (the JAX tick is one compiled scan); with the engine's
    ``speculative_k`` and greedy sampling it is one batched verify step;
  - over a mesh (the engine's ``parallel``; cp, tp or cp x tp) every rank
    builds the pool with the same geometry and makes the same calls (the
    server's lockstep, inference/multihost.py): the pool and the staging
    row are this rank's shards (its slots over cp, its kv heads over tp),
    and an admission copies only the staged rows that lie in this rank's
    slot shard.

Randomness is one ``torch.Generator`` seeded with ``seed`` and drawn from
in order, where the JAX engine splits a PRNG key per admission and tick:
sampled tokens differ from the JAX package's, greedy tokens do not.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from long_vita_tpu_torch.inference.engine import (
    GenerationResult,
    InferenceEngine,
    _round_up,
)
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.inference.speculative import draft_tokens
from long_vita_tpu_torch.models.qwen2 import KVCache


@dataclasses.dataclass
class _Slot:
    request_id: int
    prompt_tokens: int
    tokens: list
    logprobs: list
    remaining: int
    # for prefix-cache put-back on finish (engine.prefix_cache set)
    prompt_ids: Optional[np.ndarray] = None
    media_key: str = ""


class ContinuousEngine:
    """Slot-pool wrapper over an InferenceEngine (one device, or each rank
    of a mesh)."""

    def __init__(
        self,
        engine: InferenceEngine,
        sampling: SamplingParams = SamplingParams(),
        *,
        max_slots: int = 8,
        tick: int = 16,
        seed: int = 0,
        on_tokens=None,
    ):
        """on_tokens(rid, token_ids): streaming hook — called with each
        slot's KEPT tokens as they are produced (first token at admission,
        then per decode tick; stop tokens and post-stop tails are never
        reported, so the stream concatenates to the final result)."""
        self.engine = engine
        self.sampling = sampling
        self.on_tokens = on_tokens
        self.max_slots = max_slots
        self.tick = tick
        smax = _round_up(engine.max_seq_len, engine.chunk)
        self.cache = engine._make_cache(batch=max_slots, max_len=smax)
        self.lengths = np.zeros(max_slots, np.int64)
        self.cur_tokens = np.full(max_slots, engine.eos_id, np.int64)
        self.slots: list[Optional[_Slot]] = [None] * max_slots
        self.generator = torch.Generator(device=engine.device).manual_seed(seed)
        self._next_id = 0
        self._stop_set = {engine.eos_id, *sampling.stop_token_ids}
        # in-flight chunked admission: (rid, slot, PrefillJob)
        self._admission = None

    def _insert(self, staged: KVCache, slot: int, true_len: int) -> None:
        """Copy the staged row's first true_len positions into the slot's
        row of the pool (the rest of the row lies past the frontier). On a
        cp rank both rows are the rank's shard, global slots [rank * C,
        (rank + 1) * C): its valid prefix is true_len - rank * C, clamped
        to [0, C]."""
        n = true_len
        if self.engine.parallel is not None:
            c = self.cache.k.shape[2]
            n = min(max(true_len - self.engine.parallel.comm.rank * c, 0), c)
        for big, small in ((self.cache.k, staged.k), (self.cache.v, staged.v),
                           (self.cache.k_scale, staged.k_scale),
                           (self.cache.v_scale, staged.v_scale)):
            if big is not None and n:
                big[:, slot, :n].copy_(small[:, 0, :n])

    def _pool_cache(self) -> KVCache:
        """The pool's buffers at the slots' frontiers (a [B] length)."""
        return dataclasses.replace(
            self.cache, length=torch.as_tensor(self.lengths, device=self.engine.device)
        )

    # -- public ----------------------------------------------------------

    def set_sampling(self, sampling: SamplingParams):
        """Switch the pool's sampling config — only while drained (the
        server's scheduler batches by sampling key)."""
        if self.active:
            raise RuntimeError("cannot switch sampling with requests in flight")
        self.sampling = sampling
        self._stop_set = {self.engine.eos_id, *sampling.stop_token_ids}

    @property
    def free_slots(self) -> int:
        n = sum(s is None for s in self.slots)
        return n - (1 if self._admission is not None else 0)

    @property
    def active(self) -> int:
        return self.max_slots - sum(s is None for s in self.slots)

    @property
    def admission_pending(self) -> bool:
        return self._admission is not None

    def start_admission(self, input_ids, images=None, image_indices=None) -> int:
        """Reserve a slot and begin a CHUNKED prefill for a new request.

        Drive with admission_step() between decode ticks — one prompt chunk
        per call, so a long admission never stalls in-flight decodes for
        more than ~one chunk. Returns the request id."""
        if self._admission is not None:
            raise RuntimeError("an admission is already in flight")
        slot = next((i for i, s in enumerate(self.slots) if s is None), None)
        if slot is None:
            raise RuntimeError("no free slots")
        job = self.engine.start_prefill(input_ids, images, image_indices)
        rid = self._next_id
        self._next_id += 1
        self._admission = (rid, slot, job)
        return rid

    def admission_step(self) -> Optional[int]:
        """One prefill chunk of the in-flight admission; on the final call
        the row drops into its slot and the rid is returned (None before)."""
        rid, slot, job = self._admission
        if not job.done:
            self.engine.prefill_step(job)
            if not job.done:
                return None
        staged, last_hidden, true_len = self.engine.finish_prefill(job)
        token, lp = self.engine._head_sample(last_hidden, self.generator, self.sampling)
        first = int(token[0])
        self._insert(staged, slot, true_len)
        self.slots[slot] = _Slot(
            request_id=rid,
            prompt_tokens=true_len,
            tokens=[first],
            logprobs=[float(lp[0])],
            remaining=self.sampling.max_new_tokens - 1,
            prompt_ids=job.ids[0, :true_len].cpu().numpy().astype(np.int32),
            media_key=job.media_key,
        )
        self.lengths[slot] = true_len
        self.cur_tokens[slot] = first
        self._admission = None
        if self.on_tokens is not None and first not in self._stop_set:
            self.on_tokens(rid, [first])
        return rid

    def add_request(self, input_ids, images=None, image_indices=None) -> int:
        """Prefill a request into a free slot in one go; returns the id."""
        rid = self.start_admission(input_ids, images, image_indices)
        while self.admission_step() is None:
            pass
        return rid

    def _emit(self, i: int, s: _Slot, emitted: list, emit_lps: list, finished: list,
              advance) -> None:
        """Keep a slot's new tokens up to its budget and its first stop;
        finish it at a stop, at its budget or at the sequence cap.
        ``advance`` moves the slot's frontier when it goes on."""
        take = min(len(emitted), s.remaining)
        stop_at = next((m for m, t in enumerate(emitted[:take]) if t in self._stop_set), None)
        kept = emitted[: take if stop_at is None else stop_at]
        s.tokens += kept
        s.logprobs += emit_lps[: len(kept)]
        if self.on_tokens is not None and kept:
            self.on_tokens(s.request_id, kept)
        if stop_at is not None:
            # every kept token was fed back (a stop ends what was fed)
            finished.append(self._finish(i, s, all_fed=True))
            self.slots[i] = None
            return
        s.remaining -= take
        advance()
        if s.remaining <= 0 or self.lengths[i] >= self.engine.max_seq_len - 1:
            finished.append(self._finish(i, s))
            self.slots[i] = None

    def step(self) -> list[tuple[int, GenerationResult]]:
        """Decode one tick for every active slot; returns finished
        (request_id, result) pairs and frees their slots.

        With the engine's prompt-lookup speculation on (speculative_k > 0)
        and greedy sampling, a tick is ONE batched verify step instead of
        `tick` single-token reads: each slot proposes k-1 n-gram drafts
        from its own history, the pool verifies them in one cache read,
        and each row emits 1..k tokens (accepted prefix + bonus), the same
        tokens as the plain tick (inference/speculative.py)."""
        finished: list[tuple[int, GenerationResult]] = []
        # rows already past their first-token stop finish without decoding
        for i, s in enumerate(self.slots):
            if s is not None and (s.tokens[-1] in self._stop_set or s.remaining <= 0):
                finished.append(self._finish(i, s))
                self.slots[i] = None
        active_mask = np.asarray([s is not None for s in self.slots])
        if not active_mask.any():
            return finished

        k = self.engine.speculative_k
        # every active row needs k free cache rows for a verify step, and
        # near the SEQUENCE cap a verify could emit tokens past where the
        # plain tick masks to eos: the plain tick runs there instead, so the
        # two paths stay identical at the boundary
        spec_cap = min(self.engine.cache_slots(self.cache), self.engine.max_seq_len - 1)
        if k > 0 and self.sampling.greedy and all(
            int(self.lengths[i]) + k <= spec_cap
            for i, s in enumerate(self.slots) if s is not None
        ):
            return finished + self._step_speculative()

        dev = self.engine.device
        tokens, lps, _, _ = self.engine._decode_scan_masked(
            torch.as_tensor(self.cur_tokens[:, None], device=dev),
            torch.as_tensor(self.lengths, device=dev),
            self._pool_cache(),
            self.generator,
            self.sampling,
            self.tick,
            torch.as_tensor(~active_mask, device=dev),
        )
        tokens = tokens.cpu().numpy()
        lps = lps.cpu().numpy()

        for i, s in enumerate(self.slots):
            if s is None:
                continue

            def advance(i=i):
                self.lengths[i] += self.tick
                self.cur_tokens[i] = int(tokens[i, self.tick - 1])

            self._emit(i, s, [int(t) for t in tokens[i]], [float(x) for x in lps[i]],
                       finished, advance)
        return finished

    def _step_speculative(self) -> list[tuple[int, GenerationResult]]:
        """One batched verify step for every active slot (greedy only).

        Cache discipline per row (the solo path's frontier rule,
        inference/speculative.py): the verify writes k rows at the row's
        frontier; step[0..j] (pending token + j accepted drafts) have valid
        kv, so lengths advances j+1 and the rejected tail stays masked
        garbage, overwritten by the next verify. The emitted bonus token
        outs[j] becomes the row's pending cur_token (kv not yet written) —
        the plain tick's bookkeeping of its last sampled token."""
        k = self.engine.speculative_k
        step_mat = np.full((self.max_slots, k), self.engine.eos_id, np.int64)
        n_drafts = np.zeros(self.max_slots, np.int64)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            step_mat[i, 0] = self.cur_tokens[i]
            hist = np.concatenate([
                np.asarray(s.prompt_ids, np.int32), np.asarray(s.tokens, np.int32)
            ])
            drafts = draft_tokens(hist, k - 1)
            step_mat[i, 1 : 1 + len(drafts)] = drafts
            n_drafts[i] = len(drafts)

        dev = self.engine.device
        outs, olps, _ = self.engine._verify_step(
            torch.as_tensor(step_mat, device=dev),
            torch.as_tensor(self.lengths[:, None], device=dev),
            self._pool_cache(),
        )
        self.engine._spec_steps += 1
        outs = outs.cpu().numpy()
        olps = olps.cpu().numpy()

        finished: list[tuple[int, GenerationResult]] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            # accept drafts while they equal the model's own argmax
            j = 0
            while j < int(n_drafts[i]) and step_mat[i, j + 1] == outs[i, j]:
                j += 1
            # kv rows step[0..j] are valid; bonus outs[j] is emitted, unfed
            self.lengths[i] += j + 1
            self.cur_tokens[i] = int(outs[i, j])
            self._emit(i, s, [int(t) for t in outs[i, : j + 1]],
                       [float(x) for x in olps[i, : j + 1]], finished, lambda: None)
        return finished

    def run_to_completion(self) -> list[tuple[int, GenerationResult]]:
        out = []
        while self.active:
            out += self.step()
        return out

    def _finish(self, i: int, s: _Slot, all_fed: bool = False) -> tuple[int, GenerationResult]:
        """Build the result for slot i; snapshot its cache row into the
        engine's prefix cache so a follow-up turn resumes here."""
        res = self._result(s)
        pc = self.engine.prefix_cache
        if pc is not None and s.prompt_ids is not None:
            # frontier rule as engine.generate: kv rows are valid for the
            # prompt plus every kept token that was FED back. The in-tick
            # stop branch fed every kept token (all_fed); elsewhere the
            # last kept token may still be un-fed — claim one less (match
            # aligns down to the chunk grid anyway).
            stopped = len(res.token_ids) < len(s.tokens)
            n_fed = (len(res.token_ids) if (all_fed or stopped)
                     else max(0, len(res.token_ids) - 1))

            def row(x):
                return None if x is None else x[:, i : i + 1]

            frontier = s.prompt_tokens + n_fed
            pc.put(
                np.concatenate([s.prompt_ids, np.asarray(res.token_ids[:n_fed], np.int32)]),
                KVCache(row(self.cache.k), row(self.cache.v), frontier,
                        k_scale=row(self.cache.k_scale), v_scale=row(self.cache.v_scale)),
                frontier, s.media_key,
            )
        return (s.request_id, res)

    def _result(self, s: _Slot) -> GenerationResult:
        toks = s.tokens
        for idx, t in enumerate(toks):
            if t in self._stop_set:
                toks = toks[:idx]
                s.logprobs = s.logprobs[:idx]
                break
        text = self.engine.mm.tokenizer.decode(toks, skip_special_tokens=True)
        return GenerationResult(
            toks, text, s.prompt_tokens,
            s.logprobs if self.sampling.return_logprobs else None,
        )
