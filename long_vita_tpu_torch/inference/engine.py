"""Inference engine: chunked text prefill + KV-cache decode, one device.

Counterpart of long_vita_tpu/inference/engine.py (text-only, single device).
The serving path is the JAX engine's:

  - prompts pad to a multiple of ``chunk`` and stream through the decoder in
    chunks against a preallocated cache (the flash kernel on CUDA);
  - the cache length is then cut back to the true prompt length, and the
    last real token is re-run decode-style against the cache without it, so
    the first sampled token sees exactly the unpadded prompt;
  - decode runs in fixed-size segments with a host early-stop check between
    them; a ragged batch keeps one frontier per row.

PyTorch runs eagerly, so there is no jit: a donated JAX buffer becomes a
cache written in place. Randomness is one ``torch.Generator`` per request,
seeded from ``seed``. Images, videos, the int8 KV cache, weight
quantization, meshes, the prefix cache and speculative decoding are later
slices and raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.inference.sampler import SamplingParams, sample
from long_vita_tpu_torch.models import qwen2
from long_vita_tpu_torch.models.qwen2 import KVCache, Qwen2Params


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _later(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to long_vita_tpu_torch yet (ROADMAP: port "
        f"queue, {item})"
    )


@dataclasses.dataclass
class GenerationResult:
    token_ids: list[int]
    text: str
    prompt_tokens: int
    logprobs: Optional[list[float]] = None


@dataclasses.dataclass
class PrefillJob:
    """Incremental prefill state: one chunk per prefill_step call."""

    ids: torch.Tensor  # [1, padded] on the engine's device
    cache: KVCache
    true_len: int
    padded: int
    start: int = 0
    last_hidden: Optional[torch.Tensor] = None

    @property
    def done(self) -> bool:
        return self.start >= self.padded


class InferenceEngine:
    def __init__(
        self,
        params: Qwen2Params,
        cfg: LongVITAConfig,
        mm_tokenizer,
        *,
        max_seq_len: int = 16384,
        chunk: int = 2048,
        cache_dtype: torch.dtype = torch.bfloat16,
        kv_quant: bool = False,
        mesh=None,
        decode_segment: int = 64,
        prefix_cache_entries: int = 0,
        speculative_k: int = 0,
        weight_quant: Optional[str] = None,
    ):
        """params: the text decoder's weights (models/qwen2.py), already on
        the serving device. mm_tokenizer: anything with ``expand(input_ids,
        images=, videos=, max_num_frame=)`` returning an object with
        ``input_ids``/``images``/``image_indices``, and ``tokenizer.decode``
        (the JAX package's MultimodalTokenizer interface)."""
        if kv_quant:
            raise _later("kv_quant (int8 KV cache)", "int8 KV with K2")
        if weight_quant is not None:
            raise _later(f"weight_quant={weight_quant!r}", "w8a16/w4 with K6")
        if mesh is not None:
            raise _later("mesh (multi-device serving)", "multi-GPU")
        if prefix_cache_entries:
            raise _later("prefix_cache_entries", "server/CLI")
        if speculative_k:
            raise _later("speculative_k", "server/CLI")
        self.params = params
        self.cfg = cfg
        self.mm = mm_tokenizer
        self.max_seq_len = max_seq_len
        self.chunk = chunk
        self.cache_dtype = cache_dtype
        self.decode_segment = decode_segment
        self.eos_id = cfg.text.eos_token_id
        self.device = params.embed.device

    # ---- pieces (the JAX engine's jitted functions) ----------------------

    def _make_cache(self, batch: int, max_len: int) -> KVCache:
        return KVCache.zeros(
            self.cfg.text, batch=batch, max_len=max_len,
            dtype=self.cache_dtype, device=self.device,
        )

    def _embed_chunk(self, ids_chunk: torch.Tensor) -> torch.Tensor:
        return qwen2.embed_tokens(self.params, ids_chunk).to(self.cache_dtype)

    def _prefill_chunk(self, embeds, start: int, cache: KVCache):
        """One prompt chunk through the decoder, extending the cache."""
        positions = start + torch.arange(embeds.shape[1], device=self.device)[None]
        hidden, cache = qwen2.qwen2_decoder(
            self.params, embeds, positions, self.cfg.text, kv_cache=cache,
        )
        return hidden[:, -1], cache

    def _last_row(self, token, pos, cache: KVCache):
        """Decode-style pass of the final real prompt token (no sampling)."""
        embeds = qwen2.embed_tokens(self.params, token)
        hidden, cache = qwen2.qwen2_decoder(
            self.params, embeds, pos, self.cfg.text, kv_cache=cache,
        )
        return hidden[:, -1], cache

    def _head_sample(self, hidden, generator, sp: SamplingParams):
        logits = qwen2.lm_head(self.params, hidden)
        token = sample(logits, generator, sp)
        logprob = torch.log_softmax(logits, dim=-1).gather(-1, token[:, None])[:, 0]
        return token, logprob

    def _decode_scan_masked(self, token, start_pos, cache, generator, sp, n, done):
        """n decode steps for every row; rows already done (or at capacity)
        emit eos, and their writes past the cache are dropped."""
        stops = torch.tensor(
            (self.eos_id,) + tuple(sp.stop_token_ids), device=self.device
        )
        cap = self.max_seq_len - 1  # last admissible token position
        toks, lps = [], []
        for i in range(n):
            embeds = qwen2.embed_tokens(self.params, token)
            hidden, cache = qwen2.qwen2_decoder(
                self.params, embeds, (start_pos + i)[:, None], self.cfg.text,
                kv_cache=cache,
            )
            logits = qwen2.lm_head(self.params, hidden[:, -1])
            next_token = sample(logits, generator, sp)
            done = done | (start_pos + i >= cap)
            next_token = torch.where(done, self.eos_id, next_token)
            # an eos id past a small test vocab reads NaN, as JAX's gather
            # fills out-of-range reads; such rows are cut at the stop anyway
            vocab = logits.shape[-1]
            logprob = torch.log_softmax(logits, dim=-1).gather(
                -1, next_token.clamp(max=vocab - 1)[:, None]
            )[:, 0]
            logprob = torch.where(next_token < vocab, logprob, torch.nan)
            done = done | torch.isin(next_token, stops)
            toks.append(next_token)
            lps.append(logprob)
            token = next_token[:, None]
        return torch.stack(toks, 1), torch.stack(lps, 1), cache, done

    def _decode_run(self, token, start_pos, cache, generator, sp, budget, done0):
        """Decode up to ``budget`` tokens in segments of ``decode_segment``
        (smaller powers of two for small budgets), stopping early once every
        row is done. -> (tokens [B, <=budget], logprobs, cache, done)."""
        tok_parts, lp_parts = [], []
        done = done0
        remaining = budget
        while remaining > 0:
            n = self.decode_segment
            while n // 2 >= remaining:
                n //= 2
            toks, lps, cache, done = self._decode_scan_masked(
                token, start_pos, cache, generator, sp, n, done
            )
            tok_parts.append(toks.cpu().numpy())
            lp_parts.append(lps.cpu().numpy())
            token = toks[:, -1:]
            start_pos = start_pos + n
            remaining -= n
            if bool(done.all()):
                break
        tokens = np.concatenate(tok_parts, axis=1)[:, :budget]
        lps = np.concatenate(lp_parts, axis=1)[:, :budget]
        return tokens, lps, cache, done

    def _expand(self, input_ids, images, videos, max_num_frame):
        if len(images) or len(videos):
            raise _later("images and videos", "vision with K3")
        expanded = self.mm.expand(
            input_ids, images=(), videos=(), max_num_frame=max_num_frame
        )
        if expanded.images is not None:
            raise _later("image features", "vision with K3")
        return expanded

    # ---- public API ------------------------------------------------------

    def start_prefill(self, input_ids: Sequence[int]) -> PrefillJob:
        """Begin an incremental prefill; drive with prefill_step, then
        finish_prefill. (prefill() wraps the three for one-shot callers.)"""
        true_len = len(input_ids)
        if true_len > self.max_seq_len:
            raise ValueError(
                f"prompt {true_len} exceeds max_seq_len {self.max_seq_len} "
                "(reference max_tokens_to_oom semantics)"
            )
        padded = _round_up(true_len, self.chunk)
        ids = np.zeros((1, padded), np.int64)
        ids[0, :true_len] = input_ids
        cache = self._make_cache(
            batch=1, max_len=_round_up(self.max_seq_len, self.chunk)
        )
        return PrefillJob(
            ids=torch.as_tensor(ids, device=self.device), cache=cache,
            true_len=true_len, padded=padded,
        )

    def prefill_step(self, job: PrefillJob) -> bool:
        """Run ONE prompt chunk; returns True when all chunks are done."""
        start = job.start
        chunk_embeds = self._embed_chunk(job.ids[:, start : start + self.chunk])
        job.last_hidden, job.cache = self._prefill_chunk(chunk_embeds, start, job.cache)
        job.start = start + self.chunk
        return job.done

    def finish_prefill(self, job: PrefillJob) -> tuple[KVCache, torch.Tensor, int]:
        """-> (cache at true length, last-row hidden, true prompt length)."""
        if not job.done:
            raise ValueError("prefill_step until done before finish_prefill")
        true_len, cache, last_hidden = job.true_len, job.cache, job.last_hidden
        # padded tail slots hold garbage kv; shrink the cache to the truth so
        # decode masks them and overwrites them one position at a time
        cache = KVCache(cache.k, cache.v, true_len)
        if job.padded != true_len:
            # recompute the last row exactly: a decode-style pass of the final
            # real token against the same buffers with length true_len - 1
            cache_minus = KVCache(cache.k, cache.v, true_len - 1)
            tok = job.ids[:, true_len - 1 : true_len]
            pos = torch.full((1, 1), true_len - 1, device=self.device)
            last_hidden, cache = self._last_row(tok, pos, cache_minus)
        return cache, last_hidden, true_len

    def prefill(self, input_ids: Sequence[int]) -> tuple[KVCache, torch.Tensor, int]:
        """-> (cache at true length, last-row hidden, true prompt length)."""
        job = self.start_prefill(input_ids)
        while not job.done:
            self.prefill_step(job)
        return self.finish_prefill(job)

    def prefill_batch(
        self, batch_ids: list[Sequence[int]]
    ) -> tuple[KVCache, torch.Tensor, np.ndarray]:
        """Batched ragged prefill: every prompt pads to one chunk multiple and
        the rows stream through the decoder together; a per-row frontier
        (a [B] cache length) then realigns each row at its true length.

        -> (cache with per-row lengths, last-row hidden [B, H], lengths [B])."""
        bsz = len(batch_ids)
        lengths = np.asarray([len(x) for x in batch_ids], np.int64)
        if lengths.max() > self.max_seq_len:
            raise ValueError(
                f"prompt {int(lengths.max())} exceeds max_seq_len "
                f"{self.max_seq_len} (reference max_tokens_to_oom semantics)"
            )
        padded = _round_up(int(lengths.max()), self.chunk)
        ids_np = np.zeros((bsz, padded), np.int64)
        for row, toks in enumerate(batch_ids):
            ids_np[row, : len(toks)] = toks
        ids = torch.as_tensor(ids_np, device=self.device)

        cache = self._make_cache(
            batch=bsz, max_len=_round_up(self.max_seq_len, self.chunk)
        )
        for start in range(0, padded, self.chunk):
            chunk_embeds = self._embed_chunk(ids[:, start : start + self.chunk])
            _, cache = self._prefill_chunk(chunk_embeds, start, cache)
        # realign every row: re-run its final prompt token decode-style
        # against a per-row frontier of len - 1 (the write overwrites slot
        # len - 1 with the identical kv; causality hides each row's padded-
        # prefill garbage beyond its frontier)
        frontier = torch.as_tensor(lengths - 1, device=self.device)
        cache = KVCache(cache.k, cache.v, frontier)
        last_tok = torch.as_tensor(
            np.take_along_axis(ids_np, lengths[:, None] - 1, axis=1),
            device=self.device,
        )
        last_hidden, cache = self._last_row(last_tok, frontier[:, None], cache)
        return cache, last_hidden, lengths

    def generate_batch(
        self,
        requests: list[dict],
        *,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
    ) -> list[GenerationResult]:
        """Decode several requests in lockstep. Each request dict:
        {"messages": [...]} or {"input_ids": [...]} (media keys raise)."""
        expanded = []
        for r in requests:
            input_ids = r.get("input_ids")
            if input_ids is None:
                input_ids = self.mm.encode_chat(r["messages"])
            expanded.append(self._expand(
                input_ids, r.get("images", ()), r.get("videos", ()),
                r.get("max_num_frame"),
            ))
        cache, last_hidden, lengths = self.prefill_batch(
            [e.input_ids for e in expanded]
        )
        bsz = len(requests)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        first, first_lp = self._head_sample(last_hidden, gen, sampling)
        first = first.cpu().numpy()
        rows = [[int(first[b])] for b in range(bsz)]
        row_lps = [[float(x)] for x in first_lp.cpu().numpy()]
        # scan to the LONGEST row's budget (the shortest prompt); each row's
        # own capacity is enforced inside the decode loop
        budget = min(
            sampling.max_new_tokens - 1,
            self.max_seq_len - 1 - int(lengths.min()),
        )
        stop_set = {self.eos_id, *sampling.stop_token_ids}
        done0 = torch.as_tensor([int(t) in stop_set for t in first], device=self.device)
        if budget > 0 and not bool(done0.all()):
            tokens, lps, cache, _ = self._decode_run(
                torch.as_tensor(first[:, None], device=self.device),
                torch.as_tensor(lengths, device=self.device),
                cache, gen, sampling, budget, done0,
            )
            for b in range(bsz):
                rows[b] += [int(t) for t in tokens[b]]
                row_lps[b] += [float(x) for x in lps[b]]
        results = []
        for b in range(bsz):
            toks, lps_b = rows[b], row_lps[b]
            for idx, t in enumerate(toks):
                if t in stop_set:
                    toks, lps_b = toks[:idx], lps_b[:idx]
                    break
            text = self.mm.tokenizer.decode(toks, skip_special_tokens=True)
            results.append(GenerationResult(
                toks, text, int(lengths[b]),
                lps_b if sampling.return_logprobs else None,
            ))
        return results

    def generate(
        self,
        messages: Optional[list[dict]] = None,
        *,
        input_ids: Optional[Sequence[int]] = None,
        images: Sequence = (),
        videos: Sequence = (),
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        max_num_frame: Optional[int] = None,
    ) -> GenerationResult:
        """Chat generate from ``messages`` (needs a tokenizer) or token ids."""
        if input_ids is None:
            input_ids = self.mm.encode_chat(messages)
        expanded = self._expand(input_ids, images, videos, max_num_frame)
        cache, last_hidden, true_len = self.prefill(expanded.input_ids)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        token, first_lp = self._head_sample(last_hidden, gen, sampling)
        token = token.reshape(1, 1)
        out_tokens = [int(token[0, 0])]
        pos = true_len
        budget = min(sampling.max_new_tokens - 1, self.max_seq_len - 1 - pos)
        logprobs: list[float] = [float(first_lp[0])]
        stop_set = {self.eos_id, *sampling.stop_token_ids}
        if out_tokens[-1] not in stop_set and budget > 0:
            tokens, lps, cache, _ = self._decode_run(
                token, torch.full((1,), pos, device=self.device), cache,
                gen, sampling, budget,
                torch.zeros(1, dtype=torch.bool, device=self.device),
            )
            out_tokens += [int(t) for t in tokens[0]]
            logprobs += [float(x) for x in lps[0]]
        for idx, t in enumerate(out_tokens):
            if t in stop_set:
                out_tokens, logprobs = out_tokens[:idx], logprobs[:idx]
                break
        text = self.mm.tokenizer.decode(out_tokens, skip_special_tokens=True)
        return GenerationResult(
            out_tokens, text, true_len,
            logprobs if sampling.return_logprobs else None,
        )
