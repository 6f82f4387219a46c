"""Inference engine: chunked multimodal prefill + KV-cache decode, one device.

Counterpart of long_vita_tpu/inference/engine.py (single device). The
serving path is the JAX engine's:

  - the multimodal tokenizer expands <image>/<video> tags into context-token
    runs; the tiles are encoded up front in pieces of ``transfer_chunk``
    tiles (each cast to the cache dtype on the host before the copy), in ViT
    batches of ``vision_chunk`` through the single-pass attention kernel K3,
    into one feature buffer; with ``interleave_encode`` each piece is encoded
    just before the first prompt chunk its tiles scatter into;
  - prompts pad to a multiple of ``chunk`` and stream through the decoder in
    chunks against a preallocated cache (flash kernel K1 on CUDA, or the int8
    flash kernel K2 with ``kv_quant``); each chunk's embeddings take the
    feature rows whose positions fall inside it;
  - the cache length is then cut back to the true prompt length, and the
    last real token is re-run decode-style against the cache without it, so
    the first sampled token sees exactly the unpadded prompt;
  - decode runs in fixed-size segments with a host early-stop check between
    them; a ragged batch keeps one frontier per row; greedy requests of an
    engine with ``speculative_k`` take k-row verify steps instead
    (inference/speculative.py);
  - ``prefix_cache_entries`` keeps KV snapshots of recent prompts and resumes
    a prefill after the longest shared prefix (inference/prefix_cache.py);
  - ``weight_quant`` ("int8" or "int4") serves a quantized copy of the text
    decoder (models/quantize.py): int4 projections and head run K6 for
    decode-sized row counts.

PyTorch runs eagerly, so there is no jit: a donated JAX buffer becomes a
cache written in place. Randomness is one ``torch.Generator`` per request,
seeded from ``seed``.

With a ``mesh`` (parallel/mesh.Mesh) of cp > 1 the engine serves from a KV
cache sharded over cp by slot (JAX :215-232): every rank builds the engine
with the same mesh and weights and calls generate / generate_batch with the
same inputs (JAX's multi-controller contract; the ranks are processes of an
NCCL group, or thread-ranks sharing one card). Each rank holds slots // cp
cache slots; a prefill chunk runs its projections on this rank's 1/cp of
the rows and attends its shard (K1, K2 for an int8 cache), and the partials
merge over cp (ops/cp_cache_attention.py); decode is replicated; tiles are
encoded 1/cp a rank (K3) and their features all-gathered. Every rank
samples the same tokens from the same logits and generator.

With a mesh of tp > 1 (JAX :197-220 and ``shard_cache`` :278-300) every rank
validates the geometry, quantises the WHOLE tree (``weight_quant``), then
cuts its shard of it (parallel/sharding.shard_params): Megatron's column
and row projections with an all-reduce over tp after o_proj and
down_proj, a vocab-parallel embedding and head (the logits all-gathered,
so every rank samples the same token with the same generator), and a
cache of the rank's kv heads. K1 and K2 run at the local head counts; K6
on the int4 column shards. Tiles are encoded 1/(cp x tp) a rank. cp and tp
compose: the cache is then sharded by slot over cp and by kv head over tp.

With a mesh of tq > 1 too (2-D tensor parallelism: JAX's engine calls
shard_params, which takes ``text_param_specs(tp2d=True)`` there, :215-233)
every weight of the decoder is cut over both matrix dims: a column weight
[out@tp, in@tq], a row weight [out@tq, in@tp], the embedding and the head
[V@tp, H@tq], and the quantised trees as JAX's quantized_param_specs
adapts them (int8 codes as their weight, the scale with the output dim;
int4 by its output dim alone, over tp for a column weight and the head,
over tq for a row one). The decoder runs the cached path on the rank's
hidden slice [B, S, H/tq] without sequence parallelism (models/qwen2.py):
RMSNorm sums its squares over tq, a column product is summed over tq, a
row product gives the rank's hidden slice summed over tp, and the head
sums its partial logits over tq before the all-gather over tp, so every
rank samples the same token. The cache keeps num_kv_heads / tp heads on
every tq rank (JAX's shard_cache, :279-290); the attention is the same on
each. cp composes with it as with tp. A MoE model refuses tq (JAX's
words), and so does pp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.inference.prefix_cache import PrefixCache, media_fingerprint
from long_vita_tpu_torch.inference.sampler import SamplingParams, sample
from long_vita_tpu_torch.inference.speculative import speculative_decode
from long_vita_tpu_torch.models import qwen2
from long_vita_tpu_torch.models.long_vita import LongVITAParams, encode_images
from long_vita_tpu_torch.models.qwen2 import KVCache, Qwen2Params
from long_vita_tpu_torch.models.quantize import (
    quantize_weights_int4,
    quantize_weights_int8,
)
from long_vita_tpu_torch.parallel.mesh import Mesh, validate_geometry
from long_vita_tpu_torch.parallel.sharding import shard_params

_OOB_SEQ = 2**30  # a feature row at this position lands in no chunk


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _host_cast_pixels(images, dtype: torch.dtype) -> torch.Tensor:
    """Pixels (a numpy stack, or a host tensor) as a host tensor of the cache
    dtype: an f32 stack is cast to bf16 on the host, so the copy to the card
    moves half the bytes. A stack already in that dtype keeps its bits (the
    serving lockstep admits the cast stack it published)."""
    if torch.is_tensor(images):
        return images.to(dtype)
    return torch.from_numpy(np.ascontiguousarray(images)).to(dtype)


def _tile_stack(images):
    """A tile stack as given (a host tensor) or as a numpy array; None, or
    a stack of no tiles, -> None."""
    if images is None:
        return None
    arr = images if torch.is_tensor(images) else np.asarray(images)
    return arr if arr.shape[0] > 0 else None


def _pad_tiles(arr, n: int):
    """Append zero tiles up to n (numpy or a tensor, as given)."""
    if arr.shape[0] == n:
        return arr
    if torch.is_tensor(arr):
        return torch.cat([arr, arr.new_zeros((n - arr.shape[0], *arr.shape[1:]))], 0)
    pad = np.zeros((n - arr.shape[0], *arr.shape[1:]), arr.dtype)
    return np.concatenate([arr, pad], 0)


def _pad_scatter_indices(indices, n_feat_rows: int) -> np.ndarray:
    """Match the [2, N_tiles, T] scatter indices to a feature buffer padded
    to n_feat_rows tiles: the extra tiles get (batch 0, seq 2^30), which no
    chunk's scatter keeps."""
    idx = np.asarray(indices)
    short = n_feat_rows - idx.shape[1]
    if short <= 0:
        return idx
    pad = np.zeros((2, short, idx.shape[2]), idx.dtype)
    pad[1] = _OOB_SEQ
    return np.concatenate([idx, pad], 1)


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
    feats: Optional[torch.Tensor] = None  # [N_tiles (padded), T, H] on device
    indices: Optional[np.ndarray] = None  # [2, N_tiles (padded), T] host
    media_key: str = ""    # prefix-cache fingerprint of the tile stack
    resumed_from: int = 0  # tokens restored from the prefix cache
    # interleaved encode: the host tiles not encoded yet, how many are, and
    # each tile's first prompt row
    pixels: Optional[np.ndarray] = None
    tiles_done: int = 0
    tile_first_row: Optional[np.ndarray] = None

    @property
    def done(self) -> bool:
        return self.start >= self.padded


class InferenceEngine:
    def __init__(
        self,
        params,
        cfg: LongVITAConfig,
        mm_tokenizer,
        *,
        max_seq_len: int = 16384,
        chunk: int = 2048,
        vision_chunk: int = 64,
        cache_dtype: torch.dtype = torch.bfloat16,
        kv_quant: bool = False,
        mesh=None,
        decode_segment: int = 64,
        prefix_cache_entries: int = 0,
        speculative_k: int = 0,
        transfer_chunk: int = 256,
        weight_quant: Optional[str] = None,
        interleave_encode: bool = False,
    ):
        """params: a ``LongVITAParams`` (models/long_vita.py), or the text
        decoder's ``Qwen2Params`` alone for text-only serving, already on the
        serving device. mm_tokenizer: a data/multimodal.MultimodalTokenizer,
        or anything with ``expand(input_ids, images=, videos=,
        max_num_frame=)`` returning an object with
        ``input_ids``/``images``/``image_indices``, and ``tokenizer.decode``.

        kv_quant: an int8 KV cache with per-(token, kv head) f32 scales.
        vision_chunk: tiles per ViT batch; transfer_chunk: tiles per host ->
        device piece of the encode (0: one piece); interleave_encode: encode
        each piece just before the first prompt chunk its tiles scatter into
        (off by default, as in the JAX package).
        prefix_cache_entries: KV snapshots kept for prefix reuse (0: off).
        speculative_k: 0 (off) or the rows of a prompt-lookup verify step
        (>= 2), for greedy requests of generate.
        weight_quant: None, "int8" (w8a16) or "int4" (w4a16): the text
        decoder's projections and head are quantized into a new tree on the
        parameters' device; ``params`` stays as it is.
        mesh: a parallel.mesh.Mesh; with cp > 1, the cp-sharded cache, with
        tp > 1 the tp-sharded weights and cache, with tq > 1 the weights cut
        over tq too (see the module docstring); ``params`` is the whole tree
        on every rank. A pp mesh, and a MoE model over dp or tq, raise (as
        JAX's engine does, or with its words)."""
        self.mesh, self.parallel = mesh, None
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a long_vita_tpu_torch.parallel.mesh.Mesh, got {mesh!r}")
        if mesh is not None and mesh.shape["pp"] > 1:
            raise NotImplementedError(
                f"serving over a pp {mesh.shape['pp']} mesh: pipeline stages run in training "
                "only, as in the JAX package (its engine takes a tp x cp mesh)")
        if mesh is not None:
            validate_geometry(cfg.text, mesh.cfg)
            qwen2.check_moe_mesh(cfg.text, dp=mesh.shape["dp"], cp=mesh.shape["cp"],
                                 tp=mesh.shape["tp"], tq=mesh.shape["tq"])
            if cfg.text.num_experts and mesh.shape["dp"] > 1:
                # expert parallelism exchanges rows between the dp ranks in
                # every call: a training layout (JAX's engine takes tp x cp)
                raise NotImplementedError(
                    f"serving a MoE model over dp {mesh.shape['dp']}: the engine serves a "
                    "tp x cp mesh (MoE over tp, cp and cp x tp)")
        if mesh is not None and mesh.size > 1:
            self.parallel = qwen2.ParallelConfig(mesh)
        if mesh is not None and mesh.shape["cp"] > 1:
            cp = mesh.shape["cp"]
            slots = _round_up(max_seq_len, chunk)
            if chunk > slots // cp:
                raise ValueError(
                    f"prefill chunk {chunk} exceeds one cp rank's cache "
                    f"shard ({slots}//{cp} = {slots // cp}); lower "
                    "chunk or raise max_seq_len"
                )
            if slots % cp:
                raise ValueError(f"cache slots {slots} do not divide over cp {cp}")
        if speculative_k < 0 or speculative_k == 1:
            raise ValueError("speculative_k must be 0 (off) or >= 2")
        self.speculative_k = speculative_k
        self._spec_steps = 0  # verify steps taken (acceptance telemetry)
        self.prefix_cache = (
            PrefixCache(prefix_cache_entries, chunk) if prefix_cache_entries > 0 else None
        )
        self.interleave_encode = interleave_encode
        self.weight_quant = weight_quant
        if weight_quant == "int8":
            params = quantize_weights_int8(params)
        elif weight_quant == "int4":
            params = quantize_weights_int4(params)
        elif weight_quant is not None:
            raise ValueError(f"unknown weight_quant {weight_quant!r}")
        if mesh is not None:
            params = shard_params(params, mesh, cfg)  # after quantising the whole tree
        self.params = params
        self.text: Qwen2Params = params.text if isinstance(params, LongVITAParams) else params
        self.cfg = cfg
        self.mm = mm_tokenizer
        self.max_seq_len = max_seq_len
        self.chunk = chunk
        self.vision_chunk = vision_chunk
        self.transfer_chunk = transfer_chunk
        self.cache_dtype = cache_dtype
        self.kv_quant = kv_quant
        self.decode_segment = decode_segment
        self.eos_id = cfg.text.eos_token_id
        self.device = self.text.embed.device

    # ---- pieces (the JAX engine's jitted functions) ----------------------

    def _make_cache(self, batch: int, max_len: int) -> KVCache:
        """A cache of max_len slots, this rank's max_len // cp of them when
        cp-serving (slots [rank * C, (rank + 1) * C)), of this rank's kv
        heads when tp-serving."""
        if self.parallel is not None:
            max_len //= self.parallel.cp
        return KVCache.zeros(
            self.cfg.text, batch=batch, max_len=max_len,
            dtype=self.cache_dtype, device=self.device, quantize=self.kv_quant,
            kv_heads=qwen2.kv_heads(self.text, self.cfg.text),
        )

    def cache_slots(self, cache: KVCache) -> int:
        """A cache's global slots (a cp rank holds 1/cp of them)."""
        return cache.k.shape[2] * (self.parallel.cp if self.parallel is not None else 1)

    def _encode(self, tiles: np.ndarray) -> torch.Tensor:
        if not isinstance(self.params, LongVITAParams):
            raise ValueError(
                "images need a LongVITAParams engine: this one was built with "
                "the text decoder's weights alone"
            )
        pixels = _host_cast_pixels(tiles, self.cache_dtype).to(self.device)
        return encode_images(
            self.params, pixels, self.cfg, chunk=self.vision_chunk, attn_impl="short",
            parallel=self.parallel,
        )

    def _encode_images_host(self, images: np.ndarray) -> torch.Tensor:
        """Encode a host tile stack in pieces of ``transfer_chunk`` tiles
        into one feature buffer (a stack within one piece is encoded at
        once). The buffer is padded to a transfer_chunk multiple with the
        encodings of zero tiles; _pad_scatter_indices sends those rows
        nowhere."""
        arr = _tile_stack(images)
        n, tc = arr.shape[0], self.transfer_chunk
        if not tc or n <= tc:
            return self._encode(arr)
        buf = None
        for i in range(0, n, tc):
            part = self._encode(_pad_tiles(arr[i : i + tc], tc))
            if buf is None:
                buf = torch.empty(
                    (_round_up(n, tc), *part.shape[1:]), dtype=part.dtype, device=part.device
                )
            buf[i : i + tc] = part
        return buf

    def _media(self, images, image_indices):
        """-> (feature buffer, host scatter indices padded to it), or Nones."""
        if _tile_stack(images) is None:
            return None, None
        feats = self._encode_images_host(images)
        return feats, _pad_scatter_indices(image_indices, feats.shape[0])

    def _embed_chunk(self, ids_chunk: torch.Tensor, feats=None, indices=None, start: int = 0):
        """Token embeddings of one prompt chunk, with the feature rows whose
        (batch, seq - start) falls inside the chunk; every other row (an
        earlier or later chunk's, or a padded tile's) is dropped."""
        embeds = qwen2.embed_tokens(self.text, ids_chunk)
        if feats is not None:
            b_idx = indices[0].reshape(-1)
            s_idx = indices[1].reshape(-1) - start
            rows = np.nonzero(
                (b_idx >= 0) & (b_idx < ids_chunk.shape[0])
                & (s_idx >= 0) & (s_idx < ids_chunk.shape[1])
            )[0]
            if rows.size:
                flat = feats.reshape(-1, feats.shape[-1])
                tq = self.text.tq_comm
                if tq is not None:  # the rank's hidden slice of the rows (2-D tp)
                    h = embeds.shape[-1]
                    flat = flat.narrow(-1, tq.rank * h, h)
                dev = self.device
                embeds[torch.as_tensor(b_idx[rows], device=dev),
                       torch.as_tensor(s_idx[rows], device=dev)] = (
                    flat[torch.as_tensor(rows, device=dev)].to(embeds.dtype)
                )
        return embeds.to(self.cache_dtype)

    def _prefill_chunk(self, embeds, start: int, cache: KVCache):
        """One prompt chunk through the decoder, extending the cache."""
        positions = start + torch.arange(embeds.shape[1], device=self.device)[None]
        hidden, cache = qwen2.qwen2_decoder(
            self.text, embeds, positions, self.cfg.text, kv_cache=cache,
            parallel=self.parallel,
        )
        return hidden[:, -1], cache

    def _last_row(self, token, pos, cache: KVCache):
        """Decode-style pass of the final real prompt token (no sampling)."""
        embeds = qwen2.embed_tokens(self.text, token)
        hidden, cache = qwen2.qwen2_decoder(
            self.text, embeds, pos, self.cfg.text, kv_cache=cache,
            parallel=self.parallel,
        )
        return hidden[:, -1], cache

    def _verify_step(self, tokens, pos0: int, cache: KVCache):
        """Speculative verify: k tokens [B, k] at positions pos0 .. pos0 + k
        - 1 against a cache of length pos0. -> (each row's greedy token
        [B, k], its logprob, the cache at length pos0 + k)."""
        embeds = qwen2.embed_tokens(self.text, tokens)
        positions = pos0 + torch.arange(tokens.shape[1], device=self.device)[None]
        hidden, cache = qwen2.qwen2_decoder(
            self.text, embeds, positions, self.cfg.text, kv_cache=cache,
            parallel=self.parallel,
        )
        logits = qwen2.lm_head(self.text, hidden)  # [B, k, V]
        out = torch.argmax(logits, dim=-1)
        lps = torch.log_softmax(logits.float(), dim=-1).gather(-1, out[..., None])[..., 0]
        return out, lps, cache

    def _head_sample(self, hidden, generator, sp: SamplingParams):
        logits = qwen2.lm_head(self.text, hidden)
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
            embeds = qwen2.embed_tokens(self.text, token)
            hidden, cache = qwen2.qwen2_decoder(
                self.text, embeds, (start_pos + i)[:, None], self.cfg.text,
                kv_cache=cache, parallel=self.parallel,
            )
            logits = qwen2.lm_head(self.text, hidden[:, -1])
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

    # ---- public API ------------------------------------------------------

    def start_prefill(
        self,
        input_ids: Sequence[int],
        images: Optional[np.ndarray] = None,
        image_indices: Optional[np.ndarray] = None,
    ) -> PrefillJob:
        """Begin an incremental prefill; drive with prefill_step, then
        finish_prefill. (prefill() wraps the three for one-shot callers.)
        images [N, H, W, 3] host tiles and image_indices [2, N, T] as the
        multimodal tokenizer's expand returns them; the tiles are encoded
        here, before the first chunk, or with interleave_encode (and more
        than one transfer piece) by prefill_step. With a prefix cache, a
        prompt that shares at least a chunk with a snapshot resumes after
        it."""
        true_len = len(input_ids)
        if true_len > self.max_seq_len:
            raise ValueError(
                f"prompt {true_len} exceeds max_seq_len {self.max_seq_len} "
                "(reference max_tokens_to_oom semantics)"
            )
        padded = _round_up(true_len, self.chunk)
        ids = np.zeros((1, padded), np.int64)
        ids[0, :true_len] = input_ids
        feats = indices = pixels = tile_first_row = None
        arr = _tile_stack(images)
        if arr is not None:
            n, tc = arr.shape[0], self.transfer_chunk
            if self.interleave_encode and tc and n > tc:
                pixels = arr
                tile_first_row = np.asarray(image_indices)[1].min(axis=1)
                indices = _pad_scatter_indices(image_indices, _round_up(n, tc))
            else:
                feats, indices = self._media(arr, image_indices)
        media_key, cache, start = "", None, 0
        if self.prefix_cache is not None:
            media_key = media_fingerprint(images)
            hit = self.prefix_cache.match(np.asarray(input_ids, np.int32), media_key)
            if hit is not None:
                cache, start = hit
        if cache is None:
            cache = self._make_cache(
                batch=1, max_len=_round_up(self.max_seq_len, self.chunk)
            )
        tiles_done = 0
        if pixels is not None and start > 0:
            # a prefix-cache resume: tiles whose every row lies inside the
            # restored prefix are never read, so their encodes are skipped
            last_row = np.asarray(image_indices)[1].max(axis=1)
            while tiles_done < pixels.shape[0] and last_row[tiles_done] < start:
                tiles_done += 1
        return PrefillJob(
            ids=torch.as_tensor(ids, device=self.device), cache=cache,
            true_len=true_len, padded=padded, start=start, feats=feats,
            indices=indices, media_key=media_key, resumed_from=start,
            pixels=pixels, tiles_done=tiles_done, tile_first_row=tile_first_row,
        )

    def _advance_encode(self, job: PrefillJob, upto_row: int) -> None:
        """Interleaved encode: encode transfer pieces until every tile whose
        first row lies below ``upto_row`` has its features in the job's
        buffer (padded to a transfer-piece multiple, as the up-front encode's)."""
        if job.pixels is None:
            return
        n, tc = job.pixels.shape[0], self.transfer_chunk
        mask = job.tile_first_row < upto_row
        need = int(np.nonzero(mask)[0].max()) + 1 if mask.any() else 0
        while job.tiles_done < need:
            i = job.tiles_done
            part = self._encode(_pad_tiles(job.pixels[i : i + tc], tc))
            if job.feats is None:
                job.feats = torch.zeros(
                    (_round_up(n, tc), *part.shape[1:]), dtype=part.dtype, device=part.device
                )
            job.feats[i : i + tc] = part
            job.tiles_done = min(i + tc, n)

    def prefill_step(self, job: PrefillJob) -> bool:
        """Run ONE prompt chunk; returns True when all chunks are done."""
        start = job.start
        self._advance_encode(job, start + self.chunk)
        # a leading text-only chunk of an interleaved encode has no features yet
        indices = job.indices if job.feats is not None else None
        chunk_embeds = self._embed_chunk(
            job.ids[:, start : start + self.chunk], job.feats, indices, start
        )
        job.last_hidden, job.cache = self._prefill_chunk(chunk_embeds, start, job.cache)
        job.start = start + self.chunk
        return job.done

    def finish_prefill(self, job: PrefillJob) -> tuple[KVCache, torch.Tensor, int]:
        """-> (cache at true length, last-row hidden, true prompt length)."""
        if not job.done:
            raise ValueError("prefill_step until done before finish_prefill")
        true_len, cache, last_hidden = job.true_len, job.cache, job.last_hidden
        # padded tail slots hold garbage kv; shrink the cache to the truth so
        # decode masks them and overwrites them one position at a time (an
        # int8 cache keeps its scales)
        cache = dataclasses.replace(cache, length=true_len)
        if job.padded != true_len:
            # recompute the last row exactly: a decode-style pass of the final
            # real token against the same buffers with length true_len - 1
            # (a prompt ends with a text token, so no feature lands there)
            cache_minus = dataclasses.replace(cache, length=true_len - 1)
            tok = job.ids[:, true_len - 1 : true_len]
            pos = torch.full((1, 1), true_len - 1, device=self.device)
            last_hidden, cache = self._last_row(tok, pos, cache_minus)
        return cache, last_hidden, true_len

    def prefill(
        self,
        input_ids: Sequence[int],
        images: Optional[np.ndarray] = None,
        image_indices: Optional[np.ndarray] = None,
    ) -> tuple[KVCache, torch.Tensor, int]:
        """-> (cache at true length, last-row hidden, true prompt length)."""
        job = self.start_prefill(input_ids, images, image_indices)
        while not job.done:
            self.prefill_step(job)
        return self.finish_prefill(job)

    def prefill_batch(
        self, batch_inputs: list[tuple]
    ) -> tuple[KVCache, torch.Tensor, np.ndarray]:
        """Batched ragged prefill: every prompt pads to one chunk multiple and
        the rows stream through the decoder together; a per-row frontier
        (a [B] cache length) then realigns each row at its true length.

        batch_inputs: one (input_ids, images, image_indices) per row (images
        and image_indices None for a text row). The rows' tile stacks are
        encoded as one, with each row's scatter batch index set to the row.
        -> (cache with per-row lengths, last-row hidden [B, H], lengths [B])."""
        bsz = len(batch_inputs)
        lengths = np.asarray([len(x[0]) for x in batch_inputs], np.int64)
        if lengths.max() > self.max_seq_len:
            raise ValueError(
                f"prompt {int(lengths.max())} exceeds max_seq_len "
                f"{self.max_seq_len} (reference max_tokens_to_oom semantics)"
            )
        padded = _round_up(int(lengths.max()), self.chunk)
        ids_np = np.zeros((bsz, padded), np.int64)
        for row, (toks, _, _) in enumerate(batch_inputs):
            ids_np[row, : len(toks)] = toks
        ids = torch.as_tensor(ids_np, device=self.device)

        stacks, idx_parts = [], []
        for row, (_, imgs, idx) in enumerate(batch_inputs):
            if imgs is None or np.asarray(imgs).shape[0] == 0:
                continue
            stacks.append(np.asarray(imgs))
            idx = np.array(idx, copy=True)
            idx[0] = row
            idx_parts.append(idx)
        feats = indices = None
        if stacks:
            feats, indices = self._media(
                np.concatenate(stacks, 0), np.concatenate(idx_parts, 1)
            )

        cache = self._make_cache(
            batch=bsz, max_len=_round_up(self.max_seq_len, self.chunk)
        )
        for start in range(0, padded, self.chunk):
            chunk_embeds = self._embed_chunk(
                ids[:, start : start + self.chunk], feats, indices, start
            )
            _, cache = self._prefill_chunk(chunk_embeds, start, cache)
        # realign every row: re-run its final prompt token decode-style
        # against a per-row frontier of len - 1 (the write overwrites slot
        # len - 1 with the identical kv; causality hides each row's padded-
        # prefill garbage beyond its frontier)
        frontier = torch.as_tensor(lengths - 1, device=self.device)
        cache = dataclasses.replace(cache, length=frontier)
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
        {"messages": [...]} or {"input_ids": [...]}, plus optional "images",
        "videos" and "max_num_frame"."""
        expanded = []
        for r in requests:
            input_ids = r.get("input_ids")
            if input_ids is None:
                input_ids = self.mm.encode_chat(r["messages"])
            expanded.append(self.mm.expand(
                input_ids, images=r.get("images", ()), videos=r.get("videos", ()),
                max_num_frame=r.get("max_num_frame"),
            ))
        cache, last_hidden, lengths = self.prefill_batch(
            [(e.input_ids, e.images, e.image_indices) for e in expanded]
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
        """Chat generate from ``messages`` (needs a tokenizer) or token ids;
        <image>/<video> tags in the prompt take ``images``/``videos``."""
        if input_ids is None:
            input_ids = self.mm.encode_chat(messages)
        expanded = self.mm.expand(
            input_ids, images=images, videos=videos, max_num_frame=max_num_frame
        )
        job = self.start_prefill(
            expanded.input_ids, expanded.images, expanded.image_indices
        )
        while not job.done:
            self.prefill_step(job)
        cache, last_hidden, true_len = self.finish_prefill(job)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        token, first_lp = self._head_sample(last_hidden, gen, sampling)
        token = token.reshape(1, 1)
        out_tokens = [int(token[0, 0])]
        pos = true_len
        budget = min(sampling.max_new_tokens - 1, self.max_seq_len - 1 - pos)
        logprobs: list[float] = [float(first_lp[0])]
        stop_set = {self.eos_id, *sampling.stop_token_ids}
        if out_tokens[-1] not in stop_set and budget > 0:
            if self.speculative_k > 0 and sampling.greedy:
                hist = np.concatenate([
                    np.asarray(expanded.input_ids, np.int32),
                    np.asarray(out_tokens, np.int32),
                ])
                toks, lps, cache = speculative_decode(
                    self, hist, out_tokens[-1], pos, cache, budget, stop_set,
                    self.speculative_k,
                )
                out_tokens += toks
                logprobs += lps
            else:
                tokens, lps, cache, _ = self._decode_run(
                    token, torch.full((1,), pos, device=self.device), cache,
                    gen, sampling, budget,
                    torch.zeros(1, dtype=torch.bool, device=self.device),
                )
                out_tokens += [int(t) for t in tokens[0]]
                logprobs += [float(x) for x in lps[0]]
        stopped = False
        for idx, t in enumerate(out_tokens):
            if t in stop_set:
                out_tokens, logprobs = out_tokens[:idx], logprobs[:idx]
                stopped = True
                break
        if self.prefix_cache is not None:
            # kv is valid for every token fed back: all of them when a stop
            # ended decode, all but the last sample otherwise
            n_fed = len(out_tokens) if stopped else max(0, len(out_tokens) - 1)
            ids_cached = np.concatenate([
                np.asarray(expanded.input_ids, np.int32),
                np.asarray(out_tokens[:n_fed], np.int32),
            ])
            self.prefix_cache.put(ids_cached, cache, true_len + n_fed, job.media_key)
        text = self.mm.tokenizer.decode(out_tokens, skip_special_tokens=True)
        return GenerationResult(
            out_tokens, text, true_len,
            logprobs if sampling.return_logprobs else None,
        )
