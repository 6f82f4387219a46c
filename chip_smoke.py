#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (long_vita_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. build the three CUDA kernels from the sources in this checkout (one
     nvcc each, in parallel) and print nvcc's register/spill lines;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it, with stated tolerances, and time both
     with CUDA events: K1 the flash forward, K2 the int8 flash forward, K3
     the ViT's short attention;
  3. text serving: the full-width, full-depth Qwen2.5-14B decoder (random
     bf16 weights from a seeded generator) through InferenceEngine: greedy
     generate twice, a ragged generate_batch and a sampled request, counting
     K1's launches; then the prefill's last-row logits against two plain
     references;
  4. multimodal serving: the same decoder with a random InternViT-300M tower
     and projector: a 64-frame video into an int8 cache, twice; a ragged
     batch of a 7-tile image and a 16-frame video into an int8 cache; the
     video into a bf16 cache. Launch counts of K1, K2 and K3 are checked
     against the layers and chunks the requests need; the video's last-row
     logits and its encoded features are held against the same flow on the
     plain versions.

The card's nvidia-smi line is the first line of stdout and is repeated
before the last two, which are the kernel report and {"ok": true, "device":
{...}}. Without a CUDA device the script exits 1 and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
# bf16 kernel vs the plain version: both compute logits and softmax
# statistics in f32; they differ in where p is rounded to bf16 (the kernel
# rounds exp(s - running max), the plain version exp(s - final max)) and in
# summation order, then both round o to bf16 (2^-8 relative). Two bf16
# roundings bound the output error well inside 1e-2 abs + 1e-2 rel; the f32
# lse never sees a bf16 rounding, so it gets 1e-3 absolute.
O_ATOL, O_RTOL, LSE_ATOL = 1e-2, 1e-2, 1e-3
# f32 kernel: only summation order and exp differ.
F32_ATOL = 1e-4
# solo-prefill last-row logits, kernel path vs the plain attention: 48 bf16
# layers of random weights amplify any rounding difference. On an H100 the
# plain attention alone, chunked against a cache vs one 5000-row pass, lands
# at cosine 0.9985 and a max logit move of 3.1% of the spread; the bounds
# leave room for that floor and catch a kernel that is wrong.
LOGIT_COS, LOGIT_SPREAD_FRAC = 0.995, 0.05
# ViT features through K3 vs through the plain attention, 24 bf16 layers of
# random weights then the projector: the two round p to bf16 at different
# points (running vs final max), which each layer carries forward; the
# bound on the relative Frobenius error and the worst row's cosine leaves
# room for that and catches a kernel that is wrong.
FEAT_REL_ERR, FEAT_ROW_COS = 0.05, 0.99
SOURCES = {
    "flash_fwd": ("long_vita_tpu_torch/ops/csrc/flash_fwd.cu",
                  "long_vita_tpu/ops/flash_attention.py:144"),
    "flash_fwd_quant": ("long_vita_tpu_torch/ops/csrc/flash_fwd_quant.cu",
                        "long_vita_tpu/ops/flash_attention.py:261"),
    "short_attn": ("long_vita_tpu_torch/ops/csrc/short_attn.cu",
                   "long_vita_tpu/ops/flash_attention.py:1192"),
}


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of fn() in ms from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _counters():
    """The three kernels' wrappers, whose ``launches`` count kernel launches."""
    from long_vita_tpu_torch.ops import flash_attention as fa

    return {
        "flash_fwd": fa.flash_attention,
        "flash_fwd_quant": fa.flash_attention_quant,
        "short_attn": fa.short_attention,
    }


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_build() -> None:
    from long_vita_tpu_torch.ops import _build
    from long_vita_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa.build()
    print(f"[build] {', '.join(SOURCES)} built (in parallel) and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"[build] {name}: {line.strip()}")


def _kernel_case(name, q, k, v, *, f32=False, **kw) -> float:
    """Run the kernel and the plain version on the same inputs; -> max |o err|."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    if fa.flash_attention.launches != before + 1:
        raise AssertionError(f"[{name}] kernel launch count did not rise by 1")
    ref_kw = {x: kw[x] for x in kw if x not in ("q_positions", "kv_positions")}
    ro, rlse = fa.flash_attention_reference(q, k, v, **ref_kw)
    err_o = (o.float() - ro.float()).abs()
    err_lse = (lse - rlse).abs().max().item()
    atol, rtol, latol = (F32_ATOL, F32_ATOL, F32_ATOL) if f32 else (O_ATOL, O_RTOL, LSE_ATOL)
    bound = atol + rtol * ro.float().abs()
    ok = bool((err_o <= bound).all()) and err_lse <= latol
    ok = ok and bool(torch.isfinite(o.float()).all())
    print(
        f"[kernel] {name}: max|o-ref| {err_o.max().item():.3e} "
        f"max|lse-ref| {err_lse:.3e} (tol o {atol}+{rtol}*|ref|, lse {latol}) "
        f"{'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError(f"[{name}] kernel disagrees with the plain version")
    return err_o.max().item()


def phase_kernels() -> dict:
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.ops.flash_attention import NEG_INF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    errs = []
    # (a) the main-path shape: a 2048-row prefill chunk at offset 4096
    # against a whole 16K cache of which 6144 slots are valid
    qa = rnd(1, 2048, 40, 128)
    ka, va = rnd(1, 16384, 8, 128), rnd(1, 16384, 8, 128)
    kw_a = dict(causal=True, q_offset=4096, kv_offset=0, kv_valid_len=6144)
    errs.append(_kernel_case("(a) chunk 2048 @4096 vs cache 16384 len 6144", qa, ka, va, **kw_a))
    # (b) causal self-attention with packed segments
    qb, kb, vb = rnd(2, 4096, 40, 128), rnd(2, 4096, 8, 128), rnd(2, 4096, 8, 128)
    seg = torch.zeros(2, 4096, dtype=torch.int32, device=dev)
    seg[0, 1000:] = 1
    seg[1, 300:] = 1
    seg[1, 2500:] = 2
    errs.append(_kernel_case(
        "(b) causal 2x4096 40/8 heads, segment ids", qb, kb, vb,
        causal=True, q_segment_ids=seg, kv_segment_ids=seg,
    ))
    # (c) non-causal, D = 64, unaligned length (the ViT shape)
    qc, kc, vc = rnd(2, 1025, 16, 64), rnd(2, 1025, 16, 64), rnd(2, 1025, 16, 64)
    errs.append(_kernel_case("(c) non-causal 2x1025 16 heads D64", qc, kc, vc, causal=False))
    # (d) kv_valid_len = 0: every row is empty
    before = fa.flash_attention.launches
    od, lsed = fa.flash_attention(
        qa[:, :256], ka[:, :1024], va[:, :1024], causal=True, kv_valid_len=0,
        return_lse=True,
    )
    torch.cuda.synchronize()
    if fa.flash_attention.launches != before + 1:
        raise AssertionError("[(d)] kernel launch count did not rise by 1")
    if not (bool((od == 0).all()) and bool((lsed == NEG_INF).all())):
        raise AssertionError("[(d)] kv_valid_len=0 must give o = 0, lse = -2^30")
    print("[kernel] (d) kv_valid_len=0: o == 0 and lse == -2^30 ok")
    # (e) the float32 kernel at a small chunk-against-cache shape
    qe, ke, ve = (rnd(1, 300, 8, 128, dtype=torch.float32),
                  rnd(1, 1024, 2, 128, dtype=torch.float32),
                  rnd(1, 1024, 2, 128, dtype=torch.float32))
    _kernel_case("(e) f32 chunk 300 @500 vs cache 1024 len 800", qe, ke, ve, f32=True,
                 causal=True, q_offset=500, kv_valid_len=800)

    kern_ms = _cuda_ms(lambda: fa.flash_attention(qa, ka, va, **kw_a), reps=20)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(qa, ka, va, **kw_a), reps=5)
    pairs = sum(i + 1 for i in range(4096, 4096 + 2048))  # unmasked (q, k) pairs
    tflops = 4 * 40 * 128 * pairs / (kern_ms * 1e-3) / 1e12
    print(
        f"[kernel] (a) timing, median of CUDA events: kernel {kern_ms:.3f} ms "
        f"({tflops:.1f} TFLOP/s on unmasked pairs), plain {plain_ms:.3f} ms"
    )
    return {"max_abs_err": max(errs), "ms": kern_ms, "plain_ms": plain_ms}


def _pair_case(name, kernel, plain, n_counter, *, lse_atol=LSE_ATOL) -> float:
    """Run a kernel (which must launch once) and its plain version on the
    same inputs; hold o to O_ATOL + O_RTOL * |plain| and lse to lse_atol.
    -> max |o err|."""
    import torch

    before = n_counter.launches
    o, lse = kernel()
    torch.cuda.synchronize()
    if n_counter.launches != before + 1:
        raise AssertionError(f"[{name}] kernel launch count did not rise by 1")
    ro, rlse = plain()
    err_o = (o.float() - ro.float()).abs()
    err_lse = (lse - rlse).abs().max().item() if lse.numel() else 0.0
    ok = bool((err_o <= O_ATOL + O_RTOL * ro.float().abs()).all()) and err_lse <= lse_atol
    ok = ok and bool(torch.isfinite(o.float()).all())
    print(f"[kernel] {name}: max|o-ref| {err_o.max().item():.3e} max|lse-ref| {err_lse:.3e} "
          f"(tol o {O_ATOL}+{O_RTOL}*|ref|, lse {lse_atol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{name}] kernel disagrees with the plain version")
    return err_o.max().item()


def phase_kernels_quant() -> dict:
    """K2 at the serving shape: a 2048-row chunk at offset 14336 against an
    int8 cache [1, 32768, 8, 128] with 16384 valid slots, codes and scales
    from quantize_kv of seeded bf16 values; and kv_valid_len = 0."""
    import torch

    from long_vita_tpu_torch.models.qwen2 import quantize_kv
    from long_vita_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q = rnd(1, 2048, 40, 128)
    k, ks = quantize_kv(rnd(1, 32768, 8, 128))
    v, vs = quantize_kv(rnd(1, 32768, 8, 128))
    kw = dict(q_offset=14336, kv_valid_len=16384)
    err = _pair_case(
        "K2 chunk 2048 @14336 vs int8 cache 32768 len 16384",
        lambda: fa.flash_attention_quant(q, k, ks, v, vs, return_lse=True, **kw),
        lambda: fa.flash_attention_quant_reference(q, k, ks, v, vs, **kw),
        fa.flash_attention_quant,
    )
    before = fa.flash_attention_quant.launches
    o0, lse0 = fa.flash_attention_quant(
        q[:, :256], k, ks, v, vs, q_offset=14336, kv_valid_len=0, return_lse=True
    )
    torch.cuda.synchronize()
    if fa.flash_attention_quant.launches != before + 1:
        raise AssertionError("[K2 kv_valid_len=0] kernel launch count did not rise by 1")
    if not (bool((o0 == 0).all()) and bool((lse0 == fa.NEG_INF).all())):
        raise AssertionError("[K2 kv_valid_len=0] must give o = 0, lse = -2^30")
    print("[kernel] K2 kv_valid_len=0: o == 0 and lse == -2^30 ok")
    kern_ms = _cuda_ms(lambda: fa.flash_attention_quant(q, k, ks, v, vs, **kw), reps=20)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_quant_reference(q, k, ks, v, vs, **kw), reps=5)
    pairs = 2048 * 14336 + 2048 * 2049 // 2  # unmasked (q, k) pairs
    tflops = 4 * 40 * 128 * pairs / (kern_ms * 1e-3) / 1e12
    print(f"[kernel] K2 timing, median of CUDA events: kernel {kern_ms:.3f} ms "
          f"({tflops:.1f} TFLOP/s on unmasked pairs), plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms}


def phase_kernels_short() -> dict:
    """K3 at the encode shape, q/k/v as the ViT hands them over (strided
    views of one [64, 1025, 3, 16, 64] qkv projection), and one short
    unaligned case."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = []
    for n, s in ((64, 1025), (3, 257)):
        qkv = torch.randn((n, s, 3, 16, 64), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        errs.append(_pair_case(
            f"K3 [{n}, {s}, 16, 64]",
            lambda: fa.short_attention(q, k, v, return_lse=True),
            lambda: fa.short_attention_reference(q, k, v),
            fa.short_attention,
        ))
        if n == 64:
            kern_ms = _cuda_ms(lambda: fa.short_attention(q, k, v), reps=20)
            plain_ms = _cuda_ms(lambda: fa.short_attention_reference(q, k, v), reps=5)
    tflops = 4 * 64 * 16 * 1025 * 1025 * 64 / (kern_ms * 1e-3) / 1e12
    print(f"[kernel] K3 timing at [64, 1025, 16, 64], median of CUDA events: kernel "
          f"{kern_ms:.3f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms")
    return {"max_abs_err": max(errs), "ms": kern_ms, "plain_ms": plain_ms}


class _Tok:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in ids)


# stand-in ids of the tokens the expansion inserts (<img>, <vid>, their
# context tokens, ...): any ids of the vocabulary do for random weights; 198
# is Qwen2's "\n". The <image>/<video> tags are replaced by the expansion and
# lie past the vocabulary, so no random text id is taken for one.
(IMG_START, IMG_END, IMG_CTX, VID_START, VID_END, VID_CTX, PATCH_START,
 PATCH_END, PATCH_CTX) = range(151670, 151679)
NL = 198
IMG_TAG, VID_TAG = 1_000_000, 1_000_001


class _StubMM:
    """The multimodal tokenizer's interface (expand / tokenizer.decode)
    without tokenizer files, PIL or JAX: token ids in, token ids out, and
    the tag expansion of long_vita_tpu/data/multimodal.py (_block,
    _expand_image, _expand_video) on pre-made tiles. An image is (tiles
    [1 + rows * cols, 448, 448, 3], (rows, cols)), the thumbnail first: a
    thumbnail block, then per grid row a newline and per tile a patch block.
    A video is frames [F, 448, 448, 3]: a vid_start, T context ids and a
    vid_end per frame."""

    tokenizer = _Tok()

    def __init__(self, t: int = 256):
        self.t = t

    def _block(self, ids, start, ctx, end, indices):
        import numpy as np

        ids.append(start)
        seq = np.arange(len(ids), len(ids) + self.t, dtype=np.int64)
        indices.append(np.stack([np.zeros(self.t, np.int64), seq]))
        ids.extend([ctx] * self.t)
        ids.append(end)

    def expand(self, input_ids, images=(), videos=(), max_num_frame=None):
        import types

        import numpy as np

        images, videos = list(images), list(videos)
        ids, stacks, indices = [], [], []
        for tok in input_ids:
            if tok == IMG_TAG:
                tiles, (rows, cols) = images.pop(0)
                stacks.append(tiles)
                self._block(ids, IMG_START, IMG_CTX, IMG_END, indices)
                for _ in range(rows if len(tiles) > 1 else 0):
                    ids.append(NL)
                    for _ in range(cols):
                        self._block(ids, PATCH_START, PATCH_CTX, PATCH_END, indices)
            elif tok == VID_TAG:
                frames = videos.pop(0)
                stacks.append(frames)
                for _ in range(len(frames)):
                    self._block(ids, VID_START, VID_CTX, VID_END, indices)
            else:
                ids.append(int(tok))
        if not stacks:
            return types.SimpleNamespace(input_ids=ids, images=None, image_indices=None)
        return types.SimpleNamespace(
            input_ids=ids, images=np.concatenate(stacks), image_indices=np.stack(indices, 1)
        )


def _plain_chunked_last_row(text, tc, ids, chunk, max_seq, *, feats=None,
                            indices=None, quantize=False):
    """engine.prefill's flow (chunks against a cache, then the last row
    decode-style) with attention forced to the plain versions. With feats,
    the tile features are merged into the embeddings first, where the
    engine's per-chunk scatter puts them; quantize: an int8 cache."""
    import dataclasses

    import torch

    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.models.long_vita import merge_image_embeddings

    dev = text.embed.device
    n = len(ids)
    padded = -(-n // chunk) * chunk
    ids_t = torch.zeros((1, padded), dtype=torch.long, device=dev)
    ids_t[0, :n] = torch.as_tensor(ids, device=dev)
    embeds = qwen2.embed_tokens(text, ids_t)
    if feats is not None:
        embeds = merge_image_embeddings(embeds, feats, torch.as_tensor(indices, device=dev))
    cache = qwen2.KVCache.zeros(
        tc, 1, -(-max_seq // chunk) * chunk, device=dev, quantize=quantize
    )
    for start in range(0, padded, chunk):
        pos = start + torch.arange(chunk, device=dev)[None]
        _, cache = qwen2.qwen2_decoder(
            text, embeds[:, start : start + chunk], pos, tc, kv_cache=cache, attn_impl="xla"
        )
    hidden, _ = qwen2.qwen2_decoder(
        text, qwen2.embed_tokens(text, ids_t[:, n - 1 : n]),
        torch.full((1, 1), n - 1, device=dev), tc,
        kv_cache=dataclasses.replace(cache, length=n - 1), attn_impl="xla",
    )
    return hidden[:, -1]


def _text_params(cfg, dev):
    """The full Qwen2.5-14B decoder with random bf16 weights (seed SEED)."""
    import torch

    from long_vita_tpu_torch.models import qwen2

    tc = cfg.text
    t0 = time.perf_counter()
    params = qwen2.init_qwen2_params(
        torch.Generator(device=dev).manual_seed(SEED), tc, dtype=torch.bfloat16, device=dev
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(
        f"[serve] Qwen2.5-14B decoder: {tc.num_hidden_layers} layers, hidden "
        f"{tc.hidden_size}, {tc.num_attention_heads}/{tc.num_key_value_heads} heads, "
        f"vocab {tc.vocab_size}; {n_params / 1e9:.3f} B random bf16 params "
        f"(seed {SEED}) built in {time.perf_counter() - t0:.1f} s"
    )
    return params


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _check_launches(counts: dict, expected: dict) -> None:
    print(f"[counts] launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(
            "the main path did not launch each kernel once per layer and chunk "
            "(or encode batch) it needs"
        )


def _logit_check(tag, name, logits, ref) -> bool:
    import torch.nn.functional as F

    cos = F.cosine_similarity(logits, ref, dim=-1).item()
    max_abs = (logits - ref).abs().max().item()
    spread = (ref.max() - ref.min()).item()
    good = cos >= LOGIT_COS and max_abs <= LOGIT_SPREAD_FRAC * spread
    print(f"[{tag}] last-row logits, {name}: cosine {cos:.6f} (>= {LOGIT_COS}), "
          f"max|diff| {max_abs:.4f} (<= {LOGIT_SPREAD_FRAC} x spread {spread:.3f}) "
          f"{'ok' if good else 'FAIL'}")
    return good


def phase_serving(params) -> int:
    """Text serving. -> K1 launches made by the serving requests."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_14b
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.models import qwen2

    cfg = long_vita_14b()
    tc = cfg.text
    dev = torch.device("cuda")
    chunk, max_seq = 2048, 16384
    engine = InferenceEngine(params, cfg, _StubMM(), max_seq_len=max_seq, chunk=chunk)
    rng = np.random.default_rng(SEED)
    vocab = tc.vocab_size
    prompt = rng.integers(0, vocab, 5000).tolist()  # not a chunk multiple
    batch = [{"input_ids": rng.integers(0, vocab, n).tolist()} for n in (700, 2100, 4000)]
    sampled_prompt = rng.integers(0, vocab, 1500).tolist()
    greedy = SamplingParams(max_new_tokens=32)

    def chunks(n):
        return -(-n // chunk)

    # ---- the main path: requests through the engine's public entry points
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first, t_first = _timed(lambda: engine.generate(input_ids=prompt, sampling=greedy))
    again, t_again = _timed(lambda: engine.generate(input_ids=prompt, sampling=greedy))
    batched, t_batch = _timed(lambda: engine.generate_batch(
        batch, sampling=SamplingParams(max_new_tokens=16)
    ))
    sampled, _ = _timed(lambda: engine.generate(
        input_ids=sampled_prompt, seed=1,
        sampling=SamplingParams(greedy=False, temperature=0.7, top_p=0.9, max_new_tokens=16),
    ))
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_chunks = 2 * chunks(len(prompt)) + chunks(4000) + chunks(len(sampled_prompt))
    print(f"[serve] expected flash_fwd launches: {tc.num_hidden_layers} layers x "
          f"{n_chunks} prefill chunks")
    _check_launches(counts, {
        "flash_fwd": tc.num_hidden_layers * n_chunks, "flash_fwd_quant": 0, "short_attn": 0,
    })
    launches = counts["flash_fwd"]
    if first.token_ids != again.token_ids:
        raise AssertionError(f"repeat greedy generate differs: {first.token_ids} vs {again.token_ids}")
    outs = [first, again, *batched, sampled]
    if not all(r.token_ids and all(0 <= t < vocab for t in r.token_ids) for r in outs):
        raise AssertionError("empty output or token id outside [0, vocab)")
    print(f"[serve] greedy x2 identical ({len(first.token_ids)} tokens): {first.token_ids[:8]} ...")
    print(f"[serve] generate_batch 700/2100/4000 ids -> {[len(r.token_ids) for r in batched]} "
          f"tokens in {t_batch:.2f} s; sampled (T 0.7, top-p 0.9) -> {sampled.token_ids[:8]} ...")

    # ---- timings of the solo request (warm): TTFT = prefill + first token
    (cache, hidden, _), t_prefill = _timed(lambda: engine.prefill(prompt))
    _, t_head = _timed(lambda: qwen2.lm_head(params, hidden).argmax(-1))
    ttft = t_prefill + t_head
    decode_ms = (t_again - ttft) / (len(again.token_ids) - 1) * 1e3
    print(
        f"[serve] solo 5000-id prompt, 32 greedy tokens: TTFT {ttft * 1e3:.1f} ms "
        f"(prefill {len(prompt) / t_prefill:.0f} prompt tokens/s over "
        f"{chunks(len(prompt))} chunks of {chunk}), generate {t_again:.2f} s "
        f"(first call {t_first:.2f} s), decode {decode_ms:.2f} ms/token; "
        f"peak allocated {peak_gb:.2f} GB"
    )

    # ---- the kernel path's last-row logits (engine.prefill: flash chunks,
    # then the decode-style last row) against (i) a no-cache forward of the
    # same 5000 ids through the plain attention and (ii) the same chunked
    # flow with the plain attention, which isolates the kernel
    logits = qwen2.lm_head(params, hidden)
    del cache, hidden
    ids = torch.as_tensor([prompt], device=dev)
    ref_hidden, _ = qwen2.qwen2_decoder(
        params, qwen2.embed_tokens(params, ids), torch.arange(len(prompt), device=dev)[None],
        tc, attn_impl="xla",
    )
    nocache = qwen2.lm_head(params, ref_hidden[:, -1])
    del ref_hidden
    chunked = qwen2.lm_head(params, _plain_chunked_last_row(params, tc, prompt, chunk, max_seq))
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (1, vocab)
    for name, ref in (("plain no-cache forward", nocache), ("plain chunked prefill", chunked)):
        ok = _logit_check("serve", f"kernel path vs {name}", logits, ref) and ok
    if not ok:
        raise AssertionError("kernel-path logits disagree with the plain forward")
    return launches


def _encode_batches(n: int, transfer_chunk: int, vision_chunk: int) -> int:
    """ViT batches the engine's encode of n tiles runs (pieces of
    transfer_chunk tiles, padded, when n exceeds one piece)."""
    if n <= transfer_chunk:
        return -(-n // vision_chunk)
    return -(-n // transfer_chunk) * -(-transfer_chunk // vision_chunk)


def phase_multimodal(
    text_params, cfg, dev, *, n_frames=64, batch_frames=16, grid=(2, 3),
    chunk=2048, max_seq=32768, vision_chunk=64, new_tokens=16,
) -> dict:
    """Image and video serving at full width. -> launch counts of the run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.models.intern_vit import init_vit_params
    from long_vita_tpu_torch.models.long_vita import LongVITAParams, encode_images
    from long_vita_tpu_torch.models.projector import init_projector_params

    vc, tc = cfg.vision, cfg.text
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    lv = LongVITAParams(
        text=text_params,
        vision=init_vit_params(gen, vc, torch.bfloat16, dev),
        projector=init_projector_params(gen, cfg, torch.bfloat16, dev),
    )
    n_vis = sum(p.numel() for p in lv.vision.parameters())
    n_proj = sum(p.numel() for p in lv.projector.parameters())
    rng = np.random.default_rng(SEED)

    def tiles(n):
        return rng.standard_normal((n, vc.image_size, vc.image_size, 3), dtype=np.float32)

    # a trained projector maps into the embedding space; the random one's
    # rows come out ~20x the embedding table's scale, and 16K such rows swamp
    # the prompt. Its second matrix is scaled so that the features of two
    # probe tiles have the table's standard deviation.
    probe = encode_images(lv, torch.from_numpy(tiles(2)).to(dev, torch.bfloat16), cfg)
    ratio = (text_params.embed.float().std() / probe.float().std()).item()
    lv.projector.fc2.weight.mul_(ratio)

    def text(n):
        return rng.integers(0, 151643, n).tolist()

    video, short_video = tiles(n_frames), tiles(batch_frames)
    image = (tiles(1 + grid[0] * grid[1]), grid)
    print(f"[mm] InternViT-300M ({vc.num_hidden_layers} layers, hidden {vc.hidden_size}, "
          f"{vc.num_attention_heads} heads, {vc.seq_len} tokens a tile) {n_vis / 1e6:.1f} M and "
          f"projector {n_proj / 1e6:.1f} M random bf16 params (seed {SEED + 1}; projector "
          f"output scaled by {ratio:.4f} to the embedding table's std), seeded f32 pixels: "
          f"built in {time.perf_counter() - t0:.1f} s")

    mm = _StubMM(cfg.image_token_length)
    req_i = [*text(20), VID_TAG, *text(20)]
    reqs_ii = [
        {"input_ids": [*text(20), IMG_TAG, *text(20)], "images": [image]},
        {"input_ids": [*text(20), VID_TAG, *text(20)], "videos": [short_video]},
    ]
    x = mm.expand(req_i, videos=[video])
    n_i = len(x.input_ids)
    lens_ii = [
        len(mm.expand(r["input_ids"], r.get("images", ()), r.get("videos", ())).input_ids)
        for r in reqs_ii
    ]
    kw = dict(max_seq_len=max_seq, chunk=chunk, vision_chunk=vision_chunk)
    eng_q = InferenceEngine(lv, cfg, mm, kv_quant=True, **kw)
    eng_b = InferenceEngine(lv, cfg, mm, **kw)
    greedy = SamplingParams(max_new_tokens=new_tokens)

    # ---- the main path: requests through the engine's public entry points
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first, t_first = _timed(lambda: eng_q.generate(input_ids=req_i, videos=[video], sampling=greedy))
    again, t_again = _timed(lambda: eng_q.generate(input_ids=req_i, videos=[video], sampling=greedy))
    batched, t_batch = _timed(lambda: eng_q.generate_batch(reqs_ii, sampling=greedy))
    bf16, t_bf16 = _timed(lambda: eng_b.generate(input_ids=req_i, videos=[video], sampling=greedy))
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_layers, n_vit = tc.num_hidden_layers, vc.num_hidden_layers
    tc_tiles = eng_q.transfer_chunk

    def chunks(n):
        return -(-n // chunk)

    enc_i = _encode_batches(n_frames, tc_tiles, vision_chunk)
    enc_ii = _encode_batches(1 + grid[0] * grid[1] + batch_frames, tc_tiles, vision_chunk)
    print(f"[mm] (i) {n_frames}-frame video, {n_i} tokens ({chunks(n_i)} chunks of {chunk}); "
          f"(ii) batch of a {1 + grid[0] * grid[1]}-tile image and a {batch_frames}-frame "
          f"video, {lens_ii} tokens ({chunks(max(lens_ii))} chunks); (iii) = (i), bf16 cache")
    _check_launches(counts, {
        "flash_fwd": n_layers * chunks(n_i),
        "flash_fwd_quant": n_layers * (2 * chunks(n_i) + chunks(max(lens_ii))),
        "short_attn": n_vit * (3 * enc_i + enc_ii),
    })
    if first.token_ids != again.token_ids:
        raise AssertionError(f"repeat greedy generate differs: {first.token_ids} vs {again.token_ids}")
    outs = [first, again, *batched, bf16]
    if not all(r.token_ids and all(0 <= t < tc.vocab_size for t in r.token_ids) for r in outs):
        raise AssertionError("empty output or token id outside [0, vocab)")
    if [r.prompt_tokens for r in outs] != [n_i, n_i, *lens_ii, n_i]:
        raise AssertionError("prompt lengths differ from the expansion's")
    print(f"[mm] (i) int8 cache, greedy x2 identical ({len(first.token_ids)} tokens, "
          f"{len(set(first.token_ids))} distinct): "
          f"{first.token_ids[:8]} ... in {t_first:.2f} / {t_again:.2f} s; (ii) -> "
          f"{[len(r.token_ids) for r in batched]} tokens in {t_batch:.2f} s; (iii) bf16 cache "
          f"-> {bf16.token_ids[:8]} ... in {t_bf16:.2f} s; peak allocated {peak_gb:.2f} GB")

    # ---- timings (warm): encode, TTFT = prefill (encode included) + head
    feats, t_enc = _timed(lambda: eng_q._encode_images_host(x.images))
    (cache, hid_q, _), t_pre_q = _timed(lambda: eng_q.prefill(x.input_ids, x.images, x.image_indices))
    del cache
    logits_q, t_head_q = _timed(lambda: qwen2.lm_head(text_params, hid_q))
    (cache, hid_b, _), t_pre_b = _timed(lambda: eng_b.prefill(x.input_ids, x.images, x.image_indices))
    del cache
    logits_b, t_head_b = _timed(lambda: qwen2.lm_head(text_params, hid_b))
    ttft_q, ttft_b = t_pre_q + t_head_q, t_pre_b + t_head_b
    decode_ms = (t_again - ttft_q) / (len(again.token_ids) - 1) * 1e3
    print(f"[mm] ViT encode of {n_frames} frames (host cast + copy + {enc_i} batch(es) of "
          f"{vision_chunk}): {t_enc * 1e3:.1f} ms = {n_frames / t_enc:.1f} frames/s; TTFT (i) "
          f"int8 cache {ttft_q * 1e3:.1f} ms ({n_i / t_pre_q:.0f} prompt tokens/s), (iii) bf16 "
          f"cache {ttft_b * 1e3:.1f} ms; decode with the int8 cache {decode_ms:.2f} ms/token")

    # ---- the kernel path against the same flow on the plain versions
    pixels = torch.from_numpy(x.images).to(torch.bfloat16).to(dev)
    plain_feats = encode_images(lv, pixels, cfg, chunk=vision_chunk, attn_impl="xla")
    del pixels
    diff = (feats.float() - plain_feats.float()).reshape(-1, feats.shape[-1])
    ref = plain_feats.float().reshape(-1, feats.shape[-1])
    rel = (diff.norm() / ref.norm()).item()
    row_cos = F.cosine_similarity(feats.float().reshape(-1, feats.shape[-1]), ref, dim=-1).min().item()
    good_feats = rel <= FEAT_REL_ERR and row_cos >= FEAT_ROW_COS
    print(f"[mm] encoded features, K3 vs the plain ViT attention: relative error {rel:.3e} "
          f"(<= {FEAT_REL_ERR}), worst row cosine {row_cos:.6f} (>= {FEAT_ROW_COS}) "
          f"{'ok' if good_feats else 'FAIL'}")
    del feats
    plain_hidden = _plain_chunked_last_row(
        text_params, tc, x.input_ids, chunk, max_seq, feats=plain_feats,
        indices=x.image_indices, quantize=True,
    )
    plain_logits = qwen2.lm_head(text_params, plain_hidden)
    ok = bool(torch.isfinite(logits_q).all()) and logits_q.shape == (1, tc.vocab_size)
    ok = _logit_check("mm", "K3 + K2 path vs the plain ViT attention + plain int8 prefill",
                      logits_q, plain_logits) and ok
    cos_qb = F.cosine_similarity(logits_q, logits_b, dim=-1).item()
    print(f"[mm] (for the record) last-row logits, int8 cache (i) vs bf16 cache (iii): "
          f"cosine {cos_qb:.6f}")
    if not (ok and good_feats):
        raise AssertionError("the kernel path disagrees with the plain versions")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    from long_vita_tpu_torch.config import long_vita_14b

    phase_build()
    kern = {
        "flash_fwd": phase_kernels(),
        "flash_fwd_quant": phase_kernels_quant(),
        "short_attn": phase_kernels_short(),
    }
    cfg, dev = long_vita_14b(), torch.device("cuda")
    params = _text_params(cfg, dev)
    launches = dict.fromkeys(SOURCES, 0)
    launches["flash_fwd"] = phase_serving(params)
    for name, n in phase_multimodal(params, cfg, dev).items():
        launches[name] += n
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **kern[name]}
        for name, (src, replaces) in SOURCES.items()
    ]}
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
