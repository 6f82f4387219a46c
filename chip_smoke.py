#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (long_vita_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. build the CUDA kernel library from the sources in this checkout;
  2. hold the flash-forward kernel against its plain PyTorch version on the
     card at the serving shapes, with stated tolerances, and time it;
  3. serve the full-width, full-depth Qwen2.5-14B text decoder (random bf16
     weights from a seeded generator) through InferenceEngine: greedy
     generate twice, a ragged generate_batch and a sampled request, counting
     the kernel's launches; then compare the prefill's last-row logits with
     a no-cache forward through the plain attention.

The last two lines of stdout are the kernel report and
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result.
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


def phase_build() -> None:
    from long_vita_tpu_torch.ops import _build
    from long_vita_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa.build()
    print(f"[build] flash_fwd built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("flash_fwd").splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "error")):
            print(f"[build] {line.strip()}")


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


class _Tok:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in ids)


class _StubMM:
    """Token ids in, token ids out: the multimodal tokenizer interface
    (expand / tokenizer.decode) without tokenizer files."""

    tokenizer = _Tok()

    def expand(self, input_ids, images=(), videos=(), max_num_frame=None):
        import types

        return types.SimpleNamespace(
            input_ids=list(input_ids), images=None, image_indices=None
        )


def _plain_chunked_last_row(params, tc, ids, chunk, max_seq):
    """engine.prefill's flow (chunks against a cache, then the last row
    decode-style) with attention forced to the plain version."""
    import torch

    from long_vita_tpu_torch.models import qwen2

    n = ids.shape[1]
    padded = -(-n // chunk) * chunk
    cache = qwen2.KVCache.zeros(tc, 1, -(-max_seq // chunk) * chunk, device=ids.device)
    ids = torch.nn.functional.pad(ids, (0, padded - n))
    for start in range(0, padded, chunk):
        pos = start + torch.arange(chunk, device=ids.device)[None]
        _, cache = qwen2.qwen2_decoder(
            params, qwen2.embed_tokens(params, ids[:, start : start + chunk]), pos, tc,
            kv_cache=cache, attn_impl="xla",
        )
    hidden, _ = qwen2.qwen2_decoder(
        params, qwen2.embed_tokens(params, ids[:, n - 1 : n]),
        torch.full((1, 1), n - 1, device=ids.device), tc,
        kv_cache=qwen2.KVCache(cache.k, cache.v, n - 1), attn_impl="xla",
    )
    return hidden[:, -1]


def phase_serving() -> int:
    """-> flash kernel launches made by the serving requests."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.config import long_vita_14b
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.ops import flash_attention as fa

    cfg = long_vita_14b()
    tc = cfg.text
    dev = torch.device("cuda")
    chunk, max_seq = 2048, 16384
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
    engine = InferenceEngine(params, cfg, _StubMM(), max_seq_len=max_seq, chunk=chunk)
    rng = np.random.default_rng(SEED)
    vocab = tc.vocab_size
    prompt = rng.integers(0, vocab, 5000).tolist()  # not a chunk multiple
    batch = [{"input_ids": rng.integers(0, vocab, n).tolist()} for n in (700, 2100, 4000)]
    sampled_prompt = rng.integers(0, vocab, 1500).tolist()
    greedy = SamplingParams(max_new_tokens=32)

    def chunks(n):
        return -(-n // chunk)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # ---- the main path: requests through the engine's public entry points
    fa.flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    first, t_first = timed(lambda: engine.generate(input_ids=prompt, sampling=greedy))
    again, t_again = timed(lambda: engine.generate(input_ids=prompt, sampling=greedy))
    batched, t_batch = timed(lambda: engine.generate_batch(
        batch, sampling=SamplingParams(max_new_tokens=16)
    ))
    sampled, _ = timed(lambda: engine.generate(
        input_ids=sampled_prompt, seed=1,
        sampling=SamplingParams(greedy=False, temperature=0.7, top_p=0.9, max_new_tokens=16),
    ))
    launches = fa.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_chunks = 2 * chunks(len(prompt)) + chunks(4000) + chunks(len(sampled_prompt))
    expected = tc.num_hidden_layers * n_chunks
    print(f"[serve] flash launches {launches}, expected {tc.num_hidden_layers} layers x "
          f"{n_chunks} prefill chunks = {expected}")
    if launches != expected:
        raise AssertionError("the prefill did not go through the flash kernel once per layer and chunk")
    if first.token_ids != again.token_ids:
        raise AssertionError(f"repeat greedy generate differs: {first.token_ids} vs {again.token_ids}")
    outs = [first, again, *batched, sampled]
    if not all(r.token_ids and all(0 <= t < vocab for t in r.token_ids) for r in outs):
        raise AssertionError("empty output or token id outside [0, vocab)")
    print(f"[serve] greedy x2 identical ({len(first.token_ids)} tokens): {first.token_ids[:8]} ...")
    print(f"[serve] generate_batch 700/2100/4000 ids -> {[len(r.token_ids) for r in batched]} "
          f"tokens in {t_batch:.2f} s; sampled (T 0.7, top-p 0.9) -> {sampled.token_ids[:8]} ...")

    # ---- timings of the solo request (warm): TTFT = prefill + first token
    (cache, hidden, _), t_prefill = timed(lambda: engine.prefill(prompt))
    _, t_head = timed(lambda: qwen2.lm_head(params, hidden).argmax(-1))
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
    chunked = qwen2.lm_head(params, _plain_chunked_last_row(params, tc, ids, chunk, max_seq))
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (1, vocab)
    for name, ref in (("plain no-cache forward", nocache), ("plain chunked prefill", chunked)):
        cos = F.cosine_similarity(logits, ref, dim=-1).item()
        max_abs = (logits - ref).abs().max().item()
        spread = (ref.max() - ref.min()).item()
        good = cos >= LOGIT_COS and max_abs <= LOGIT_SPREAD_FRAC * spread
        ok = ok and good
        print(f"[serve] last-row logits, kernel path vs {name}: cosine {cos:.6f} "
              f"(>= {LOGIT_COS}), max|diff| {max_abs:.4f} (<= {LOGIT_SPREAD_FRAC} x spread "
              f"{spread:.3f}) {'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel-path logits disagree with the plain forward")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    phase_build()
    kern = phase_kernels()
    launches = phase_serving()
    report = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "long_vita_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "long_vita_tpu/ops/flash_attention.py:144",
        "launches": launches,
        **kern,
    }]}
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
