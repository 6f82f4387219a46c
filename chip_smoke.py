#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (long_vita_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. build the five CUDA sources from this checkout (one nvcc each, in
     parallel) and print nvcc's register/spill lines;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving and training paths give it, with stated tolerances,
     and time both with CUDA events: K1 the flash forward, K2 the int8 flash
     forward, K3 the ViT's short attention, K4 the one-pass flash backward,
     K5 the two-pass flash backward (its dkv and dq entry points);
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
     plain versions;
  5. T1, stage-1 alignment at 32K (configs/stage1_alignment.yaml's regime):
     the same decoder and a random tower and projector, text and vision
     frozen, the projector trained at lr 1e-3, full remat, through
     Trainer.train for 2 steps on one packed row of a 64-frame video, a
     16-frame video, a 7-tile image and text; the backward takes K5. The
     loss must fall, the projector move and the frozen weights stay
     bit-identical; launch counts are checked per step;
  6. T2, a trainable tower at 16K: text frozen, the tower (lr x 0.1) and
     projector trained, 2 steps on a 16-frame video, a 7-tile image and
     text; the backward takes K4 in the decoder and the tower. Then the
     trainable gradients of one step at 4096 tokens through the kernels are
     held against the same step on the plain attention, and the same gate
     must reject the step with a fault planted in the decoder's K4.

The card's nvidia-smi line is the first line of stdout and is repeated
before the last two, which are the kernel report and {"ok": true, "device":
{...}}. Without a CUDA device the script exits 1 and prints no result.
"""
from __future__ import annotations

import json
import logging
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
# bf16 backward kernel vs the plain backward: both round p and dS to bf16 at
# the same points but from f32 logits summed in another order, so a rounding
# can flip; each gradient sums thousands of such products. Held elementwise
# to GRAD_TOL x max|ref| absolute + GRAD_TOL relative (measured on the H100
# at 0.1-0.3% of max|ref|).
GRAD_TOL = 1e-2
# T2: the trainable gradients of one step through the kernels vs the same
# step on the plain attention, 48 bf16 layers of random weights: cosine of
# the flattened gradients and the relative loss difference. Measured on an
# H100: sound runs 0.9948-0.9961; each bf16 path lands at 0.9963 against
# the same step in f32, so the gap is bf16 rounding at different points,
# amplified by 72 random layers (K4's dQ atomics in another order alone give
# 0.9998). Dropping one kv tile's dQ, or its dK and dV, in the decoder's K4
# reads 0.915-0.960, and the gate sits between. A fault in the tower's
# backward moves nothing this can see (random ViT weights give near-uniform
# attention, so dS is small); the kernel phase's elementwise check is the
# tower's guard.
TRAIN_GRAD_COS, TRAIN_LOSS_REL = 0.99, 1e-2
# entry point -> (source, the Pallas kernel it replaces)
SOURCES = {
    "flash_fwd": ("long_vita_tpu_torch/ops/csrc/flash_fwd.cu",
                  "long_vita_tpu/ops/flash_attention.py:144"),
    "flash_fwd_quant": ("long_vita_tpu_torch/ops/csrc/flash_fwd_quant.cu",
                        "long_vita_tpu/ops/flash_attention.py:261"),
    "short_attn": ("long_vita_tpu_torch/ops/csrc/short_attn.cu",
                   "long_vita_tpu/ops/flash_attention.py:1192"),
    "flash_bwd": ("long_vita_tpu_torch/ops/csrc/flash_bwd.cu",
                  "long_vita_tpu/ops/flash_attention.py:588"),
    "flash_bwd_dkv": ("long_vita_tpu_torch/ops/csrc/flash_bwd_2pass.cu",
                      "long_vita_tpu/ops/flash_attention.py:454"),
    "flash_bwd_dq": ("long_vita_tpu_torch/ops/csrc/flash_bwd_2pass.cu",
                     "long_vita_tpu/ops/flash_attention.py:530"),
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
    """The kernels' wrappers, whose ``launches`` count kernel launches."""
    from long_vita_tpu_torch.ops import flash_attention as fa

    return {
        "flash_fwd": fa.flash_attention,
        "flash_fwd_quant": fa.flash_attention_quant,
        "short_attn": fa.short_attention,
        "flash_bwd": fa.flash_bwd_fused,
        "flash_bwd_dkv": fa.flash_bwd_dkv,
        "flash_bwd_dq": fa.flash_bwd_dq,
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
    print(f"[build] {', '.join(fa.SOURCES)} built (in parallel) and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in fa.SOURCES:
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


def _segments(b, s, cuts, dev):
    import torch

    seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
    for c in cuts:
        seg[:, c:] += 1
    return seg


def _grad_errs(name, got, ref) -> list:
    """Hold each gradient to GRAD_TOL x max|ref| + GRAD_TOL x |ref|;
    -> [max |err| of dq, dk, dv]."""
    import torch

    errs, ok = [], True
    for g, r in zip(got, ref):
        err = (g.float() - r.float()).abs()
        scale = r.float().abs().max().item()
        ok = ok and bool((err <= GRAD_TOL * scale + GRAD_TOL * r.float().abs()).all())
        ok = ok and bool(torch.isfinite(g.float()).all()) and g.shape == r.shape
        errs.append(err.max().item())
    print(f"[kernel] {name}: max|d-ref| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
          f"(tol {GRAD_TOL} x max|ref| + {GRAD_TOL} x |ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{name}] backward kernel disagrees with the plain backward")
    return errs


def phase_kernels_bwd() -> dict:
    """K4 and K5 against the plain backward: the decoder's training shape at
    4096 tokens ([1, 4096, 40/8, 128], causal, 3 segments; K5 called
    directly, since JAX's rule picks K4 there) and K4 at the ViT's [16, 1025,
    16, 64] non-causal. Each entry point and the plain backward timed with
    CUDA events, then K4 at 16K and K5 at 32K alone, the shapes T2 and T1
    give them."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def operands(s):
        q, k, v, do = rnd(1, s, 40, 128), rnd(1, s, 8, 128), rnd(1, s, 8, 128), rnd(1, s, 40, 128)
        seg = _segments(1, s, (s // 4, 5 * s // 8), dev)
        kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        return q, k, v, o, lse, do, kw

    def run(fused, counter, entries, q, k, v, o, lse, do, **kw):
        """K4 (fused) or K5, forced whatever JAX's rule picks at the shape."""
        before = [e.launches for e in entries]
        got = fa._flash_bwd_cuda(q, k, v, o, lse, do, kw["causal"], 0, 0, k.shape[1],
                                 kw.get("q_segment_ids"), kw.get("kv_segment_ids"), fused)
        torch.cuda.synchronize()
        if [e.launches for e in entries] != [n + 1 for n in before]:
            raise AssertionError(f"[{counter}] kernel launch count did not rise by 1")
        return got

    q, k, v, o, lse, do, kw = operands(4096)
    if not fa.bwd_uses_fused(1, 4096, 4096, 40, 128, 2):
        raise AssertionError("JAX's rule takes the one-pass backward at 4096 tokens")
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    k4 = _grad_errs("K4 [1, 4096, 40/8, 128] causal, 3 segments",
                    run(True, "K4", [fa.flash_bwd_fused], q, k, v, o, lse, do, **kw), ref)
    k5 = _grad_errs("K5 [1, 4096, 40/8, 128] causal, 3 segments",
                    run(False, "K5", [fa.flash_bwd_dkv, fa.flash_bwd_dq], q, k, v, o, lse, do, **kw),
                    ref)
    del ref
    a4 = fa.bwd_operands(q, k, v, o, lse, do, True, 0, 0, 4096, kw["q_segment_ids"],
                         kw["kv_segment_ids"], True)
    a5 = fa.bwd_operands(q, k, v, o, lse, do, True, 0, 0, 4096, kw["q_segment_ids"],
                         kw["kv_segment_ids"], False)
    k4_ms = _cuda_ms(lambda: fa.flash_bwd_fused(a4), reps=10)
    dkv_ms = _cuda_ms(lambda: fa.flash_bwd_dkv(a5), reps=10)
    dq_ms = _cuda_ms(lambda: fa.flash_bwd_dq(a5), reps=10)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw), reps=3)
    flops = 2.5 * 4 * 40 * 128 * 4096 * 4096 / 2  # fwd-equivalent x 2.5, causal half
    print(f"[kernel] backward timing at [1, 4096, 40/8, 128], median of CUDA events: K4 "
          f"{k4_ms:.3f} ms ({flops / k4_ms / 1e9:.1f} TFLOP/s on the causal half), K5 dkv "
          f"{dkv_ms:.3f} + dq {dq_ms:.3f} ms, plain backward {plain_ms:.3f} ms")
    del q, k, v, o, lse, do, a4, a5

    qkv = rnd(16, 1025, 3, 16, 64)
    qv, kv_, vv = qkv.unbind(2)
    dov = rnd(16, 1025, 16, 64)
    ov, lsev = fa.short_attention(qv, kv_, vv, return_lse=True)
    if not fa.bwd_uses_fused(16, 1025, 1025, 16, 64, 2):
        raise AssertionError("JAX's rule takes the one-pass backward for the ViT")
    refv = fa.flash_attention_bwd_reference(qv, kv_, vv, ov, lsev, dov, causal=False)
    vit = _grad_errs("K4 [16, 1025, 16, 64] non-causal (the ViT)",
                     run(True, "K4", [fa.flash_bwd_fused], qv, kv_, vv, ov, lsev, dov,
                         causal=False), refv)
    del qkv, refv

    for s, fused in ((16384, True), (32768, False)):
        if fa.bwd_uses_fused(1, s, s, 40, 128, 2) is not fused:
            raise AssertionError(f"JAX's rule at {s} tokens is not {'K4' if fused else 'K5'}")
        q, k, v, o, lse, do, kw = operands(s)
        ms = _cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw), reps=3)
        fwd_ms = _cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=3)
        flops = 2.5 * 4 * 40 * 128 * s * s / 2
        print(f"[kernel] {'K4' if fused else 'K5'} alone at [1, {s}, 40/8, 128] causal, 3 "
              f"segments: {ms:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s on the causal half); "
              f"K1 forward {fwd_ms:.2f} ms")
        del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return {
        "flash_bwd": {"max_abs_err": max(k4 + vit), "ms": k4_ms, "plain_ms": plain_ms},
        "flash_bwd_dkv": {"max_abs_err": max(k5[1:]), "ms": dkv_ms, "plain_ms": plain_ms},
        "flash_bwd_dq": {"max_abs_err": k5[0], "ms": dq_ms, "plain_ms": plain_ms},
    }


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
    """Kernels missing from ``expected`` must not have launched."""
    expected = {**dict.fromkeys(counts, 0), **expected}
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


def _vlm_params(text_params, cfg, dev, seed, probe_tiles):
    """The decoder with a random InternViT-300M and projector (bf16, from
    ``seed``). A trained projector maps into the embedding space; the random
    one's rows come out ~20x the embedding table's scale, and 16K such rows
    swamp the prompt. Its second matrix is scaled so that the features of the
    probe tiles have the table's standard deviation. -> (params, scale)."""
    import torch

    from long_vita_tpu_torch.models.intern_vit import init_vit_params
    from long_vita_tpu_torch.models.long_vita import LongVITAParams, encode_images
    from long_vita_tpu_torch.models.projector import init_projector_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    lv = LongVITAParams(
        text=text_params,
        vision=init_vit_params(gen, cfg.vision, torch.bfloat16, dev),
        projector=init_projector_params(gen, cfg, torch.bfloat16, dev),
    )
    with torch.no_grad():
        probe = encode_images(lv, torch.from_numpy(probe_tiles).to(dev, torch.bfloat16), cfg)
        ratio = (text_params.embed.float().std() / probe.float().std()).item()
        lv.projector.fc2.weight.mul_(ratio)
    return lv, ratio


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
    from long_vita_tpu_torch.models.long_vita import encode_images

    vc, tc = cfg.vision, cfg.text
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)

    def tiles(n):
        return rng.standard_normal((n, vc.image_size, vc.image_size, 3), dtype=np.float32)

    lv, ratio = _vlm_params(text_params, cfg, dev, SEED + 1, tiles(2))
    n_vis = sum(p.numel() for p in lv.vision.parameters())
    n_proj = sum(p.numel() for p in lv.projector.parameters())

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


def _train_pack(cfg, seq_len, videos, images, rng, *, text_segments, answer=300,
                text_sup=700):
    """One packed training row of seq_len tokens, as the data pipeline packs
    samples: a sample per video (frames [F, 448, 448, 3]) and per image
    ((tiles, (rows, cols))), each a 30-token prompt around the media and a
    supervised answer of ``answer`` tokens, then ``text_segments`` text-only
    samples filling the row with their last ``text_sup`` tokens supervised.
    Positions restart per sample; tiles are concatenated in order."""
    import numpy as np

    from long_vita_tpu_torch.training.loss import IGNORE_INDEX, Pack

    mm = _StubMM(cfg.image_token_length)

    def text(n):  # ids below Qwen2's first special token
        return rng.integers(0, min(151643, cfg.text.vocab_size), n).tolist()

    samples = []  # (ids, labels, tiles, image_indices)
    for tag, media in [(VID_TAG, v) for v in videos] + [(IMG_TAG, i) for i in images]:
        x = mm.expand([*text(15), tag, *text(15)],
                      images=[media] if tag == IMG_TAG else (),
                      videos=[media] if tag == VID_TAG else ())
        ans = text(answer)
        samples.append((x.input_ids + ans, [IGNORE_INDEX] * len(x.input_ids) + ans,
                        x.images, x.image_indices))
    rest = seq_len - sum(len(smp[0]) for smp in samples)
    sizes = [rest // text_segments] * text_segments
    sizes[-1] += rest - sum(sizes)
    for n in sizes:
        ids = text(n)
        samples.append((ids, [IGNORE_INDEX] * (n - text_sup) + ids[n - text_sup:], None, None))
    tokens, labels, pos, seg, tiles, indices = [], [], [], [], [], []
    for i, (ids, lab, t, idx) in enumerate(samples):
        if t is not None:
            idx = idx.copy()
            idx[1] += len(tokens)
            tiles.append(t)
            indices.append(idx)
        tokens += ids
        labels += lab
        pos += range(len(ids))
        seg += [i] * len(ids)
    as32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return Pack(as32(tokens), as32(labels), as32(pos), as32(seg),
                np.concatenate(tiles), np.concatenate(indices, axis=1))


def _fingerprint(p) -> int:
    """A position-weighted int64 sum of a tensor's raw bits (1 + index mod
    65521 as weights, in chunks to bound the temporaries): any change of its
    bits changes it, short of a collision."""
    import torch

    bits = p.detach().reshape(-1).view(torch.int16 if p.element_size() == 2 else torch.int32)
    total, step = 0, 1 << 26
    for i in range(0, bits.numel(), step):
        chunk = bits[i:i + step].to(torch.int64)
        w = (torch.arange(i, i + chunk.numel(), device=p.device) % 65521) + 1
        total += int((chunk * w).sum())
    return total


def _snapshot(module, trained) -> dict:
    """Copies of the trained parameters, fingerprints of the others."""
    return {n: (p.detach().clone() if n in trained else _fingerprint(p))
            for n, p in module.named_parameters()}


def _moved(module, snap) -> set:
    import torch

    return {n for n, p in module.named_parameters()
            if (not torch.equal(p.detach(), snap[n]) if torch.is_tensor(snap[n])
                else _fingerprint(p) != snap[n])}


def phase_train(text_params, cfg, dev, *, tag, seq_len, videos, grid, freeze_vision,
                vit_lr_mult=1.0, text_segments=4, answer=300, text_sup=700, steps=2,
                budget=4096, vision_chunk=64, seed) -> tuple:
    """Train the VLM for ``steps`` steps on one packed row through
    Trainer.train: text frozen, the tower frozen or trained, the projector
    trained, full remat, stage 1's schedule (configs/stage1_alignment.yaml:
    lr 1e-3, 30 warmup steps of 1000, so step 0 moves nothing and step 1
    takes lr / 30: Adam's first step moves every weight by about its lr,
    and at 1e-3 that is larger than the scaled projector's weights). Checks
    the launch counts, that the loss after the steps (a no-grad pass over
    the same row on the same path) is below the first step's, that the projector's
    matrices moved and every frozen parameter kept its bits.
    -> (launch counts, the VLM params)."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.training.loss import collate_packs, to_device
    from long_vita_tpu_torch.training.optimizer import OptimizerConfig
    from long_vita_tpu_torch.training.train_step import loss_fn
    from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig

    vc, tc = cfg.vision, cfg.text
    rng = np.random.default_rng(seed)

    def tiles(n):
        return rng.standard_normal((n, vc.image_size, vc.image_size, 3), dtype=np.float32)

    t0 = time.perf_counter()
    lv, ratio = _vlm_params(text_params, cfg, dev, seed, tiles(2))
    pack = _train_pack(cfg, seq_len, [tiles(f) for f in videos],
                       [(tiles(1 + grid[0] * grid[1]), grid)], rng, text_segments=text_segments,
                       answer=answer, text_sup=text_sup)
    batch = collate_packs([pack], budget)
    n_tiles = len(pack.images)
    optim = OptimizerConfig(lr=1e-3, warmup_steps=30, total_steps=1000, freeze_text=True,
                            freeze_vision=freeze_vision, vit_lr_mult=vit_lr_mult)
    trainer = Trainer(lv, cfg, TrainerConfig(
        seq_len=seq_len, logit_budget=budget, steps=steps, remat=True,
        vision_chunk=vision_chunk, optim=optim,
    ))
    trained = {n for n, p in lv.named_parameters() if p.requires_grad}
    print(f"[{tag}] pack of {seq_len} tokens: {len(set(pack.segment_ids.tolist()))} samples, "
          f"videos of {list(videos)} frames and a {1 + grid[0] * grid[1]}-tile image "
          f"({n_tiles} tiles), {int((batch['labels'] != -100).sum())} supervised rows in a "
          f"budget of {budget}; trained: {len(trained)} tensors "
          f"({sum(p.numel() for n, p in lv.named_parameters() if n in trained) / 1e6:.1f} M, "
          f"{'projector' if freeze_vision else f'tower at lr x {vit_lr_mult} and projector'}); "
          f"projector output scaled by {ratio:.4f}; set up in {time.perf_counter() - t0:.1f} s")
    before = _snapshot(lv, trained)
    stamps = []

    def batches():
        for _ in range(steps):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield batch

    # ---- the main path: Trainer.train
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = trainer.train(batches())["losses"]
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]

    n_layers, n_vit = tc.num_hidden_layers, vc.num_hidden_layers
    vit_batches = [min(vision_chunk, n_tiles - i) for i in range(0, n_tiles, vision_chunk)]
    dec_fused = fa.bwd_uses_fused(1, seq_len, seq_len, tc.num_attention_heads, tc.head_dim, 2)
    expected = dict.fromkeys(counts, 0)
    bwd = "flash_bwd" if dec_fused else None
    if freeze_vision:
        expected["flash_fwd"] = 2 * n_layers * steps
        expected["short_attn"] = n_vit * len(vit_batches) * steps
    else:
        expected["flash_fwd"] = 2 * (n_layers + n_vit * len(vit_batches)) * steps
        for b in vit_batches:
            if not fa.bwd_uses_fused(b, vc.seq_len, vc.seq_len, vc.num_attention_heads,
                                     vc.head_dim, 2):
                raise AssertionError("this phase expects the one-pass backward in the tower")
            expected["flash_bwd"] += n_vit * steps
    if bwd:
        expected["flash_bwd"] += n_layers * steps
    else:
        expected["flash_bwd_dkv"] = expected["flash_bwd_dq"] = n_layers * steps
    print(f"[{tag}] decoder backward: {'K4 (one pass)' if dec_fused else 'K5 (two pass)'}; "
          f"{len(vit_batches)} ViT batch(es) of {vit_batches} tiles a step")
    _check_launches(counts, expected)

    # bf16 weights take the Adam update rounded to bf16 (no master copy, as
    # in the JAX package): an update below half an ulp leaves a weight as it
    # is (a norm scale at 1.0 has an ulp of 2^-7; the tower's weights do not
    # move at lr 1e-3 x 0.1 / 30). The projector's matrices are held to
    # moving; the rest of what trains is reported.
    moved = _moved(lv, before)
    del before
    must = {n for n, p in lv.projector.named_parameters(prefix="projector") if p.dim() >= 2}
    stuck = sorted(must - moved)
    wrong = sorted(moved - trained)
    with torch.no_grad():  # the same row and path as the steps, no remat
        after = loss_fn(lv, to_device(batch, dev), cfg, False, vision_chunk,
                        freeze_vision)[0].item()
    print(f"[{tag}] losses of the steps {losses}, after them {after}; steps "
          f"{[round(t, 2) for t in step_s]} s = {[round(seq_len / t) for t in step_s]} "
          f"tokens/s; peak allocated {peak_gb:.2f} GB; trained tensors that moved: "
          f"{len(moved & trained)} of {len(trained)}; frozen ones that did: {len(wrong)}")
    if len(losses) != steps or not all(np.isfinite(losses + [after])) or not after < losses[0]:
        raise AssertionError(f"[{tag}] the loss did not fall: {losses}, after {after}")
    if stuck or wrong:
        raise AssertionError(f"[{tag}] trained but unchanged {stuck[:5]}; frozen but changed "
                             f"{wrong[:5]}")
    del trainer
    return counts, lv


def phase_train_grads(lv, cfg, dev, *, seq_len=4096, grid=(2, 3), vision_chunk=64,
                      answer=300, text_sup=700) -> None:
    """The trainable gradients (tower and projector, text frozen) of one
    step on a seq_len-token pack with a 7-tile image, through the kernels
    and through the plain attention (attn_impl "xla": xla_attention in the
    decoder and the tower). Then the control: the same step with a fault
    planted in the decoder's K4 (dK and dV of kv tile 0 dropped), which the
    gate must reject."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.training.loss import collate_packs, to_device
    from long_vita_tpu_torch.training.train_step import gradients, loss_fn
    from long_vita_tpu_torch.utils.convert import set_requires_grad

    rng = np.random.default_rng(SEED + 7)
    size = cfg.vision.image_size
    tiles = rng.standard_normal((1 + grid[0] * grid[1], size, size, 3), dtype=np.float32)
    pack = _train_pack(cfg, seq_len, [], [(tiles, grid)], rng, text_segments=2,
                       answer=answer, text_sup=text_sup)
    batch = to_device(collate_packs([pack], seq_len), dev)
    set_requires_grad(lv, freeze_text=True)

    def step(impl):
        lv.zero_grad(set_to_none=True)
        loss, _ = loss_fn(lv, batch, cfg, True, vision_chunk, False, attn_impl=impl)
        loss.backward()
        grads = {n: g.float().flatten() for n, g in gradients(lv).items()}
        lv.zero_grad(set_to_none=True)
        return loss.item(), grads

    def gate(name, run, ref) -> bool:
        (lk, gk), (lp, gp) = run, ref
        loss_rel = abs(lk - lp) / abs(lp)
        cos = {}
        for group in ("vision.", "projector.", ""):
            names = [n for n in gk if n.startswith(group)]
            a, b = torch.cat([gk[n] for n in names]), torch.cat([gp[n] for n in names])
            cos[group or "all"] = F.cosine_similarity(a, b, dim=0).item()
        worst = min(F.cosine_similarity(gk[n], gp[n], dim=0).item() for n in gk)
        passes = cos["all"] >= TRAIN_GRAD_COS and loss_rel <= TRAIN_LOSS_REL
        print(f"[T2] one step at {seq_len} tokens, {name} vs plain attention: loss {lk:.6f} vs "
              f"{lp:.6f} (rel {loss_rel:.2e} <= {TRAIN_LOSS_REL}); gradient cosine all "
              f"{cos['all']:.6f} (>= {TRAIN_GRAD_COS}), tower {cos['vision.']:.6f}, projector "
              f"{cos['projector.']:.6f}, worst tensor {worst:.6f}: "
              f"{'passes' if passes else 'fails'} the gate")
        return passes

    plain = step("xla")
    good = gate("kernels", step("auto"), plain)
    kernel = fa.flash_bwd_fused

    def planted(a):
        kernel(a)
        if a["q"].shape[-1] == 128:  # the decoder's
            a["dk"][:, :64].zero_()
            a["dv"][:, :64].zero_()

    planted.launches = 0
    fa.flash_bwd_fused = planted
    try:
        caught = not gate("kernels with a planted fault (decoder K4 loses dK, dV of kv tile 0)",
                          step("auto"), plain)
    finally:
        fa.flash_bwd_fused = kernel
    if not good:
        raise AssertionError("the kernel path's gradients disagree with the plain attention's")
    if not caught:
        raise AssertionError("the T2 gate did not reject the planted fault")


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
        **phase_kernels_bwd(),
    }
    cfg, dev = long_vita_14b(), torch.device("cuda")
    params = _text_params(cfg, dev)
    launches = dict.fromkeys(SOURCES, 0)
    launches["flash_fwd"] = phase_serving(params)
    for name, n in phase_multimodal(params, cfg, dev).items():
        launches[name] += n
    torch.cuda.empty_cache()  # the serving engines and their caches are gone
    log = logging.getLogger("long_vita_tpu_torch.training.trainer")  # a line per step
    log.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[trainer] %(message)s"))
    log.addHandler(handler)
    counts, lv = phase_train(params, cfg, dev, tag="T1", seq_len=32768, videos=(64, 16),
                             grid=(2, 3), freeze_vision=True, seed=SEED + 5)
    del lv
    for name, n in counts.items():
        launches[name] += n
    torch.cuda.empty_cache()
    counts, lv = phase_train(params, cfg, dev, tag="T2", seq_len=16384, videos=(16,),
                             grid=(2, 3), freeze_vision=False, vit_lr_mult=0.1, seed=SEED + 6)
    for name, n in counts.items():
        launches[name] += n
    torch.cuda.empty_cache()
    phase_train_grads(lv, cfg, dev)
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
