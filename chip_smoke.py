#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (long_vita_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. build the six CUDA sources from this checkout (one nvcc each, in
     parallel) and print nvcc's register/spill lines, ptxas's performance
     notes and the Hopper forward's and backward's shared memory;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving and training paths give it, with stated tolerances,
     and time both with CUDA events beside the kernel's bound and the one
     PyTorch call that computes the same function: K1 the flash forward
     (also on the trainable tower's D = 64 shape and with NaN in the cache
     rows past kv_valid_len), K2 the int8 flash forward, K3 the ViT's short
     attention, K4 the one-pass
     flash backward, K5 the two-pass flash backward (its dkv and dq entry
     points; both also timed at T2's and T1's packed segment layouts beside
     their bounds), K6 the w4a16 product (five 14B shapes, 1 to 512 rows; one 14B
     matrix quantised on the card against numpy's quantisation, bit for bit);
  3. text serving: the full-width, full-depth Qwen2.5-14B decoder (random
     bf16 weights from a seeded generator) through InferenceEngine: greedy
     generate twice, a ragged generate_batch and a sampled request, counting
     K1's launches; then the prefill's last-row logits against two plain
     references;
  4. quantized serving of the same decoder: weight_quant="int4" (greedy x2,
     the ragged batch, speculative_k=4, an exact repeat through the prefix
     cache; K6, its dequantise route and K1 counted exactly; logits against
     the same flow on K6's plain version) and weight_quant="int8" (greedy
     x2); the bf16 weights must keep their bits;
  5. multimodal serving: the same decoder with a random InternViT-300M tower
     and projector: a 64-frame video into an int8 cache, twice; a ragged
     batch of a 7-tile image and a 16-frame video into an int8 cache; the
     video into a bf16 cache; the video in pieces of 16 frames encoded up
     front and interleaved with the prefill chunks (same tokens). Launch
     counts of K1, K2 and K3 are checked against the layers and chunks the
     requests need; the video's last-row logits and its encoded features are
     held against the same flow on the plain versions;
  6. T1, stage-1 alignment at 32K (configs/stage1_alignment.yaml's regime):
     the same decoder and a random tower and projector, text and vision
     frozen, the projector trained at lr 1e-3, full remat, through
     Trainer.train for 2 steps on one packed row of a 64-frame video, a
     16-frame video, a 7-tile image and text; the backward takes K5. The
     loss must fall, the projector move and the frozen weights stay
     bit-identical; launch counts are checked per step;
  7. T2, a trainable tower at 16K: text frozen, the tower (lr x 0.1) and
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
# K6 vs its plain version: both take each int4 x bf16 product exactly and sum
# in f32 (in other orders), then round once: bf16 out within 1e-2 x max|ref|
# (a bf16 rounding is 2^-8 relative), f32 out within 1e-4 x max|ref|.
W4_BF16_TOL, W4_F32_TOL = 1e-2, 1e-4
# the 14B shapes K6 is given (in, out) and the row counts it is held at
W4_SHAPES = {
    "q_proj/o_proj": (5120, 5120), "k_proj/v_proj": (5120, 1024),
    "gate_proj/up_proj": (5120, 13824), "down_proj": (13824, 5120), "lm_head": (5120, 152064),
}
W4_ROWS = (1, 4, 64, 512)
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
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
    "w4_matmul": ("long_vita_tpu_torch/ops/csrc/w4_matmul.cu",
                  "long_vita_tpu/ops/quant_matmul.py:132"),
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


def _queued_ms(fns, reps: int) -> float:
    """Device time per call of ``fns`` (taken in turn), from CUDA events
    around ``reps`` calls queued behind a 20M-cycle sleep kernel, so that the
    host's launch overhead (tens of microseconds a call, more than a decode-
    sized kernel takes) does not show. Give several copies of the operands
    to keep a working set over the 50 MB L2 cold, as decode finds it."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM_BYTES_PER_S and the operations over BF16_FLOPS."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _counters():
    """The kernels' wrappers, whose ``launches`` count kernel launches."""
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.ops import quant_matmul as qm

    return {
        "flash_fwd": fa.flash_attention,
        "flash_fwd_quant": fa.flash_attention_quant,
        "short_attn": fa.short_attention,
        "flash_bwd": fa.flash_bwd_fused,
        "flash_bwd_dkv": fa.flash_bwd_dkv,
        "flash_bwd_dq": fa.flash_bwd_dq,
        "w4_matmul": qm.w4_matmul,
    }


def _reset_counts() -> None:
    from long_vita_tpu_torch.ops import quant_matmul as qm

    for fn in _counters().values():
        fn.launches = 0
    qm.w4_matmul_dequant.calls = 0


def _read_counts() -> dict:
    """Launches of every kernel, and "w4_dequant": the calls of K6's
    dequantise route (JAX's prefill route, a torch.matmul, no kernel)."""
    from long_vita_tpu_torch.ops import quant_matmul as qm

    counts = {name: fn.launches for name, fn in _counters().items()}
    counts["w4_dequant"] = qm.w4_matmul_dequant.calls
    return counts


def phase_build() -> None:
    from long_vita_tpu_torch.ops import _build
    from long_vita_tpu_torch.ops import flash_attention  # noqa: F401  (registers K1-K5)
    from long_vita_tpu_torch.ops import quant_matmul  # noqa: F401  (registers K6)

    t0 = time.perf_counter()
    _build.build_registered()
    sources = _build.registered_sources()
    print(f"[build] {', '.join(sources)} built (in parallel) and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error", "warning",
                                       "Performance Loss")):
                print(f"[build] {name}: {line.strip()}")
    for d in (128, 64):
        print(f"[build] flash_fwd_sm90.cuh: the D={d} forward (K1 bf16, and K3 at D=64) takes "
              f"{_build.load('flash_fwd').lvt_flash_fwd_smem_bytes(d)} bytes of dynamic shared "
              f"memory a block")
        bwd, dq = _build.load("flash_bwd"), _build.load("flash_bwd_2pass")
        print(f"[build] flash_bwd_sm90.cuh: at D={d} a kv-major block takes "
              f"{bwd.lvt_flash_bwd_smem_bytes(d, 1)} bytes of dynamic shared memory in K4 and "
              f"{bwd.lvt_flash_bwd_smem_bytes(d, 0)} in K5's dkv pass, a dq block "
              f"{dq.lvt_flash_bwd_dq_smem_bytes(d)}")


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
    # (f) the trainable tower's shape: non-causal, D = 64, q/k/v strided views
    # of one [16, 1025, 3, 16, 64] qkv projection
    qf, kf, vf = rnd(16, 1025, 3, 16, 64).unbind(2)
    errs.append(_kernel_case("(f) non-causal [16, 1025, 16, 64] qkv views", qf, kf, vf,
                             causal=False))
    # (g) NaN in every cache row past kv_valid_len (TMA loads rows inside the
    # tensor as they are): none may reach o
    kg, vg = ka[:, :8192].clone(), va[:, :8192].clone()
    kg[:, 6100:] = float("nan")
    vg[:, 6100:] = float("nan")
    errs.append(_kernel_case("(g) chunk 2048 @4096, cache rows past len 6100 hold NaN",
                             qa, kg, vg, causal=True, q_offset=4096, kv_valid_len=6100))
    del kg, vg
    # (e) the float32 kernel at a small chunk-against-cache shape
    qe, ke, ve = (rnd(1, 300, 8, 128, dtype=torch.float32),
                  rnd(1, 1024, 2, 128, dtype=torch.float32),
                  rnd(1, 1024, 2, 128, dtype=torch.float32))
    _kernel_case("(e) f32 chunk 300 @500 vs cache 1024 len 800", qe, ke, ve, f32=True,
                 causal=True, q_offset=500, kv_valid_len=800)

    # device time, the calls queued behind a sleep: at a sub-millisecond
    # kernel the wrapper's host work (checks, tensor maps, the meta scalars)
    # would show in events around each call
    kern_ms = _queued_ms([lambda: fa.flash_attention(qa, ka, va, **kw_a)], reps=20)
    plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(qa, ka, va, **kw_a), reps=5)
    pairs = sum(i + 1 for i in range(4096, 4096 + 2048))  # unmasked (q, k) pairs
    tflops = 4 * 40 * 128 * pairs / (kern_ms * 1e-3) / 1e12
    # bytes: q and o, the 6144 valid rows of k and v, lse
    bound = _bound(2 * 2 * qa.numel() + 2 * 2 * 6144 * 8 * 128 + 4 * 2048 * 40,
                   4 * 40 * 128 * pairs)
    lib_ms = _sdpa_ms(qa, ka[:, :6144], va[:, :6144], lower_right=True)
    print(
        f"[kernel] (a) timing: kernel {kern_ms:.3f} ms (queued) "
        f"({tflops:.1f} TFLOP/s on unmasked pairs), plain {plain_ms:.3f} ms, bound "
        f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), F.scaled_dot_product_attention "
        f"(lower-right causal, kv repeated to 40 heads) {lib_ms:.3f} ms"
    )
    return {"max_abs_err": max(errs), "ms": kern_ms, "plain_ms": plain_ms, **bound,
            "library_ms": lib_ms}


def _sdpa_ms(q, k, v, *, lower_right=False, mask=None, do=None, reps=20) -> float:
    """F.scaled_dot_product_attention's time on the same q, k, v (model
    layout [B, S, H, D]; k and v repeated to q's heads outside the timing):
    non-causal, causal aligned at the bottom right (a chunk against a
    longer cache), or with a boolean mask; with ``do``, forward and backward
    (median of CUDA events), else the forward queued as the kernels are."""
    import torch
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]

    def heads_first(x, rep=1):
        x = x.repeat_interleave(rep, dim=2) if rep > 1 else x
        return x.transpose(1, 2).contiguous()

    qt, kt, vt = heads_first(q), heads_first(k, g), heads_first(v, g)
    if lower_right:
        from torch.nn.attention.bias import causal_lower_right

        mask = causal_lower_right(q.shape[1], k.shape[1])
    if do is None:
        return _queued_ms([lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)],
                          reps=reps)
    leaves = [x.requires_grad_() for x in (qt, kt, vt)]
    dot = heads_first(do)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        torch.autograd.grad(out, leaves, dot)

    return _cuda_ms(fwd_bwd, reps=reps)


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
    # bytes: q and o, the 16384 valid rows of the int8 codes and their f32 scales, lse
    bound = _bound(2 * 2 * q.numel() + 2 * 16384 * 8 * (128 + 4) + 4 * 2048 * 40,
                   4 * 40 * 128 * pairs)
    print(f"[kernel] K2 timing, median of CUDA events: kernel {kern_ms:.3f} ms "
          f"({tflops:.1f} TFLOP/s on unmasked pairs), plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}); no PyTorch call attends over "
          f"an int8 cache")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms, **bound, "library_ms": None}


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
            kern_ms = _queued_ms([lambda: fa.short_attention(q, k, v)], reps=20)
            plain_ms = _cuda_ms(lambda: fa.short_attention_reference(q, k, v), reps=5)
            lib_ms = _sdpa_ms(q, k, v)
            bound = _bound(4 * 2 * q.numel() + 4 * 64 * 16 * 1025, 4 * 64 * 16 * 1025 * 1025 * 64)
    tflops = 4 * 64 * 16 * 1025 * 1025 * 64 / (kern_ms * 1e-3) / 1e12
    print(f"[kernel] K3 timing at [64, 1025, 16, 64]: kernel {kern_ms:.3f} ms (queued; "
          f"{tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), F.scaled_dot_product_attention "
          f"{lib_ms:.3f} ms")
    return {"max_abs_err": max(errs), "ms": kern_ms, "plain_ms": plain_ms, **bound,
            "library_ms": lib_ms}


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


def _train_segments(s, videos, grid, dev, text_segments=4):
    """The segment ids [1, s] of phase_train's packed row (_train_pack's
    layout: a sample per video and image, then text samples)."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_14b

    pack = _train_pack(long_vita_14b(), s, [np.zeros((f, 1, 1, 3), np.float32) for f in videos],
                       [(np.zeros((1 + grid[0] * grid[1], 1, 1, 3), np.float32), grid)],
                       np.random.default_rng(SEED), text_segments=text_segments)
    return torch.from_numpy(pack.segment_ids).to(dev)[None]


def _plain_bwd_by_segment(q, k, v, o, lse, do, seg) -> tuple:
    """The plain backward of one causal row [1, S] of contiguous segments
    (each id one run of positions), a segment and a kv head's GQA group at a
    time: no pair across segments is unmasked, so each piece is the whole
    row's plain backward restricted to it, and the logits of a 16.7K-token
    segment and 5 q heads (5.6 GB in f32) fit on the card where the whole
    row's would not. -> (dq, dk, dv) as flash_attention_bwd_reference."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    ids, lens = torch.unique_consecutive(seg[0], return_counts=True)
    if q.shape[0] != 1 or len(torch.unique(ids)) != len(ids):
        raise ValueError("one batch row of contiguous segments")
    hkv = k.shape[2]
    g = q.shape[2] // hkv
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    a = 0
    for n in lens.tolist():
        r = slice(a, a + n)
        for h in range(hkv):
            hq, hk = slice(h * g, (h + 1) * g), slice(h, h + 1)
            dq[:, r, hq], dk[:, r, hk], dv[:, r, hk] = fa.flash_attention_bwd_reference(
                q[:, r, hq], k[:, r, hk], v[:, r, hk], o[:, r, hq], lse[:, hq, r],
                do[:, r, hq], causal=True)
        a += n
    return dq, dk, dv


def _bwd_bounds(q, k, seg) -> dict:
    """The backward's bounds on one causal self-attention row with
    contiguous segments: S, dP, dV, dK and dQ are 2 x D operations a (q, k)
    pair inside a segment and q head (K5's dkv pass does 4 of the 5, its dq
    pass 3); bytes: q, k, v, do, lse, delta and the ids read once, dq, dk,
    dv written once (K4's dq as f32 sums). -> (unmasked pairs, {entry: bound})."""
    import torch

    hq, d = q.shape[2], q.shape[3]
    lens = torch.unique_consecutive(seg[0], return_counts=True)[1].tolist()
    pairs = sum(n * (n + 1) // 2 for n in lens)
    ins = 2 * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * q.numel() // d + 2 * 4 * seg.numel()
    dkv_bytes = 2 * 2 * k.numel()
    op = 2 * hq * d * pairs
    return pairs, {
        "flash_bwd": _bound(ins + 4 * q.numel() + dkv_bytes, 5 * op),
        "flash_bwd_dkv": _bound(ins + dkv_bytes, 4 * op),
        "flash_bwd_dq": _bound(ins + 2 * q.numel(), 3 * op),
    }


def phase_kernels_bwd() -> dict:
    """K4 and K5 against the plain backward: the decoder's training shape at
    4096 tokens ([1, 4096, 40/8, 128], causal, 3 segments; K5 called
    directly, since JAX's rule picks K4 there) and K4 at the ViT's [16, 1025,
    16, 64] non-causal. Each entry point and the plain backward timed with
    CUDA events, then K4 at 16K and K5 at 32K alone, the shapes T2 and T1
    give them, with 3 segments and with the segments of T2's and T1's packed
    rows, each beside its bound; on the packed rows the kernel is also held
    to the plain backward, computed a segment at a time."""
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
    # the bounds count the (q, k) pairs inside the 3 segments
    seg = kw["q_segment_ids"][0]
    pairs, bounds = _bwd_bounds(q, k, kw["q_segment_ids"])
    mask = (seg[:, None] == seg[None, :]) & torch.ones(4096, 4096, dtype=torch.bool, device=dev).tril()
    lib_ms = _sdpa_ms(q, k, v, mask=mask, do=do, reps=5)
    print(f"[kernel] backward timing at [1, 4096, 40/8, 128], median of CUDA events: K4 "
          f"{k4_ms:.3f} ms ({flops / k4_ms / 1e9:.1f} TFLOP/s on the causal half), K5 dkv "
          f"{dkv_ms:.3f} + dq {dq_ms:.3f} ms, plain backward {plain_ms:.3f} ms; bounds "
          f"(operations on {pairs} unmasked pairs) K4 {bounds['flash_bwd']['bound_ms']:.3f}, dkv "
          f"{bounds['flash_bwd_dkv']['bound_ms']:.3f}, dq {bounds['flash_bwd_dq']['bound_ms']:.3f} "
          f"ms; F.scaled_dot_product_attention forward + backward (block-causal boolean mask, "
          f"kv repeated to 40 heads) {lib_ms:.3f} ms")
    del q, k, v, o, lse, do, a4, a5, mask

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

    packed = {}  # K4 at T2's row, K5 at T1's: [max |err| of dq, dk, dv]
    for s, fused, videos in ((16384, True, (16,)), (32768, False, (64, 16))):
        if fa.bwd_uses_fused(1, s, s, 40, 128, 2) is not fused:
            raise AssertionError(f"JAX's rule at {s} tokens is not {'K4' if fused else 'K5'}")
        name, row = ("K4", "T2") if fused else ("K5", "T1")
        entries = ["flash_bwd"] if fused else ["flash_bwd_dkv", "flash_bwd_dq"]
        q, k, v, o, lse, do, kw = operands(s)
        for layout in ("3 segments", f"{row}'s packed row"):
            if layout != "3 segments":  # the same tensors, the row's segments
                seg = _train_segments(s, videos, (2, 3), dev)
                kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
                o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
                wrappers = ([fa.flash_bwd_fused] if fused
                            else [fa.flash_bwd_dkv, fa.flash_bwd_dq])
                got = run(fused, name, wrappers, q, k, v, o, lse, do, **kw)
                packed[name] = _grad_errs(f"{name} at [1, {s}, 40/8, 128] causal, {layout}", got,
                                          _plain_bwd_by_segment(q, k, v, o, lse, do, seg))
                del got
                meta = fa._device_meta(dev, 0, 0, s)
                prep_ms = _cuda_ms(lambda: fa.bwd_tile_order(fa.bwd_seg_ranges(seg, seg), s, meta),
                                   reps=10)
                print(f"[kernel] {layout}: the tile ranges and grid order (bwd_seg_ranges, "
                      f"bwd_tile_order) {prep_ms:.3f} ms a backward call")
            ms = _cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw), reps=3)
            fwd_ms = _cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=3)
            pairs_s, bnd = _bwd_bounds(q, k, kw["q_segment_ids"])
            bound_ms = sum(bnd[e]["bound_ms"] for e in entries)
            by = "/".join(sorted({bnd[e]["bound_by"] for e in entries}))
            flops = 10 * 40 * 128 * pairs_s
            causal_ms = _sdpa_ms(q, k, v, mask=torch.ones(s, s, dtype=torch.bool, device=dev).tril(),
                                 do=do, reps=3) if s == 16384 and layout == "3 segments" else None
            n_seg = len(torch.unique_consecutive(kw["q_segment_ids"][0]))
            print(f"[kernel] {name} alone at [1, {s}, 40/8, 128] causal, {layout} ({n_seg} "
                  f"segments, {pairs_s} unmasked pairs): {ms:.3f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s on them), bound {bound_ms:.3f} ms ({by}); "
                  f"K1 forward {fwd_ms:.2f} ms"
                  + (f"; F.scaled_dot_product_attention forward + backward, causal without "
                     f"segments: {causal_ms:.2f} ms" if causal_ms else ""))
        del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return {
        "flash_bwd": {"max_abs_err": max(k4 + vit + packed["K4"]), "ms": k4_ms,
                      "plain_ms": plain_ms, **bounds["flash_bwd"], "library_ms": lib_ms},
        "flash_bwd_dkv": {"max_abs_err": max(k5[1:] + packed["K5"][1:]), "ms": dkv_ms,
                          "plain_ms": plain_ms, **bounds["flash_bwd_dkv"], "library_ms": lib_ms},
        "flash_bwd_dq": {"max_abs_err": max(k5[0], packed["K5"][0]), "ms": dq_ms,
                         "plain_ms": plain_ms,
                         **bounds["flash_bwd_dq"], "library_ms": lib_ms},
    }


def phase_kernels_w4() -> dict:
    """K6 against its plain version at the five 14B shapes and rows 1, 4,
    64 and 512 (bf16 out for the projections, f32 for the head), timed at 1
    and 512 rows with the plain version, torch.matmul on the dequantised
    bf16 weight (the nearest library call: JAX's route above 512 rows and
    what bf16 serving runs) and the bound. Before that, one 14B matrix
    quantised on the card must equal numpy's host quantisation bit for bit.
    -> the report entry, timed at q_proj's shape and one row."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.models.quantize import quantize_kernel, quantize_kernel_int4
    from long_vita_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    # the card's quantisation against numpy's, on gate_proj's matrix
    w = rnd(13824, 5120, scale=0.02)  # nn.Linear orientation [out, in]
    packed, scales = quantize_kernel_int4(w)
    q8, s8 = quantize_kernel(w)
    host = w.float().cpu().numpy()
    hp, hs = qm.quantize_int4_grouped(host.T)
    a = np.max(np.abs(host), axis=-1)
    h_scale = np.where(a > 0, a / np.float32(127.0), np.float32(1.0))
    h_q8 = np.rint(host / h_scale[:, None]).astype(np.int8)
    diff = {name: int((got.cpu().numpy() != want).sum()) for name, got, want in (
        ("int4 codes", packed, hp), ("int4 scales", scales, hs),
        ("int8 codes", q8, h_q8), ("int8 scales", s8, h_scale))}
    same = not any(diff.values())
    print(f"[w4] gate_proj [13824, 5120] bf16 quantised on the card, int4 (packed "
          f"{tuple(packed.shape)}, scales {tuple(scales.shape)}) and int8: "
          f"{'bit for bit equal to' if same else 'DIFFERS from'} numpy's host quantisation "
          f"(elements that differ: {diff})")
    if not same:
        raise AssertionError("quantisation on the card differs from the host's")
    del w, packed, scales, q8, s8, host

    errs, report = [], None
    for name, (n_in, n_out) in W4_SHAPES.items():
        out_dtype = torch.float32 if name == "lm_head" else bf
        tol = W4_F32_TOL if out_dtype == torch.float32 else W4_BF16_TOL
        packed, scales = quantize_kernel_int4(rnd(n_out, n_in, scale=0.02))
        for rows in W4_ROWS:
            x = rnd(rows, n_in)
            before = qm.w4_matmul.launches
            got = qm.w4_matmul(x, packed, scales, out_dtype)
            torch.cuda.synchronize()
            if qm.w4_matmul.launches != before + 1:
                raise AssertionError(f"[w4 {name} rows {rows}] the kernel did not launch once")
            ref = qm.w4_matmul_reference(x, packed, scales, out_dtype)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            again = qm.w4_matmul(x, packed, scales, out_dtype)
            ok = err <= tol * scale and bool(torch.isfinite(got).all()) and torch.equal(again, got)
            errs.append(err)
            print(f"[w4] {name} [{rows}, {n_in}] x [{n_in}, {n_out}] -> {str(out_dtype)[6:]}: "
                  f"max|k-ref| {err:.3e} (<= {tol} x max|ref| {scale:.3f}), a second call "
                  f"{'has the same bits' if torch.equal(again, got) else 'DIFFERS'} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[w4 {name} rows {rows}] K6 disagrees with its plain version")
            if rows not in (1, 512):
                continue
            # timings: enough weight copies to keep the working set over L2
            n_bytes = packed.numel() + 4 * scales.numel()
            copies = [(packed, scales)] + [
                (packed.clone(), scales.clone()) for _ in range(-(-120_000_000 // n_bytes) - 1)
            ]
            kern_ms = _queued_ms([lambda p=p, s=s: qm.w4_matmul(x, p, s, out_dtype)
                                  for p, s in copies], reps=60)
            del copies
            plain_ms = _cuda_ms(lambda: qm.w4_matmul_reference(x, packed, scales, out_dtype), reps=3)
            w_deq = (qm.unpack_int4_torch(packed).reshape(n_in // 128, 128, n_out).float()
                     * scales[:, None]).reshape(n_in, n_out).to(bf)
            deqs = [w_deq] + [w_deq.clone() for _ in range(-(-120_000_000 // w_deq.nbytes) - 1)]
            if out_dtype == torch.float32:
                lib_ms = _queued_ms([lambda w=w: torch.mm(x, w, out_dtype=torch.float32)
                                     for w in deqs], reps=60)
            else:
                lib_ms = _queued_ms([lambda w=w: torch.matmul(x, w) for w in deqs], reps=60)
            del deqs, w_deq
            bound = _bound(2 * x.numel() + n_bytes + got.element_size() * got.numel(),
                           2 * rows * n_in * n_out)
            print(f"[w4] {name} at {rows} row(s), device time per call (queued, cold L2): "
                  f"K6 {kern_ms * 1e3:.1f} us, bound {bound['bound_ms'] * 1e3:.1f} us "
                  f"({bound['bound_by']}; {bound['bound_ms'] / kern_ms:.1%} of it), torch.matmul "
                  f"on the dequantised bf16 weight {lib_ms * 1e3:.1f} us (a reference, not the "
                  f"same function), plain version {plain_ms:.3f} ms")
            if name == "q_proj/o_proj" and rows == 1:
                report = {"ms": kern_ms, "plain_ms": plain_ms, **bound, "library_ms": lib_ms}
        del packed, scales
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), **report}


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


def _decode_profile(engine, prompt, tag: str, steps: int = 16) -> None:
    """Where a decode step's time goes: ``steps`` greedy decode steps after
    a prefill of ``prompt``, under torch.profiler. Prints the host's wall
    time a step, the device's busy time a step (the sum of the kernels'
    durations) and its share, kernels a step, and K6's share of the busy
    time. The profiler's own overhead inflates the wall time; the busy time
    is the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.models import qwen2

    cache, hidden, n = engine.prefill(prompt)
    token = qwen2.lm_head(engine.text, hidden).argmax(-1)[:, None]
    dev = token.device
    args = (torch.full((1,), n, device=dev), cache, torch.Generator(device=dev).manual_seed(0),
            SamplingParams(max_new_tokens=steps + 1), steps, torch.zeros(1, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine._decode_run(token, *args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / steps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6 / steps
    k6 = sum(e.time_range.elapsed_us() for e in kernels if "w4_" in e.name) / 1e6 / steps
    print(f"[{tag}] decode profile, {steps} steps: wall {wall * 1e3:.2f} ms a step under the "
          f"profiler, device busy {busy * 1e3:.2f} ms ({busy / wall:.1%}; idle "
          f"{1 - busy / wall:.1%}), {len(kernels) / steps:.0f} kernels a step, K6 "
          f"{k6 * 1e3:.2f} ms of the busy time")
    del cache


def _ttft_decode(engine, prompt, t_generate: float, n_tokens: int) -> tuple:
    """A warm prefill of ``prompt`` and its head, timed: -> (TTFT s, prefill
    s, last-row logits, decode ms/token of a generate of ``n_tokens`` tokens
    that took ``t_generate`` s)."""
    from long_vita_tpu_torch.models import qwen2

    (cache, hidden, _), t_prefill = _timed(lambda: engine.prefill(prompt))
    del cache
    logits, t_head = _timed(lambda: qwen2.lm_head(engine.text, hidden))
    ttft = t_prefill + t_head
    return ttft, t_prefill, logits, (t_generate - ttft) / (n_tokens - 1) * 1e3


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


def phase_serving(params) -> tuple:
    """Text serving. -> (K1 launches made by the serving requests, the
    kernel path's last-row logits of the 5000-id prompt)."""
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
    ttft, t_prefill, logits, decode_ms = _ttft_decode(engine, prompt, t_again, len(again.token_ids))
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
    _decode_profile(engine, prompt, "serve")
    return launches, logits


def _decode_steps(results, max_new: int, budget: int, segment: int = 64) -> int:
    """Decode steps engine._decode_run takes for one generate or
    generate_batch of greedy ``results``: segments of ``segment`` steps
    (smaller powers of two for a small rest) until ``budget`` tokens, or
    until the segment in which every row has emitted a stop token (a row
    shorter than max_new stopped at its length)."""
    stops = [len(r.token_ids) - 1 if len(r.token_ids) < max_new else None for r in results]
    if budget <= 0 or all(x is not None and x < 0 for x in stops):
        return 0
    stop_at = None if any(x is None for x in stops) else max(stops)
    steps = 0
    while budget > 0:
        n = segment
        while n // 2 >= budget:
            n //= 2
        steps += n
        budget -= n
        if stop_at is not None and stop_at < steps:
            break
    return steps


def phase_int4(params, cfg, dev, bf16_logits) -> dict:
    """int4 serving (w4a16) of the text-serving decoder through
    InferenceEngine(weight_quant="int4"): the solo 5000-id prompt with 32
    greedy tokens twice, the 700 / 2100 / 4000 ragged batch,
    speculative_k=4 on a prompt that repeats a 64-id pattern, and an exact
    repeat through prefix_cache_entries=2. Launch counts of K6, its
    dequantise route and K1 are checked exactly; the last-row logits are
    held against the same flow with K6's launcher swapped for its plain
    version. -> the launch counts of the run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.prefix_cache import copy_cache
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.inference.speculative import draft_tokens
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.ops import quant_matmul as qm

    tc = cfg.text
    chunk, max_seq, k = 2048, 16384, 4
    kw = dict(max_seq_len=max_seq, chunk=chunk)
    eng, t_quant = _timed(lambda: InferenceEngine(params, cfg, _StubMM(), weight_quant="int4", **kw))
    q_bytes = sum(m.packed.nbytes + m.scales.nbytes for m in eng.text.modules()
                  if isinstance(m, qwen2.QuantDense4))
    eng_spec = InferenceEngine(eng.params, cfg, _StubMM(), speculative_k=k, **kw)
    eng_pc = InferenceEngine(eng.params, cfg, _StubMM(), prefix_cache_entries=2, **kw)
    print(f"[int4] the decoder's 7 x {tc.num_hidden_layers} projections and head quantised on "
          f"the card in {t_quant:.1f} s: {q_bytes / 1e9:.3f} GB of packed codes and scales "
          f"(a decode step's K6 reads)")
    rng = np.random.default_rng(SEED)  # the text-serving phase's prompts
    vocab = tc.vocab_size
    prompt = rng.integers(0, vocab, 5000).tolist()
    batch = [{"input_ids": rng.integers(0, vocab, n).tolist()} for n in (700, 2100, 4000)]
    spec_prompt = rng.integers(0, vocab, 64).tolist() * 30  # 1920 ids
    greedy = SamplingParams(max_new_tokens=32)

    def chunks(n):
        return -(-n // chunk)

    # ---- the main path: requests through the engine's public entry points
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first, t_first = _timed(lambda: eng.generate(input_ids=prompt, sampling=greedy))
    again, t_again = _timed(lambda: eng.generate(input_ids=prompt, sampling=greedy))
    batched, t_batch = _timed(lambda: eng.generate_batch(batch, sampling=SamplingParams(max_new_tokens=16)))
    spec, t_spec = _timed(lambda: eng_spec.generate(input_ids=spec_prompt, sampling=greedy))
    pc_first, _ = _timed(lambda: eng_pc.generate(input_ids=prompt, sampling=greedy))
    pc_again, t_pc = _timed(lambda: eng_pc.generate(input_ids=prompt, sampling=greedy))
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    pc = eng_pc.prefix_cache
    resumed = pc.tokens_saved  # the repeat resumes at the last chunk boundary below 4999
    n_chunks = 3 * chunks(len(prompt)) + chunks(4000) + chunks(len(spec_prompt)) + chunks(len(prompt) - resumed)
    solo_budget = min(31, max_seq - 1 - len(prompt))
    steps = (sum(_decode_steps([r], 32, solo_budget) for r in (first, again, pc_first, pc_again))
             + _decode_steps(batched, 16, min(15, max_seq - 1 - 700)))
    per_pass = 7 * tc.num_hidden_layers
    # K6: each prefill's last-row pass and its first head, each decode step
    # and each verify step (a pass and its head); the prefill chunks take
    # the dequantise route
    print(f"[int4] expected: K1 {tc.num_hidden_layers} x {n_chunks} prefill chunks (the "
          f"repeat resumed at {resumed}); the dequantise route {per_pass} x {n_chunks}; K6 "
          f"({per_pass} + 1) x (6 last rows + {steps} decode steps + {eng_spec._spec_steps} "
          f"verify steps)")
    _check_launches(counts, {
        "flash_fwd": tc.num_hidden_layers * n_chunks,
        "w4_dequant": per_pass * n_chunks,
        "w4_matmul": (per_pass + 1) * (6 + steps + eng_spec._spec_steps),
    })
    if pc.hits != 1 or resumed != 4096:
        raise AssertionError(f"the repeat did not resume at 4096 (hits {pc.hits}, saved {resumed})")
    if not (first.token_ids == again.token_ids == pc_first.token_ids == pc_again.token_ids):
        raise AssertionError(f"int4 greedy runs differ: {first.token_ids} / {again.token_ids} / "
                             f"{pc_first.token_ids} / {pc_again.token_ids}")
    outs = [first, again, *batched, spec, pc_first, pc_again]
    if not all(r.token_ids and all(0 <= t < vocab for t in r.token_ids) for r in outs):
        raise AssertionError("empty output or token id outside [0, vocab)")
    print(f"[int4] greedy x2 identical ({len(first.token_ids)} tokens): {first.token_ids[:8]} ...; "
          f"the prefix-cache repeat (resumed at {resumed}) gives the same tokens; generate_batch "
          f"700/2100/4000 -> {[len(r.token_ids) for r in batched]} tokens in {t_batch:.2f} s; "
          f"peak allocated {peak_gb:.2f} GB")

    # ---- timings (warm): TTFT, decode, the prefix hit's TTFT, speculation
    ttft, t_prefill, logits, decode_ms = _ttft_decode(eng, prompt, t_again, len(again.token_ids))
    (cache, _, _), t_hit = _timed(lambda: eng_pc.prefill(prompt))
    del cache
    print(f"[int4] solo 5000-id prompt, 32 greedy tokens: TTFT {ttft * 1e3:.1f} ms, generate "
          f"{t_again:.2f} s (first call {t_first:.2f} s), decode {decode_ms:.2f} ms/token; the "
          f"prefix-cache hit's prefill {t_hit * 1e3:.1f} ms (one chunk) against {t_prefill * 1e3:.1f} ms")

    # ---- the K6 path's last-row logits against the same flow with K6's
    # launcher swapped for its plain version (nothing else changes)
    kernel = qm._w4_cuda
    qm._w4_cuda = lambda x, p, s_, od: qm.w4_matmul_reference(x, p, s_, od)
    try:
        cache, hid_plain, _ = eng.prefill(prompt)
        plain_logits = qwen2.lm_head(eng.text, hid_plain)
    finally:
        qm._w4_cuda = kernel
    del cache
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (1, vocab)
    ok = _logit_check("int4", "K6 path vs the same flow on K6's plain version", logits,
                      plain_logits) and ok
    cos_bf16 = F.cosine_similarity(logits, bf16_logits, dim=-1).item()
    print(f"[int4] (for the record, random weights) last-row logits, int4 vs bf16 weights: "
          f"cosine {cos_bf16:.6f}")

    # ---- speculation: acceptance, the first divergence from plain greedy,
    # and the verify step's row 0 against the one-row decode at its position
    emitted = len(spec.token_ids) - 1  # after the first token, which the head samples
    plain_spec = eng.generate(input_ids=spec_prompt, sampling=greedy)
    div = next((i for i, (a, b) in enumerate(zip(spec.token_ids, plain_spec.token_ids)) if a != b), None)
    print(f"[int4] speculative_k={k} on a 64-id pattern x 30: {eng_spec._spec_steps} verify steps "
          f"for {emitted} tokens ({emitted / max(eng_spec._spec_steps, 1):.2f} a step, "
          f"{emitted - eng_spec._spec_steps} drafts accepted) in {t_spec:.2f} s; against plain "
          f"greedy: {'identical' if div is None else f'first divergence at token {div}'}")
    cache, hidden, n = eng.prefill(spec_prompt)
    t0 = int(qwen2.lm_head(eng.text, hidden).argmax(-1))
    drafts = draft_tokens(np.asarray(spec_prompt + [t0]), k - 1)
    step = torch.zeros((1, k), dtype=torch.long, device=dev)
    step[0, 0] = t0
    step[0, 1:1 + len(drafts)] = torch.as_tensor(drafts, device=dev)
    verify_cache = copy_cache(cache)
    h1, _ = qwen2.qwen2_decoder(eng.text, qwen2.embed_tokens(eng.text, step[:, :1]),
                                torch.full((1, 1), n, device=dev), tc, kv_cache=cache)
    hk, _ = qwen2.qwen2_decoder(eng.text, qwen2.embed_tokens(eng.text, step),
                                n + torch.arange(k, device=dev)[None], tc, kv_cache=verify_cache)
    del cache, verify_cache
    ok = _logit_check("int4", f"the {k}-row verify step's row 0 vs the one-row decode",
                      qwen2.lm_head(eng.text, hk)[:, 0], qwen2.lm_head(eng.text, h1[:, -1])) and ok
    if not ok:
        raise AssertionError("the int4 path's logits disagree")
    _decode_profile(eng, prompt, "int4")
    del eng, eng_spec, eng_pc
    torch.cuda.empty_cache()
    return counts


def phase_int8(params, cfg, dev, bf16_logits) -> dict:
    """One weight_quant="int8" generate of the 5000-id prompt, greedy x2
    identical, with TTFT and decode ms/token. w8a16 has no kernel of its
    own (the JAX package leaves it to XLA): each product casts the int8
    codes to bf16 first. -> the launch counts of the run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams

    tc = cfg.text
    eng, t_quant = _timed(lambda: InferenceEngine(
        params, cfg, _StubMM(), max_seq_len=16384, chunk=2048, weight_quant="int8"))
    prompt = np.random.default_rng(SEED).integers(0, tc.vocab_size, 5000).tolist()
    greedy = SamplingParams(max_new_tokens=32)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first, _ = _timed(lambda: eng.generate(input_ids=prompt, sampling=greedy))
    again, t_again = _timed(lambda: eng.generate(input_ids=prompt, sampling=greedy))
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_launches(counts, {"flash_fwd": tc.num_hidden_layers * 2 * 3})
    if first.token_ids != again.token_ids:
        raise AssertionError(f"int8 greedy runs differ: {first.token_ids} / {again.token_ids}")
    ttft, _, logits, decode_ms = _ttft_decode(eng, prompt, t_again, len(again.token_ids))
    cos = F.cosine_similarity(logits, bf16_logits, dim=-1).item()
    print(f"[int8] weights quantised on the card in {t_quant:.1f} s; greedy x2 identical "
          f"({len(first.token_ids)} tokens): {first.token_ids[:8]} ...; TTFT {ttft * 1e3:.1f} ms, "
          f"decode {decode_ms:.2f} ms/token; peak allocated {peak_gb:.2f} GB; (for the record) "
          f"last-row logits vs bf16 weights: cosine {cos:.6f}")
    _decode_profile(eng, prompt, "int8")
    del eng
    torch.cuda.empty_cache()
    return counts


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
    # (iv) the video again in transfer pieces of 16 frames, encoded up front
    # and interleaved with the prefill chunks
    eng_up = InferenceEngine(lv, cfg, mm, kv_quant=True, transfer_chunk=16, **kw)
    eng_il = InferenceEngine(lv, cfg, mm, kv_quant=True, transfer_chunk=16,
                             interleave_encode=True, **kw)
    greedy = SamplingParams(max_new_tokens=new_tokens)

    # ---- the main path: requests through the engine's public entry points
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first, t_first = _timed(lambda: eng_q.generate(input_ids=req_i, videos=[video], sampling=greedy))
    again, t_again = _timed(lambda: eng_q.generate(input_ids=req_i, videos=[video], sampling=greedy))
    batched, t_batch = _timed(lambda: eng_q.generate_batch(reqs_ii, sampling=greedy))
    bf16, t_bf16 = _timed(lambda: eng_b.generate(input_ids=req_i, videos=[video], sampling=greedy))
    upfront, t_up = _timed(lambda: eng_up.generate(input_ids=req_i, videos=[video], sampling=greedy))
    interleaved, t_il = _timed(lambda: eng_il.generate(input_ids=req_i, videos=[video], sampling=greedy))
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_layers, n_vit = tc.num_hidden_layers, vc.num_hidden_layers
    tc_tiles = eng_q.transfer_chunk

    def chunks(n):
        return -(-n // chunk)

    enc_i = _encode_batches(n_frames, tc_tiles, vision_chunk)
    enc_ii = _encode_batches(1 + grid[0] * grid[1] + batch_frames, tc_tiles, vision_chunk)
    enc_iv = _encode_batches(n_frames, 16, vision_chunk)
    print(f"[mm] (i) {n_frames}-frame video, {n_i} tokens ({chunks(n_i)} chunks of {chunk}); "
          f"(ii) batch of a {1 + grid[0] * grid[1]}-tile image and a {batch_frames}-frame "
          f"video, {lens_ii} tokens ({chunks(max(lens_ii))} chunks); (iii) = (i), bf16 cache")
    _check_launches(counts, {
        "flash_fwd": n_layers * chunks(n_i),
        "flash_fwd_quant": n_layers * (4 * chunks(n_i) + chunks(max(lens_ii))),
        "short_attn": n_vit * (3 * enc_i + enc_ii + 2 * enc_iv),
    })
    if interleaved.token_ids != upfront.token_ids:
        raise AssertionError(f"interleaved encode differs from the up-front encode: "
                             f"{interleaved.token_ids} vs {upfront.token_ids}")
    print(f"[mm] (iv) pieces of 16 frames ({enc_iv} encode batches each way): interleaved encode "
          f"gives the up-front encode's tokens ({t_il:.2f} s vs {t_up:.2f} s); against (i), one "
          f"piece of {n_frames}: {'identical' if upfront.token_ids == first.token_ids else 'differs'} "
          f"(for the record: other ViT batch sizes may round differently)")
    if first.token_ids != again.token_ids:
        raise AssertionError(f"repeat greedy generate differs: {first.token_ids} vs {again.token_ids}")
    outs = [first, again, *batched, bf16, upfront, interleaved]
    if not all(r.token_ids and all(0 <= t < tc.vocab_size for t in r.token_ids) for r in outs):
        raise AssertionError("empty output or token id outside [0, vocab)")
    if [r.prompt_tokens for r in outs] != [n_i, n_i, *lens_ii, n_i, n_i, n_i]:
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
        "w4_matmul": phase_kernels_w4(),
    }
    cfg, dev = long_vita_14b(), torch.device("cuda")
    params = _text_params(cfg, dev)
    launches = dict.fromkeys(SOURCES, 0)

    def add(counts):
        for name in SOURCES:
            launches[name] += counts[name]

    launches["flash_fwd"], bf16_logits = phase_serving(params)
    bits = _snapshot(params, set())
    add(phase_int4(params, cfg, dev, bf16_logits))
    add(phase_int8(params, cfg, dev, bf16_logits))
    changed = _moved(params, bits)
    print(f"[serve] the bf16 decoder after quantising it twice: {len(changed)} of "
          f"{len(bits)} tensors changed a bit")
    if changed:
        raise AssertionError(f"quantisation changed the bf16 weights: {sorted(changed)[:5]}")
    del bits
    add(phase_multimodal(params, cfg, dev))
    torch.cuda.empty_cache()  # the serving engines and their caches are gone
    log = logging.getLogger("long_vita_tpu_torch.training.trainer")  # a line per step
    log.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[trainer] %(message)s"))
    log.addHandler(handler)
    counts, lv = phase_train(params, cfg, dev, tag="T1", seq_len=32768, videos=(64, 16),
                             grid=(2, 3), freeze_vision=True, seed=SEED + 5)
    del lv
    add(counts)
    torch.cuda.empty_cache()
    counts, lv = phase_train(params, cfg, dev, tag="T2", seq_len=16384, videos=(16,),
                             grid=(2, 3), freeze_vision=False, vit_lr_mult=0.1, seed=SEED + 6)
    add(counts)
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
