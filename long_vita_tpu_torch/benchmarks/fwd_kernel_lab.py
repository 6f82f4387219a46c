"""The forward-kernel lab: K7's variants of the Hopper forward against K1.

Counterpart of benchmarks/fwd_kernel_lab.py. The TPU lab timed scratch
variants of the production forward (its `_variant_kernel`, Pallas) to test
what bounds it; here each variant is a compile-time policy of the Hopper
forward (``ops/csrc/fwd_kernel_lab.cu``, K7), built with nvcc at first use
like every kernel of the port:

  - ``variant_flash``: causal attention from position 0 on head-major q
    [B, Hq, S, D], k and v [B, Hkv, S, D] (GQA, no segments, no offsets),
    with the lab's switches ``fastpath``, ``cheap_mask``, ``wide_ml`` and
    ``block_kv`` (128 or 64 kv rows a tile); a CUDA tensor launches K7, a
    CPU tensor takes ``variant_flash_reference``;
  - ``run_lab``: what the TPU lab's ``main`` measures, on the card: K1
    (production) and every variant at [1, 16384, 40/8, 128] bf16 with
    ``F.scaled_dot_product_attention`` (kv repeated to the 40 heads) as the
    library yardstick where the TPU lab had splash attention; then the
    forward + backward of K4 (one-pass) and K5 (two-pass) beside that
    library call's, on the lab's 7-unit operation count. Every kernel's
    output there is held to its plain version on the same inputs.

Run on the card: ``python -m long_vita_tpu_torch.benchmarks.fwd_kernel_lab``
(prints a line per contender and one JSON line of results; exits 1 without a
CUDA device or when a kernel disagrees with its plain version).
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import sys

import numpy as np
import torch

from long_vita_tpu_torch.benchmarks.timing import cuda_ms, queued
from long_vita_tpu_torch.ops import _build
from long_vita_tpu_torch.ops._target import on_cuda

# the Pallas variant's mask value and empty-row lse (np.finfo(f32).min)
NEG_INF = float(np.finfo(np.float32).min)
BLOCK_KVS = (128, 64)
# the card's published dense bf16 peak (NVIDIA H100 SXM data sheet, 700 W)
BF16_FLOPS = 989e12
# a kernel against the plain version (chip_smoke.py's tolerances): both
# round p and o to bf16, at other points (the kernel where the running max
# moves), so o is held to 1e-2 abs + 1e-2 rel and the f32 lse, which sees
# no bf16 rounding, to 1e-3; the backward rounds p and dS to bf16 from
# logits summed in another order, so each gradient is held to 1e-2 x
# max|ref| + 1e-2 x |ref|
O_ATOL, O_RTOL, LSE_ATOL, GRAD_TOL = 1e-2, 1e-2, 1e-3, 1e-2

_build.register("lvt_fwd_lab", "fwd_kernel_lab", (
    [ctypes.c_void_p] * 5       # q k v o lse
    + [ctypes.c_int] * 9        # batch hq hkv s d block_kv fastpath cheap_mask wide_ml
    + [ctypes.c_float]          # scale
))


def variant_flash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_kv: int = 128,
    cheap_mask: bool = True,
    fastpath: bool = True,
    wide_ml: bool = False,
    return_lse: bool = False,
):
    """Causal attention from position 0, head-major: q [B, Hq, S, D], k and
    v [B, Hkv, S, D] -> o [B, Hq, S, D] (and lse [B, Hq, S] f32 when
    return_lse). The switches pick K7's variant; they do not change the
    function, so the plain version ignores them."""
    if on_cuda(q, k, v):
        o, lse = _lab_cuda(q, k, v, block_kv, cheap_mask, fastpath, wide_ml)
    else:
        o, lse = variant_flash_reference(q, k, v)
    return (o, lse) if return_lse else o


variant_flash.launches = 0  # CUDA kernel launches (the wrapper counts them)


def lab_args(q, k, v, block_kv, cheap_mask, fastpath, wide_ml):
    """Check q, k, v for K7 and prepare its launch: -> (o, lse, the
    arguments of lvt_fwd_lab before the stream)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K7 takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in (64, 128) or block_kv not in BLOCK_KVS or (d == 64 and block_kv != 128):
        raise ValueError(f"K7 is built at D 128 with kv tiles of 128 or 64 rows and at D 64 "
                         f"with 128, got D {d}, block_kv {block_kv}")
    if max(b, hq, -(-s // 128)) > 65535 or s >= 2**31:
        raise ValueError(f"K7's grid takes at most 65535 batch rows, heads and q tiles, got "
                         f"{tuple(q.shape)}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    return o, lse, (q, k, v, o, lse, b, hq, hkv, s, d, block_kv, int(fastpath),
                    int(cheap_mask), int(wide_ml), 1.0 / math.sqrt(d))


def _lab_cuda(q, k, v, block_kv, cheap_mask, fastpath, wide_ml):
    o, lse, args = lab_args(q, k, v, block_kv, cheap_mask, fastpath, wide_ml)
    _build.launch("lvt_fwd_lab", q.device, *args)
    _build.count(variant_flash)
    return o, lse


def variant_flash_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7 (the Pallas `_variant_kernel`), one kv
    head's GQA group at a time: f32 logits q.k^T / sqrt(D), the causal mask
    with the f32 minimum, p = exp(s - max) rounded to v's dtype before P.V
    with f32 accumulation, o = acc / l, lse = max + log(l) (an empty row: o
    = 0 and lse = the f32 minimum, as the Pallas kernel gives; causal from
    position 0 has none). -> (o [B, Hq, S, D] in q's dtype, lse [B, Hq, S]
    f32)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    for h in range(hkv):
        heads = slice(h * g, (h + 1) * g)
        kh, vh = k[:, h:h + 1].float(), v[:, h:h + 1]
        sc = (q[:, heads].float() @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
        sc = sc.masked_fill_(~mask, NEG_INF)
        m = sc.amax(-1, keepdim=True)
        p = sc.sub_(m).exp_().masked_fill_(~mask, 0.0)  # sc is not used again
        l = p.sum(-1, keepdim=True)
        acc = p.to(v.dtype).float() @ vh.float()
        o[:, heads] = (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)
        lse[:, heads] = torch.where(l == 0, NEG_INF, m + torch.log(l))[..., 0]
    return o, lse


def variants() -> list[dict]:
    """Every switch combination at each kv tile K7 is built with at D 128."""
    return [dict(block_kv=bk, fastpath=f, cheap_mask=c, wide_ml=w)
            for bk in BLOCK_KVS for f, c, w in itertools.product((False, True), repeat=3)]


def variant_name(kw: dict) -> str:
    on = [n for n in ("fastpath", "cheap_mask", "wide_ml") if kw[n]]
    return f"K7 bk{kw['block_kv']} " + ("+".join(on) if on else "base")


def run_lab(*, s: int = 16384, heads=(40, 8), d: int = 128, reps: int = 10, seed: int = 0,
            log=print, device="cuda") -> dict:
    """The lab on the card at [1, s, heads, d] bf16 (causal from 0). The
    plain version's output is the reference: K1 and every K7 variant are held
    to it (o to O_ATOL + O_RTOL x |ref|, the lse to LSE_ATOL), one K4 and one
    K5 backward on K1's (o, lse) to the plain backward on the same inputs
    (each gradient to GRAD_TOL x max|ref| + GRAD_TOL x |ref|). -> {"forward":
    {name: {ms, tflops, host_ms (K1), max_abs_err (vs K1), plain_err,
    plain_lse_err, worst (err / tolerance, o) and ok (the kernels)}},
    "backward": {name: {ms, tflops, and for K4 and K5 max_abs_err [dq, dk,
    dv], worst and ok}}, "flops", "bound_ms", "plain_ms", "ok" (every kernel
    held), "failed" (the names that were not)}; each line also goes to
    ``log``. Every K7 variant is launched 2 + reps + 1 times (warm-up, timed,
    the comparison), K1 as many times and 21 more for its host time, then 2
    x (2 + max(reps // 2, 3)) + 1 times with the backward, each of K4's and
    K5's passes 2 + max(reps // 2, 3) + 1 times."""
    import torch.nn.functional as F

    from long_vita_tpu_torch.ops import flash_attention as fa

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the forward-kernel lab runs on a CUDA device")
    hq, hkv = heads
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q_sm, k_sm, v_sm = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
    q_hm, k_hm, v_hm = (x.transpose(1, 2).contiguous() for x in (q_sm, k_sm, v_sm))
    flops = 4 * hq * s * s * d * 0.5
    bound_ms = flops / BF16_FLOPS * 1e3
    fwd, bwd = {}, {}
    ro, rlse = variant_flash_reference(q_hm, k_hm, v_hm)
    plain_ms = cuda_ms(lambda: variant_flash_reference(q_hm, k_hm, v_hm), 2, warmup=0)
    log(f"[lab] plain version (variant_flash_reference, a kv head's group at a time) "
        f"{plain_ms:.3f} ms; bound {bound_ms:.3f} ms: {flops / 1e12:.3f} TFLOP (4 S^2 Hq D / 2) "
        f"at {BF16_FLOPS / 1e12:.0f} TFLOP/s")

    def report(name, ms, out, lse=None, k1_out=None, host_ms=None):
        row = {"ms": ms, "tflops": flops / (ms * 1e-3) / 1e12}
        line = f"[lab] {name:36s} {ms:8.3f} ms {row['tflops']:7.1f} TFLOP/s"
        if host_ms is not None:
            row["host_ms"] = host_ms
            line += f", host {host_ms * 1e3:.1f} us a call"
        if k1_out is not None:
            row["max_abs_err"] = (out.float() - k1_out.float()).abs().max().item()
            line += f", max|o - K1| {row['max_abs_err']:.3e}"
        err = (out.float() - ro.float()).abs()
        row["plain_err"] = err.max().item()
        row["worst"] = (err / (O_ATOL + O_RTOL * ro.float().abs())).max().item()
        line += f", max|o - plain| {row['plain_err']:.3e} (worst err / tol {row['worst']:.3f})"
        if lse is not None:  # a kernel: held to the plain version
            row["plain_lse_err"] = (lse - rlse).abs().max().item()
            row["ok"] = (row["worst"] <= 1 and row["plain_lse_err"] <= LSE_ATOL
                         and bool(torch.isfinite(out.float()).all()))
            line += (f", max|lse - plain| {row['plain_lse_err']:.3e} (tol {LSE_ATOL}) "
                     f"{'ok' if row['ok'] else 'FAIL'}")
        log(line)
        fwd[name] = row

    def k1():
        return fa.flash_attention(q_sm, k_sm, v_sm, causal=True, return_lse=True)

    ms = cuda_ms(k1, reps)
    o, lse = k1()
    k1_o = o.transpose(1, 2)
    report("K1 (production)", ms, k1_o, lse, host_ms=queued([k1], 20, cycles=100_000_000)[1])
    for kw in variants():
        def k7(kw=kw):
            return variant_flash(q_hm, k_hm, v_hm, **kw)

        ms = cuda_ms(k7, reps)
        report(variant_name(kw), ms, *variant_flash(q_hm, k_hm, v_hm, return_lse=True, **kw),
               k1_out=k1_o)
    del o, lse
    g = hq // hkv
    k_rep, v_rep = k_hm.repeat_interleave(g, 1), v_hm.repeat_interleave(g, 1)

    def sdpa():
        return F.scaled_dot_product_attention(q_hm, k_rep, v_rep, is_causal=True)

    report("SDPA (library, kv repeated)", cuda_ms(sdpa, reps), sdpa(), k1_out=k1_o)
    del k_rep, v_rep, ro, rlse, k1_o

    # forward + backward on the lab's 7-unit model (2 forward, 5 backward
    # products, causal half)
    bwd_flops = flops * 3.5
    do = rnd(1, s, hq, d)

    def kernels(fused):
        o, lse = fa.flash_attention(q_sm, k_sm, v_sm, causal=True, return_lse=True)
        fa._flash_bwd_cuda(q_sm, k_sm, v_sm, o, lse, do, True, 0, 0, s, None, None, fused)

    leaves = [x.repeat_interleave(g, 1) if i else x.clone()
              for i, x in enumerate((q_hm, k_hm, v_hm))]
    leaves = [x.requires_grad_() for x in leaves]
    do_hm = do.transpose(1, 2).contiguous()

    def sdpa_fb():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(out, leaves, do_hm)

    for name, fn in (("K1 + K4 (one-pass)", lambda: kernels(True)),
                     ("K1 + K5 (two-pass)", lambda: kernels(False)),
                     ("SDPA forward + backward", sdpa_fb)):
        ms = cuda_ms(fn, max(reps // 2, 3))
        bwd[name] = {"ms": ms, "tflops": bwd_flops / (ms * 1e-3) / 1e12}
        log(f"[lab] {name:36s} {ms:8.3f} ms {bwd[name]['tflops']:7.1f} TFLOP/s (7-unit model)")
    del leaves, do_hm

    o, lse = fa.flash_attention(q_sm, k_sm, v_sm, causal=True, return_lse=True)
    ref = fa.flash_attention_bwd_reference_by_group(q_sm, k_sm, v_sm, o, lse, do)
    for name, fused in (("K1 + K4 (one-pass)", True), ("K1 + K5 (two-pass)", False)):
        got = fa._flash_bwd_cuda(q_sm, k_sm, v_sm, o, lse, do, True, 0, 0, s, None, None, fused)
        row, worst, errs = bwd[name], 0.0, []
        for x, r in zip(got, ref):
            err, r = (x.float() - r.float()).abs(), r.float().abs()
            errs.append(err.max().item())
            worst = max(worst, (err / (GRAD_TOL * r.max() + GRAD_TOL * r)).max().item())
        row.update(max_abs_err=errs, worst=worst,
                   ok=worst <= 1 and all(bool(torch.isfinite(x.float()).all()) for x in got))
        log(f"[lab] {name} backward vs the plain backward on K1's (o, lse): max|err| dq "
            f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (worst err / tol {worst:.3f}, tol "
            f"{GRAD_TOL} x max|ref| + {GRAD_TOL} x |ref|) {'ok' if row['ok'] else 'FAIL'}")
    failed = [n for n, r in {**fwd, **bwd}.items() if r.get("ok") is False]
    return {"shape": [1, s, hq, hkv, d], "flops": flops, "bound_ms": bound_ms,
            "plain_ms": plain_ms, "forward": fwd, "backward": bwd, "ok": not failed,
            "failed": failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fwd_kernel_lab: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all(["flash_fwd", "flash_bwd", "flash_bwd_2pass", "fwd_kernel_lab"])
    res = run_lab(s=args.seq, reps=args.reps, log=lambda *a: print(*a, file=sys.stderr))
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
