#!/usr/bin/env python3
"""Time the int8-cache flash forward K2 (lvt_flash_fwd_quant) and the w4a16
product K6 (lvt_w4_matmul) against an older build of their sources, on one
GPU.

    git archive <commit> long_vita_tpu_torch/ops/csrc | tar -x -C build/old
    python3 tools/quant_ab.py --old build/old/long_vita_tpu_torch/ops/csrc

The older K2 keeps the current entry point's signature, so both builds take
the arguments ``flash_quant_args`` prepares. The older K6 took a split
count and a workspace of f32 partials [split, rows, out] where the current
one takes a block count and ``w4_split_plan``'s workspace: ``old_w4_cuda``
is the older wrapper, so each build is called as its own wrapper called it.
For each case: the older and the current kernel in turns (old, new, new,
old; each the device time of ``--reps`` calls queued behind a sleep,
chip_smoke.queued, over enough weight copies to keep K6's working set
out of L2 as decode finds it; the current K6 also on one copy, warm in L2
where it fits), both held against the plain PyTorch version,
the plain version's time, the nearest PyTorch call (K2: none computes the
function, K1 over a bf16 cache of the same shape is timed instead; K6:
torch.matmul on the dequantised bf16 weight, not the same function), and
the bound: the larger of the bytes (each input read once, each output
written once) over 3.35 TB/s and the operations over 989 TFLOP/s. Last,
the wrappers' host time a call (the older ``_w4_cuda`` against the current
one, q_proj at one row: the host clock around 200 calls, which return
before the device is done). The nvidia-smi line comes first and the last
line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (timing helpers, the card's peaks)

ENTRIES = {"flash_fwd_quant": "lvt_flash_fwd_quant", "w4_matmul": "lvt_w4_matmul"}


def build_old(csrc: Path) -> dict:
    """nvcc the older flash_fwd_quant.cu and w4_matmul.cu with the
    package's flags; -> {entry point: ctypes function}."""
    from long_vita_tpu_torch.ops import _build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ENTRIES:
        lib = out_dir / f"lib{name}-old.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(csrc / f"{name}.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the older {name}.cu:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build old] {name}: {line.strip()}")
        fn = getattr(ctypes.CDLL(str(lib)), ENTRIES[name])
        fn.argtypes = _build.argtypes(ENTRIES[name])
        fn.restype = ctypes.c_int
        fns[ENTRIES[name]] = fn
    return fns


def call(fn, args) -> None:
    import torch

    err = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")


def old_w4_cuda(fn, x, packed, scales, out_dtype):
    """The older _w4_cuda around the older kernel: its checks, its split of
    the groups over blocks (4 blocks an SM of 64 x 64 tiles) and its f32
    workspace, made on every call."""
    import torch

    rows, n_in = x.shape
    half, n_out = packed.shape
    if x.dtype not in (torch.bfloat16, torch.float32) or out_dtype not in (torch.bfloat16,
                                                                           torch.float32):
        raise TypeError("w4 kernel takes bf16 or f32")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("w4 kernel takes int8 packed and f32 scales")
    if n_in != 2 * half or n_out % 64 or scales.shape != (n_in // 128, n_out):
        raise ValueError("shapes")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed weights and scales must be contiguous")
    x = x.contiguous()
    if x.data_ptr() % 16 or packed.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError("x, packed and scales must be 16-byte aligned for the kernel")
    dev = x.device
    out = torch.empty((rows, n_out), dtype=out_dtype, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = (n_out // 64) * -(-rows // 64)
    ksplit = max(1, min(n_in // 256, -(-4 * sms // tiles)))
    ws = torch.empty((ksplit, rows, n_out), dtype=torch.float32, device=dev) if ksplit > 1 else None
    call(fn, (x, packed, scales, out, ws, rows, n_in, n_out, ksplit, 0,
              int(out_dtype == torch.float32)))
    return out


def turns(old, new, reps) -> tuple:
    """(old, new, new, old) queued device times of two lists of calls."""
    times = [cs.queued(fns, reps=reps)[0] for fns in (old, new, new, old)]
    return [times[0], times[3]], [times[1], times[2]]


def k2_case(name, old_fn, q, k, ks, v, vs, q_offset, kv_len, reps) -> dict:
    import torch

    from long_vita_tpu_torch.ops import _build
    from long_vita_tpu_torch.ops import flash_attention as fa

    new_fn = _build.kernel("lvt_flash_fwd_quant")
    kw = dict(q_offset=q_offset, kv_valid_len=kv_len)
    outs = {}
    for tag, fn in (("new", new_fn), ("old", old_fn)):
        o, lse, args = fa.flash_quant_args(q, k, ks, v, vs, q_offset, 0, kv_len)
        call(fn, args)
        torch.cuda.synchronize()
        outs[tag] = (o, args)
    ro, rlse = fa.flash_attention_quant_reference(q, k, ks, v, vs, **kw)
    res = {"name": name, "entry": "lvt_flash_fwd_quant"}
    for tag in ("new", "old"):
        res[f"max_abs_err_{tag}"] = (outs[tag][0].float() - ro.float()).abs().max().item()
    res["finite"] = bool(torch.isfinite(outs["new"][0].float()).all())
    res["plain_ms"] = cs.cuda_ms(lambda: fa.flash_attention_quant_reference(q, k, ks, v, vs, **kw),
                                  reps=3, warmup=1)
    args = outs["new"][1]
    res["old_ms"], res["new_ms"] = turns([lambda: call(old_fn, args)], [lambda: call(new_fn, args)],
                                         reps)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    res["k1_bf16_cache_ms"] = cs.queued(
        [lambda: fa.flash_attention(q, kb, vb, causal=True, **kw)], reps=reps)[0]
    sq, hq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv = k.shape[2]
    pairs = sum(min(kv_len, q_offset + i + 1) for i in range(sq))  # unmasked (q, k) pairs
    flops = 4 * hq * d * pairs
    res.update(cs._bound(2 * 2 * q.numel() + 2 * kv_len * hkv * (d + 4) + 4 * sq * hq, flops))
    old_ms, new_ms = sum(res["old_ms"]) / 2, sum(res["new_ms"]) / 2
    res["tflops_old"], res["tflops_new"] = flops / old_ms / 1e9, flops / new_ms / 1e9
    res["speedup"] = old_ms / new_ms
    res["library_ms"] = None
    print(f"[ab] {name}: old {res['old_ms'][0]:.3f}/{res['old_ms'][1]:.3f} ms "
          f"({res['tflops_old']:.1f} TFLOP/s), new {res['new_ms'][0]:.3f}/{res['new_ms'][1]:.3f} ms "
          f"({res['tflops_new']:.1f} TFLOP/s), {res['speedup']:.2f}x; bound {res['bound_ms']:.3f} ms "
          f"({res['bound_by']}); plain {res['plain_ms']:.3f} ms; K1 over a bf16 cache "
          f"{res['k1_bf16_cache_ms']:.3f} ms; max|o-ref| new {res['max_abs_err_new']:.3e} old "
          f"{res['max_abs_err_old']:.3e}")
    return res


def k6_case(name, old_fn, x, packed, scales, out_dtype, reps) -> dict:
    import torch

    from long_vita_tpu_torch.ops import quant_matmul as qm

    rows, n_in = x.shape
    n_out = packed.shape[1]
    new = qm._w4_cuda(x, packed, scales, out_dtype)
    old = old_w4_cuda(old_fn, x, packed, scales, out_dtype)
    ref = qm.w4_matmul_reference(x, packed, scales, out_dtype).float()
    res = {"name": name, "entry": "lvt_w4_matmul", "rows": rows, "n_in": n_in, "n_out": n_out,
           "max_ref": ref.abs().max().item(),
           "max_abs_err_new": (new.float() - ref).abs().max().item(),
           "max_abs_err_old": (old.float() - ref).abs().max().item(),
           "same_bits_again": torch.equal(new, qm._w4_cuda(x, packed, scales, out_dtype))}
    res["plain_ms"] = cs.cuda_ms(lambda: qm.w4_matmul_reference(x, packed, scales, out_dtype),
                                  reps=3, warmup=1)
    n_bytes = packed.numel() + 4 * scales.numel()
    copies = [(packed, scales)] + [(packed.clone(), scales.clone())
                                   for _ in range(-(-120_000_000 // n_bytes) - 1)]
    res["old_ms"], res["new_ms"] = turns(
        [lambda p=p, s=s: old_w4_cuda(old_fn, x, p, s, out_dtype) for p, s in copies],
        [lambda p=p, s=s: qm._w4_cuda(x, p, s, out_dtype) for p, s in copies], reps)
    del copies
    # the same calls on one copy of the weight, left in L2 when it fits (50
    # MB): against the cold time, what device memory's access pattern costs
    res["new_warm_ms"] = cs.queued([lambda: qm._w4_cuda(x, packed, scales, out_dtype)], reps)[0]
    w = (qm.unpack_int4_torch(packed).reshape(n_in // 128, 128, n_out).float()
         * scales[:, None]).reshape(n_in, n_out).to(torch.bfloat16)
    deqs = [w] + [w.clone() for _ in range(-(-120_000_000 // w.nbytes) - 1)]
    if out_dtype == torch.float32:
        res["library_ms"] = cs.queued(
            [lambda w=w: torch.mm(x, w, out_dtype=torch.float32) for w in deqs], reps=reps)[0]
    else:
        res["library_ms"] = cs.queued([lambda w=w: torch.matmul(x, w) for w in deqs], reps=reps)[0]
    del deqs, w
    res["library_call"] = "torch.matmul on the dequantised bf16 weight (not the same function)"
    res.update(cs._bound(2 * x.numel() + n_bytes + new.element_size() * new.numel(),
                         2 * rows * n_in * n_out))
    old_ms, new_ms = sum(res["old_ms"]) / 2, sum(res["new_ms"]) / 2
    res["speedup"] = old_ms / new_ms
    res["bound_share_new"] = res["bound_ms"] / new_ms
    print(f"[ab] {name} [{rows}, {n_in}] x [{n_in}, {n_out}]: old "
          f"{res['old_ms'][0] * 1e3:.1f}/{res['old_ms'][1] * 1e3:.1f} us, new "
          f"{res['new_ms'][0] * 1e3:.1f}/{res['new_ms'][1] * 1e3:.1f} us (warm L2 "
          f"{res['new_warm_ms'] * 1e3:.1f} us), {res['speedup']:.2f}x; "
          f"bound {res['bound_ms'] * 1e3:.1f} us ({res['bound_by']}, "
          f"{res['bound_share_new']:.1%} of it); torch.matmul dequantised "
          f"{res['library_ms'] * 1e3:.1f} us; plain {res['plain_ms']:.3f} ms; max|k-ref| new "
          f"{res['max_abs_err_new']:.3e} old {res['max_abs_err_old']:.3e} (max|ref| "
          f"{res['max_ref']:.3f}); a second call {'same bits' if res['same_bits_again'] else 'DIFFERS'}")
    return res


def host_us(fn, n=200) -> float:
    """Host time a call of fn in microseconds (the calls only queue work)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="directory of the older sources")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    import torch

    from long_vita_tpu_torch.models.qwen2 import quantize_kv
    from long_vita_tpu_torch.models.quantize import quantize_kernel_int4
    from long_vita_tpu_torch.ops import _build
    from long_vita_tpu_torch.ops import flash_attention  # noqa: F401  (registers K2)
    from long_vita_tpu_torch.ops import quant_matmul as qm

    if not torch.cuda.is_available():
        print("quant_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs._nvidia_smi()
    print(smi)
    old = build_old(a.old.resolve())
    _build.build_all(ENTRIES)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    # K2 at the serving chunk (as chip_smoke.py) and at the prompt's first chunk
    q = rnd(1, 2048, 40, 128)
    k, ks = quantize_kv(rnd(1, 32768, 8, 128))
    v, vs = quantize_kv(rnd(1, 32768, 8, 128))
    out = [k2_case(f"K2 chunk 2048 @{off}, int8 cache 32768 len {n}", old["lvt_flash_fwd_quant"],
                   q, k, ks, v, vs, off, n, a.reps) for off, n in ((14336, 16384), (0, 2048))]
    del q, k, ks, v, vs
    torch.cuda.empty_cache()
    host = {}
    for name, (n_in, n_out) in cs.W4_SHAPES.items():
        out_dtype = torch.float32 if name == "lm_head" else bf
        packed, scales = quantize_kernel_int4(rnd(n_out, n_in, scale=0.02))
        for rows in (1, 512):
            x = rnd(rows, n_in)
            out.append(k6_case(f"K6 {name}", old["lvt_w4_matmul"], x, packed, scales, out_dtype,
                               a.reps))
            if name == "q_proj/o_proj" and rows == 1:
                host["old_us"] = host_us(lambda: old_w4_cuda(old["lvt_w4_matmul"], x, packed,
                                                             scales, out_dtype))
                host["new_us"] = host_us(lambda: qm._w4_cuda(x, packed, scales, out_dtype))
                host["new_again_us"] = host_us(lambda: qm._w4_cuda(x, packed, scales, out_dtype))
                host["old_again_us"] = host_us(lambda: old_w4_cuda(old["lvt_w4_matmul"], x, packed,
                                                                   scales, out_dtype))
                print(f"[ab] _w4_cuda host time a call, q_proj at one row: old "
                      f"{host['old_us']:.1f}/{host['old_again_us']:.1f} us, new "
                      f"{host['new_us']:.1f}/{host['new_again_us']:.1f} us")
        del packed, scales
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"device": smi, "cases": out, "w4_host": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
