#!/usr/bin/env python3
"""Time the bf16 flash backward K4 (lvt_flash_bwd) and K5 (lvt_flash_bwd_dkv
+ lvt_flash_bwd_dq) against an older build of their sources, on one GPU.

    git archive <commit> long_vita_tpu_torch/ops/csrc | tar -x -C build/old
    python3 tools/attn_bwd_ab.py --old build/old/long_vita_tpu_torch/ops/csrc

The older sources keep the C entry points' names and, but for the
``seg_ranges`` and ``tile_order`` arguments the current ones added, their
signatures, so both
builds take the same prepared arguments (``bwd_operands``,
``bwd_launch_args``; the kv ids padded to rows of 4 suit both). For each
case: the older and the current kernels in turns (old, new, new, old; each
the median of CUDA events around ``--reps`` calls, K4's f32 dq sums zeroed
before each call), both held against the plain backward where it fits in
memory (else against each other), the plain version's time, SDPA forward +
backward on the same inputs (``F.scaled_dot_product_attention`` with the
same mask, kv repeated to the q heads, as chip_smoke.py times it), and the
bound: the larger of the bytes (each input read once, each output written
once) over 3.35 TB/s and the operations on the unmasked (q, k) pairs over 989
TFLOP/s. Cases: [1, 4096, 40/8, 128] causal with 3 segments (K4 and K5),
T2's 16K packed row (K4), T1's 32K packed row (K5), the trainable tower's
[16, 1025, 16, 64] non-causal (K4). The nvidia-smi line comes first and the
last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke as cs  # noqa: E402  (timing helpers, bounds, the packed rows)
from attn_fwd_ab import call  # noqa: E402  (a ctypes entry point on the current stream)

ENTRIES = {"flash_bwd": ("lvt_flash_bwd",), "flash_bwd_2pass": ("lvt_flash_bwd_dkv", "lvt_flash_bwd_dq")}


def old_args(args):
    """The older entry points take no seg_ranges and tile_order (arguments
    11 and 12)."""
    return args[:11] + args[13:]


def build_old(csrc: Path) -> dict:
    """nvcc the older flash_bwd.cu and flash_bwd_2pass.cu with the package's
    flags; -> {entry point: ctypes function}."""
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
        for entry in ENTRIES[name]:
            fn = getattr(ctypes.CDLL(str(lib)), entry)
            fn.argtypes = old_args(_build.argtypes(entry))
            fn.restype = ctypes.c_int
            fns[entry] = fn
    return fns


def case(name, kernel, new, old, q, k, v, do, kw, bound, *, plain=True, library=None,
         reps=5) -> dict:
    """One shape: ``kernel`` "K4" or "K5"; ``bound`` chip_smoke._bound's
    dict for the kernel's work."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    fused = kernel == "K4"
    entries = ["lvt_flash_bwd"] if fused else ["lvt_flash_bwd_dkv", "lvt_flash_bwd_dq"]
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    a = fa.bwd_operands(q, k, v, o, lse, do, kw["causal"], 0, 0, k.shape[1],
                        kw.get("q_segment_ids"), kw.get("kv_segment_ids"), fused)
    args = fa.bwd_launch_args(a)

    def run(fns, argv):
        def go():
            if fused:
                a["dq"].zero_()
            for e in entries:
                call(fns[e], argv)
        return go

    outs = {}
    for tag, fns, argv in (("new", new, args), ("old", old, old_args(args))):
        run(fns, argv)()
        torch.cuda.synchronize()
        outs[tag] = [x.float().clone() for x in (a["dq"], a["dk"], a["dv"])]
    res = {"name": name, "kernel": kernel}
    if plain:
        ref = [x.float() for x in fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)]
        for tag in ("new", "old"):
            res[f"max_rel_err_{tag}"] = max(
                (g - r).abs().max().item() / r.abs().max().item() for g, r in zip(outs[tag], ref))
        del ref
        res["plain_ms"] = cs._cuda_ms(
            lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw), reps=3, warmup=1)
    else:
        res["max_rel_err_new_vs_old"] = max(
            (g - r).abs().max().item() / r.abs().max().item()
            for g, r in zip(outs["new"], outs["old"]))
        res["plain_ms"] = None
    res["finite"] = all(bool(torch.isfinite(x).all()) for x in outs["new"])
    times = [cs._cuda_ms(run(fns, argv), reps=reps)
             for fns, argv in ((old, old_args(args)), (new, args), (new, args),
                               (old, old_args(args)))]
    res["old_ms"], res["new_ms"] = [times[0], times[3]], [times[1], times[2]]
    res["speedup"] = (times[0] + times[3]) / (times[1] + times[2])
    res.update(bound)
    res["library_ms"] = library() if library is not None else None
    print(f"[ab] {name} {kernel}: old {times[0]:.3f}/{times[3]:.3f} ms, new {times[1]:.3f}/"
          f"{times[2]:.3f} ms, {res['speedup']:.2f}x; bound {res['bound_ms']:.3f} ms "
          f"({res['bound_by']}); plain {res['plain_ms']}; SDPA forward + backward "
          f"{res['library_ms']}; errors "
          f"{ {k_: round(v_, 5) for k_, v_ in res.items() if k_.startswith('max_rel')} }",
          flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="directory of the older sources")
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    import torch

    from long_vita_tpu_torch.ops import _build
    from long_vita_tpu_torch.ops import flash_attention  # noqa: F401  (registers K4, K5)

    if not torch.cuda.is_available():
        print("attn_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = cs._nvidia_smi()
    print(smi)
    old = build_old(a.old.resolve())
    new = {e: _build.kernel(e) for es in ENTRIES.values() for e in es}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def pick(bounds, kernel):
        keys = ["flash_bwd"] if kernel == "K4" else ["flash_bwd_dkv", "flash_bwd_dq"]
        return {"bound_ms": sum(bounds[x]["bound_ms"] for x in keys),
                "bound_by": "/".join(sorted({bounds[x]["bound_by"] for x in keys}))}

    out = []
    # the decoder at 4096 tokens, 3 segments; then T2's and T1's packed rows
    rows = [(4096, None, ("K4", "K5")), (16384, (16,), ("K4",)), (32768, (64, 16), ("K5",))]
    for s, videos, kernels in rows:
        q, k, v, do = rnd(1, s, 40, 128), rnd(1, s, 8, 128), rnd(1, s, 8, 128), rnd(1, s, 40, 128)
        seg = (cs._segments(1, s, (s // 4, 5 * s // 8), dev) if videos is None
               else cs._train_segments(s, videos, (2, 3), dev))
        kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
        _, bounds = cs._bwd_bounds(q, k, seg)
        mask = (seg[0][:, None] == seg[0][None, :]) & torch.ones(
            s, s, dtype=torch.bool, device=dev).tril()
        lib = cs._sdpa_ms(q, k, v, mask=mask, do=do, reps=3) if s <= 16384 else None
        del mask
        label = (f"[1, {s}, 40/8, 128] causal, 3 segments" if videos is None
                 else f"{'T2' if s == 16384 else 'T1'}'s packed row [1, {s}, 40/8, 128]")
        for kernel in kernels:
            out.append(case(label, kernel, new, old, q, k, v, do, kw, pick(bounds, kernel),
                            plain=s == 4096, library=lambda: lib,
                            reps=a.reps if s == 4096 else 3))
        del q, k, v, do, seg
        torch.cuda.empty_cache()
    # the trainable tower: non-causal D 64, q/k/v views of one qkv projection
    q, k, v = rnd(16, 1025, 3, 16, 64).unbind(2)
    do = rnd(16, 1025, 16, 64)
    pairs = 16 * 1025 * 1025
    # q, k, v, do and lse, delta read; the f32 dq sums and dk, dv written
    n_bytes = 4 * 2 * q.numel() + 2 * 4 * q.numel() // 64 + 4 * q.numel() + 2 * 2 * q.numel()
    out.append(case("ViT [16, 1025, 16, 64] non-causal", "K4", new, old, q, k, v, do,
                    dict(causal=False), cs._bound(n_bytes, 5 * 2 * 16 * 64 * pairs),
                    library=lambda: cs._sdpa_ms(q, k, v, do=do, reps=5), reps=a.reps))
    print(smi)
    print(json.dumps({"device": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
