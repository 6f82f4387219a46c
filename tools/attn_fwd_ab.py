#!/usr/bin/env python3
"""Time the bf16 attention forwards K1 (lvt_flash_fwd) and K3
(lvt_short_attn) against an older build of their sources, on one GPU.

    git archive <commit> long_vita_tpu_torch/ops/csrc | tar -x -C build/old
    python3 tools/attn_fwd_ab.py --old build/old/long_vita_tpu_torch/ops/csrc

The older sources keep the C entry points' names and, but for the
``seg_ranges`` argument the current lvt_flash_fwd added, their signatures,
so both builds take the same prepared arguments (``flash_fwd_args``,
``short_attn_args``). For each case: the older and the current kernel in
turns (old, new, new, old; each the device time of ``--reps`` calls queued
behind a sleep, chip_smoke.queued), both held against
the plain PyTorch version where it fits in memory (else against each other),
the plain version's time, one PyTorch call that computes the same function
(``F.scaled_dot_product_attention``, as chip_smoke.py times it), and the
bound: the larger of the bytes (q, o, the valid K/V rows, lse; each once)
over 3.35 TB/s and the operations on unmasked (q, k) pairs over 989
TFLOP/s. Cases: K1 at the serving chunk, at T2's 16K and T1's 32K packed
causal rows, at D = 64 on the trainable tower's [16, 1025, 16, 64]; K3 at
the encode shape [64, 1025, 16, 64]. The nvidia-smi line comes first and
the last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (timing helpers, the card's peaks)


def build_old(csrc: Path) -> dict:
    """nvcc the older flash_fwd.cu and short_attn.cu with the package's
    flags; -> {entry point: ctypes function}."""
    from long_vita_tpu_torch.ops import _build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("flash_fwd", "short_attn"):
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
        entry = {"flash_fwd": "lvt_flash_fwd", "short_attn": "lvt_short_attn"}[name]
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = old_args(entry, _build.argtypes(entry))
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return fns


def old_args(entry, args):
    """The older lvt_flash_fwd takes no seg_ranges (argument 7)."""
    return args[:7] + args[8:] if entry == "lvt_flash_fwd" else args


def call(fn, args) -> None:
    import torch

    err = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError_t {err}")


def pairs(sq, kv_len, causal, q_off, seg, dev) -> int:
    """Unmasked (q, k) pairs of one batch row and head (seg: [Sq] ids of a
    self-attention row, or None)."""
    import torch

    total, kpos = 0, torch.arange(kv_len, device=dev)
    for r0 in range(0, sq, 2048):
        qpos = q_off + torch.arange(r0, min(sq, r0 + 2048), device=dev)
        m = torch.ones(len(qpos), kv_len, dtype=torch.bool, device=dev)
        if causal:
            m &= kpos[None] <= qpos[:, None]
        if seg is not None:
            m &= seg[r0:r0 + len(qpos), None] == seg[None, :kv_len]
        total += int(m.sum())
    return total


def case(name, entry, new_fn, old_fn, args, o, q, kv_rows, n_pairs, *, plain=None,
         library=None, library_call="", reps=10) -> dict:
    """One shape: n_pairs counts the unmasked (q, k) pairs of a head over
    the whole batch; kv_rows the valid K/V rows a batch row."""
    import torch

    hq, d = q.shape[2], q.shape[3]
    hkv = args[1].shape[2]
    args_old = old_args(entry, args)
    call(new_fn, args)
    o_new = o.clone()
    call(old_fn, args_old)
    o_old = o.clone()
    torch.cuda.synchronize()
    res = {"name": name, "entry": entry}
    if plain is not None:
        ro = plain()[0].float()
        res["max_abs_err_new"] = (o_new.float() - ro).abs().max().item()
        res["max_abs_err_old"] = (o_old.float() - ro).abs().max().item()
        del ro
        res["plain_ms"] = cs.cuda_ms(plain, reps=3, warmup=1)
    else:
        res["max_abs_err_new_vs_old"] = (o_new.float() - o_old.float()).abs().max().item()
        res["plain_ms"] = None
    res["finite"] = bool(torch.isfinite(o_new.float()).all())
    times = []
    for fn, a in ((old_fn, args_old), (new_fn, args), (new_fn, args), (old_fn, args_old)):
        times.append(cs.queued([lambda: call(fn, a)], reps=reps)[0])
    res["old_ms"] = [times[0], times[3]]
    res["new_ms"] = [times[1], times[2]]
    flops = 4 * hq * d * n_pairs
    n_bytes = 2 * 2 * q.numel() + 2 * 2 * q.shape[0] * kv_rows * hkv * d + 4 * q.numel() // d
    res.update(cs._bound(n_bytes, flops))
    old_ms, new_ms = sum(res["old_ms"]) / 2, sum(res["new_ms"]) / 2
    res["tflops_old"], res["tflops_new"] = flops / old_ms / 1e9, flops / new_ms / 1e9
    res["speedup"] = old_ms / new_ms
    res["library_ms"] = library() if library is not None else None
    res["library_call"] = library_call
    print(f"[ab] {name}: old {res['old_ms'][0]:.3f}/{res['old_ms'][1]:.3f} ms "
          f"({res['tflops_old']:.1f} TFLOP/s), new {res['new_ms'][0]:.3f}/{res['new_ms'][1]:.3f} "
          f"ms ({res['tflops_new']:.1f} TFLOP/s), {res['speedup']:.2f}x; bound "
          f"{res['bound_ms']:.3f} ms ({res['bound_by']}); plain {res['plain_ms']}; "
          f"{library_call} {res['library_ms']}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="directory of the older sources")
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    import torch

    from long_vita_tpu_torch.ops import _build
    from long_vita_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("attn_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = cs._nvidia_smi()
    print(smi)
    old = build_old(a.old.resolve())
    new = {e: _build.kernel(e) for e in ("lvt_flash_fwd", "lvt_short_attn")}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    out = []
    # K1 at the serving chunk: 2048 rows at offset 4096, 6144 of 16384 slots
    q, k, v = rnd(1, 2048, 40, 128), rnd(1, 16384, 8, 128), rnd(1, 16384, 8, 128)
    kw = dict(causal=True, q_offset=4096, kv_offset=0, kv_valid_len=6144)
    o, _, args = fa.flash_fwd_args(q, k, v, True, 4096, 0, 6144, None, None)
    out.append(case(
        "K1 (a) chunk 2048 @4096, cache 16384 len 6144", "lvt_flash_fwd",
        new["lvt_flash_fwd"], old["lvt_flash_fwd"], args, o, q, 6144,
        pairs(2048, 6144, True, 4096, None, dev),
        plain=lambda: fa.flash_attention_reference(q, k, v, **kw),
        library=lambda: cs._sdpa_ms(q, k[:, :6144], v[:, :6144], lower_right=True),
        library_call="sdpa lower-right causal, kv repeated", reps=a.reps))
    del q, k, v, o, args
    # K3 at the encode shape, q/k/v views of one qkv projection
    q, k, v = rnd(64, 1025, 3, 16, 64).unbind(2)
    o, _, args = fa.short_attn_args(q, k, v)
    out.append(case(
        "K3 [64, 1025, 16, 64]", "lvt_short_attn", new["lvt_short_attn"],
        old["lvt_short_attn"], args, o, q, 1025, 64 * 1025 * 1025,
        plain=lambda: fa.short_attention_reference(q, k, v),
        library=lambda: cs._sdpa_ms(q, k, v), library_call="sdpa", reps=a.reps))
    # K1 at D = 64 on the trainable tower's shape, non-causal
    q, k, v = rnd(16, 1025, 3, 16, 64).unbind(2)
    o, _, args = fa.flash_fwd_args(q, k, v, False, 0, 0, 1025, None, None)
    out.append(case(
        "K1 D64 [16, 1025, 16, 64] non-causal", "lvt_flash_fwd", new["lvt_flash_fwd"],
        old["lvt_flash_fwd"], args, o, q, 1025, 16 * 1025 * 1025,
        plain=lambda: fa.flash_attention_reference(q, k, v, causal=False),
        library=lambda: cs._sdpa_ms(q, k, v), library_call="sdpa", reps=a.reps))
    del q, k, v, o, args
    # K1 at T2's 16K and T1's 32K packed rows: causal with segments
    for s, cuts in ((16384, (5000, 9000, 12000)), (32768, (16552, 21000, 25000, 29000))):
        q, k, v = rnd(1, s, 40, 128), rnd(1, s, 8, 128), rnd(1, s, 8, 128)
        seg = cs._segments(1, s, cuts, dev)
        o, _, args = fa.flash_fwd_args(q, k, v, True, 0, 0, s, seg, seg)
        out.append(case(
            f"K1 causal [1, {s}, 40/8, 128], {len(cuts) + 1} segments", "lvt_flash_fwd",
            new["lvt_flash_fwd"], old["lvt_flash_fwd"], args, o, q, s,
            pairs(s, s, True, 0, seg[0], dev),
            library=lambda: cs._sdpa_ms(q, k, v, lower_right=True, reps=5),
            library_call="sdpa causal without segments, kv repeated", reps=max(3, a.reps // 3)))
        del q, k, v, o, args
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"device": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
