#!/usr/bin/env python3
"""Build variants of the Hopper backward (ops/csrc/flash_bwd_sm90.cuh) side
by side and compare them on one GPU.

    python3 tools/attn_bwd_variants.py

Each variant is a copy of ops/csrc under build/exp/<name>/ with text edits
applied to flash_bwd_sm90.cuh (EDITS; each must match exactly once):
  one_group  K5's dkv pass issues dV += P^T.dO and dK += dS^T.Q as one
             commit group (the committed source waits for dV before it
             issues dK);
  ds_smem    K5's dkv pass stages dS^T in shared memory (as K4 does) and
             reads it there as dK's A operand, so no dS fragments stay in
             registers;
  dq_apart   K4 waits for dV and dK before it issues dQ = dS.K.
For each variant: ptxas's serialisation notes (C7512, C7520) and spills of
the D 128 kv-major kernels; K4 and K5 held to the plain backward with
chip_smoke's GRAD_TOL at [1, 4096, 40/8, 128] with 3 segments, K4 on T2's
16K and K5 on T1's 32K packed rows (the plain backward a segment at a time
there); the variants timed in turns (each the median of CUDA events),
K5's dkv pass also alone. ``--gen-only`` writes the variant sources and
exits (no GPU needed).
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
CSRC = ROOT / "long_vita_tpu_torch" / "ops" / "csrc"
EXP = ROOT / "build" / "exp"

# the committed dkv pass waits for dV before it issues dK; one_group drops that
R_OLD = """        else wgmma_rs_m64n64(dv, pf[kk], bo);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      wgmma_fence();
#pragma unroll"""
R_NEW = """        else wgmma_rs_m64n64(dv, pf[kk], bo);
      }
#pragma unroll"""

B1_OLD = "static constexpr int dqs = ds + (kFused ? 2 * kDsBytes : 0);"
B1_NEW = "static constexpr int dqs = ds + 2 * kDsBytes;"
B2_OLD = """      uint32_t df[kBQ / 16][4];
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
        df[n / 2][(n & 1) * 2 + 0] = pack_f32(dpt[4 * n], dpt[4 * n + 1]);
        df[n / 2][(n & 1) * 2 + 1] = pack_f32(dpt[4 * n + 2], dpt[4 * n + 3]);
      }
      fence_regs(dv);"""
B2_NEW = """      unsigned char* ds_s = base + L::ds + (it & 1) * kDsBytes;
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n) {
        const int off = ((n ^ (rl & 7)) * 16) + 4 * i4;
        *reinterpret_cast<uint32_t*>(ds_s + rl * 128 + off) = pack_f32(dpt[4 * n], dpt[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(ds_s + (rl + 8) * 128 + off) =
            pack_f32(dpt[4 * n + 2], dpt[4 * n + 3]);
      }
      fence_proxy_async();
      bar_sync(2 + wg, 128);
      const uint32_t ds_u = base_u + L::ds + (it & 1) * kDsBytes;
      fence_regs(dv);"""
B3_OLD = """        const uint64_t bq = sw128_desc(q_s + kk * 16 * 128, kQBox, 1024);
        if constexpr (D == 128) wgmma_rs_m64n128(dk, df[kk], bq);
        else wgmma_rs_m64n64(dk, df[kk], bq);"""
B3_NEW = """        const uint64_t da = sw128_desc(ds_u + r0 * 128 + kk * 32, 16, 1024);
        const uint64_t bq = sw128_desc(q_s + kk * 16 * 128, kQBox, 1024);
        if constexpr (D == 128) wgmma_ss_m64n128_tb(dk, da, bq, 1);
        else wgmma_ss_m64n64_tb(dk, da, bq, 1);"""

C_OLD = """#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t da = sw128_desc(ds_u + kk * 16 * 128, kQBox, 1024);"""
C_NEW = """      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
""" + C_OLD

EDITS = {"R": [(R_OLD, R_NEW)], "B": [(B1_OLD, B1_NEW), (B2_OLD, B2_NEW), (B3_OLD, B3_NEW)],
         "C": [(C_OLD, C_NEW)]}
VARIANTS = {"base": "", "one_group": "R", "ds_smem": "B", "dq_apart": "C"}


def generate() -> None:
    for name, letters in VARIANTS.items():
        d = EXP / name / "csrc"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(CSRC, d)
        src = (d / "flash_bwd_sm90.cuh").read_text()
        for letter in letters:
            for old, new in EDITS[letter]:
                assert src.count(old) == 1, (name, letter, old[:60])
                src = src.replace(old, new)
        (d / "flash_bwd_sm90.cuh").write_text(src)
        print(f"[gen] {name}: {letters or 'as committed'}")


def ptxas_summary(log: str) -> dict:
    fn, out = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
        if m:
            fn = m.group(1)
        if "C7512" in line or "C7520" in line:
            f = re.search(r"'(_Z\w+)'", line).group(1)
            out.setdefault(f, {})["serial"] = "C7512" if "C7512" in line else "C7520"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            out.setdefault(fn, {})["spill"] = int(m.group(1))
    return {k: v for k, v in out.items() if "dkv_kernelILi128" in k}


def build() -> dict:
    from long_vita_tpu_torch.ops import _build
    from long_vita_tpu_torch.ops import flash_attention  # noqa: F401

    procs = {}
    for name in VARIANTS:
        for src in ("flash_bwd", "flash_bwd_2pass"):
            lib = EXP / name / f"lib{src}.so"
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                   str(EXP / name / "csrc" / f"{src}.cu")]
            procs[(name, src)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (name, src), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[build] {name}/{src} FAILED\n{log[-3000:]}")
            continue
        for f, v in sorted(ptxas_summary(log).items()):
            print(f"[build] {name}/{src} {f[-30:]}: {v}")
        entries = ["lvt_flash_bwd"] if src == "flash_bwd" else ["lvt_flash_bwd_dkv",
                                                                 "lvt_flash_bwd_dq"]
        for e in entries:
            fn = getattr(ctypes.CDLL(str(lib)), e)
            fn.argtypes = _build.argtypes(e)
            fn.restype = ctypes.c_int
            fns.setdefault(name, {})[e] = fn
    return {k: v for k, v in fns.items() if len(v) == 3}


def main() -> int:
    if "--gen-only" in sys.argv:
        generate()
        return 0
    import torch

    import chip_smoke as cs
    from attn_fwd_ab import call
    from long_vita_tpu_torch.ops import flash_attention as fa

    print(cs._nvidia_smi(), flush=True)
    generate()
    fns = build()
    names = list(fns)
    print(f"[build] usable: {names}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = [(4096, None), (16384, (16,)), (32768, (64, 16))]
    for s, videos in rows:
        q, k, v, do = rnd(1, s, 40, 128), rnd(1, s, 8, 128), rnd(1, s, 8, 128), rnd(1, s, 40, 128)
        seg = (cs._segments(1, s, (s // 4, 5 * s // 8), dev) if videos is None
               else cs._train_segments(s, videos, (2, 3), dev))
        kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        ref = (fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw) if s == 4096
               else cs._plain_bwd_by_segment(q, k, v, o, lse, do, seg))
        for fused in (True, False):
            if s == 16384 and not fused or s == 32768 and fused:
                continue
            a = fa.bwd_operands(q, k, v, o, lse, do, True, 0, 0, s, seg, seg, fused)
            args = fa.bwd_launch_args(a)
            ents = ["lvt_flash_bwd"] if fused else ["lvt_flash_bwd_dkv", "lvt_flash_bwd_dq"]

            def runner(name, ents=ents, a=a, args=args, fused=fused):
                def go():
                    if fused:
                        a["dq"].zero_()
                    for e in ents:
                        call(fns[name][e], args)
                return go

            def dkv_only(name, a=a, args=args):
                return lambda: call(fns[name]["lvt_flash_bwd_dkv"], args)

            for name in names:
                runner(name)()
                torch.cuda.synchronize()
                got = (a["dq"].to(q.dtype), a["dk"], a["dv"])
                try:
                    cs._grad_errs(f"{name} {'K4' if fused else 'K5'} s={s}", got, ref)
                except AssertionError as e:
                    print(f"[check] {name}: {e}")
            order = names + names[::-1]
            t = {n: [] for n in names}
            for n in order:
                t[n].append(cs._cuda_ms(runner(n), reps=5 if s > 4096 else 10))
            line = ", ".join(f"{n} {min(x):.3f}/{max(x):.3f}" for n, x in t.items())
            print(f"[time] s={s} {'K4' if fused else 'K5 dkv+dq'}: {line}", flush=True)
            if not fused:
                t = {n: [] for n in names}
                for n in order:
                    t[n].append(cs._cuda_ms(dkv_only(n), reps=5 if s > 4096 else 10))
                line = ", ".join(f"{n} {min(x):.3f}/{max(x):.3f}" for n, x in t.items())
                print(f"[time] s={s} K5 dkv alone: {line}", flush=True)
        del q, k, v, do, o, lse, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
