#!/usr/bin/env python3
"""Attribute the w4a16 kernel K6's time at one row (decode) on one GPU.

    python3 tools/w4_variants.py

Builds text-edited variants of ops/csrc/w4_matmul.cu side by side under
build/w4v/ (one nvcc each), every one with a part of its work removed, so
their results are wrong and only their times mean anything: "empty" (no
units: the launch alone), "noload" (no TMA of the packed codes), "nomma"
(no wgmma), "nolds" (no shared loads of the codes), "noscale" (no scale
loads after the first unit), "nofinish" (a tile that spans blocks is
written by each of them instead of being summed). Each is timed twice
(device time of 40 calls queued behind a sleep over enough weight copies
to keep L2 cold, chip_smoke.queued) at q_proj, k_proj, gate_proj and
lm_head, one row, with the current wrapper's cut and workspace. An edit
that no longer matches the source stops the script: keep EDITS in step
with w4_matmul.cu. The nvidia-smi line comes first and the last line is
one JSON object with every time in microseconds.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from long_vita_tpu_torch.models.quantize import quantize_kernel_int4  # noqa: E402
from long_vita_tpu_torch.ops import _build, quant_matmul as qm  # noqa: E402

SRC = (ROOT / "long_vita_tpu_torch/ops/csrc/w4_matmul.cu").read_text()
EDITS = {
    "base": [],
    "empty": [("  const int u1 = unit_begin(blockIdx.x + 1, p.units, p.blocks);\n",
               "  const int u1 = u0;\n")],
    "noload": [("      tma_load_2d(dst, &p.tp, bar_full + 8 * s, ct * kBM, pr * kGroup);\n", ""),
               ("      mbar_arrive_tx(bar_full + 8 * s, L::kStage);\n",
                "      mbar_arrive_tx(bar_full + 8 * s, L::kStage - kPacked);\n")],
    "nomma": [("    for (int kk = 0; kk < kGroup / 16; ++kk) wgmma_rs_kb<N>(dt, at[kk], x_desc<N>(x_u, 0, kk), kk);\n", ""),
              ("    for (int kk = 0; kk < kGroup / 16; ++kk) wgmma_rs_kb<N>(db, ab[kk], x_desc<N>(x_u, 1, kk), kk);\n", "")],
    "nolds": [("        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(\n            pk + r * 128 + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15)));\n",
               "        const uint32_t w0 = r * 77u + cb;\n"),
              ("        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(\n            pk + (r + 1) * 128 + ((((cb >> 4) ^ ((r + 1) & 7)) << 4) | (cb & 15)));\n",
               "        const uint32_t w1 = r * 31u + cb;\n")],
    "noscale": [("    if (u + 1 < u1) scales_of(u + 1, st_next, sb_next);\n", "")],
    "nofinish": [("      finish_tile<N, OutT>(p, flag, wg, tile, tile * p.pairs < u0 || pr != p.pairs - 1,\n",
                  "      finish_tile<N, OutT>(p, flag, wg, tile, false,\n")],
}


def build(name, edits):
    """Start nvcc on a copy of csrc/ with `edits` applied to w4_matmul.cu.
    -> (library path, process)."""
    d = ROOT / "build" / "w4v" / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(ROOT / "long_vita_tpu_torch/ops/csrc", d)
    src = SRC
    for a, b in edits:
        assert src.count(a) == 1, (name, a[:60])
        src = src.replace(a, b)
    (d / "w4_matmul.cu").write_text(src)
    lib = d / "lib.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "w4_matmul.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    print(cs._nvidia_smi())
    procs = {n: build(n, e) for n, e in EDITS.items()}
    fns = {}
    for n, (lib, pr) in procs.items():
        log, _ = pr.communicate()
        if pr.returncode:
            raise RuntimeError(f"nvcc failed on variant {n}:\n{log[-2000:]}")
        fn = getattr(ctypes.CDLL(str(lib)), "lvt_w4_matmul")
        fn.argtypes = _build.argtypes("lvt_w4_matmul")
        fn.restype = ctypes.c_int
        fns[n] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (n_in, n_out) in (("q_proj", (5120, 5120)), ("k_proj", (5120, 1024)),
                                ("gate", (5120, 13824)), ("lm_head", (5120, 152064))):
        w = torch.randn(n_out, n_in, generator=gen, device=dev) * 0.02  # [out, in]
        packed, scales = quantize_kernel_int4(w.bfloat16())
        del w
        x = torch.randn(1, n_in, generator=gen, device=dev).bfloat16()
        od = torch.float32 if name == "lm_head" else torch.bfloat16
        shape = qm.w4_launch_shape(1, n_in, n_out, qm._sm_count(0))
        ws = qm._workspace(dev, shape)
        nb = packed.numel() + 4 * scales.numel()
        copies = [(packed, scales)] + [(packed.clone(), scales.clone()) for _ in range(-(-120_000_000 // nb) - 1)]
        o = torch.empty(1, n_out, dtype=od, device=dev)
        row = {}
        for v, fn in fns.items():
            def call(p, s, fn=fn):
                err = fn(x.data_ptr(), p.data_ptr(), s.data_ptr(), o.data_ptr(), ws.data_ptr(), 1, n_in, n_out,
                         shape.blocks, 0, int(od == torch.float32), torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            row[v] = [cs.queued([lambda p=p, s=s: call(p, s) for p, s in copies], reps=40)[0] * 1e3 for _ in range(2)]
        ws.zero_()
        out[name] = row
        print(name, shape, {k: [round(t, 2) for t in v] for k, v in row.items()})
        del copies, packed, scales
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
