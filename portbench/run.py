#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``BENCHMARK.json``'s workload of that name; its file
``portbench/cells/<cell>.json`` names the configuration
(``portbench/configs/``), the traffic mix (``portbench/traffic/``) and the
entry that drives it (``serve`` or ``train``). The last line of standard
output is the result: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics read from a device trace. A
machine without the GPUs the cell asks for gets no result and a non-zero
exit.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def environment(name: str, seed: int, seconds: float, trace: bool, device: str, t0: float,
                man: dict | None = None, cell: dict | None = None, cfg: dict | None = None,
                mix: dict | None = None):
    """What an entry is handed: the cell's files, the run's arguments, and
    ``report``, which turns its numbers into the result's metrics."""
    man = man if man is not None else harness.manifest()
    cell = cell if cell is not None else harness.named("cells", name)
    cfg = cfg if cfg is not None else harness.named("configs", cell["config"])

    def report(e2e: dict, ctx) -> dict:
        out = {}
        if not trace:
            for m in harness.metrics_of(man, "end_to_end", name):
                out[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
            return out
        for m in harness.metrics_of(man, "per_layer", name):
            value = harness.reader(m["name"]).read(ctx, m["name"])
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    return types.SimpleNamespace(
        cell_name=name, cell=cell, cfg=cfg,
        mix=mix if mix is not None else harness.named("traffic", cell["traffic"]),
        seed=seed, seconds=seconds, trace=trace, device=device, t0=t0, report=report)


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_env()
    man = harness.manifest()
    entry = next((w for w in man["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} GPU(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    env = environment(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0, man)
    import importlib

    result, checks = importlib.import_module(f"portbench.{env.cell['entry']}").run(env)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
