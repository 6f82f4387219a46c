#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

For each seed, in one process: a run of the cell (a window of ``--seconds``
at the cell's own load and sizes) judged as the benchmark judges it, and
the control: the plain reference computed with every matrix in fp8 (the
precision below the configuration's bfloat16) put in the program's place,
judged by the same predicate at the cell's limits. Prints one JSON line a
seed with both readings and both verdicts, and exits non-zero if the
control came out correct on any seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10 --fault half_batch

With ``--fault`` the run is the program with that fault planted
(``portbench/system.py``'s FAULTS) and no control: the fault's readings.
The benchmark's own runs never run the control or a fault.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    import argparse
    import importlib
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    harness.cache_env()
    import torch

    from portbench import system
    from portbench.run import environment

    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 2
    if args.fault is not None:
        system.FAULTS[args.fault](setattr)
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        env = environment(args.workload, seed, args.seconds, False, "cuda", time.perf_counter())
        env.control = args.fault is None
        result, checks = importlib.import_module(f"portbench.{env.cell['entry']}").run(env)
        line = {"seed": seed, "fault": args.fault, "correct": result["correct"]}
        if env.control:
            line["control_correct"] = result["control_correct"]
            if result["control_correct"]:
                passed.append(seed)
        print(json.dumps({**line, "checks": checks, "metrics": result["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    if passed:
        print(f"the control came out correct on seeds {passed}", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
