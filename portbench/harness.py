"""What every entry of the benchmark shares: the manifest and the files it
names, the result line, the statistics, the device record, and the check
that no JAX module came in."""
from __future__ import annotations

import importlib
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORK = os.path.join(ROOT, "build", "portbench")  # git-ignored, inside the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "long_vita_tpu")


def cache_env() -> None:
    """Point every build and kernel cache at fixed directories of the
    checkout, and set the allocator (before torch is imported)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(WORK, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(WORK, "torch_extensions")
    # the 72B stage's step peaks within 3 GiB of the card; one-size blocks
    # would leave it unable to reuse what the head's backward frees
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def read_json(*parts) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def named(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json`` (a cell, configuration or traffic mix)."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return read_json(HERE, kind, f"{name}.json")


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a generator or a reader)."""
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", name):
        raise ValueError(f"not a module name: {name!r}")
    return importlib.import_module(f"portbench.{kind}.{name}")


def manifest() -> dict:
    return read_json(ROOT, "BENCHMARK.json")


def metrics_of(man: dict, section: str, cell: str) -> list[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in man[section] if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<name up to the first
    dot>.py``; the cell-suffixed splits of one quantity share it."""
    return module("metrics", metric.split(".")[0])


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics
    (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = q * (len(v) - 1)
    i = int(x)
    return v[i] if i + 1 >= len(v) else v[i] + (x - i) * (v[i + 1] - v[i])


def within(checks: dict) -> bool:
    """Whether every number compared lies within its limit: the one
    predicate that judges a run, and judges the control in its place."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def device_record(torch, count: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count)),
    }


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def emit(result: dict, checks: dict) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output,
    the checks under the key that comes last."""
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
