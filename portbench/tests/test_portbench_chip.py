"""Runs on the card (marked ``cuda``; each test skips on a machine without
one, deciding inside the test). Run them there with

    python -m pytest -m cuda portbench/tests/test_portbench_chip.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import harness


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _run(*args, timeout=1500) -> list:
    out = subprocess.run([sys.executable, *args], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_a_short_run_of_the_cell_is_correct(cell):
    _card()
    result = _run("portbench/run.py", "--workload", cell, "--seed", "2147483659",
                  "--seconds", "10", "--trace", "0")[-1]
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_the_control_fails_the_limits(cell):
    """The fp8 control put in the program's place comes out not correct by
    the run's own predicate, at the cell's own sizes and limits."""
    _card()
    line = _run("portbench/control.py", "--workload", cell, "--seeds", "17",
                "--seconds", "10")[-1]
    assert line["correct"] and line["control_correct"] is False, line["checks"]


def test_no_result_without_a_card():
    """A machine without the card gets no result line and a non-zero exit."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          harness.manifest()["workloads"][0]["name"], "--seed", "1", "--seconds",
                          "1"], cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()
