"""CPU rehearsals of whole runs at the port's tiny geometry: what they load,
how the window counts, and that the comparison fails a broken program."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time

import pytest

from portbench import harness, serve, system
from portbench.tests import tiny

ROOT = harness.ROOT


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=900, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_rehearsal_loads_nothing_of_jax():
    code = ("from portbench.tests import tiny; from portbench import harness; import json\n"
            "r = [tiny.run(c)[0]['correct'] for c in ('tiny-video', 'tiny-train')]\n"
            "print(json.dumps([r, harness.forbidden_modules()]))")
    correct, loaded = json.loads(_python(code))
    assert correct == [True, True]
    assert loaded == []


def test_reference_imports_nothing_of_the_port():
    folder = os.path.join(ROOT, "portbench", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(folder, name)).read())
            for node in ast.walk(tree):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else []
                for mod in mods:
                    assert mod.split(".")[0] not in ("long_vita_tpu_torch", *harness.FORBIDDEN), \
                        (name, mod)
                    assert mod not in ("portbench.system", "portbench.serve", "portbench.train")
    code = ("import sys; import portbench.reference.serving, portbench.reference.training\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'long_vita_tpu_torch', 'long_vita_tpu', 'jax'}))")
    assert _python(code) == "[]"


def _stalled(monkeypatch, seconds: float):
    orig = serve.Window.step

    def step(self):
        if not getattr(self, "_stalled", False) and time.perf_counter() > self.t_open + 0.5:
            self._stalled = True
            time.sleep(seconds)
        return orig(self)

    monkeypatch.setattr(serve.Window, "step", step)


def test_a_stall_lowers_the_rate(monkeypatch):
    plain = tiny.run("tiny-video")[0]["metrics"]["prompt_tokens_per_s"]["value"]
    _stalled(monkeypatch, 3.0)
    slow = tiny.run("tiny-video")[0]["metrics"]["prompt_tokens_per_s"]["value"]
    assert slow < 0.6 * plain


def test_a_stall_raises_the_tail(monkeypatch):
    plain = tiny.run("tiny-doc")[0]["metrics"]["ttft_p90_ms"]["value"]
    _stalled(monkeypatch, 3.0)
    slow = tiny.run("tiny-doc")[0]["metrics"]["ttft_p90_ms"]["value"]
    assert slow > plain + 1000.0


def test_an_altered_token_fails(monkeypatch):
    system.FAULTS["token_altered"](monkeypatch.setattr)
    result, checks = tiny.run("tiny-video")
    assert not result["correct"] and checks["max_gap"]["value"] > checks["max_gap"]["limit"]


def test_a_cache_left_unwritten_fails(monkeypatch):
    """An admission that leaves the slot pool as it was: the decode ticks
    read a stale cache."""
    system.FAULTS["cache_unwritten"](monkeypatch.setattr)
    result, checks = tiny.run("tiny-video")
    assert not result["correct"] and checks["max_gap"]["value"] > checks["max_gap"]["limit"]


def _keep_state(setattr_) -> None:
    """An optimizer step that returns its state unchanged."""
    from long_vita_tpu_torch.training import optimizer

    def keep(self, params, grads, state, frozen_sq=None, g_norm=None):
        live = [g for g in grads.values() if g is not None]
        state.count += 1
        return optimizer.global_norm(live, frozen_sq) if g_norm is None else g_norm

    setattr_(optimizer.AdamW, "step", keep)


def _plant(monkeypatch, fault, window_only: bool) -> None:
    """Plant ``fault`` for the whole run, or once the set-up's steps have
    run, so that the window's steps alone go wrong."""
    if not window_only:
        fault(monkeypatch.setattr)
        return
    from long_vita_tpu_torch.training import trainer

    calls = [0]
    setup = tiny.CELLS["tiny-train"][0]["setup_steps"]
    orig = trainer.Trainer.train

    def train(self, batches, tokenizer=None):
        if calls[0] >= setup:
            fault(monkeypatch.setattr)
        calls[0] += 1
        return orig(self, batches, tokenizer)

    monkeypatch.setattr(trainer.Trainer, "train", train)


@pytest.mark.parametrize("window_only", [False, True], ids=["whole_run", "window_only"])
def test_half_the_batch_left_out_fails(monkeypatch, window_only):
    """The loss's mean taken over the first half of the supervised targets
    only: the steps' supervised counts part from the reference's."""
    _plant(monkeypatch, system.FAULTS["half_batch"], window_only)
    result, checks = tiny.run("tiny-train")
    assert not result["correct"]
    assert checks["supervised_gap"]["value"] > checks["supervised_gap"]["limit"]


@pytest.mark.parametrize("window_only", [False, True], ids=["whole_run", "window_only"])
def test_a_step_that_keeps_its_state_fails(monkeypatch, window_only):
    _plant(monkeypatch, _keep_state, window_only)
    result, checks = tiny.run("tiny-train")
    assert not result["correct"]
    assert checks["change_norm_gap"]["value"] > checks["change_norm_gap"]["limit"]
    if not window_only:
        assert checks["change_norm_gap"]["value"] == pytest.approx(1.0)


def _with_control(cell):
    import importlib

    env = tiny.environment(cell)
    env.control = True
    return importlib.import_module(f"portbench.{env.cell['entry']}").run(env)


@pytest.mark.parametrize("cell,number", [("tiny-video", "logprob_gap"),
                                         ("tiny-train", "change_norm_gap")])
def test_the_control_reads_higher(cell, number):
    """The fp8 control put in the program's place reads higher than the
    program (at this size the program runs bfloat16 on the CPU), and its
    verdict is the run's own predicate over its numbers."""
    result, checks = _with_control(cell)
    assert checks[f"control_{number}"]["value"] > checks[number]["value"]
    low = {k: v for k, v in checks.items() if not k.startswith("control_")}
    low.update({k[len("control_"):]: v for k, v in checks.items() if k.startswith("control_")})
    assert result["control_correct"] == harness.within(low)


def test_the_control_fails_where_the_program_passes():
    """At the serving cell's limits the run's predicate finds the program
    correct and the control, in its place, not correct. (The tiny training
    cell's control sits within its sound runs' reach at this size: 2.3e-3 to
    4.8e-3 against 2.8e-3 to 3.4e-3 over seeds 7-9.)"""
    result, checks = _with_control("tiny-video")
    assert result["correct"] and result["control_correct"] is False, checks


def test_files_added_alone_are_found(tmp_path, monkeypatch):
    """A cell, a configuration, a traffic mix and a per-layer metric added as
    new files, and named in the manifest, run without an edit elsewhere."""
    import portbench.metrics

    for kind in ("cells", "configs", "traffic"):
        (tmp_path / kind).mkdir()
    cell, mix = tiny.CELLS["tiny-video"]
    (tmp_path / "cells" / "new-cell.json").write_text(json.dumps({**cell, "config": "new-config",
                                                                   "traffic": "new-mix"}))
    (tmp_path / "configs" / "new-config.json").write_text(json.dumps(tiny.CONFIG))
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (tmp_path / "extra").mkdir()
    (tmp_path / "extra" / "new_reader.py").write_text(
        "def read(ctx, name):\n    return float(len(ctx.answered))\n")
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    monkeypatch.setattr(portbench.metrics, "__path__", [*portbench.metrics.__path__,
                                                         str(tmp_path / "extra")])
    man = tiny.manifest()
    man["per_layer"].append({"name": "new_reader.x", "unit": "n", "workloads": ["new-cell"]})
    from portbench.run import environment

    env = environment("new-cell", 3, 1.0, True, "cpu", time.perf_counter(), man=man)
    result, _ = serve.run(env)
    assert result["metrics"]["new_reader.x"]["value"] > 0
