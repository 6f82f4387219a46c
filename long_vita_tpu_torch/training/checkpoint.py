"""Training checkpoints in a torch format, with stage-handoff semantics.

Counterpart of long_vita_tpu/training/checkpoint.py, which writes orbax
stores; the port writes one ``torch.save`` file per step instead
(``<directory>/<step>/state.pt``: the parameters by module name, the Adam
moments and counts, the step), keeps the newest three, and restores into a
live TrainState in place. Reading or writing the JAX package's orbax stores
waits (ROADMAP: port queue, training: orbax interop).

Stage handoff: ``load_checkpoint(..., load_optim=False)`` and
``restore_params_only`` take the parameters and keep the fresh optimizer
state, as the reference's --no-load-optim --finetune.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from long_vita_tpu_torch.training.optimizer import AdamState
from long_vita_tpu_torch.training.train_step import TrainState

_FILE = "state.pt"
MAX_TO_KEEP = 3


def _steps(directory: str) -> list[int]:
    root = Path(directory)
    if not root.is_dir():
        return []
    return sorted(
        int(d.name) for d in root.iterdir()
        if d.name.isdigit() and (d / _FILE).is_file()
    )


def save_checkpoint(directory: str, state: TrainState, step: Optional[int] = None) -> None:
    """Write ``state`` as step ``step`` (default: state.step); drop all but
    the newest MAX_TO_KEEP steps. The file appears atomically."""
    step = state.step if step is None else int(step)
    out = Path(directory) / str(step)
    out.mkdir(parents=True, exist_ok=True)
    payload = {
        "params": {n: p.detach() for n, p in state.params.named_parameters()},
        "mu": state.opt_state.mu,
        "nu": state.opt_state.nu,
        "count": state.opt_state.count,
        "step": step,
    }
    tmp = out / f"{_FILE}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out / _FILE)
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        shutil.rmtree(Path(directory) / str(old))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _read(directory: str, step: Optional[int]) -> dict:
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    return torch.load(Path(directory) / str(step) / _FILE, map_location="cpu",
                      weights_only=True)


@torch.no_grad()
def _copy_params(params: nn.Module, saved: dict) -> None:
    named = dict(params.named_parameters())
    if set(named) != set(saved):
        raise ValueError(
            "checkpoint parameters differ from the model's: missing "
            f"{sorted(set(named) - set(saved))[:5]}, extra {sorted(set(saved) - set(named))[:5]}"
        )
    for n, p in named.items():
        if saved[n].shape != p.shape:
            raise ValueError(f"{n}: checkpoint shape {tuple(saved[n].shape)} != {tuple(p.shape)}")
        p.copy_(saved[n])


def load_checkpoint(
    directory: str, state: TrainState, *, load_optim: bool = True,
    step: Optional[int] = None,
) -> TrainState:
    """Restore the newest (or ``step``'s) checkpoint into ``state``: the
    parameters in place and, with load_optim, the moments, counts and step."""
    saved = _read(directory, step)
    _copy_params(state.params, saved["params"])
    if load_optim:
        dev = {n: p.device for n, p in state.params.named_parameters()}
        state.opt_state = AdamState(
            {n: t.to(dev[n]) for n, t in saved["mu"].items()},
            {n: t.to(dev[n]) for n, t in saved["nu"].items()},
            int(saved["count"]),
        )
        state.step = int(saved["step"])
    return state


def restore_params_only(directory: str, params_template: nn.Module,
                        step: Optional[int] = None) -> nn.Module:
    """Stage handoff: the parameters of a previous stage, copied into
    ``params_template`` in place; everything else starts fresh."""
    _copy_params(params_template, _read(directory, step)["params"])
    return params_template
