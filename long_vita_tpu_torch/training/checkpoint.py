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

The format knows no mesh geometry: over tensor parallelism (1-D and 2-D),
FSDP and pipeline stages (``layout``, parallel/sharding.rank_layout of a rank's
shard) ``save_checkpoint`` gathers the parameters and the moments leaf by
leaf, over dp (FSDP), then tq, then tp, then pp (a stage's layers under their
global names, in canonical order whatever the schedule), and world rank 0
writes the whole tree, the one-device format (JAX's orbax stores hold
global arrays too); loading cuts each rank's slices from the whole tensors
and takes a stage's layers. A checkpoint written at tp 2, under FSDP or
over pp 2 (GPipe or interleaved) resumes at tp 1 without FSDP or pp, and
the other way round. JAX's stores keep the interleaved schedule's
chunk-major layer order and record (pp, virtual_pp), refusing a restore
into another layout (checkpoint.py:41-112); the port's canonical order
needs no such record.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from long_vita_tpu_torch.parallel.sharding import gather_named, shard_named
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


def save_checkpoint(directory: str, state: TrainState, step: Optional[int] = None, *,
                    layout: Optional[dict] = None, tp_comm=None, write: bool = True,
                    dp_comm=None, tq_comm=None) -> None:
    """Write ``state`` as step ``step`` (default: state.step); drop all but
    the newest MAX_TO_KEEP steps. The file appears atomically. Over tp, tq,
    FSDP and pp (``layout`` of the state's shards, their ``tp_comm`` and,
    for FSDP leaves, ``dp_comm``, for leaves cut over tq, ``tq_comm``; a
    pipeline stage's tree gathers its layers over its Stage's
    communicator): every rank of those groups calls it, the parameters and
    moments are gathered to the host leaf by leaf, and only the rank given
    ``write`` writes."""
    step = state.step if step is None else int(step)
    params = {n: p.detach() for n, p in state.params.named_parameters()}
    mu, nu = state.opt_state.mu, state.opt_state.nu
    if layout is not None:
        stage = getattr(state.params, "text", state.params).pp
        params, mu, nu = (gather_named(t, layout, tp_comm, device="cpu", keep=write,
                                       dp_comm=dp_comm, stage=stage, tq_comm=tq_comm)
                          for t in (params, mu, nu))
    if not write:
        return
    out = Path(directory) / str(step)
    out.mkdir(parents=True, exist_ok=True)
    payload = {
        "params": params,
        "mu": mu,
        "nu": nu,
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
    # memory-mapped: a tp rank that takes its slices reads only their pages
    return torch.load(Path(directory) / str(step) / _FILE, map_location="cpu",
                      weights_only=True, mmap=True)


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
    step: Optional[int] = None, layout: Optional[dict] = None,
) -> TrainState:
    """Restore the newest (or ``step``'s) checkpoint into ``state``: the
    parameters in place and, with load_optim, the moments, counts and step.
    ``layout`` (state's parameters a tp or FSDP shard): each tensor's
    slice."""
    saved = _read(directory, step)
    cut = (lambda t: t) if layout is None else (lambda t: shard_named(t, layout))
    _copy_params(state.params, cut(saved["params"]))
    if load_optim:
        dev = {n: p.device for n, p in state.params.named_parameters()}
        state.opt_state = AdamState(
            {n: t.to(dev[n]).contiguous() for n, t in cut(saved["mu"]).items()},
            {n: t.to(dev[n]).contiguous() for n, t in cut(saved["nu"]).items()},
            int(saved["count"]),
        )
        state.step = int(saved["step"])
    return state


def restore_params_only(directory: str, params_template: nn.Module,
                        step: Optional[int] = None,
                        layout: Optional[dict] = None) -> nn.Module:
    """Stage handoff: the parameters of a previous stage, copied into
    ``params_template`` in place (``layout``: the template is a tp or FSDP
    shard, each tensor's slice); everything else starts fresh."""
    saved = _read(directory, step)["params"]
    _copy_params(params_template, saved if layout is None else shard_named(saved, layout))
    return params_template
