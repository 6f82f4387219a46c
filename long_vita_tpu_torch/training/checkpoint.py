"""Training checkpoints as the JAX package's orbax stores, with stage-handoff
semantics.

Counterpart of long_vita_tpu/training/checkpoint.py: a CheckpointManager
directory (utils/orbax_store.py) whose steps hold the items ``params`` (the
JAX parameter tree), ``opt_state`` (make_optimizer's optax chain state:
training/optimizer.optax_chain_slots) and ``step``, beside
``layer_layout.json``, read and written without JAX, orbax or tensorstore.
The port reads every store the JAX package writes (OCDBT, zarr v2, zstd:
utils/ocdbt.py, utils/zarr.py, utils/zstd.py) and writes stores that JAX's
load_checkpoint and restore_params_only restore (each array uncompressed in
a directory of its own). The newest three steps are kept; a step at or
below the newest is not written again (orbax's should_save).

Parameters travel by name (utils/convert.jax_path): a decoder or tower
layer is a row of its stacked [L, ...] leaf, a dense weight [out, in] the
transposed JAX kernel. The Adam moments are the chain's mu and nu, which JAX
holds for every leaf: a leaf for which the port keeps none (one behind
stop_gradient, or frozen by the optimizer's mask) is written as zeros of
JAX's shape and dtype, and on reading, such a stop_gradient leaf's moments
must be zero and are dropped (a mask-frozen leaf's update is 0 whatever its
moments: training/optimizer.py). Both counts must equal the step.

Over tensor parallelism (1-D and 2-D), FSDP and pipeline stages
(``layout``, parallel/sharding.rank_layout of a rank's shard)
``save_checkpoint`` gathers the parameters and the moments leaf by leaf,
over dp (FSDP), then tq, then tp, then pp (a stage's layers under their
global names), and world rank 0 writes the whole tree. Under interleaved pp
(a stage tree of virtual_pp > 1) the layer stacks are written chunk-major
and ``layer_layout.json`` records (pp, virtual_pp), JAX's contract
(train_step.py:281-292), so a JAX run of that geometry resumes the store.
Loading reads the recorded layout and takes each rank's slices of each
layer's row alone (an uncompressed chunk is memory-mapped, so a tp rank or
a stage reads only its pages), so a store resumes at any tp, FSDP, pp and
virtual_pp; JAX's own load_checkpoint refuses another layout
(checkpoint.py:107-116). ``restore_params_only`` returns the canonical
layer order, as JAX's (checkpoint.py:158-170).

Stage handoff: ``load_checkpoint(..., load_optim=False)`` and
``restore_params_only`` take the parameters and keep the fresh optimizer
state, as the reference's --no-load-optim --finetune.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from long_vita_tpu_torch.parallel.pipeline import interleave_permutation
from long_vita_tpu_torch.parallel.sharding import gather_named, renamed, slice_leaf
from long_vita_tpu_torch.training.optimizer import AdamState, OptimizerConfig, optax_chain_slots
from long_vita_tpu_torch.training.train_step import TrainState
from long_vita_tpu_torch.utils import orbax_store
from long_vita_tpu_torch.utils.convert import jax_path, port_name
from long_vita_tpu_torch.utils.zarr import zarr_dtype

MAX_TO_KEEP = orbax_store.MAX_TO_KEEP
_COUNT = "<i4"  # optax's counts are int32


def latest_step(directory: str) -> Optional[int]:
    steps = orbax_store.steps(directory)
    return steps[-1] if steps else None


def _rows(layout: tuple, path: tuple, n_rows: int):
    """layer -> its row in the stored stack: chunk-major for the decoder's
    layers under an interleaved layout, else the layer itself."""
    if path[:2] != ("text", "layers") or layout[1] <= 1:
        return lambda layer: layer
    perm = interleave_permutation(n_rows, *layout)
    row = {layer: j for j, layer in enumerate(perm)}
    return row.__getitem__


def _numpy_bits(dst: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array of a zarr dtype's storage as a torch tensor of ``dtype``
    over the same memory (bfloat16 over its uint16 bits)."""
    t = torch.from_numpy(dst)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _groups(names, shapes: dict) -> dict:
    """JAX path -> (transposed, per-layer JAX shape, [(layer, name)]) of the
    parameters ``names`` (whole tensors: their ``shapes``)."""
    out: dict = {}
    for name in names:
        path, layer, t = jax_path(name)
        shape = list(shapes[name])
        out.setdefault(path, (t, shape[::-1] if t else shape, []))[2].append((layer, name))
    return out


def _write_item(w: orbax_store.ItemWriter, prefix: tuple, groups: dict, tensors: dict,
                dtypes: dict, layout: tuple) -> None:
    """Each group's leaf under ``prefix``, its rows from ``tensors`` (a name
    absent there stays zero: the chunk file is made zero-filled)."""
    for path, (transposed, shape, members) in groups.items():
        stacked = members[0][0] is not None
        full = [len(members)] + shape if stacked else shape
        name0 = members[0][1]
        out = w.array(prefix + path, full, zarr_dtype(str(dtypes[name0]).split(".")[-1]))
        row = _rows(layout, path, len(members))
        for layer, name in members:
            t = tensors.get(name)
            if t is None:
                continue
            dst = out[row(layer)] if stacked else out
            _numpy_bits(dst, dtypes[name]).copy_(t.t() if transposed else t)
        del out


def save_checkpoint(directory: str, state: TrainState, step: Optional[int] = None, *,
                    layout: Optional[dict] = None, tp_comm=None, write: bool = True,
                    dp_comm=None, tq_comm=None) -> None:
    """Write ``state`` as step ``step`` (default: state.step), unless the
    directory holds that step or a newer one; keep the newest MAX_TO_KEEP
    steps. The step appears atomically. Over tp, tq, FSDP and pp
    (``layout`` of the state's shards, their ``tp_comm`` and, for FSDP
    leaves, ``dp_comm``, for leaves cut over tq, ``tq_comm``; a pipeline
    stage's tree gathers its layers over its Stage's communicator): every
    rank of those groups calls it, the parameters and moments are gathered
    to the host leaf by leaf, and only the rank given ``write`` writes."""
    step = state.step if step is None else int(step)
    params = {n: p.detach() for n, p in state.params.named_parameters()}
    mu, nu = state.opt_state.mu, state.opt_state.nu
    stage = getattr(state.params, "text", state.params).pp
    if layout is not None:
        params, mu, nu = (gather_named(t, layout, tp_comm, device="cpu", keep=write,
                                       dp_comm=dp_comm, stage=stage, tq_comm=tq_comm)
                          for t in (params, mu, nu))
    if not write:
        return
    newest = latest_step(directory)
    if newest is not None and newest >= step:
        return
    layer_layout = (stage.size, stage.virtual) if stage is not None and stage.virtual > 1 \
        else (1, 1)
    cfg = state.opt_state.config or OptimizerConfig()
    adam, schedule, empty = optax_chain_slots(cfg)
    groups = _groups(params, {n: t.shape for n, t in params.items()})
    p_dtype = {n: t.dtype for n, t in params.items()}
    mu_dtype = {n: torch.bfloat16 if cfg.moment_dtype == "bfloat16" else d
                for n, d in p_dtype.items()}
    out = orbax_store.StepWriter(directory, step)
    try:
        w = orbax_store.ItemWriter(out.path / "params")
        _write_item(w, (), groups, params, p_dtype, layer_layout)
        w.close()
        w = orbax_store.ItemWriter(out.path / "opt_state")
        _write_item(w, (adam, "mu"), groups, mu, mu_dtype, layer_layout)
        _write_item(w, (adam, "nu"), groups, nu, p_dtype, layer_layout)
        for slot in (adam, schedule):
            w.array((slot, "count"), (), _COUNT)[()] = state.opt_state.count
        for slot in empty:
            w.empty((slot,))
        w.close()
        orbax_store.write_step_item(out.path / "step", step)
        out.commit()
    except BaseException:
        out.abort()
        raise
    orbax_store.write_layout(directory, layer_layout)


class _Store:
    """One step of a store, read leaf by leaf into a template's names:
    ``take(item, prefix, name, device)`` -> this rank's slice of the
    parameter (or moment) ``name`` on ``device``, of the stored dtype (moved
    in the stored layout and transposed there: a host transpose of the head
    would cost more than the read)."""

    def __init__(self, directory: str, step: Optional[int], template: nn.Module,
                 layout: Optional[dict]):
        step = latest_step(directory) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        self.step, self.root = int(step), Path(directory) / str(step)
        self.stored = orbax_store.read_layout(directory)
        self.layout = layout
        self.items: dict = {}
        text = getattr(template, "text", template)
        self.named = dict(template.named_parameters())
        self.n_layers = {"text": text.pp.n_layers if text.pp is not None else len(text.layers)}
        vision = getattr(template, "vision", None)
        if vision is not None:
            self.n_layers["vision"] = len(vision.layers)

    def item(self, name: str) -> orbax_store.Item:
        if name not in self.items:
            self.items[name] = orbax_store.Item(self.root / name)
        return self.items[name]

    @property
    def bytes_read(self) -> int:
        return sum(it.bytes_read for it in self.items.values())

    def global_name(self, name: str) -> str:
        leaf = self.layout.get(name) if self.layout is not None else None
        return renamed(name, leaf.pp_layer) if leaf is not None and leaf.staged else name

    def check_names(self, item: str) -> None:
        """The template's leaves are the stored tree's."""
        held = {p for p, v in self.item(item).tree.items() if v["value_type"] != "None"}
        want = {jax_path(self.global_name(n))[0] for n in self.named}
        if held != want:
            raise ValueError(
                f"checkpoint {self.root / item} holds other leaves than the model: missing "
                f"{sorted(want - held)[:5]}, extra {sorted(held - want)[:5]}")

    def take(self, item: str, prefix: tuple, name: str, device) -> torch.Tensor:
        path, layer, transposed = jax_path(self.global_name(name))
        arr = self.item(item).array(prefix + path)
        per = list(arr.shape[1:] if layer is not None else arr.shape)
        whole = per[::-1] if transposed else per
        leaf = self.layout.get(name) if self.layout is not None else None
        box = _box(whole, leaf)
        want = tuple(self.named[name].shape)
        if tuple(hi - lo for lo, hi in box) != want:
            raise ValueError(f"{name}: checkpoint shape {tuple(whole)} gives a slice of "
                             f"{tuple(hi - lo for lo, hi in box)}, the model holds {want}")
        index = [slice(lo, hi) for lo, hi in (box[::-1] if transposed else box)]
        if layer is not None:
            tower = path[0]
            if arr.shape[0] != self.n_layers[tower]:
                raise ValueError(f"{name}: the checkpoint stacks {arr.shape[0]} layers, the "
                                 f"model's {tower} has {self.n_layers[tower]}")
            index = [_rows(self.stored, path, arr.shape[0])(layer)] + index
        t = torch.from_numpy(arr.read(index))
        if arr.dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        t = t.to(device)
        return t.t() if transposed else t


def _box(whole: list, leaf) -> list:
    """The (lo, hi) range per dim of ``leaf``'s slice (parallel/sharding.
    slice_leaf) of a tensor of shape ``whole``; the whole tensor for None."""
    if leaf is None:
        return [(0, n) for n in whole]
    out = []
    for d, n in enumerate(whole):
        view = [1] * len(whole)
        view[d] = n
        coords = slice_leaf(torch.arange(n).view(view).expand(*whole), leaf)
        line = coords[tuple(slice(None) if i == d else 0 for i in range(len(whole)))]
        lo, hi = int(line[0]), int(line[-1]) + 1
        if hi - lo != line.numel():
            raise ValueError(f"a slice of dim {d} that is not one range")
        out.append((lo, hi))
    return out


def _read(directory: str, step: Optional[int]) -> dict:
    """A step whole, by the port's names and in canonical layer order, on
    the host: {"params", "mu", "nu": name -> tensor, "count", "step"}. A
    leaf whose mu and nu are both zero (JAX's moments of a leaf that took
    no gradient) is left out of mu and nu, as the port holds none for it."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    root = Path(directory) / str(step)
    stored = orbax_store.read_layout(directory)
    params_item, opt = orbax_store.Item(root / "params"), orbax_store.Item(root / "opt_state")
    paths = [p for p in params_item.tree if params_item.is_array(p)]
    adam = next(p[0] for p in opt.tree if p[1:] == ("mu",) + paths[0])

    def whole(item, prefix, path) -> dict:
        arr = item.array(prefix + path)
        out = {}
        for layer in range(arr.shape[0]) if "layers" in path else [None]:
            name, transposed = port_name(path, layer)
            t = torch.from_numpy(arr.read(
                [] if layer is None else [_rows(stored, path, arr.shape[0])(layer)]))
            t = t.view(torch.bfloat16) if arr.dtype == "bfloat16" else t
            out[name] = t.t().contiguous() if transposed else t
        return out

    params, mu, nu = {}, {}, {}
    for path in paths:
        params.update(whole(params_item, (), path))
        m, v = whole(opt, (adam, "mu"), path), whole(opt, (adam, "nu"), path)
        for name in m:
            if torch.any(m[name] != 0) or torch.any(v[name] != 0):
                mu[name], nu[name] = m[name], v[name]
    return {"params": params, "mu": mu, "nu": nu,
            "count": int(opt.array((adam, "count")).read()),
            "step": orbax_store.read_step_item(root / "step")}


@torch.no_grad()
def _copy_params(store: _Store, params: nn.Module) -> None:
    store.check_names("params")
    for n, p in params.named_parameters():
        p.copy_(store.take("params", (), n, p.device))


def load_checkpoint(
    directory: str, state: TrainState, *, load_optim: bool = True,
    step: Optional[int] = None, layout: Optional[dict] = None,
) -> TrainState:
    """Restore the newest (or ``step``'s) checkpoint into ``state``: the
    parameters in place and, with load_optim, the moments, counts and step.
    ``layout`` (state's parameters a tp, FSDP or pp shard): each tensor's
    slice, read alone."""
    store = _Store(directory, step, state.params, layout)
    _copy_params(store, state.params)
    if not load_optim:
        return state
    opt = state.opt_state
    adam, schedule, empty = optax_chain_slots(opt.config or OptimizerConfig())
    item = store.item("opt_state")
    if any(item.is_array((slot,)) for slot in empty) or not all(
            item.is_array((slot, "count")) for slot in (adam, schedule)):
        raise ValueError(f"{store.root / 'opt_state'} is not the optax chain of this run's "
                         f"optimizer (weight_decay {(opt.config or OptimizerConfig()).weight_decay}"
                         f": the counts at {adam} and {schedule}, empty states at {empty})")
    counts = [int(item.array((slot, "count")).read()) for slot in (adam, schedule)]
    saved = orbax_store.read_step_item(store.root / "step")
    if not counts[0] == counts[1] == saved == store.step:
        raise ValueError(f"{store.root}: scale_by_adam's count {counts[0]}, the schedule's "
                         f"{counts[1]} and the step item {saved} differ from step {store.step}")
    named = dict(state.params.named_parameters())
    for n, p in named.items():  # a stop_gradient leaf holds no moments: JAX's are zero
        if n not in opt.mu and not p.requires_grad:
            for kind in ("mu", "nu"):
                if torch.any(store.take("opt_state", (adam, kind), n, p.device) != 0):
                    raise ValueError(f"{n}: the checkpoint's {kind} is not zero, but the run "
                                     "stops its gradient")

    def moments(kind: str, held: dict) -> dict:
        return {n: store.take("opt_state", (adam, kind), n, named[n].device).to(t.dtype)
                .contiguous() for n, t in held.items()}

    state.opt_state = AdamState(moments("mu", opt.mu), moments("nu", opt.nu), counts[0],
                                opt.config)
    state.step = store.step
    return state


def restore_params_only(directory: str, params_template: nn.Module,
                        step: Optional[int] = None, layout: Optional[dict] = None,
                        stats: Optional[dict] = None) -> nn.Module:
    """Stage handoff: the parameters of a previous stage, copied into
    ``params_template`` in place in canonical layer order (``layout``: the
    template is a tp, FSDP or pp shard, each tensor's slice read alone);
    everything else starts fresh. ``stats``: a dict that receives
    "bytes_read", the bytes copied out of the store's files."""
    store = _Store(directory, step, params_template, layout)
    _copy_params(store, params_template)
    if stats is not None:
        stats["bytes_read"] = store.bytes_read
    return params_template
