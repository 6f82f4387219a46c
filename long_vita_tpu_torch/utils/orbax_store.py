"""The orbax checkpoint layout of the JAX package's training stores, read
and written without orbax.

long_vita_tpu/training/checkpoint.py saves through an orbax
``CheckpointManager`` (max_to_keep 3). Its directory holds:

  - one directory per finished step, ``<step>/``; a step is written under a
    name holding ``.orbax-checkpoint-tmp`` and renamed when finished, so a
    reader skips such names;
  - in a step, ``_CHECKPOINT_METADATA`` (JSON: the item handlers and the
    commit time) and one directory per item: ``params`` and ``opt_state``
    (pytrees), ``step`` (one array);
  - in a pytree item, ``_METADATA`` (JSON): ``tree_metadata`` keys every
    leaf by its path tuple, ``"('text', 'layers', 'q_proj', 'kernel')"``,
    with each key's type (1 a sequence index, 2 a dict key or a named
    field) and the value's type: an array, or ``None`` for an empty slot (an
    optax ``EmptyState``), which holds no data. ``use_ocdbt`` says where the
    arrays lie: under the key ``<dotted.path>/`` of the item's OCDBT store
    (utils/ocdbt.py), or in the directory ``<item>/<dotted.path>/``; each is
    a zarr v2 array (utils/zarr.py). ``use_zarr3`` stores are not read;
  - beside the steps, ``layer_layout.json``: the (pp, virtual_pp) order of
    the decoder's stacked layers, (1, 1) when absent.

The JAX package writes OCDBT stores with zstd chunks, one chunk per device
shard. The port writes the other layout orbax reads: every array in its own
directory, uncompressed, one chunk (``use_ocdbt`` false). orbax restores it
into a template without the ``_sharding`` and ``array_metadatas`` files that
it writes itself (the template carries the shardings), so the port writes
neither.
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from long_vita_tpu_torch.utils.ocdbt import OcdbtStore
from long_vita_tpu_torch.utils.zarr import ZarrArray, write_array

MAX_TO_KEEP = 3
TMP = ".orbax-checkpoint-tmp"
METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
LAYOUT = "layer_layout.json"
_HANDLERS = {
    "params": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
              "StandardCheckpointHandler",
    "opt_state": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                 "StandardCheckpointHandler",
    "step": "orbax.checkpoint._src.handlers.array_checkpoint_handler.ArrayCheckpointHandler",
}
_SEQUENCE, _DICT = 1, 2  # tree_metadata key types


def steps(directory) -> list[int]:
    """The finished steps in a CheckpointManager directory, ascending."""
    root = Path(directory)
    if not root.is_dir():
        return []
    return sorted(int(d.name) for d in root.iterdir() if d.name.isdigit() and d.is_dir())


def read_layout(directory) -> tuple[int, int]:
    """The stored (pp, virtual_pp) layer-stack order; (1, 1) if absent."""
    path = Path(directory) / LAYOUT
    if not path.exists():
        return (1, 1)
    d = json.loads(path.read_text())
    return (int(d["pp"]), int(d["virtual_pp"]))


def write_layout(directory, layout: Sequence[int]) -> None:
    (Path(directory) / LAYOUT).write_text(
        json.dumps({"pp": int(layout[0]), "virtual_pp": int(layout[1])}))


def _dotted(path: tuple) -> str:
    return ".".join(path)


class Item:
    """A pytree item of a step (``params`` or ``opt_state``): ``tree`` maps
    each leaf's path tuple to its value metadata; ``array(path)`` opens an
    array leaf; ``bytes_read`` sums what its arrays copied out."""

    def __init__(self, path):
        self.path = Path(path)
        meta = json.loads((self.path / METADATA).read_text())
        if meta.get("use_zarr3"):
            raise ValueError(f"{self.path / METADATA}: use_zarr3 is true; the port reads the "
                             "zarr v2 stores that this repository's orbax writes")
        self.tree = {tuple(ast.literal_eval(k)): v["value_metadata"]
                     for k, v in meta["tree_metadata"].items()}
        self.store = OcdbtStore(self.path) if meta.get("use_ocdbt") else None
        self._arrays: dict = {}

    def is_array(self, path: tuple) -> bool:
        v = self.tree.get(tuple(path))
        return v is not None and v["value_type"] != "None"

    def array(self, path: tuple) -> ZarrArray:
        path = tuple(path)
        if path not in self._arrays:
            if not self.is_array(path):
                raise KeyError(f"{self.path}: no array leaf {path}")
            self._arrays[path] = (
                ZarrArray.at_ocdbt(self.store, _dotted(path)) if self.store is not None
                else ZarrArray.at_dir(self.path / _dotted(path)))
        return self._arrays[path]

    def arrays(self) -> dict:
        """Every array leaf whole, by its dotted name, in its storage dtype
        (bfloat16 as uint16 bits)."""
        return {_dotted(p): self.array(p).read() for p in self.tree if self.is_array(p)}

    @property
    def bytes_read(self) -> int:
        return sum(a.bytes_read for a in self._arrays.values()) + (
            self.store.bytes_read if self.store is not None else 0)


class ItemWriter:
    """A pytree item written in the uncompressed, non-OCDBT layout:
    ``array(path, shape, dtype)`` makes a leaf's zarr array and returns its
    chunk memory-mapped to fill; ``empty(path)`` records an empty slot;
    ``close()`` writes the metadata."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.mkdir(parents=True)
        self.leaves: dict[tuple, Optional[list]] = {}

    def array(self, path: tuple, shape: Sequence[int], dtype: str) -> np.ndarray:
        path = tuple(path)
        self.leaves[path] = [int(s) for s in shape]
        return write_array(self.path / _dotted(path), shape, dtype)

    def empty(self, path: tuple) -> None:
        self.leaves[tuple(path)] = None

    def close(self) -> None:
        tree = {}
        for path, shape in sorted(self.leaves.items()):
            keys = [{"key": k, "key_type": _SEQUENCE if k.isdigit() else _DICT} for k in path]
            if shape is None:
                value = {"value_type": "None", "skip_deserialize": True}
            else:
                value = {"value_type": "jax.Array", "skip_deserialize": False,
                         "write_shape": shape}
            tree[repr(path)] = {"key_metadata": keys, "value_metadata": value}
        _write_json(self.path / METADATA, {
            "tree_metadata": tree, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None})


def _write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj))


def write_step_item(path, step: int) -> None:
    """The ``step`` item: an int64 scalar (orbax's ArrayCheckpointHandler)."""
    path = Path(path)
    path.mkdir(parents=True)
    write_array(path / "checkpoint", (), "<i8")[()] = step
    _write_json(path / METADATA, {
        "tree_metadata": {"('checkpoint',)": {
            "key_metadata": [{"key": "checkpoint", "key_type": _DICT}],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}},
        "use_ocdbt": False, "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None})


def read_step_item(path) -> int:
    """The step that a step directory's ``step`` item holds."""
    path = Path(path)
    meta = json.loads((path / METADATA).read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{path / METADATA}: use_zarr3 is true")
    if meta.get("use_ocdbt"):
        return int(ZarrArray.at_ocdbt(OcdbtStore(path), "checkpoint").read())
    return int(ZarrArray.at_dir(path / "checkpoint").read())


class StepWriter:
    """A step of a CheckpointManager directory, written under a temporary
    name (``path``) and renamed into place by ``commit``, which then keeps
    the newest MAX_TO_KEEP steps."""

    def __init__(self, directory, step: int):
        self.directory, self.step = Path(directory), int(step)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.t0 = time.time_ns()
        self.path = self.directory / f"{self.step}{TMP}-{self.t0}"
        self.path.mkdir()

    def commit(self) -> None:
        _write_json(self.path / CHECKPOINT_METADATA, {
            "item_handlers": _HANDLERS, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": self.t0, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}})
        os.replace(self.path, self.directory / str(self.step))
        for old in steps(self.directory)[:-MAX_TO_KEEP]:
            shutil.rmtree(self.directory / str(old))

    def abort(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)
