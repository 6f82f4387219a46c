"""zarr v2 arrays as orbax stores them, read and written without zarr or
tensorstore.

An array is a ``.zarray`` JSON (shape, chunks, dtype, compressor, fill
value) and one value per chunk under the key ``i.j.k`` (the chunk's grid
index, ``.``-separated, C order; ``0`` for a 0-d array), in a directory or
under a key prefix of an OCDBT store (utils/ocdbt.py). A chunk is stored
whole even at the grid's edge; a chunk that is absent reads as the fill
value (zeros where it is null). Compressor: ``zstd`` (utils/zstd.py) or
``null``.

``ZarrArray.read(index)`` reads only the chunks that the box ``index``
touches. An uncompressed chunk is memory-mapped from its file (a directory
chunk, or an OCDBT value at its offset in a data file) and only the box is
copied out, so a tp rank or a pipeline stage reads only its pages; a zstd
chunk is decoded whole. ``bytes_read`` counts the bytes copied out of the
files: a compressed chunk's stored bytes, an uncompressed chunk's box.

bfloat16, which numpy lacks, travels as its uint16 bit pattern.
``write_array`` writes an uncompressed array of one chunk, as orbax writes
from one process, and returns its chunk memory-mapped for the caller to fill.
"""
from __future__ import annotations

import itertools
import json
import math
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from long_vita_tpu_torch.utils import zstd

ZARRAY = ".zarray"
# zarr dtype -> the numpy dtype that holds its bits
DTYPES = {
    "bfloat16": np.dtype("<u2"),
    "<f4": np.dtype("<f4"),
    "<f2": np.dtype("<f2"),
    "<i4": np.dtype("<i4"),
    "<i8": np.dtype("<i8"),
    "|i1": np.dtype("i1"),
    "|u1": np.dtype("u1"),
}


def zarr_dtype(name: str) -> str:
    """A numpy or torch dtype's name (``float32``, ``bfloat16``, ...) -> the
    zarr dtype string."""
    table = {"bfloat16": "bfloat16", "float32": "<f4", "float16": "<f2", "int32": "<i4",
             "int64": "<i8", "int8": "|i1", "uint8": "|u1"}
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"no zarr dtype for {name} (the store holds {sorted(table)})") from None


class _Dir:
    """Chunks as files of a directory."""

    def __init__(self, path: Path):
        self.path = path

    def meta(self) -> bytes:
        return (self.path / ZARRAY).read_bytes()

    def chunk(self, key: str):
        """-> (bytes or None, (file, offset, length) or None); both None if absent."""
        f = self.path / key
        if not f.is_file():
            return None, None
        return None, (f, 0, f.stat().st_size)

    def where(self) -> str:
        return str(self.path)


class _Ocdbt:
    """Chunks as values of an OCDBT store under ``prefix``."""

    def __init__(self, store, prefix: str):
        self.store, self.prefix = store, prefix

    def meta(self) -> bytes:
        return self.store.read(self.prefix + ZARRAY)

    def chunk(self, key: str):
        key = self.prefix + key
        if key not in self.store:
            return None, None
        v = self.store.locate(key)
        if v.inline is not None:
            return v.inline, None
        return None, (v.path, v.offset, v.length)

    def where(self) -> str:
        return f"{self.store.root}:{self.prefix}"


class ZarrArray:
    """A zarr v2 array in a directory (``ZarrArray.at_dir``) or under an
    OCDBT key prefix (``ZarrArray.at_ocdbt``)."""

    def __init__(self, source):
        self.source = source
        meta = json.loads(source.meta())
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{source.where()}: zarr_format {meta.get('zarr_format')}, not 2")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = meta["dtype"]
        if self.dtype not in DTYPES:
            raise ValueError(f"{source.where()}: dtype {self.dtype!r} (known: {sorted(DTYPES)})")
        self.storage = DTYPES[self.dtype]
        if meta.get("order", "C") != "C" or meta.get("filters"):
            raise ValueError(f"{source.where()}: order {meta.get('order')!r}, filters "
                             f"{meta.get('filters')!r}; this reader takes C order, no filters")
        self.sep = meta.get("dimension_separator", ".")
        comp = meta.get("compressor")
        self.compressor = None if comp is None else comp["id"]
        if self.compressor not in (None, "zstd"):
            raise ValueError(f"{source.where()}: compressor {self.compressor!r} (zstd or null)")
        self.fill = meta.get("fill_value")
        self.bytes_read = 0

    @classmethod
    def at_dir(cls, path) -> "ZarrArray":
        return cls(_Dir(Path(path)))

    @classmethod
    def at_ocdbt(cls, store, prefix: str) -> "ZarrArray":
        return cls(_Ocdbt(store, prefix.rstrip("/") + "/"))

    def _fill(self) -> np.ndarray:
        if self.fill is None:
            return np.zeros((), self.storage)
        if self.dtype == "bfloat16":  # a float fill value as bfloat16's bits
            return (np.asarray(self.fill, np.float32).view(np.uint32) >> 16).astype(np.uint16)
        return np.asarray(self.fill, self.storage)

    def _chunk(self, grid: tuple) -> Optional[np.ndarray]:
        """One chunk as an array of the chunk shape (memory-mapped when it
        is stored raw in a file), or None when it is absent."""
        key = self.sep.join(map(str, grid)) if grid else "0"
        inline, ref = self.source.chunk(key)
        if inline is None and ref is None:
            return None
        count = math.prod(self.chunks)
        if self.compressor == "zstd":
            if ref is not None:
                path, offset, length = ref
                with open(path, "rb") as f:
                    f.seek(offset)
                    inline = f.read(length)
            self.bytes_read += len(inline)
            raw = zstd.decompress(inline, count * self.storage.itemsize)
            return np.frombuffer(raw, self.storage, count).reshape(self.chunks)
        if inline is not None:
            return np.frombuffer(inline, self.storage, count).reshape(self.chunks)
        path, offset, length = ref
        if length != count * self.storage.itemsize:
            raise ValueError(f"{self.source.where()}/{key}: {length} bytes for a chunk of "
                             f"{self.chunks} {self.dtype}")
        return np.memmap(path, self.storage, "r", offset, self.chunks)

    def read(self, index: Optional[Sequence] = None) -> np.ndarray:
        """The box ``index`` (per leading dim an int or a slice of step 1;
        the dims after it whole; None: the whole array) as a new array of
        the storage dtype, an int's dim dropped."""
        index = tuple(index or ())
        box, drop = [], []
        for d, n in enumerate(self.shape):
            ix = index[d] if d < len(index) else slice(None)
            if isinstance(ix, slice):
                lo, hi, step = ix.indices(n)
                if step != 1:
                    raise ValueError("a box of step 1 only")
                box.append((lo, max(lo, hi)))
            else:
                ix = int(ix) + (n if int(ix) < 0 else 0)
                if not 0 <= ix < n:
                    raise IndexError(f"index {ix} of dim {d} ({n})")
                box.append((ix, ix + 1))
                drop.append(d)
        out = np.empty([hi - lo for lo, hi in box], self.storage)
        ranges = [range(lo // c, -(-hi // c)) if hi > lo else range(0)
                  for (lo, hi), c in zip(box, self.chunks)]
        for grid in itertools.product(*ranges):
            chunk = self._chunk(grid)
            src, dst = [], []
            for g, (lo, hi), c in zip(grid, box, self.chunks):
                a, b = max(lo, g * c), min(hi, (g + 1) * c)
                src.append(slice(a - g * c, b - g * c))
                dst.append(slice(a - lo, b - lo))
            if chunk is None:
                out[tuple(dst)] = self._fill()
                continue
            part = chunk[tuple(src)]
            out[tuple(dst)] = part
            if self.compressor is None:
                self.bytes_read += part.nbytes
        return out.reshape([s for d, s in enumerate(out.shape) if d not in drop])


def write_array(path, shape: Sequence[int], dtype: str) -> np.ndarray:
    """An uncompressed zarr v2 array of one chunk in the new directory
    ``path``: its ``.zarray`` and its chunk file, returned memory-mapped
    for writing (flush it, or drop it, when done). ``dtype``: a zarr dtype
    string."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    shape = [int(s) for s in shape]
    meta = {"chunks": shape, "compressor": None, "dimension_separator": ".", "dtype": dtype,
            "fill_value": None, "filters": None, "order": "C", "shape": shape,
            "zarr_format": 2}
    (path / ZARRAY).write_text(json.dumps(meta))
    key = ".".join("0" for _ in shape) if shape else "0"
    return np.memmap(path / key, DTYPES[dtype], "w+", 0, tuple(shape))
