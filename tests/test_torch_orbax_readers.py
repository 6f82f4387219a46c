"""PyTorch port: the readers under the training checkpoints, without
tensorstore or zarr in the port (the tests hold them to tensorstore, which
they import themselves):

  - utils/zstd.py: libzstd's frames at levels 1, 3 and 19, 0 bytes to 3 MB,
    decoded whole; a truncated frame raises; the same, and the fixture's
    store, with TensorFlow (another zstd, RTLD_GLOBAL) loaded first;
  - utils/ocdbt.py: ``list()`` and ``read()`` against tensorstore's own
    ``ocdbt`` kvstore on the JAX-written fixture's merged stores and on a
    store of 340 keys in 41 versions with nodes of at most 512 bytes (a
    B+tree of height 3, zstd level 5, inline and indirect values); a flipped
    byte fails the CRC-32C;
  - utils/zarr.py: tensorstore's zarr v2 arrays (zstd and raw, chunk grids
    with ragged edges) read whole and by box; an absent chunk reads as the
    fill value (zeros where it is null); a box read touches only its
    chunks and counts their bytes; a zarr3 store is refused by name;
  - the JAX-written fixture (tools/make_orbax_fixture.py: OCDBT, zarr v2,
    zstd) decodes to the arrays saved beside it, bit for bit.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from long_vita_tpu_torch.utils import orbax_store, zstd
from long_vita_tpu_torch.utils.ocdbt import MANIFEST, OcdbtStore
from long_vita_tpu_torch.utils.zarr import ZarrArray, write_array

FIXTURE = Path(__file__).resolve().parent / "data" / "orbax_jax_tiny"


def _compress(data: bytes, level: int) -> bytes:
    lib = zstd._library()  # the library as the port loads it, whichever test loads it first
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compress.restype = ctypes.c_size_t
    cap = lib.ZSTD_compressBound(ctypes.c_size_t(len(data)))
    out = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(out, ctypes.c_size_t(cap), data, ctypes.c_size_t(len(data)), level)
    assert not lib.ZSTD_isError(ctypes.c_size_t(n))
    return out.raw[:n]


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_frames(level):
    rng = np.random.default_rng(level)
    for size in (0, 1, 4097, 3_000_000):
        data = (rng.integers(0, 7, size, dtype=np.uint8) * 31).tobytes()  # compressible
        frame = _compress(data, level)
        assert frame[:4] == zstd.MAGIC
        assert zstd.decompress(frame) == data
        assert zstd.decompress(np.frombuffer(frame, np.uint8)) == data
        if size:
            with pytest.raises(ValueError, match="zstd"):
                zstd.decompress(frame[:-3])


_AFTER_TENSORFLOW = """
import sys
import tensorflow  # noqa: F401  (its libtensorflow_framework carries another zstd, RTLD_GLOBAL)
sys.path.insert(0, "tests")
from test_torch_orbax_readers import FIXTURE, test_zstd_frames
from long_vita_tpu_torch.utils.ocdbt import OcdbtStore
test_zstd_frames(19)
store = OcdbtStore(FIXTURE / "store" / "3" / "params")
assert all(store.read(k) is not None for k in store.list())
print("ok")
"""


def test_zstd_after_tensorflow():
    """TensorFlow loaded first (as transformers loads it to test an array's
    type) must not take libzstd's internal calls: the port loads the
    library with its own symbols first (RTLD_DEEPBIND)."""
    pytest.importorskip("tensorflow")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]),
               TF_CPP_MIN_LOG_LEVEL="3")
    res = subprocess.run([sys.executable, "-c", _AFTER_TENSORFLOW], cwd=Path(__file__).resolve().parents[1],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def _against_tensorstore(root: Path) -> OcdbtStore:
    import tensorstore as ts

    store = OcdbtStore(root)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    assert keys and store.list() == keys
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    return store


@pytest.mark.parametrize("item", ["params", "opt_state"])
def test_ocdbt_reads_the_jax_fixture_as_tensorstore(item):
    root = FIXTURE / "store" / "3" / item
    assert (root / "ocdbt.process_0" / MANIFEST).is_file()  # the merged multi-process form
    store = _against_tensorstore(root)
    leaf = "text.final_norm" if item == "params" else "1.mu.text.final_norm"
    assert store.list(leaf + "/") == [leaf + "/.zarray", leaf + "/0"]


@pytest.fixture(scope="module")
def deep_store(tmp_path_factory):
    import tensorstore as ts

    root = tmp_path_factory.mktemp("ocdbt") / "kv"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/", "config": {
        "max_decoded_node_bytes": 512, "max_inline_value_bytes": 16,
        "compression": {"id": "zstd", "level": 5}}}).result()
    rng = np.random.default_rng(0)
    for i in range(40):  # a version each
        kv.write(f"arr{i % 7}/{i}.0.{rng.integers(100)}",
                 rng.bytes(int(rng.integers(0, 100)))).result()
    txn = ts.Transaction()
    for i in range(300):
        kv.with_transaction(txn).write(f"k/{i:05d}/x", rng.bytes(i % 40)).result()
    txn.commit_async().result()
    return root


def test_ocdbt_reads_a_deep_tree_as_tensorstore(deep_store):
    store = _against_tensorstore(deep_store)
    assert len(store.list()) == 340 and len(store.list("k/")) == 300
    assert store.locate("k/00000/x").inline == b""
    assert store.locate("k/00039/x").path is not None  # past the inline limit


def test_ocdbt_refuses_a_corrupt_node(deep_store, tmp_path):
    root = tmp_path / "kv"
    shutil.copytree(deep_store, root)
    manifest = bytearray((root / MANIFEST).read_bytes())
    manifest[20] ^= 1
    (root / MANIFEST).write_bytes(bytes(manifest))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(root)
    shutil.copy(deep_store / MANIFEST, root / MANIFEST)
    _, ref = OcdbtStore(root)._manifest()  # the newest root node
    data = root / (ref.file[0] + ref.file[1])
    raw = bytearray(data.read_bytes())
    raw[ref.offset + ref.length // 2] ^= 0x40
    data.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(root)


def _ts_zarr(path: Path, a: np.ndarray, chunks, compressor, fill=None):
    import tensorstore as ts

    t = ts.open({"driver": "zarr", "kvstore": f"file://{path}/",
                 "metadata": {"shape": list(a.shape), "chunks": list(chunks),
                              "dtype": a.dtype.str, "compressor": compressor,
                              "fill_value": fill}},
                create=True, delete_existing=True).result()
    t.write(a).result()


@pytest.mark.parametrize("compressor", [None, {"id": "zstd", "level": 3}], ids=["raw", "zstd"])
def test_zarr_reads_tensorstore_arrays_by_box(tmp_path, compressor):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((7, 10, 3)).astype("<f4")
    _ts_zarr(tmp_path / "a", a, (3, 4, 3), compressor)
    arr = ZarrArray.at_dir(tmp_path / "a")
    np.testing.assert_array_equal(arr.read(), a)
    seen = []
    chunk = arr._chunk
    arr._chunk = lambda grid: seen.append(grid) or chunk(grid)
    arr.bytes_read = 0
    box = arr.read((5, slice(2, 6)))
    np.testing.assert_array_equal(box, a[5, 2:6])
    assert sorted(seen) == [(1, 0, 0), (1, 1, 0)]  # row 5 in chunk row 1, cols 2..5 in 0 and 1
    stored = sum((tmp_path / "a" / f"{g[0]}.{g[1]}.{g[2]}").stat().st_size for g in seen)
    assert arr.bytes_read == (box.nbytes if compressor is None else stored)
    for dtype in ("<f2", "<i4", "<i8", "|i1", "|u1"):
        b = (rng.standard_normal((5, 2)) * 20).astype(dtype)
        where = tmp_path / f"dtype{np.dtype(dtype).char}{np.dtype(dtype).itemsize}"
        _ts_zarr(where, b, (2, 2), compressor)
        np.testing.assert_array_equal(ZarrArray.at_dir(where).read(), b)


def test_zarr_absent_chunks_read_as_the_fill_value(tmp_path):
    for fill, want in ((None, 0.0), (1.5, 1.5)):
        out = write_array(tmp_path / str(fill), (4, 3), "<f4")
        meta = json.loads((tmp_path / str(fill) / ".zarray").read_text())
        (tmp_path / str(fill) / ".zarray").write_text(json.dumps(
            {**meta, "chunks": [2, 3], "fill_value": fill}))
        del out
        (tmp_path / str(fill) / "0.0").write_bytes(np.arange(6, dtype="<f4").tobytes())
        got = ZarrArray.at_dir(tmp_path / str(fill)).read()
        np.testing.assert_array_equal(got[:2], np.arange(6, dtype="<f4").reshape(2, 3))
        np.testing.assert_array_equal(got[2:], np.full((2, 3), want, "<f4"))
    bf16 = write_array(tmp_path / "bf16", (2,), "bfloat16")
    meta = json.loads((tmp_path / "bf16" / ".zarray").read_text())
    (tmp_path / "bf16" / ".zarray").write_text(json.dumps({**meta, "fill_value": -2.0}))
    del bf16
    os.remove(tmp_path / "bf16" / "0")
    assert ZarrArray.at_dir(tmp_path / "bf16").read().tolist() == [0xC000, 0xC000]


def test_a_zarr3_store_is_refused(tmp_path):
    item = tmp_path / "params"
    item.mkdir()
    (item / "_METADATA").write_text(json.dumps({"tree_metadata": {}, "use_ocdbt": True,
                                                "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3"):
        orbax_store.Item(item)


def test_the_jax_fixture_decodes_bit_for_bit():
    """tools/make_orbax_fixture.py's store against the arrays saved beside
    it: every leaf of both items, the step item and the layout."""
    want = np.load(FIXTURE / "leaves.npz")
    step = FIXTURE / "store" / "3"
    assert orbax_store.steps(FIXTURE / "store") == [3]
    assert orbax_store.read_step_item(step / "step") == 3
    assert orbax_store.read_layout(FIXTURE / "store") == (1, 1)
    got = {}
    for item in ("params", "opt_state"):
        it = orbax_store.Item(step / item)
        assert it.store is not None  # OCDBT
        got.update({f"{item}.{k}": v for k, v in it.arrays().items()})
    bf16 = set(want["bfloat16"].tolist())
    assert set(got) == set(want.files) - {"bfloat16"} and bf16
    for name, a in got.items():
        w = want[name]
        assert a.dtype == w.dtype and a.shape == w.shape and np.array_equal(a, w), name
    assert all(got[n].dtype == np.uint16 for n in bf16)
