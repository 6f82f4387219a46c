"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``ops/csrc/`` compiles on first use into a shared library
with a plain C interface under ``build/kernels/`` at the repository root
(git-ignored). The library's file name carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.
nvcc's output (``-Xptxas -v``: registers, shared memory, spills) is kept in a
``.log`` beside the library.

The ops modules register their C entry points here (``register``: entry
name, source, ctypes argument types) and launch them through ``launch``;
``build_registered`` builds every registered source at once.

Nothing here runs at import time: the CPU tests import every module on a
machine with neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# C entry point -> (its source under csrc/, its argument types before the stream)
_ENTRIES: dict[str, tuple[str, list]] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "long_vita_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to for its current content (the
    source, the shared headers of ``csrc/`` and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu``; None if its library already exists.
    -> (process, temporary output, final output, command)."""
    out = library_path(name)
    if out.is_file():
        return None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, tmp, out, cmd


def _finish(name: str, started) -> Path:
    proc, tmp, out, cmd = started
    stdout, stderr = proc.communicate()
    out.with_suffix(".log").write_text(stdout + stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{' '.join(cmd)}\n{stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for its hash exists."""
    started = _start(name)
    return library_path(name) if started is None else _finish(name, started)


def build_all(names) -> None:
    """Compile several sources at once: one nvcc process each, all started
    before the first is waited for."""
    started = {name: _start(name) for name in names}
    errors = []
    for name, st in started.items():
        if st is None:
            continue
        try:
            _finish(name, st)
        except RuntimeError as e:  # wait for the others before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load (once per process) ``csrc/<name>.cu``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``csrc/<name>.cu``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def register(entry: str, source: str, argtypes) -> None:
    """Declare the C entry point ``entry`` of ``csrc/<source>.cu``; its last
    argument, the CUDA stream, is appended to ``argtypes`` here."""
    _ENTRIES[entry] = (source, [*argtypes, ctypes.c_void_p])


def argtypes(entry: str) -> list:
    """The ctypes argument types of the registered entry point ``entry``,
    the stream last."""
    return _ENTRIES[entry][1]


def registered_sources() -> tuple[str, ...]:
    """The sources of the registered entry points, in registration order."""
    return tuple(dict.fromkeys(source for source, _ in _ENTRIES.values()))


def kernel(entry: str):
    """The registered C entry point ``entry``, its library built and loaded
    if needed."""
    source, argtypes = _ENTRIES[entry]
    fn = getattr(load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def build_registered() -> None:
    """Build every registered source (one nvcc each, in parallel) and load
    every registered entry point."""
    build_all(registered_sources())
    for entry in _ENTRIES:
        kernel(entry)


def launch(entry: str, dev, *args) -> None:
    """Call a registered entry point on ``dev``'s current stream (tensors
    pass as their data pointers, None as a null pointer); raise on a CUDA
    error."""
    import torch

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel(entry)(
            *(a.data_ptr() if torch.is_tensor(a) else a for a in args), stream
        )
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")


_count_lock = threading.Lock()


def count(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.<attr>``, a kernel wrapper's launch counter,
    under a lock: thread-ranks (parallel/comm.ThreadComm) launch from
    several threads, and a bare += between two of them can lose a count."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
