"""ctypes bindings for the native preprocessing feedworker.

Counterpart of long_vita_tpu/data/native.py. The port keeps its own copy of
the C++ source (``data/csrc/preprocess.cpp``, native/preprocess.cpp's code)
and builds it with g++ at first use into the git-ignored ``build/native/``
at the repository root, with native/build.sh's flags: -ffast-math at compile
time only (linking with it would pull in crtfastmath.o, which sets FTZ/DAZ
for the whole process at load and flushes the host's subnormals). The
library's name carries a hash of the source and the flags, so an edited
source rebuilds.

Where the JAX package logs a failed build and falls back to PIL, the port
raises with g++'s output: the GPU machine may have no PIL to fall back to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
COMPILE_FLAGS = ("-O3", "-march=native", "-ffast-math", "-funroll-loops", "-fPIC",
                 "-std=c++17", "-pthread")
LINK_FLAGS = ("-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"liblvpreprocess-{h.hexdigest()[:16]}.so"


def _run(cmd: list) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(
            f"building the native preprocessing library failed: {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )


def build() -> Path:
    """Compile and link the source unless its library exists (a temporary
    file renamed into place, so concurrent builders never load a partial
    one). -> the library's path."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = out.with_suffix(f".{os.getpid()}.o")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        _run(["g++", *COMPILE_FLAGS, "-c", str(SOURCE), "-o", str(obj)])
        _run(["g++", *LINK_FLAGS, str(obj), "-o", str(tmp)])
        os.replace(tmp, out)
    finally:
        for f in (obj, tmp):
            f.unlink(missing_ok=True)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.preprocess_frames.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.preprocess_frames_u8.argtypes = lib.preprocess_frames.argtypes
        lib.crop_tiles.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def _f32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def preprocess_frames(
    frames: np.ndarray,  # uint8 [N, H, W, 3]
    out_size: int,
    mean, std,
    num_threads: int = 0,
    square_pad: bool = True,
    precision: str = "u8",
) -> np.ndarray:
    """-> float32 [N, out_size, out_size, 3]: expand2square (mean color),
    antialiased bicubic resize, normalize — reference process_images
    semantics in one native call.

    precision="u8" (default) reproduces the reference's ACTUAL pipeline
    bit-for-bit (PIL uint8-mode resize: int32 filter weights at 2^22,
    uint8-clipped intermediate between the passes) and is the fast path;
    precision="float" matches PIL's float-mode resampler to 1e-5 instead
    (no fixed-point quantization, ~1 LSB from the uint8 path)."""
    lib = _load()
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"frames must be [N, H, W, 3] RGB, got {frames.shape}")
    out = np.empty((n, out_size, out_size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    fn = lib.preprocess_frames_u8 if precision == "u8" else lib.preprocess_frames
    fn(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, _f32_ptr(out), out_size, _f32_ptr(mean), _f32_ptr(std),
        num_threads, 1 if square_pad else 0,
    )
    return out


def crop_tiles(
    img: np.ndarray,  # uint8 [gh*tile, gw*tile, 3]
    grid_h: int, grid_w: int, tile: int,
    mean, std,
) -> np.ndarray:
    """-> float32 [grid_h * grid_w, tile, tile, 3]: the row-major tiles of an
    image already resized to the grid, normalized."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((grid_h * grid_w, tile, tile, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.crop_tiles(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        grid_h, grid_w, tile, _f32_ptr(out), _f32_ptr(mean), _f32_ptr(std),
    )
    return out
