"""zstd frames decoded by the system's libzstd, bound with ctypes.

The JAX package's orbax stores compress their OCDBT manifests, B+tree nodes
and zarr chunks as zstd frames (RFC 8878). The port reads them through
``libzstd.so.1``'s streaming decoder (``ZSTD_decompressStream``), which needs
no content size in the frame header: tensorstore's writers leave it out of
some frames. There is no second route: without the library ``decompress``
raises and names it. The port writes its own stores uncompressed, so it needs
no encoder.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

LIBRARY = "libzstd.so.1"
MAGIC = b"\x28\xb5\x2f\xfd"  # a zstd frame's first four bytes

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _Buffer(ctypes.Structure):  # ZSTD_inBuffer and ZSTD_outBuffer have one layout
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            try:
                # its own symbols first: a library loaded with RTLD_GLOBAL
                # before it (TensorFlow's carries another zstd) must not
                # take its internal calls
                lib = ctypes.CDLL(LIBRARY, mode=os.RTLD_LOCAL | os.RTLD_DEEPBIND)
            except OSError as e:
                raise RuntimeError(
                    f"reading an orbax store's zstd frames needs the system's {LIBRARY} "
                    f"(zstd's shared library): {e}") from e
            lib.ZSTD_createDStream.restype = ctypes.c_void_p
            lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
            lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
            lib.ZSTD_initDStream.restype = ctypes.c_size_t
            lib.ZSTD_decompressStream.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]
            lib.ZSTD_decompressStream.restype = ctypes.c_size_t
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t
            _lib = lib
    return _lib


def decompress(data, size_hint: int = 0) -> bytes:
    """The concatenated contents of the zstd frames in ``data`` (bytes, a
    memoryview or a numpy uint8 array). ``size_hint``: the decoded size when
    the caller knows it (the first output buffer's size). Raises ValueError
    on a corrupt or truncated frame."""
    lib = _library()
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, np.uint8)
    src = np.ascontiguousarray(data).view(np.uint8).reshape(-1)  # no copy of bytes or a memmap
    n = src.size
    inb = _Buffer(src.ctypes.data, n, 0)
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    chunks = []
    try:
        lib.ZSTD_initDStream(stream)
        cap = max(int(size_hint), lib.ZSTD_DStreamOutSize())
        left = 1  # 0 once a frame has ended and been flushed whole
        while inb.pos < inb.size or left:
            out = ctypes.create_string_buffer(cap)
            outb = _Buffer(ctypes.addressof(out), cap, 0)
            before = inb.pos
            left = lib.ZSTD_decompressStream(stream, ctypes.byref(outb), ctypes.byref(inb))
            if lib.ZSTD_isError(left):
                raise ValueError(f"zstd: {lib.ZSTD_getErrorName(left).decode()}")
            chunks.append(ctypes.string_at(ctypes.addressof(out), outb.pos))
            if left and inb.pos == inb.size and inb.pos == before and outb.pos < cap:
                raise ValueError(f"zstd: the frame is truncated ({n} bytes given)")
            if not n:
                break
    finally:
        lib.ZSTD_freeDStream(stream)
    return b"".join(chunks)
