"""The serving lockstep: rank 0 publishes, the other ranks of a mesh replay.

Counterpart of long_vita_tpu/inference/multihost.py (reference
run_text_generation_server.py:114-153, text_generation_server.py:25-32).
The JAX package needs this channel only on a pod spanning hosts: one process
drives every device of a host. The port runs one process per GPU
(torchrun), or thread-ranks on one card, so EVERY serving mesh (cp, tp or
cp x tp) of more than one rank serves through it: world rank 0 answers HTTP
and publishes each scheduler
action (admit / prefill chunk / decode tick, or a whole request or batch)
over one ordered broadcast, and the other ranks decode the same payload
and issue the same engine call, so every rank reaches the same collectives
with the same operands (inference/server.py: ``FollowerReplayer``,
``follower_serve``).

The channel is a communicator of parallel/comm.py (``Comm.broadcast``): a
``ThreadComm`` for thread-ranks, or ``host_comm()`` of the mesh's world
``DistComm`` (a gloo group beside NCCL, so the bytes stay on the host).
Every function takes it explicitly; the role comes from its rank (rank 0
is the primary), where the JAX package asks ``jax.process_index()``.

Wire format (the JAX package's, byte for byte; two-phase, so a decode tick
costs a 64 KiB broadcast instead of a fixed multi-MiB slot):

  1. a 16-byte header broadcast: big-endian [json_len:8 | body_len:8]
     (8-byte fields: an admit publishes the EXPANDED tile stack, ~4.9 GB
     at 4096 frames in bf16 — past a 4-byte field);
  2. a body broadcast of ``_bucket(body_len)`` bytes, body_len rounded up
     to 64 KiB x 2^k.

The body is the JSON metadata, {"msg": ..., "arrays": [[dtype name,
shape], ...]}, then the raw bytes of the arrays. An array is a numpy array
or a torch tensor; a bf16 tensor rides as its 16-bit pattern under the
dtype name "bfloat16" (what ml_dtypes names it in the JAX package, so the
bytes are the same) and numpy, which has no bf16, never sees it. Decoded
arrays are CPU torch tensors. ``encode_payload`` rejects a body over
MAX_BODY_BYTES (PayloadTooLarge) before any collective is entered.

The idle channel: a follower waits in ``broadcast`` as long as no request
comes, and every wait of a communicator raises after its timeout (600 s by
default) — that is what makes a dead rank fatal to the others. So the
primary publishes IDLE, a no-op the followers skip, whenever the channel
has been quiet for a quarter of that timeout (``Heartbeat``): an idle
server keeps its followers for days, and a rank that dies still stops the
others within one timeout.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from long_vita_tpu_torch.parallel.comm import Comm

logger = logging.getLogger(__name__)

HEADER_BYTES = 16
BUCKET_BYTES = 64 * 1024
# Sanity ceiling on one broadcast body (64 GiB, an order of magnitude above
# the largest real payload, the ~4.9 GB 4096-frame bf16 tile stack). Checked
# BEFORE any collective, so a violation fails the request, not the group.
MAX_BODY_BYTES = 64 * 1024**3
SHUTDOWN = {"__ctl__": "shutdown"}
IDLE = {"__ctl__": "idle"}


class PayloadTooLarge(ValueError):
    """Raised by encode_payload before any broadcast has been entered."""


def is_primary(comm: Comm) -> bool:
    return comm.rank == 0


def _bucket(n: int) -> int:
    size = BUCKET_BYTES
    while size < n:
        size *= 2
    return size


def _dtype_name(a) -> str:
    if torch.is_tensor(a):
        return str(a.dtype).removeprefix("torch.")
    return a.dtype.name


def _raw(a) -> np.ndarray:
    """The array's bytes as a flat uint8 array (a tensor through its byte
    view: a bf16 tensor gives its 16-bit patterns)."""
    if torch.is_tensor(a):
        return a.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8)


def _meta(msg: Any, arrays: Sequence) -> bytes:
    return json.dumps({
        "msg": msg,
        "arrays": [[_dtype_name(a), list(a.shape)] for a in arrays],
    }).encode("utf-8")


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if torch.is_tensor(a) else int(a.nbytes)


def payload_nbytes(msg: Any, arrays: Sequence = ()) -> int:
    """Body size (msg, arrays) would occupy on the wire: a caller can reject
    an oversized request before it enters the collective."""
    return len(_meta(msg, arrays)) + sum(_nbytes(a) for a in arrays)


def encode_payload(msg: Any, arrays: Sequence = ()) -> tuple[np.ndarray, np.ndarray]:
    """(msg, arrays) -> (header, body) uint8 broadcast buffers."""
    raw = _meta(msg, arrays)
    body_len = len(raw) + sum(_nbytes(a) for a in arrays)
    if body_len > MAX_BODY_BYTES:
        raise PayloadTooLarge(
            f"broadcast body {body_len} bytes exceeds MAX_BODY_BYTES {MAX_BODY_BYTES}"
        )
    body = np.zeros((_bucket(body_len),), np.uint8)
    body[: len(raw)] = np.frombuffer(raw, np.uint8)
    off = len(raw)
    for a in arrays:
        b = _raw(a)
        body[off : off + b.size] = b
        off += b.size
    header = np.zeros((HEADER_BYTES,), np.uint8)
    header[:8] = np.frombuffer(len(raw).to_bytes(8, "big"), np.uint8)
    header[8:16] = np.frombuffer(body_len.to_bytes(8, "big"), np.uint8)
    return header, body


def decode_payload(header: np.ndarray, body: np.ndarray) -> tuple[Any, list[torch.Tensor]]:
    """-> (msg, arrays as CPU torch tensors)."""
    json_len = int.from_bytes(bytes(np.asarray(header[:8]).tobytes()), "big")
    meta = json.loads(np.asarray(body[:json_len]).tobytes().decode("utf-8"))
    arrays = []
    off = json_len
    for dtype_name, shape in meta["arrays"]:
        dtype = getattr(torch, dtype_name)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        raw = torch.from_numpy(np.array(body[off : off + n], np.uint8))
        arrays.append(raw.view(dtype).reshape(shape))
        off += n
    return meta["msg"], arrays


def publish_blob(comm: Comm, msg: Any = None, arrays: Sequence = ()) -> tuple[Any, list]:
    """Broadcast (msg, arrays) from rank 0 of ``comm`` to all its ranks;
    -> (msg, arrays), the same on every rank. Followers pass anything (it
    is ignored): only rank 0's payload is sent.

    A COLLECTIVE: every rank calls it the same number of times in the same
    order (the server serialises every publish and engine call under one
    lock)."""
    if is_primary(comm):
        header, body = encode_payload(msg, arrays)
    else:
        header = np.zeros((HEADER_BYTES,), np.uint8)
    header = comm.broadcast(torch.from_numpy(header)).numpy()
    body_len = int.from_bytes(bytes(header[8:16].tobytes()), "big")
    if not is_primary(comm):
        body = np.zeros((_bucket(body_len),), np.uint8)
    body = comm.broadcast(torch.from_numpy(body)).numpy()
    return decode_payload(header, body)


def publish(comm: Comm, obj: Any = None) -> Any:
    """Broadcast a plain JSON-serialisable message (no arrays)."""
    return publish_blob(comm, obj)[0]


def follower_loop(
    handle: Callable[[Any], None],
    comm: Optional[Comm] = None,
    _publish: Optional[Callable[[Any], Any]] = None,
) -> None:
    """Run on every rank but the primary: receive each published message
    and run handle(message), which must issue the engine call the primary
    made for it. Returns on SHUTDOWN; skips IDLE.

    A message whose handler raises (a bad image payload, a decode error) is
    logged and skipped: the primary fails that request alone and serves on,
    and a follower that left the loop would desynchronise the group (the
    next collective would wait for it until its timeout)."""
    pub = _publish or (lambda _: publish(comm, None))
    while True:
        msg = pub(None)
        if msg == SHUTDOWN:
            return
        if msg == IDLE:
            continue
        try:
            handle(msg)
        except Exception:
            logger.exception("follower request handler failed; staying in lockstep")


def shutdown(comm: Comm) -> None:
    """Primary: release the followers from their receive loop."""
    publish(comm, SHUTDOWN)


class Heartbeat:
    """The primary's idle beat: a daemon thread that publishes IDLE through
    ``publish`` whenever ``interval`` seconds pass without another publish
    (``touch`` marks one). It takes ``lock`` around each beat, the lock the
    server holds around every publish and engine call, so a beat never
    falls between a publish and the collectives of its engine call. A beat
    that fails (a follower died) calls ``on_error(exc)`` and stops."""

    def __init__(self, publish: Callable[[Any], Any], lock: threading.Lock, interval: float,
                 on_error: Optional[Callable[[BaseException], None]] = None):
        self._publish, self._lock, self.interval = publish, lock, interval
        self._on_error = on_error
        self._last = time.monotonic()
        self._stop = threading.Event()
        self.beats = 0
        self._thread = threading.Thread(target=self._run, daemon=True, name="lockstep-heartbeat")
        self._thread.start()

    def touch(self) -> None:
        self._last = time.monotonic()

    def _run(self) -> None:
        while not self._stop.wait(max(0.0, self._last + self.interval - time.monotonic())):
            with self._lock:
                if self._stop.is_set():
                    return
                if time.monotonic() - self._last < self.interval:
                    continue
                try:
                    self._publish(IDLE)
                except BaseException as exc:  # noqa: BLE001 (handed to on_error)
                    logger.exception("lockstep heartbeat failed")
                    if self._on_error is not None:
                        self._on_error(exc)
                    return
                self.beats += 1
                self.touch()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop beating (joins the thread; a beat in flight finishes)."""
        self._stop.set()
        self._thread.join(timeout)
