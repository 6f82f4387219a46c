"""PyTorch port: inference/multihost.py (the serving lockstep's channel)
against the JAX package's, and the channel over the port's communicators.

The wire format must be the JAX package's byte for byte: encode_payload's
header and body for a message alone, for int32 / f32 arrays, and for a bf16
tile stack (an ml_dtypes array on the JAX side, a torch bf16 tensor on the
port's). Then the round trip and the bucket sizes; PayloadTooLarge raised
before any collective; follower_loop's control flow (the counterparts of
tests/test_multihost.py); publish_blob over LocalComm, ThreadComm at 2 and
4 thread-ranks and two gloo processes (DistComm), every rank getting the
same bytes; and the idle channel: a follower keeps its place across a gap
three times its communicator's timeout while the primary beats, times out
without the beat, and a follower that dies stops the primary's beat within
one timeout. Every wait is bounded.
"""
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from long_vita_tpu.inference import multihost as jax_mh
from long_vita_tpu_torch.inference import multihost
from long_vita_tpu_torch.parallel.comm import (
    LocalComm,
    ThreadComm,
    init_process_group,
    run_thread_ranks,
)
from test_torch_comm import run_gloo

TIMEOUT = 30.0


def _payloads():
    rng = np.random.default_rng(0)
    tiles = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    ids = np.arange(37, dtype=np.int32)
    idx = np.asarray([[0] * 8, list(range(8))], np.int32)
    return {
        "msg_only": ({"prompts": ["hello <image>"], "top_k": 5, "image_list": ["aGk=" * 100]},
                     [], []),
        "int32_f32": ({"op": "admit", "has_images": True}, [ids, tiles, idx],
                      [ids, tiles, idx]),
        "bf16_tiles": ({"op": "admit", "sampling": {"top_k": 3}, "has_images": True},
                       [ids, tiles.astype(ml_dtypes.bfloat16), idx],
                       [ids, torch.from_numpy(tiles).to(torch.bfloat16), idx]),
    }


@pytest.mark.parametrize("case", list(_payloads()))
def test_encode_payload_is_the_jax_bytes(case):
    msg, jax_arrays, port_arrays = _payloads()[case]
    jh, jb = jax_mh.encode_payload(msg, jax_arrays)
    ph, pb = multihost.encode_payload(msg, port_arrays)
    assert ph.dtype == pb.dtype == np.uint8
    assert ph.tobytes() == jh.tobytes() and pb.tobytes() == jb.tobytes()
    assert multihost.payload_nbytes(msg, port_arrays) == jax_mh.payload_nbytes(msg, jax_arrays)


@pytest.mark.parametrize("case", list(_payloads()))
def test_round_trip(case):
    """decode(encode(x)) == x, as CPU torch tensors (bf16 stays bf16); the
    JAX package decodes the port's bytes to the same values."""
    msg, jax_arrays, port_arrays = _payloads()[case]
    header, body = multihost.encode_payload(msg, port_arrays)
    got_msg, got = multihost.decode_payload(header, body)
    assert got_msg == msg and len(got) == len(port_arrays)
    jmsg, jgot = jax_mh.decode_payload(header, body)
    assert jmsg == msg
    for g, want, j in zip(got, port_arrays, jgot):
        assert torch.is_tensor(g)
        want = want if torch.is_tensor(want) else torch.from_numpy(want)
        assert g.dtype == want.dtype and torch.equal(g, want)
        assert np.array_equal(np.asarray(j, np.float32), want.float().numpy())


def test_bucket_sizes():
    b = multihost.BUCKET_BYTES
    assert b == jax_mh.BUCKET_BYTES == 64 * 1024 and multihost.HEADER_BYTES == 16
    for n, want in ((1, b), (b, b), (b + 1, 2 * b), (10 << 20, 256 * b)):
        assert multihost._bucket(n) == jax_mh._bucket(n) == want
    _, body = multihost.encode_payload({"op": "tick"})
    assert body.shape == (b,)


class _NoCollective(LocalComm):
    def broadcast(self, x, src=0):
        raise AssertionError("a collective was entered")


def test_payload_too_large_before_any_collective(monkeypatch):
    monkeypatch.setattr(multihost, "MAX_BODY_BYTES", 1000)
    with pytest.raises(multihost.PayloadTooLarge, match="exceeds MAX_BODY_BYTES"):
        multihost.publish_blob(_NoCollective(), {"op": "admit"}, [np.zeros(2000, np.uint8)])
    assert multihost.payload_nbytes({"op": "admit"}, [np.zeros(2000, np.uint8)]) > 1000


def test_follower_loop_runs_until_shutdown_and_skips_idle():
    reqs = [{"prompts": ["a"]}, multihost.IDLE, {"prompts": ["b"]}, multihost.SHUTDOWN,
            {"prompts": ["never"]}]
    it = iter(reqs)
    handled = []
    multihost.follower_loop(handled.append, _publish=lambda _: next(it))
    assert handled == [reqs[0], reqs[2]]


def test_follower_loop_survives_handler_errors():
    reqs = [{"prompts": ["bad"]}, {"prompts": ["good"]}, multihost.SHUTDOWN]
    it = iter(reqs)
    handled = []

    def handle(req):
        handled.append(req)
        if req["prompts"] == ["bad"]:
            raise ValueError("bad image payload")

    multihost.follower_loop(handle, _publish=lambda _: next(it))
    assert handled == reqs[:2]


def test_publish_blob_over_local_comm():
    msg, _, arrays = _payloads()["bf16_tiles"]
    got_msg, got = multihost.publish_blob(LocalComm(), msg, arrays)
    assert got_msg == msg and all(torch.equal(torch.as_tensor(a), g) for a, g in zip(arrays, got))
    assert multihost.publish(LocalComm(), {"op": "tick"}) == {"op": "tick"}


def _channel_rounds(comm):
    """Rank 0 publishes three payloads (a request, the bf16 admit, shutdown);
    every rank returns the bytes it decoded."""
    out = []
    for case in ("msg_only", "bf16_tiles"):
        msg, _, arrays = _payloads()[case]
        if comm.rank:
            msg, arrays = None, ()
        got_msg, got = multihost.publish_blob(comm, msg, arrays)
        out.append((got_msg, [g.view(torch.uint8).numpy().tobytes() for g in got]))
    out.append(multihost.publish(comm, multihost.SHUTDOWN if comm.rank == 0 else None))
    return out


@pytest.mark.parametrize("size", [2, 4])
def test_publish_blob_over_thread_ranks(size):
    got = run_thread_ranks(_channel_rounds, size, timeout=TIMEOUT)
    assert all(g == got[0] for g in got)
    assert got[0][-1] == multihost.SHUTDOWN and got[0][1][0]["op"] == "admit"


def _gloo_channel_worker(rank, world, init, out):
    torch.set_num_threads(1)
    try:
        comm = init_process_group(rank, world, init, backend="gloo", timeout=TIMEOUT)
        assert comm.host_comm() is comm  # a gloo group carries host bytes itself
        out.put((rank, _channel_rounds(comm)))
        torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        out.put((rank, f"raised {type(e).__name__}: {e}"))


def test_publish_blob_over_gloo_processes():
    got = run_gloo(_gloo_channel_worker, 2)
    assert sorted(got) == [0, 1] and got[0] == got[1], got
    assert got[0][-1] == multihost.SHUTDOWN


def _idle_rounds(comm, gap, beat):
    """Rank 0 idles ``gap`` seconds (beating every timeout / 4 when
    ``beat``), then publishes one message and SHUTDOWN; the others follow."""
    if comm.rank:
        seen = []
        multihost.follower_loop(seen.append, comm)
        return seen
    lock = threading.Lock()
    hb = multihost.Heartbeat(lambda m: multihost.publish(comm, m), lock,
                             comm.timeout / 4) if beat else None
    time.sleep(gap)
    with lock:
        multihost.publish(comm, {"op": "after the gap"})
    if hb is not None:
        hb.stop()
    with lock:
        multihost.shutdown(comm)
    return hb.beats if hb is not None else 0


def test_follower_survives_an_idle_gap_longer_than_its_timeout():
    timeout = 1.5
    got = run_thread_ranks(lambda c: _idle_rounds(c, 3 * timeout, True), 3, timeout=timeout,
                           join_timeout=TIMEOUT)
    beats, seen = got[0], got[1:]
    assert beats >= 8, beats  # a beat every 0.375 s over 4.5 s
    assert all(s == [{"op": "after the gap"}] for s in seen), seen


def test_idle_gap_without_the_beat_times_out():
    """The hazard the beat removes: a follower waiting past its timeout."""
    with pytest.raises(TimeoutError):
        run_thread_ranks(lambda c: _idle_rounds(c, 3.0, False), 2, timeout=1.0,
                         join_timeout=TIMEOUT)


def test_a_dead_follower_stops_the_primary_within_its_timeout():
    """A follower that leaves the channel: the primary's next beat cannot
    complete, raises at its timeout and reports it."""
    comm0, _ = ThreadComm.group(2, timeout=1.0)
    errors = []
    failed = threading.Event()
    t0 = time.monotonic()
    hb = multihost.Heartbeat(lambda m: multihost.publish(comm0, m), threading.Lock(), 0.25,
                             on_error=lambda e: (errors.append(e), failed.set()))
    assert failed.wait(TIMEOUT)
    hb.stop(TIMEOUT)
    assert isinstance(errors[0], TimeoutError) and hb.beats == 0
    assert time.monotonic() - t0 < 5.0
