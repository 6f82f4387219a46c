"""The port's communicators (long_vita_tpu_torch/parallel/comm.py): ThreadComm
(thread-ranks of one process) and DistComm over gloo in spawned processes,
against the semantics of the JAX collectives they stand for (ppermute,
tiled all_to_all / all_gather, psum). Every wait is bounded: a rank that
hangs or raises must fail the others, within their timeout, and a worker
process still alive at the join timeout fails the test."""
import multiprocessing as mp
import queue
import socket
import sys
import time

import numpy as np
import pytest
import torch

from long_vita_tpu_torch.parallel.comm import (
    DistComm,
    LocalComm,
    ThreadComm,
    init_process_group,
    run_thread_ranks,
)

JOIN_TIMEOUT = 90.0  # seconds a spawned worker may take, its start included


def _rank_data(rank: int) -> torch.Tensor:
    return torch.arange(24, dtype=torch.float32).reshape(2, 4, 3) + 100 * rank


def _collectives(comm) -> dict:
    """Every collective on rank-distinct data -> numpy results."""
    x = _rank_data(comm.rank)
    if comm.size % 2 == 0:  # the even and the odd ranks
        sub = comm.split([list(range(0, comm.size, 2)), list(range(1, comm.size, 2))])
    else:
        sub = comm.split([list(range(comm.size))])
    out = {
        "shift1": comm.ring_shift(x, 1),
        "shift_back": comm.ring_shift(x, -1),
        "a2a": comm.all_to_all(x.repeat(1, comm.size, 1), 1, 0),
        "sum": comm.all_reduce_sum(x),
        "gather": comm.all_gather(x, 1),
        "sub_sum": sub.all_reduce_sum(torch.tensor([float(comm.rank)])),
        "sub_rank": torch.tensor([sub.rank, sub.size]),
    }
    comm.barrier()
    return {k: v.numpy() for k, v in out.items()}


def _expected(rank: int, size: int) -> dict:
    data = [_rank_data(r).numpy() for r in range(size)]
    rep = [np.tile(d, (1, size, 1)) for d in data]
    piece = 4  # rows of dim 1 each rank sends to each rank
    same = [r for r in range(size) if r % 2 == rank % 2] if size % 2 == 0 else list(range(size))
    return {
        "shift1": data[(rank - 1) % size],
        "shift_back": data[(rank + 1) % size],
        "a2a": np.concatenate([rep[j][:, rank * piece:(rank + 1) * piece] for j in range(size)], 0),
        "sum": sum(data),
        "gather": np.concatenate(data, 1),
        "sub_sum": np.asarray([float(sum(same))]),
        "sub_rank": np.asarray([same.index(rank), len(same)]),
    }


@pytest.mark.parametrize("size", [1, 2, 4])
def test_thread_comm_collectives(size):
    got = run_thread_ranks(_collectives, size, timeout=30)
    for rank, res in enumerate(got):
        want = _expected(rank, size)
        for key in want:
            np.testing.assert_array_equal(res[key], want[key], err_msg=f"rank {rank} {key}")


def test_local_comm_is_the_identity():
    x = _rank_data(0)
    c = LocalComm()
    for y in (c.ring_shift(x, 3), c.all_to_all(x, 1, 2), c.all_reduce_sum(x), c.all_gather(x, 1)):
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert c.split([[0]]) is c


def test_thread_comm_rank_that_raises_fails_the_others_at_once():
    def body(comm):
        if comm.rank == 1:
            raise ValueError("rank 1 failed")
        comm.barrier()  # would wait 60 s for rank 1 without the abort

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 failed"):
        run_thread_ranks(body, 3, timeout=60)
    assert time.monotonic() - t0 < 10


def test_thread_comm_hung_rank_times_out():
    """A rank that never arrives: the others raise after their timeout; the
    hung thread is abandoned at the join timeout."""
    def body(comm):
        if comm.rank == 0:
            time.sleep(3.0)  # arrives after the others gave up
            return None
        return comm.all_reduce_sum(torch.ones(1))

    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_thread_ranks(body, 2, timeout=0.5, join_timeout=10)
    assert time.monotonic() - t0 < 10
    with pytest.raises(TimeoutError, match="still running"):
        run_thread_ranks(lambda c: time.sleep(2.0), 2, timeout=0.2, join_timeout=0.3)


def test_thread_comm_split_groups_are_shared():
    def body(comm):
        a = comm.split([[0, 2], [1, 3]])
        b = comm.split([[0, 2], [1, 3]])
        assert a is b
        return a.all_gather(torch.tensor([comm.rank]), 0).tolist()

    assert run_thread_ranks(body, 4, timeout=30) == [[0, 2], [1, 3], [0, 2], [1, 3]]
    with pytest.raises(ValueError, match="partition"):
        ThreadComm.group(2)[0].split([[0]])


def test_thread_ranks_stress_under_a_short_switch_interval():
    """More thread-ranks than cores, the interpreter switching threads every
    microsecond: every exchange delivers, and the kernel wrappers' launch
    counters (ops/_build.count, under a lock) lose no count."""
    from long_vita_tpu_torch.ops import _build

    def counter():
        pass

    counter.launches = 0
    n, steps = 12, 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(comm):
            total = 0.0
            for i in range(steps):
                total += comm.all_reduce_sum(torch.tensor([float(comm.rank + i)])).item()
                for _ in range(25):
                    _build.count(counter)
            return total

        got = run_thread_ranks(body, n, timeout=60, join_timeout=120)
    finally:
        sys.setswitchinterval(old)
    want = float(sum(sum(r + i for r in range(n)) for i in range(steps)))
    assert got == [want] * n
    assert counter.launches == n * steps * 25


_FIRST_CALLS = """
import torch
torch.set_num_threads(1)
from long_vita_tpu_torch.parallel import comm
assert not comm._MATH_PRIMED
x = torch.arange(512, dtype=torch.float32).reshape(1, 32, 16) * 0.37
def rank(c):
    c.barrier()  # the ranks reach their first torch.cos together
    return torch.cos(x), torch.exp(-x)
got = comm.run_thread_ranks(rank, 2, timeout=30)
assert comm._MATH_PRIMED
want = (torch.cos(x), torch.exp(-x))
assert all(torch.equal(a, b) for r in got for a, b in zip(r, want)), "a rank's math kernel differs"
print("ok")
"""


def test_thread_ranks_bind_the_math_kernels_before_they_start():
    """run_thread_ranks calls the vectorised CPU math kernels once before its
    threads start (comm._prime_cpu_math: two threads making the first call
    of torch.cos together were handed a less accurate kernel in ~2% of
    fresh processes); in a fresh process, two ranks that call torch.cos and
    torch.exp together right after a barrier get the main thread's bits."""
    import subprocess
    from pathlib import Path

    res = subprocess.run([sys.executable, "-c", _FIRST_CALLS], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_autograd_probe_completes_on_the_cpu():
    """chip_smoke.py's probe: two thread-ranks whose backward passes meet at
    a barrier complete on the CPU (the engine runs a CPU backward on the
    calling thread). On CUDA the same probe times out (one device thread),
    which is why training over thread-ranks raises there."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    res = chip_smoke.autograd_thread_probe("cpu", timeout=20)
    assert res["completed"], res


# ---------------------------------------------------------------------------
# DistComm over gloo, two spawned processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, world, init, mode, out):
    torch.set_num_threads(1)
    try:
        comm = init_process_group(rank, world, init, backend="gloo",
                                  timeout=3.0 if mode == "hang" else 30.0)
        if mode == "ops":
            out.put((rank, _collectives(comm)))
        elif mode == "hang":
            if rank == 1:
                time.sleep(6.0)  # never joins the collective in time
                out.put((rank, "slept"))
            else:
                comm.all_reduce_sum(torch.ones(1))
                out.put((rank, "returned"))
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        out.put((rank, f"raised {type(e).__name__}: {e}"))


def run_gloo(target, world: int, *args, join_timeout: float = JOIN_TIMEOUT,
             exitcodes: dict = None) -> dict:
    """Spawn ``world`` processes target(rank, world, init, *args, queue) on a
    fresh localhost port; -> {rank: what it put}. A process alive at the
    join timeout is killed and fails the test. ``exitcodes``, when given,
    receives each rank's exit code."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target, args=(r, world, init, *args, q)) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + join_timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, res = q.get(timeout=min(left, 5.0))
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            results[rank] = res
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(5)
    assert not alive, f"workers still running after {join_timeout} s"
    if exitcodes is not None:
        exitcodes.update({r: p.exitcode for r, p in enumerate(procs)})
    return results


def test_dist_comm_gloo_collectives():
    got = run_gloo(_gloo_worker, 2, "ops")
    assert sorted(got) == [0, 1], got
    for rank, res in got.items():
        assert isinstance(res, dict), res
        want = _expected(rank, 2)
        for key in want:
            np.testing.assert_array_equal(res[key], want[key], err_msg=f"rank {rank} {key}")


def test_dist_comm_gloo_hung_rank_fails():
    got = run_gloo(_gloo_worker, 2, "hang")
    assert got[0].startswith("raised"), got


def test_dist_comm_needs_an_initialized_group():
    with pytest.raises((RuntimeError, ValueError)):
        DistComm()


# ---------------------------------------------------------------------------
# reduce_scatter and Megatron's conjugate collectives (copy_to_tp,
# reduce_from_tp, gather_seq, scatter_seq) against the unsharded op
# ---------------------------------------------------------------------------


def _conjugates(comm, device="cpu") -> dict:
    """Each conjugate Function on rank-distinct f32 data, forward and
    gradient, and reduce_scatter against a slice of all_reduce_sum. ->
    numpy results: every rank's forward, its input's gradient under an
    upstream gradient that differs by rank, and the reduce_scatter bits."""
    from long_vita_tpu_torch.parallel.comm import (
        copy_to_tp,
        gather_seq,
        reduce_from_tp,
        scatter_seq,
    )

    gen = torch.Generator().manual_seed(comm.rank)
    out = {}
    whole = torch.randn(2, 4 * comm.size, 3, generator=gen).to(device)
    rs = comm.reduce_scatter(whole, 1)
    n = whole.shape[1] // comm.size
    out["rs_exact"] = np.asarray(torch.equal(
        rs, comm.all_reduce_sum(whole)[:, comm.rank * n:(comm.rank + 1) * n]))
    out["rs"] = rs.cpu().numpy()
    for name, fn, shape in (("copy", copy_to_tp, (2, 4, 3)), ("reduce", reduce_from_tp, (2, 4, 3)),
                            ("gather", gather_seq, (2, 4, 3)),
                            ("scatter", scatter_seq, (2, 4 * comm.size, 3))):
        x = torch.randn(*shape, generator=gen).to(device).requires_grad_()
        y = fn(x, comm)
        g = torch.randn(*y.shape, generator=gen).to(device)
        y.backward(g)
        out[name] = tuple(t.detach().cpu().numpy() for t in (x, y, g, x.grad))
    comm.barrier()
    return out


def _check_conjugates(results: list) -> None:
    """Every rank's forward and gradient against the unsharded op: the
    whole computation is sum_r f(x_r) with each rank's upstream gradient
    g_r on its own output (exact for gathers and slices, 1e-6 for sums)."""
    for r, res in enumerate(results):
        assert res["rs_exact"], r
    xs = {k: [res[k][0] for res in results] for k in ("copy", "reduce", "gather", "scatter")}
    gs = {k: [res[k][2] for res in results] for k in xs}
    for r, res in enumerate(results):
        # copy_to_tp: identity forward, the upstream gradients summed
        np.testing.assert_array_equal(res["copy"][1], xs["copy"][r])
        np.testing.assert_allclose(res["copy"][3], sum(gs["copy"]), rtol=1e-6, atol=1e-6)
        # reduce_from_tp: the sum forward, the gradient passed through
        np.testing.assert_allclose(res["reduce"][1], sum(xs["reduce"]), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(res["reduce"][3], gs["reduce"][r])
        # gather_seq: every rank's slice, in rank order; the gradient is the
        # sum of every rank's upstream gradient at this rank's slice
        np.testing.assert_array_equal(res["gather"][1], np.concatenate(xs["gather"], 1))
        sl = slice(r * 4, (r + 1) * 4)
        np.testing.assert_allclose(res["gather"][3], sum(g[:, sl] for g in gs["gather"]),
                                   rtol=1e-6, atol=1e-6)
        # scatter_seq: this rank's slice of the sum; the gradient is every
        # rank's upstream gradient, gathered
        np.testing.assert_allclose(res["scatter"][1], sum(xs["scatter"])[:, sl], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(res["scatter"][3], np.concatenate(gs["scatter"], 1))


@pytest.mark.parametrize("size", [1, 2, 4])
def test_conjugate_collectives_on_thread_ranks(size):
    _check_conjugates(run_thread_ranks(_conjugates, size, timeout=30))


def test_conjugate_collectives_on_local_comm():
    _check_conjugates([_conjugates(LocalComm())])


def _uneven_seq(comm) -> dict:
    """gather_seq and scatter_seq on a whole of n = 4 * size - 3 rows, which
    does not split over the ranks: -> numpy (x, y, g, x.grad) of each."""
    from long_vita_tpu_torch.parallel.comm import gather_seq, scatter_seq, seq_slice

    gen = torch.Generator().manual_seed(comm.rank)
    n = 4 * comm.size - 3
    width = seq_slice(n, comm.size)
    real = min(max(n - comm.rank * width, 0), width)
    out = {}
    # a slice's pad rows are zeros, as the layout keeps them
    x = torch.randn(2, width, 3, generator=gen)
    x[:, real:] = 0
    for name, fn, x in (("gather", lambda t: gather_seq(t, comm, 1, n), x),
                        ("scatter", lambda t: scatter_seq(t, comm, 1),
                         torch.randn(2, n, 3, generator=gen))):
        x = x.requires_grad_()
        y = fn(x)
        g = torch.randn(*y.shape, generator=gen)
        y.backward(g)
        out[name] = tuple(t.detach().numpy() for t in (x, y, g, x.grad))
    return out


@pytest.mark.parametrize("size", [2, 4])
def test_uneven_sequence_collectives_on_thread_ranks(size):
    """A whole that does not split over the ranks (GSPMD's padded layout):
    each slice has ceil(n / size) rows, the last ones zero rows past n.
    gather_seq drops them (its gradient zero there), scatter_seq pads the
    whole with them (its gradient the gathered upstream gradients, cut to
    n rows): exact for gathers and slices, 1e-6 for sums."""
    res = run_thread_ranks(_uneven_seq, size, timeout=30)
    n = 4 * size - 3
    width = -(-n // size)
    xs = {k: [r[k][0] for r in res] for k in ("gather", "scatter")}
    gs = {k: [r[k][2] for r in res] for k in xs}
    pad = np.zeros((2, width * size - n, 3), np.float32)
    for r, got in enumerate(res):
        sl = slice(r * width, (r + 1) * width)
        assert got["gather"][1].shape == (2, n, 3)
        np.testing.assert_array_equal(got["gather"][1], np.concatenate(xs["gather"], 1)[:, :n])
        want = np.concatenate([sum(gs["gather"]), pad], 1)[:, sl]
        np.testing.assert_allclose(got["gather"][3], want, rtol=1e-6, atol=1e-6)
        assert got["scatter"][1].shape == (2, width, 3)
        want = np.concatenate([sum(xs["scatter"]), pad], 1)[:, sl]
        np.testing.assert_allclose(got["scatter"][1], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["scatter"][3],
                                      np.concatenate(gs["scatter"], 1)[:, :n])


def _gloo_conjugate_worker(rank, world, init, out):
    torch.set_num_threads(1)
    try:
        comm = init_process_group(rank, world, init, backend="gloo", timeout=30.0)
        out.put((rank, _conjugates(comm)))
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        out.put((rank, f"raised {type(e).__name__}: {e}"))


def test_conjugate_collectives_over_gloo():
    got = run_gloo(_gloo_conjugate_worker, 2)
    assert sorted(got) == [0, 1], got
    assert not any(isinstance(v, str) for v in got.values()), got
    _check_conjugates([got[0], got[1]])


def test_staging_is_never_implicit():
    """The host-staged mode is asked for by name, on gloo only."""
    with pytest.raises(ValueError, match="staged_device"):
        init_process_group(0, 1, "tcp://127.0.0.1:1", backend="nccl", staged_device="cuda")
    with pytest.raises(ValueError, match="staged_device"):
        init_process_group(0, 1, "tcp://127.0.0.1:1", backend="gloo", staged_device="cpu")


def _staged_worker(rank, world, init, out):
    try:
        comm = init_process_group(rank, world, init, backend="gloo", timeout=30.0,
                                  staged_device="cuda")
        res = _conjugates(comm, "cuda")
        big = torch.full((3, 1001), float(rank + 1), device="cuda")  # pads to the ranks
        res["sum_big"] = comm.all_reduce_sum(big).cpu().numpy()
        res["stats"] = dict(comm.stats)
        out.put((rank, res))
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        out.put((rank, f"raised {type(e).__name__}: {e}"))


@pytest.mark.cuda
def test_staged_gloo_collectives_on_one_card():
    """Two gloo processes sharing one card with CUDA operands staged through
    pinned host memory (the sums on the card): the conjugate collectives
    against the unsharded op, an all-reduce whose size does not divide by
    the ranks, and the copies counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staged mode copies CUDA operands")
    got = run_gloo(_staged_worker, 2)
    assert sorted(got) == [0, 1], got
    assert not any(isinstance(v, str) for v in got.values()), got
    _check_conjugates([got[0], got[1]])
    for res in got.values():
        np.testing.assert_array_equal(res["sum_big"], np.full((3, 1001), 3.0, np.float32))
        assert res["stats"]["copies"] > 0 and res["stats"]["bytes"] > 0
