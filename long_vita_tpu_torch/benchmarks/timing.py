"""Device timing on the card, shared by the forward-kernel lab, chip_smoke.py
and the A/B tools: ``cuda_ms`` for calls of a millisecond or more,
``queued`` for kernels short enough that the host's launch path would show."""
from __future__ import annotations

import statistics
import time

import torch


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of fn() in ms from CUDA events, one call at a time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued(fns, reps: int, cycles: int = 20_000_000) -> tuple:
    """(device ms, host ms) per call of ``fns`` (taken in turn): CUDA events
    around ``reps`` calls queued behind a sleep kernel, so that the host's
    launch overhead (tens of microseconds a call, more than a decode-sized
    kernel takes) does not show, and the host's time to enqueue one call
    (the wrapper's checks, allocations and launch). Each fn is called once
    first, to warm up. The queue must not drain: the host's time from the
    sleep's launch to the last call's must stay inside the sleep's span on
    the card (events around it); if it does not, the sleep is lengthened and
    the run repeated, and after three tries the timing fails. Give several
    copies of the operands to keep a working set over the 50 MB L2 cold, as
    decode finds it."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t1 = time.perf_counter()
        for i in range(reps):
            fns[i % len(fns)]()
        host_ms = (time.perf_counter() - t0) * 1e3
        per_call = (time.perf_counter() - t1) * 1e3 / reps
        end.record()
        torch.cuda.synchronize()
        sleep_ms = slept.elapsed_time(start)
        if host_ms < sleep_ms:
            return start.elapsed_time(end) / reps, per_call
        cycles = int(cycles * 2 * host_ms / sleep_ms)
    raise AssertionError(f"the host took {host_ms:.1f} ms to queue {reps} calls, longer than "
                         f"the {sleep_ms:.1f} ms sleep they wait behind: the queue drained")
