"""The device trace of a traced run: torch.profiler over a sub-window, read
into device intervals and host annotations.

Device operations are the profiler's CUDA events (kernels, copies, sets).
The busy time is the union of their intervals; the idle share is the rest
of the sub-window. An idle gap is named by the benchmark's own annotation
(``portbench.<what>``) and the innermost host operation that ran at its
middle.
"""
from __future__ import annotations

import bisect
import time

import torch


class Trace:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.device: list = []  # (start_ns, end_ns, name)
        self.host: list = []  # (start_ns, end_ns, name, is_annotation)

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            note = e.is_user_annotation() or e.name().startswith("portbench.")
            if e.device_type() != cuda:
                self.host.append((start, end, e.name(), note))
            elif not note:  # the annotations' device-side copies are no operation
                self.device.append((start, end, e.name()))
        self.device.sort()
        self.prof = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def union(self) -> list:
        """Merged busy intervals of the device."""
        out = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.union()) / 1e9

    def span_ns(self) -> tuple:
        """The traced window on the profiler's clock: from the first to the
        last event it recorded."""
        starts = [e[0] for e in self.device] + [h[0] for h in self.host]
        ends = [e[1] for e in self.device] + [h[1] for h in self.host]
        return min(starts), max(ends)

    def add_to(self, result: dict) -> None:
        """A traced run's result: the device's busy seconds and the traced
        window's length, and the breakdown of device operations and idle
        gaps."""
        result["device"].update(busy_s=self.busy_s(), window_s=self.window_s)
        result["breakdown"] = {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}

    def kernel_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(b - a for a, b, name in self.device if match(name)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        total: dict = {}
        for a, b, name in self.device:
            total[name] = total.get(name, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> list:
        """The longest gaps between busy intervals, each named by what the
        host was doing at its middle."""
        busy = self.union()
        lo, hi = self.span_ns()
        gaps, prev = [], lo
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        hosts = sorted(self.host)
        starts = [h[0] for h in hosts]
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) // 2
            cover = [h for h in hosts[: bisect.bisect_right(starts, mid)] if h[1] >= mid]
            notes = [h for h in cover if h[3] and h[2].startswith("portbench.")]
            ops = [h for h in cover if not h[3]]
            label = notes[-1][2][len("portbench."):] if notes else "outside"
            if ops:
                label += ": " + max(ops, key=lambda h: h[0])[2]
            out.append([label[:160], (b - a) / 1e9])
        return out


def note(name: str):
    """A host annotation that names what the benchmark is doing."""
    return torch.profiler.record_function(f"portbench.{name}")
