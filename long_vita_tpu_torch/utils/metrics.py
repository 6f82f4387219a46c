"""Metrics logging and the profiler window.

Counterpart of long_vita_tpu/utils/metrics.py (the reference's tensorboardX
logging and --profile-* flags, arguments.py:121-134; --log-throughput): a
JSONL metrics stream with the JAX package's records, a torch.profiler trace
of the card over a window of steps, and the MFU formula.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics (one object per step: step, wall_s and the
    values given, as floats where they convert)."""

    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **values):
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()


class Profiler:
    """A torch.profiler trace (host and card) over the steps start <= step
    < stop, written to ``output_dir`` as a Chrome trace
    (``trace_<start>_<stop>.json``) when the window closes. ``trace_path``
    names it; a profiler that fails to start or stop raises."""

    def __init__(self, output_dir: str, start_step: int, stop_step: int):
        self.output_dir = output_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self.trace_path = os.path.join(output_dir, f"trace_{start_step}_{stop_step}.json")
        self._prof = None

    def step(self, step: int):
        if step == self.start_step and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.output_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif step == self.stop_step and self._prof is not None:
            self._stop()

    def _stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(self.trace_path)

    def close(self):
        if self._prof is not None:
            self._stop()


def mfu(
    tokens_per_second: float,
    num_params: float,
    peak_flops: float,
    seq_len: Optional[int] = None,
    attn_flops_per_token: float = 0.0,
) -> float:
    """Model FLOPs utilization for a training step (6ND + attention)."""
    flops_per_token = 6.0 * num_params + attn_flops_per_token
    return tokens_per_second * flops_per_token / peak_flops
