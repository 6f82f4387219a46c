"""Kernel dispatch by the device the tensors lie on.

Counterpart of long_vita_tpu/ops/_target.py:17, where the process backend
(or ``LVT_TARGET``) picks Pallas or XLA at trace time. Here the tensor is the
target: a CUDA tensor launches the hand-written kernel (or its wrapper
raises), a CPU tensor takes the kernel's plain PyTorch version. There is no
switch that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True if the (non-None) tensors lie on CUDA, False if on the CPU.

    Raises on a mix of devices or on any other device type."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds <= {"cpu"}:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: {sorted(kinds)}")
