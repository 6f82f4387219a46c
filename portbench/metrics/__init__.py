"""Per-layer metrics, one reader a quantity: ``read(ctx, name)`` returns the
number, or None where the run gave it nothing to read (the metric is then
left out of the result line). ``ctx`` is what the cell's entry recorded
(portbench/serve.py, portbench/train.py)."""
from __future__ import annotations

import re

_DEMANGLED = re.compile(r"(fwd_kernel|dkv_kernel|dq_kernel)<(\d+), *(\w+), *(\w+)(?:, *(\w+))?")
_MANGLED = re.compile(r"(fwd_kernel|dkv_kernel|dq_kernel)ILi(\d+)ELb([01])ELb([01])E(?:Lb([01])E)?")


def kernel(name: str):
    """The port's attention kernels by their template: -> (kind, head dim,
    causal, segments, quantised-or-fused) or None for any other operation."""
    m = _DEMANGLED.search(name)
    if m:
        flags = [g == "true" for g in m.groups()[2:] if g is not None]
    else:
        m = _MANGLED.search(name)
        if not m:
            return None
        flags = [g == "1" for g in m.groups()[2:] if g is not None]
    flags += [False] * (3 - len(flags))
    return (m.group(1), int(m.group(2)), *flags[:3])


def is_k1(name: str) -> bool:
    """K1: the decoder's flash forward (head dim 128, bf16 operands)."""
    k = kernel(name)
    return k is not None and k[0] == "fwd_kernel" and k[1] == 128 and not k[4]


def is_k3(name: str) -> bool:
    """K3: the tower's short attention (head dim 64, not causal)."""
    k = kernel(name)
    return k is not None and k[0] == "fwd_kernel" and k[1] == 64 and not k[2] and not k[4]


def is_attn_bwd(name: str) -> bool:
    """K4 (the fused kv-major pass) and K5 (its dkv and dq passes)."""
    k = kernel(name)
    return k is not None and k[0] in ("dkv_kernel", "dq_kernel")


def traced_iterations(ctx) -> list:
    if ctx.trace is None or ctx.traced is None:
        return []
    a, b = ctx.traced
    return ctx.iterations[a:b]
