"""w4a16 matrix product: packed-int4 weights, group-wise scales, bf16 activations.

Counterpart of long_vita_tpu/ops/quant_matmul.py, in its layouts: the int4
weight [in, out] is packed split-half into int8 ``[in/2, out]`` (the low
nibble of byte p holds row p, the high nibble row in/2 + p) with f32 scales
``[in/128, out]``, one per (128-row input group, output column); x is
``[..., in]``.

  - host helpers in numpy, bit for bit the JAX package's: ``GROUP``,
    ``quantize_int4_grouped``, ``pack_int4``, ``unpack_int4``;
  - ``w4_matmul_reference``: K6's function in plain torch, sum over groups of
    s_g * (x_g @ q_g) with f32 accumulation and one cast at the end (the
    Pallas ``_w4_matmul_pallas_u`` order, :157-171);
  - ``w4_matmul_dequant``: the JAX dequantise route (``w4_matmul_xla``,
    :100-126): unpack, scale in f32, cast the weight to x's dtype, one product
    with f32 accumulation. It is JAX's own route for prefill-sized row counts
    and takes ``torch.matmul`` on CUDA, as JAX leaves that product to XLA;
  - ``w4_matmul``: JAX's rule (:279-309) with "on TPU" read as "on CUDA":
    the kernel K6 (``csrc/w4_matmul.cu``) for rows <= 512 on 128-row groups
    and an out dimension that JAX's block tiles, else the dequantise route.
    On CUDA the kernel launches or raises; on the CPU the kernel route takes
    ``w4_matmul_reference``. ``w4_matmul.launches`` counts kernel launches,
    ``w4_matmul_dequant.calls`` the dequantise route's calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from long_vita_tpu_torch.ops import _build
from long_vita_tpu_torch.ops._target import on_cuda

GROUP = 128  # input rows per scale group
MAX_KERNEL_ROWS = 512  # JAX's kernel route takes at most this many rows (:307)

_build.register("lvt_w4_matmul", "w4_matmul", (
    [ctypes.c_void_p] * 5   # x packed scales out ws
    + [ctypes.c_int] * 6    # rows n_in n_out ksplit x_f32 out_f32
))
_KERNEL_BN = 64  # output columns per block of the CUDA kernel
_BLOCKS_PER_SM = 4  # the split over groups aims at this many blocks per SM


# ---- host-side pack/quantize (numpy) -------------------------------------


def quantize_int4_grouped(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32 [..., in, out] -> (packed int8 [..., in/2, out], f32 scales
    [..., in/group, out]). Symmetric per (group, output column): scale =
    max|w_group| / 7, codes rounded half to even and clipped to -8..7. The
    group is 128 rows when in % 256 == 0, else in/2 (the tiny-shape
    fallback: one group per packed half)."""
    w = np.asarray(w, np.float32)
    n_in, n_out = w.shape[-2], w.shape[-1]
    group = GROUP if n_in % (2 * GROUP) == 0 else n_in // 2
    if n_in % (2 * group) != 0:
        raise ValueError(f"in dim {n_in} not divisible by 2*{group}")
    lead = w.shape[:-2]
    g = w.reshape(*lead, n_in // group, group, n_out)
    a = np.max(np.abs(g), axis=-2)
    scales = np.where(a > 0, a / np.float32(7.0), np.float32(1.0))
    q = np.clip(
        np.rint(g / scales[..., None, :]), -8, 7
    ).astype(np.int8).reshape(*lead, n_in, n_out)
    return pack_int4(q), scales.astype(np.float32)


def pack_int4(q: np.ndarray) -> np.ndarray:
    """int8 values in -8..7, [..., in, out] -> packed int8 [..., in/2, out].
    Low nibble = top half row p; high nibble = bottom half row in/2 + p."""
    n_in = q.shape[-2]
    top = q[..., : n_in // 2, :].astype(np.uint8) & 0xF
    bot = q[..., n_in // 2:, :].astype(np.uint8) & 0xF
    return ((bot << 4) | top).astype(np.uint8).view(np.int8)


def unpack_int4(packed: np.ndarray) -> np.ndarray:
    """Exact inverse of pack_int4."""
    p = np.asarray(packed).view(np.uint8).astype(np.int32)
    top = ((p & 0xF) ^ 8) - 8  # sign-extend the low nibble
    bot = ((p >> 4) ^ 8) - 8
    return np.concatenate([top, bot], axis=-2).astype(np.int8)


# ---- plain torch versions --------------------------------------------------


def _nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """packed int8 -> (top, bottom) int8 values in -8..7, without widening:
    the high nibble is the byte shifted right by 4 (arithmetic, so it comes
    sign-extended), the low nibble is shifted to the top of the byte first
    (wrapping) and back. Widened to int32 instead, the high nibble would
    have to be masked before the JAX package's ``^ 8 - 8`` trick, since the
    cast already sign-extended the byte (long_vita_tpu/ops/quant_matmul.py
    :112-114)."""
    return (packed << 4) >> 4, packed >> 4


def unpack_int4_torch(packed: torch.Tensor) -> torch.Tensor:
    """packed int8 [..., in/2, out] -> int8 codes [..., in, out]."""
    return torch.cat(_nibbles(packed), dim=-2)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] with f32 accumulation, f32 out: one bf16 GEMM
    writing f32 on CUDA, the operands widened (exactly) elsewhere."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def w4_matmul_reference(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K6's function in plain torch: x [..., in] -> [..., out].

    For each top-half group g (and its bottom-half partner G/2 + g), the
    group's dot x_g @ q_g with the codes in x's dtype (exact) and f32
    accumulation, scaled after the dot, added to an f32 sum in group order:
    acc + pt * s_top + pb * s_bottom. One cast to out_dtype (x's dtype when
    None) at the end. Groups are 128 rows, or in/2 (one per half) when the
    scales have two rows."""
    lead, n_in = x.shape[:-1], x.shape[-1]
    half, n_out = packed.shape
    ngroups = scales.shape[0]
    half_groups = ngroups // 2
    group = n_in // ngroups
    x2 = x.reshape(-1, n_in)
    scales = scales.float()
    acc = torch.zeros((x2.shape[0], n_out), dtype=torch.float32, device=x.device)
    for g in range(half_groups):
        top, bot = _nibbles(packed[g * group : (g + 1) * group])
        xt = x2[:, g * group : (g + 1) * group]
        xb = x2[:, half + g * group : half + (g + 1) * group]
        pt = _product_f32(xt, top.to(x.dtype))
        pb = _product_f32(xb, bot.to(x.dtype))
        acc = acc + pt * scales[g] + pb * scales[half_groups + g]
    return acc.to(out_dtype or x.dtype).reshape(*lead, n_out)


def w4_matmul_dequant(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The JAX dequantise route (w4_matmul_xla): the weight unpacked,
    multiplied by its group scale in f32 and cast to x's dtype (one
    transient [in, out] array), then one product with f32 accumulation,
    cast to out_dtype (x's dtype when None)."""
    w4_matmul_dequant.calls += 1
    out_dtype = out_dtype or x.dtype
    n_in, n_out = 2 * packed.shape[0], packed.shape[1]
    ngroups = scales.shape[-2]
    w = torch.cat(_nibbles(packed), dim=-2).reshape(ngroups, n_in // ngroups, n_out).float()
    w = w.mul_(scales.float()[:, None, :]).reshape(n_in, n_out).to(x.dtype)
    if x.is_cuda and x.dtype == torch.bfloat16:
        if out_dtype == torch.float32:
            lead = x.shape[:-1]
            out = torch.mm(x.reshape(-1, n_in), w, out_dtype=torch.float32)
            return out.reshape(*lead, n_out)
        return torch.matmul(x, w).to(out_dtype)  # cuBLAS: f32 accumulation
    return (x.float() @ w.float()).to(out_dtype)


w4_matmul_dequant.calls = 0  # calls of the dequantise route


# ---- the dispatcher ----------------------------------------------------------


def jax_block_out(n_out: int) -> int:
    """The out block JAX's kernel route picks (:284-287): the largest of
    1536, 1024, 512, 256, 128 that divides n_out, else 512."""
    return next((b for b in (1536, 1024, 512, 256, 128) if n_out % b == 0), 512)


def w4_uses_kernel(rows: int, packed: torch.Tensor, scales: torch.Tensor) -> bool:
    """JAX's choice of the kernel route (:296-308), on any device: a 2-D
    packed weight, (in/2) % 128 == 0, one scale row per 128 inputs, an out
    dimension that JAX's block divides, and at most 512 rows."""
    if packed.dim() != 2:
        return False
    half, n_out = packed.shape
    n_in = 2 * half
    return (
        n_out % jax_block_out(n_out) == 0
        and half % GROUP == 0
        and scales.shape[-2] == n_in // GROUP
        and rows <= MAX_KERNEL_ROWS
    )


def w4_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """out = x @ dequant(packed, scales); x [..., in] -> [..., out] in
    out_dtype (x's dtype when None). JAX's rule picks the route
    (w4_uses_kernel); the kernel route is K6 on CUDA and its plain version
    on the CPU."""
    lead, n_in = x.shape[:-1], x.shape[-1]
    rows = x.numel() // n_in if n_in else 0
    if not w4_uses_kernel(rows, packed, scales):
        return w4_matmul_dequant(x, packed, scales, out_dtype)
    if on_cuda(x, packed, scales):
        out = _w4_cuda(x.reshape(rows, n_in), packed, scales, out_dtype or x.dtype)
        return out.reshape(*lead, packed.shape[1])
    return w4_matmul_reference(x, packed, scales, out_dtype)


w4_matmul.launches = 0  # CUDA kernel launches (the wrapper counts them)


def kernel_ksplit(rows: int, n_in: int, n_out: int, sm_count: int) -> int:
    """Blocks the CUDA kernel splits the groups over: enough that the grid
    holds _BLOCKS_PER_SM blocks per SM, at most one per top-half group."""
    tiles = (n_out // _KERNEL_BN) * -(-rows // 64)
    want = -(-_BLOCKS_PER_SM * sm_count // tiles)
    return max(1, min(n_in // (2 * GROUP), want))


def _w4_cuda(x, packed, scales, out_dtype):
    """K6 on CUDA tensors: x [rows, in] bf16 or f32 -> [rows, out] in
    out_dtype (bf16 or f32)."""
    rows, n_in = x.shape
    half, n_out = packed.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w4 kernel takes bf16 or f32 x, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w4 kernel writes bf16 or f32, got {out_dtype}")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(
            f"w4 kernel takes int8 packed and f32 scales, got {packed.dtype}/{scales.dtype}"
        )
    if n_in != 2 * half or n_out % _KERNEL_BN or scales.shape != (n_in // GROUP, n_out):
        raise ValueError(
            f"shapes x {tuple(x.shape)} packed {tuple(packed.shape)} scales "
            f"{tuple(scales.shape)}"
        )
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("packed weights and scales must be contiguous")
    x = x.contiguous()
    if x.data_ptr() % 16 or packed.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError("x, packed and scales must be 16-byte aligned for the kernel")
    dev = x.device
    out = torch.empty((rows, n_out), dtype=out_dtype, device=dev)
    x_f32 = x.dtype == torch.float32
    ksplit = 1
    ws = None
    if not x_f32:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ksplit = kernel_ksplit(rows, n_in, n_out, sms)
        if ksplit > 1:
            ws = torch.empty((ksplit, rows, n_out), dtype=torch.float32, device=dev)
    _build.launch(
        "lvt_w4_matmul", dev, x, packed, scales, out, ws,
        rows, n_in, n_out, ksplit, int(x_f32), int(out_dtype == torch.float32),
    )
    w4_matmul.launches += 1
    return out
