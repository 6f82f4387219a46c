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
    ``w4_matmul_dequant.calls`` the dequantise route's calls;
  - ``w4_split_plan``: how the kernel cuts the work over its blocks (one
    contiguous range of (row tile, column tile, group pair) units a block)
    and in which order the partials of a tile that spans blocks are added;
    ``w4_matmul_split_reference`` is the plain version in that order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from long_vita_tpu_torch.ops import _build
from long_vita_tpu_torch.ops._target import on_cuda

GROUP = 128  # input rows per scale group
MAX_KERNEL_ROWS = 512  # JAX's kernel route takes at most this many rows (:307)

_build.register("lvt_w4_matmul", "w4_matmul", (
    [ctypes.c_void_p] * 5   # x packed scales out ws
    + [ctypes.c_int] * 6    # rows n_in n_out blocks x_f32 out_f32
))
KERNEL_COLS = 128  # output columns a block of the CUDA kernel
KERNEL_ROW_TILES = (8, 16, 32, 64, 128)  # its row tiles (the wgmma N)
_CONSUMERS = 2  # warpgroups of 64 output columns a block
# units a block takes at least: each costs a block a few hundred cycles of
# unpacking and products, so a short range would spend its life in the
# ring's first DRAM round trip and the reduction of its partials
MIN_UNITS_A_BLOCK = 4


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
    _build.count(w4_matmul_dequant, "calls")
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


class W4Shape(NamedTuple):
    """How the CUDA kernel cuts one call: row tiles of ``n`` rows, column
    tiles of KERNEL_COLS, ``pairs`` group pairs (a top-half group and its
    bottom partner) along the input; ``units`` = tiles x pairs, numbered
    tile-major (tile = row tile x col_tiles + column tile), cut into
    ``blocks`` contiguous ranges."""
    n: int
    row_tiles: int
    col_tiles: int
    pairs: int
    blocks: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.pairs


def w4_row_tile(rows: int) -> int:
    """The kernel's row tile: the fewest of 8, 16, 32, 64 rows that hold
    ``rows``, else tiles of 128."""
    return next((n for n in KERNEL_ROW_TILES if rows <= n), KERNEL_ROW_TILES[-1])


@functools.lru_cache(maxsize=256)
def w4_launch_shape(rows: int, n_in: int, n_out: int, sm_count: int) -> W4Shape:
    """The kernel's cut of [rows, n_in] @ [n_in, n_out] on a card of
    ``sm_count`` SMs: one block a SM (its shared memory holds one), or
    fewer when the units would give a block fewer than MIN_UNITS_A_BLOCK."""
    n = w4_row_tile(rows)
    row_tiles, col_tiles = -(-rows // n), n_out // KERNEL_COLS
    pairs = n_in // (2 * GROUP)
    units = row_tiles * col_tiles * pairs
    return W4Shape(n, row_tiles, col_tiles, pairs, max(1, min(sm_count, units // MIN_UNITS_A_BLOCK)))


def w4_block_units(b: int, shape: W4Shape) -> tuple[int, int]:
    """The units [begin, end) of block b: units x b / blocks, rounded down
    (the kernel's ``unit_begin``)."""
    return shape.units * b // shape.blocks, shape.units * (b + 1) // shape.blocks


def w4_split_plan(rows: int, n_in: int, n_out: int, sm_count: int) -> tuple[W4Shape, list]:
    """The kernel's cut and, for each tile, its segments in the order their
    f32 partials are added: [(block, slot, first pair, end pair)]. A tile
    within one block has one segment, written out directly; a tile that
    spans blocks is summed by the last of them to arrive, in block order,
    from the partials each wrote into its slot (0 for the block's first
    tile, 1 for its last)."""
    shape = w4_launch_shape(rows, n_in, n_out, sm_count)
    segments = [[] for _ in range(shape.tiles)]
    for b in range(shape.blocks):
        u0, u1 = w4_block_units(b, shape)
        first = u0 // shape.pairs
        u = u0
        while u < u1:
            tile = u // shape.pairs
            p1 = min(shape.pairs, u1 - tile * shape.pairs)
            segments[tile].append((b, 0 if tile == first else 1, u - tile * shape.pairs, p1))
            u = tile * shape.pairs + p1
    return shape, segments


def w4_workspace_bytes(shape: W4Shape) -> int:
    """The kernel's workspace: an int32 counter a (tile, consumer warpgroup),
    then, from a 256-byte boundary, a slot of f32 partials a (block, slot,
    consumer warpgroup, thread)."""
    counters = -(-shape.tiles * _CONSUMERS * 4 // 256) * 256
    return counters + shape.blocks * 2 * _CONSUMERS * 128 * (shape.n // 2) * 4


def w4_matmul_split_reference(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
    sm_count: int = 132,
) -> torch.Tensor:
    """The plain version in the CUDA kernel's order (w4_split_plan): each
    segment of a tile sums its group pairs from zero as w4_matmul_reference
    does (acc + pt * s_top + pb * s_bottom), the segments' f32 sums are
    added in block order, and the result is cast once. x [rows, in]."""
    rows, n_in = x.shape
    n_out = packed.shape[1]
    shape, segments = w4_split_plan(rows, n_in, n_out, sm_count)
    half, c = n_in // 2, KERNEL_COLS
    scales = scales.float()
    out = torch.empty((rows, n_out), dtype=torch.float32, device=x.device)
    for tile, segs in enumerate(segments):
        rt, ct = divmod(tile, shape.col_tiles)
        xr = x[rt * shape.n:(rt + 1) * shape.n]
        cols = slice(ct * c, (ct + 1) * c)
        total = None
        for _, _, p0, p1 in segs:
            acc = torch.zeros((xr.shape[0], c), dtype=torch.float32, device=x.device)
            for g in range(p0, p1):
                top, bot = _nibbles(packed[g * GROUP:(g + 1) * GROUP, cols])
                pt = _product_f32(xr[:, g * GROUP:(g + 1) * GROUP], top.to(x.dtype))
                pb = _product_f32(xr[:, half + g * GROUP:half + (g + 1) * GROUP], bot.to(x.dtype))
                acc = acc + pt * scales[g, cols] + pb * scales[shape.pairs + g, cols]
            total = acc if total is None else total + acc
        out[rt * shape.n:(rt + 1) * shape.n, cols] = total
    return out.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_workspaces: dict = {}  # (device index, W4Shape) -> the kernel's workspace


def _workspace(dev: torch.device, shape: W4Shape) -> torch.Tensor:
    """The kernel's workspace for one cut on ``dev``, zeroed once and reused
    by every call of that cut: the kernel leaves its counters at zero, and
    the launches of one stream never overlap. (Another cut places its
    counters elsewhere, so the key is the cut, not the size.)"""
    key = (dev.index, shape)
    ws = _workspaces.get(key)
    if ws is None:
        n = w4_workspace_bytes(shape) // 4
        ws = _workspaces[key] = torch.zeros(n, dtype=torch.int32, device=dev)
    return ws


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
    if n_in != 2 * half or n_in % (2 * GROUP) or n_out % KERNEL_COLS or scales.shape != (
        n_in // GROUP, n_out
    ):
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
    blocks, ws = 1, None
    if not x_f32:
        shape = w4_launch_shape(rows, n_in, n_out, _sm_count(dev.index))
        blocks, ws = shape.blocks, _workspace(dev, shape)
    _build.launch(
        "lvt_w4_matmul", dev, x, packed, scales, out, ws,
        rows, n_in, n_out, blocks, int(x_f32), int(out_dtype == torch.float32),
    )
    _build.count(w4_matmul)
    return out
