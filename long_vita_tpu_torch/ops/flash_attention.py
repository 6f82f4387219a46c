"""Attention kernels written by hand for Hopper, with their plain versions.

Counterpart of long_vita_tpu/ops/flash_attention.py. Three forward and two
backward kernels, CUDA C++ sources under ``csrc/`` built with nvcc at first
use (ops/_build.py, where the entry points are registered); every entry point
has its own launch counter on its wrapper:

  - ``flash_attention`` (:1488; Pallas `_fwd_kernel` :144 -> K1,
    ``csrc/flash_fwd.cu``): flash forward, GQA, offsets, kv_valid_len,
    segment ids; differentiable (the counterpart of ``_flash_core``'s
    custom_vjp, :839-921), its backward K4 or K5 as the JAX package chooses
    (``bwd_uses_fused``). The forward is the custom op ``lvt::flash_fwd``
    (``flash_fwd_op``), so that selective checkpointing can keep its
    (o, lse), as JAX's remat="flash" keeps the names "flash_out" and
    "flash_lse" (models/qwen2.remat_ops);
  - ``flash_bwd_fused`` (Pallas `_bwd_fused_kernel` :588 -> K4,
    ``csrc/flash_bwd.cu``): the one-pass backward, dQ added into an f32
    buffer;
  - ``flash_bwd_dkv`` and ``flash_bwd_dq`` (Pallas `_bwd_dkv_kernel` :454 and
    `_bwd_dq_kernel` :530 -> K5, ``csrc/flash_bwd_2pass.cu``): the two-pass
    backward, no memory that grows with the number of kv blocks; the bf16
    bodies of K4 and K5 are one Hopper backward, ``csrc/flash_bwd_sm90.cuh``,
    whose tiles and skip rule ``bwd_dkv_plan`` / ``bwd_dq_plan`` spell out;
  - ``flash_attention_quant`` (:1360; Pallas `_fwd_quant_kernel` :261 -> K2,
    ``csrc/flash_fwd_quant.cu``, the int8 instance of the Hopper forward):
    causal flash forward against an int8 KV cache with per-(token, kv head)
    f32 scales, forward only;
  - ``short_attention`` (:1227; Pallas `_short_nc_kernel` :1192 -> K3,
    ``csrc/short_attn.cu``): non-causal attention over a short sequence (the
    ViT's 1025 tokens); differentiable, its backward K4/K5 fed K3's own
    (o, lse) as the JAX ``_short_attention_bwd`` does.

Public contract, as in the JAX package: model layout ``[B, S, H, D]``; the
q/kv position offsets are taken from element ``[0, 0]`` of the positions when
given; ``kv_valid_len`` is batch-uniform (element 0 of a ``[B]`` vector);
returns ``o`` or ``(o, lse)`` with lse f32 ``[B, Hq, Sq]`` (lse is not
differentiable). A head dim that is not a multiple of 64 (SigLIP's 72,
EVA's 112) is zero-padded to a multiple of 128 with the scale of the true
one, and o sliced back, as the JAX ``_prepare`` (:1165-1183) pads it for the
Pallas kernels; the padding is part of the autograd graph, so dq, dk and dv
come back at the true head dim.

Dispatch is by device (ops/_target.py): a CUDA tensor launches the kernel or
raises; a CPU tensor takes the kernel's plain PyTorch version
(``*_reference``).

Empty rows: a query row with no unmasked key gets o = 0 and lse = -2^30.
The Pallas kernel gives the same for every row whose blocks are all skipped
(past the diagonal or past kv_len), which covers the empty rows serving
produces; a row that is fully masked inside a computed Pallas block instead
averages that block's values, a tiling artefact neither the CUDA kernel nor
the reference reproduces.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from long_vita_tpu_torch.ops import _build
from long_vita_tpu_torch.ops._target import on_cuda

NEG_INF = -(2.0**30)

IntLike = Union[int, torch.Tensor]

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

_BWD_ARGS = (
    [ctypes.c_void_p] * 14      # q k v do lse delta dq dk dv qseg kseg seg_ranges tile_order meta
    + [ctypes.c_longlong] * 10  # batch/seq strides of q k v do, segment batch strides
    + [ctypes.c_int] * 7        # batch sq skv hq hkv d causal
    + [ctypes.c_float, ctypes.c_int]  # scale dtype
)
_build.register("lvt_flash_fwd", "flash_fwd", (
    [ctypes.c_void_p] * 9       # q k v o lse qseg kseg seg_ranges meta
    + [ctypes.c_longlong] * 10  # batch/seq strides of q k v o, segment batch strides
    + [ctypes.c_int] * 7        # batch sq skv hq hkv d causal
    + [ctypes.c_float, ctypes.c_int]  # scale dtype
))
_build.register("lvt_flash_fwd_quant", "flash_fwd_quant", (
    [ctypes.c_void_p] * 8       # q k v k_scale v_scale o lse meta
    + [ctypes.c_longlong] * 14  # batch/seq strides of q k v o; b/s/h of both scales
    + [ctypes.c_int] * 6        # batch sq skv hq hkv d
    + [ctypes.c_float]          # scale
))
_build.register("lvt_short_attn", "short_attn", (
    [ctypes.c_void_p] * 5       # q k v o lse
    + [ctypes.c_longlong] * 8   # batch/seq strides of q k v o
    + [ctypes.c_int] * 4        # batch s hq hkv
    + [ctypes.c_float]          # scale
))
_build.register("lvt_flash_bwd", "flash_bwd", _BWD_ARGS)
_build.register("lvt_flash_bwd_dkv", "flash_bwd_2pass", _BWD_ARGS)
_build.register("lvt_flash_bwd_dq", "flash_bwd_2pass", _BWD_ARGS)


def _device_meta(dev, *values: IntLike) -> torch.Tensor:
    """int32 scalars on the device, read by a kernel as the Pallas kernels
    read their scalar-prefetch operands. A Python int becomes a fill kernel
    and a device tensor is cast in place: neither waits for the card (an
    element assignment from the host, ``meta[i] = x``, is a copy from
    pageable memory, which synchronises the stream first: ~10 ms of host
    time a call behind queued work, measured on an H100)."""
    return torch.stack([
        x.to(device=dev, dtype=torch.int32).reshape(()) if torch.is_tensor(x)
        else torch.full((), int(x), dtype=torch.int32, device=dev)
        for x in values
    ])


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    q_offset: IntLike = 0,
    kv_offset: IntLike = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[IntLike] = None,
    return_lse: bool = False,
):
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D]. -> o [B, Sq, Hq, D]
    (and lse [B, Hq, Sq] f32 when return_lse). Differentiable in q, k, v;
    offsets, kv_valid_len and segment ids pass through to the backward."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    if q_positions is not None:
        q_offset = q_positions[0, 0]
    if kv_positions is not None:
        kv_offset = kv_positions[0, 0]
    if kv_valid_len is None:
        kv_valid_len = k.shape[1]
    elif torch.is_tensor(kv_valid_len) and kv_valid_len.ndim:
        kv_valid_len = kv_valid_len.reshape(-1)[0]
    meta = _device_meta(q.device, q_offset, kv_offset, kv_valid_len)
    d = q.shape[-1]
    if d % 64:
        q, k, v = (pad_head_dim(x) for x in (q, k, v))
    o, lse = flash_fwd_op(q, k, v, q_segment_ids, kv_segment_ids, meta, causal,
                          1.0 / math.sqrt(d))
    o = o[..., :d]
    return (o, lse) if return_lse else o


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., D rounded up to 128], zeros in the new columns (a
    zero column adds nothing to q.k and gives o a zero column)."""
    d = x.shape[-1]
    return torch.nn.functional.pad(x, (0, _round_up(d, 128) - d))


flash_attention.launches = 0  # CUDA kernel launches (the wrapper counts them)


@torch.library.custom_op("lvt::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    qseg: Optional[torch.Tensor], kseg: Optional[torch.Tensor],
    meta: torch.Tensor, causal: bool, scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The flash forward as an op of its own: -> (o, lse). ``meta`` holds
    (q_offset, kv_offset, kv_valid_len) as int32 on q's device, which K1
    reads there (no host sync); ``scale`` the logits' scale when the head
    dim is padded (1/sqrt(D) when None). CUDA tensors launch K1, CPU tensors
    take the plain version. Its autograd (below) saves (o, lse) and runs K4
    or K5, ``_flash_core``'s custom_vjp."""
    if on_cuda(q, k, v, qseg, kseg):
        return _flash_cuda(q, k, v, causal, None, None, None, qseg, kseg, meta=meta,
                           scale=scale)
    q_offset, kv_offset, kv_len = (int(x) for x in meta)
    return flash_attention_reference(
        q, k, v, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
        q_segment_ids=qseg, kv_segment_ids=kseg, kv_valid_len=kv_len, scale=scale,
    )


@flash_fwd_op.register_fake
def _(q, k, v, qseg, kseg, meta, causal, scale=None):
    b, sq, hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, hq, sq), dtype=torch.float32)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, qseg, kseg, meta, causal, scale = inputs
    ctx.causal, ctx.scale = causal, scale
    ctx.save_for_backward(q, k, v, *output, qseg, kseg, meta)
    ctx.mark_non_differentiable(output[1])


def _flash_fwd_backward(ctx, do, _dlse):
    q, k, v, o, lse, qseg, kseg, meta = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(
        q, k, v, o, lse, do, causal=ctx.causal, q_offset=meta[0], kv_offset=meta[1],
        kv_valid_len=meta[2], q_segment_ids=qseg, kv_segment_ids=kseg, scale=ctx.scale,
    )
    return dq, dk, dv, None, None, None, None, None


flash_fwd_op.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup)


def _check_operand(name: str, x: torch.Tensor, d: int) -> None:
    if x.dim() != 4 or x.shape[3] != d:
        raise ValueError(f"{name}: expected [B, S, H, {d}], got {tuple(x.shape)}")
    if x.stride(3) != 1 or x.stride(2) != d:
        raise ValueError(
            f"{name}: the [H, D] dims must be packed (strides {x.stride()})"
        )
    vec = 16 // x.element_size()
    if x.dtype != torch.float32 and (
        x.data_ptr() % 16 or x.stride(0) % vec or x.stride(1) % vec
    ):
        raise ValueError(f"{name}: rows must be 16-byte aligned for the kernel")


# The Hopper forward (K1's bf16 body and K3, csrc/flash_fwd_sm90.cuh) takes
# a block of 128 query rows (192 at D = 64) and kv tiles of 128 rows on a
# grid of (Hq, B, q tiles), or (q tiles, Hq, B) without a causal mask, and
# reads q, k, v through TMA tensor maps: int32 coordinates and at most 65535
# batch rows, heads and q tiles.
SM90_BLOCK_KV = 128
_GRID_YZ_MAX = 65535


def sm90_block_q(d: int) -> int:
    """Query rows a block of the Hopper forward at head dim d."""
    return 192 if d == 64 else 128


def _tile_ranges(seg: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, S] int32 segment ids -> [B, ceil(S / rows), 2], the (min, max) id
    of each tile of ``rows`` (the last one padded with its last id): the
    Hopper forward skips the kv tiles whose range misses a q block's."""
    b, s = seg.shape
    if s % rows:
        seg = torch.cat([seg, seg[:, -1:].expand(b, rows - s % rows)], 1)
    tiles = seg.reshape(b, -1, rows)
    return torch.stack([tiles.amin(-1), tiles.amax(-1)], -1)


def _check_sm90(b: int, sq: int, skv: int, hq: int, d: int, block_q: Optional[int] = None) -> None:
    block_q = block_q or sm90_block_q(d)
    if max(b, hq, -(-sq // block_q)) > _GRID_YZ_MAX:
        raise ValueError(
            f"at most {_GRID_YZ_MAX} batch rows, heads and tiles of "
            f"{block_q} query rows a launch, got B={b}, Hq={hq}, Sq={sq}"
        )
    if max(sq, skv) >= 2**31:
        raise ValueError(f"sequences must be shorter than 2^31 rows, got {sq}/{skv}")


def _flash_cuda(q, k, v, causal, q_offset, kv_offset, kv_len, qseg, kseg, meta=None,
                scale=None):
    o, lse, args = flash_fwd_args(q, k, v, causal, q_offset, kv_offset, kv_len, qseg, kseg,
                                  meta=meta, scale=scale)
    _build.launch("lvt_flash_fwd", q.device, *args)
    _build.count(flash_attention)
    return o, lse


def flash_fwd_args(q, k, v, causal, q_offset, kv_offset, kv_len, qseg, kseg, meta=None,
                   scale=None):
    """Check q/k/v for K1 and prepare its launch: -> (o, lse, the arguments
    of lvt_flash_fwd before the stream). ``meta``: the three mask scalars
    already on the device, in place of q_offset, kv_offset and kv_len;
    ``scale``: the logits' scale (1/sqrt(D) when None)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head dim 64 or 128 (a ragged one padded to a "
                         f"multiple of 128 by flash_attention), got {d}")
    if k.shape != v.shape or k.shape[0] != b or hq % hkv:
        raise ValueError(
            f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, d)
    if q.dtype == torch.bfloat16:
        _check_sm90(b, sq, skv, hq, d)
    kseg_sb, seg_ranges = 0, None
    if qseg is not None:
        if qseg.shape != (b, sq) or kseg.shape != (b, skv):
            raise ValueError("segment ids must be [B, Sq] and [B, Skv]")
        qseg = qseg.to(torch.int32).contiguous()
        kseg = kseg.to(torch.int32)
        if sq and skv:
            seg_ranges = torch.cat(
                [_tile_ranges(qseg, sm90_block_q(d)), _tile_ranges(kseg, SM90_BLOCK_KV)], 1
            ).contiguous()
        # rows of a multiple of 4 ids: TMA strides are multiples of 16 bytes
        kseg_sb = _round_up(skv, 4)
        kseg = torch.nn.functional.pad(kseg, (0, kseg_sb - skv)).contiguous()

    dev = q.device
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    if meta is None:
        meta = _device_meta(dev, q_offset, kv_offset, kv_len)
    return o, lse, (
        q, k, v, o, lse, qseg, kseg, seg_ranges, meta,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        sq if qseg is not None else 0, kseg_sb,
        b, sq, skv, hq, hkv, d, int(causal), 1.0 / math.sqrt(d) if scale is None else scale,
        _DTYPE_CODE[q.dtype],
    )


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: IntLike = 0,
    kv_offset: IntLike = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[IntLike] = None,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: -> (o [B,Sq,Hq,D], lse [B,Hq,Sq]).

    f32 logits (scaled by ``scale``, 1/sqrt(D) when None) and softmax
    statistics, p cast to v's dtype before P.V, GQA grouped (K/V never
    repeated). Keys past kv_valid_len are sliced off rather than masked;
    masked keys get p = 0, so an empty row gives o = 0 and lse = -2^30."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kv_len = skv if kv_valid_len is None else min(max(int(kv_valid_len), 0), skv)
    k, v = k[:, :kv_len], v[:, :kv_len]
    dev = q.device

    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (
        1.0 / math.sqrt(d) if scale is None else scale)
    mask = torch.ones((1, sq, kv_len), dtype=torch.bool, device=dev)
    if causal:
        qpos = int(q_offset) + torch.arange(sq, device=dev)
        kpos = int(kv_offset) + torch.arange(kv_len, device=dev)
        mask = mask & (kpos[None, :] <= qpos[:, None])[None]
    if q_segment_ids is not None:
        mask = mask & (
            q_segment_ids[:, :, None] == kv_segment_ids[:, None, :kv_len]
        )
    mask = mask[:, None, None]  # [B|1, 1, 1, Sq, Skv]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True) if kv_len else torch.full(
        s.shape[:-1] + (1,), NEG_INF, device=dev
    )
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)  # [B, Hkv, G, Sq, 1]
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l == 0, 1.0, l).permute(0, 3, 1, 2, 4)
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l))[..., 0]
    return o.reshape(b, sq, hq, d).to(q.dtype), lse.reshape(b, hq, sq)


# ---------------------------------------------------------------------------
# K4 / K5: the flash backward
# ---------------------------------------------------------------------------

# The JAX package's backward blocks and its rule between the one-pass and the
# two-pass kernels (long_vita_tpu/ops/flash_attention.py:52-73, 887-911). They
# choose the kernel here; the CUDA kernels' own tiles are fixed.
DEFAULT_BLOCK_Q = DEFAULT_BLOCK_KV = 1024
BWD_BLOCK_Q_CAP, BWD_BLOCK_KV_CAP = 1024, 512
BWD_BLOCK_KV_MAJOR = 4096
FUSED_BWD_DQ_BYTES_CAP = 2 * 1024**3


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def bwd_uses_fused(
    b: int, sq: int, skv: int, hq: int, d: int, itemsize: int, *, short: bool = False
) -> bool:
    """The JAX package's choice of the one-pass backward (K4, True) over the
    two-pass one (K5, False) for q [b, sq, hq, d] against skv keys.

    JAX decides on the padded head-major shapes its backward sees: the
    forward's blocks (1024, or 576 for a ragged sequence of at most 2048) pad
    the sequences and a head dim that is not a multiple of 64 pads to 128
    (``flash_attention`` :1515-1526, ``_prepare`` :1165); short_attention's
    backward pads its sequence to 128 and D to 128 (:1252-1253); the backward
    caps the blocks at 1024 x 512 and pads again (:879-901). It takes the
    one-pass kernel while its dq partials, one q-sized array per 4096-key
    major block, fit FUSED_BWD_DQ_BYTES_CAP (:906-911)."""
    if short:
        sq_pad = skv_pad = _round_up(sq, 128)
        d_pad = _round_up(d, 128)
        block_q, block_kv = DEFAULT_BLOCK_Q, DEFAULT_BLOCK_KV
    else:
        block_q, block_kv = DEFAULT_BLOCK_Q, DEFAULT_BLOCK_KV
        if sq <= 2048 and _round_up(sq, 128) % block_q:
            block_q = min(block_q, 576)
        if skv <= 2048 and _round_up(skv, 128) % block_kv:
            block_kv = min(block_kv, 576)
        block_q = min(block_q, _round_up(sq, 128))
        block_kv = min(block_kv, _round_up(skv, 128))
        sq_pad, skv_pad = _round_up(sq, block_q), _round_up(skv, block_kv)
        d_pad = d if d % 64 == 0 else _round_up(d, 128)
    sq_pad = _round_up(sq_pad, min(block_q, BWD_BLOCK_Q_CAP))
    skv_pad = _round_up(skv_pad, min(block_kv, BWD_BLOCK_KV_CAP))
    n_kv_major = max(1, skv_pad // BWD_BLOCK_KV_MAJOR)
    return n_kv_major * b * hq * sq_pad * d_pad * itemsize <= FUSED_BWD_DQ_BYTES_CAP


# The Hopper backward (K4's and K5's bf16 bodies, csrc/flash_bwd_sm90.cuh):
# kv-major blocks (K5's dkv pass, and K4) of SM90_BWD_BLOCK_KV kv rows, two
# warpgroups of 64, walking q tiles of SM90_BWD_TILE_Q rows; q-major blocks
# (K5's dq pass) of SM90_BWD_BLOCK_Q q rows, two warpgroups of 64, walking kv
# tiles of SM90_BWD_BLOCK_KV rows. Grids (Hkv, B, kv tiles) and (Hq, B, q
# blocks) under a causal mask, else (tiles, heads, B): at most 65535 batch
# rows, heads and tiles; TMA coordinates are int32.
SM90_BWD_TILE_Q = 64
SM90_BWD_BLOCK_Q = 128
SM90_BWD_BLOCK_KV = 128
_WG_ROWS = 64


def _check_bwd_sm90(b: int, sq: int, skv: int, hq: int, hkv: int) -> None:
    n_kt, n_qb = -(-skv // SM90_BWD_BLOCK_KV), -(-sq // SM90_BWD_BLOCK_Q)
    if max(b, hq, hkv, n_kt, n_qb) > _GRID_YZ_MAX:
        raise ValueError(
            f"at most {_GRID_YZ_MAX} batch rows, heads and tiles of "
            f"{SM90_BWD_BLOCK_KV} rows a launch, got B={b}, Hq={hq}, Hkv={hkv}, "
            f"Sq={sq}, Skv={skv}"
        )
    if max(sq, skv) >= 2**31:
        raise ValueError(f"sequences must be shorter than 2^31 rows, got {sq}/{skv}")


def bwd_seg_ranges(qseg: torch.Tensor, kseg: torch.Tensor) -> torch.Tensor:
    """[B, Sq] and [B, Skv] int32 ids -> [B, n_qt + n_qb + n_kt, 2] int32:
    the (min, max) id of each SM90_BWD_TILE_Q-row q tile, each
    SM90_BWD_BLOCK_Q-row q block, then each SM90_BWD_BLOCK_KV-row kv tile
    (a last, partial tile padded with its last id)."""
    return torch.cat([
        _tile_ranges(qseg, SM90_BWD_TILE_Q), _tile_ranges(qseg, SM90_BWD_BLOCK_Q),
        _tile_ranges(kseg, SM90_BWD_BLOCK_KV),
    ], 1).to(torch.int32).contiguous()


def bwd_tile_order(seg_ranges: torch.Tensor, sq: int, meta: torch.Tensor) -> torch.Tensor:
    """The kv tiles of each batch row, heaviest first: [B, n_kt] int32, a
    permutation by the number of q tiles each kv-major block visits under a
    causal mask (bwd_dkv_plan's count). Tensor ops on the ranges' device,
    the offsets and kv_valid_len read from the kernels' int32 ``meta``
    ([q_offset, kv_offset, kv_valid_len]), so no host sync. Packed rows make
    blocks of very unequal work, and a grid that starts the heaviest ones
    first leaves no long block to the end of the launch."""
    dev = seg_ranges.device
    n_qt, n_qb = -(-sq // SM90_BWD_TILE_Q), -(-sq // SM90_BWD_BLOCK_Q)
    qr = seg_ranges[:, None, :n_qt]              # [B, 1, n_qt, 2]
    kr = seg_ranges[:, n_qt + n_qb:, None]       # [B, n_kt, 1, 2]
    meets = (qr[..., 0] <= kr[..., 1]) & (qr[..., 1] >= kr[..., 0])
    meta = meta.long()
    k0 = torch.arange(kr.shape[1], device=dev)[:, None] * SM90_BWD_BLOCK_KV
    first = meta[1] + k0 - meta[0]
    qt = torch.arange(n_qt, device=dev)[None]
    seen = (qt >= torch.div(first, SM90_BWD_TILE_Q, rounding_mode="floor")) & (k0 < meta[2])
    work = (meets & seen).sum(-1)
    return torch.argsort(work, dim=1, descending=True, stable=True).to(torch.int32).contiguous()


def _meets(r, lo: int, hi: int) -> bool:
    return r[0] <= hi and r[1] >= lo


def _one_segment(r, s) -> bool:
    return r[0] == r[1] == s[0] == s[1]


def bwd_dkv_plan(kt: int, *, sq: int, kv_len: int, causal: bool, q_offset: int = 0,
                 kv_offset: int = 0, q_ranges=None, kv_range=None) -> list:
    """The q tiles the kv-major block of kv tile ``kt`` visits (for each q
    head of its GQA group), as the kernel walks them: from the tile of the
    first q row that sees the kv tile's first key (causal), none if the kv
    tile lies wholly past kv_len, and with segments only the q tiles whose
    (min, max) id range (``q_ranges[qt]``) meets the kv tile's
    (``kv_range``). -> [(qt, (interior of warpgroup 0, of warpgroup 1))]: a
    warpgroup's 64 kv rows skip the mask on an interior pair, one whose
    every key is below kv_len and the causal frontier and inside the one
    segment of both tiles (rows past Sq have p = 0 without a mask)."""
    k0 = kt * SM90_BWD_BLOCK_KV
    n_qt = -(-sq // SM90_BWD_TILE_Q) if k0 < kv_len else 0
    begin = 0
    if causal:
        first = kv_offset + k0 - q_offset
        begin = 0 if first <= 0 else min(first // SM90_BWD_TILE_Q, n_qt)
    out = []
    for qt in range(begin, n_qt):
        if q_ranges is not None and not _meets(q_ranges[qt], *kv_range):
            continue
        inner = []
        for wg in range(2):
            r0 = k0 + wg * _WG_ROWS
            ok = r0 + _WG_ROWS <= kv_len
            if causal:
                ok = ok and kv_offset + r0 + _WG_ROWS - 1 <= q_offset + qt * SM90_BWD_TILE_Q
            if q_ranges is not None:
                ok = ok and _one_segment(q_ranges[qt], kv_range)
            inner.append(ok)
        out.append((qt, tuple(inner)))
    return out


def bwd_dq_plan(qb: int, *, sq: int, kv_len: int, causal: bool, q_offset: int = 0,
                kv_offset: int = 0, q_range=None, kv_ranges=None) -> list:
    """The kv tiles the q-major block ``qb`` of the dq pass visits, as the
    kernel walks them: below kv_len and (causal) up to the tile of the last
    key its last row sees; with segments only the kv tiles whose id range
    (``kv_ranges[j]``) meets the block's (``q_range``). -> [(j, (interior of
    warpgroup 0, of warpgroup 1))], interior as in bwd_dkv_plan."""
    q0 = qb * SM90_BWD_BLOCK_Q
    n = -(-kv_len // SM90_BWD_BLOCK_KV)
    if causal:
        diag = q_offset + min(q0 + SM90_BWD_BLOCK_Q, sq) - 1 - kv_offset
        n = 0 if diag < 0 else min(n, diag // SM90_BWD_BLOCK_KV + 1)
    out = []
    for j in range(n):
        if kv_ranges is not None and not _meets(kv_ranges[j], *q_range):
            continue
        k0 = j * SM90_BWD_BLOCK_KV
        inner = []
        for wg in range(2):
            ok = k0 + SM90_BWD_BLOCK_KV <= kv_len
            if causal:
                ok = ok and (kv_offset + k0 + SM90_BWD_BLOCK_KV - 1
                             <= q_offset + q0 + wg * _WG_ROWS)
            if kv_ranges is not None:
                ok = ok and _one_segment(kv_ranges[j], q_range)
            inner.append(ok)
        out.append((j, tuple(inner)))
    return out


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: IntLike = 0,
    kv_offset: IntLike = 0,
    kv_valid_len: Optional[IntLike] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    short: bool = False,
    delta: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of flash attention from the forward's (o, lse)
    and the output gradient do (``scale``: the forward's, 1/sqrt(D) when
    None; flash_attention passes the true head dim's at a padded one). On CUDA: K4 or K5, as the JAX package
    chooses (bwd_uses_fused; short: the rule of short_attention's backward).
    On the CPU: the plain backward.

    delta: rowsum(do * o) f32 [B, Hq, Sq] given instead of being computed
    from o (o may then be None), with lse the softmax statistics of a wider
    attention than this call's keys: the ring's pair backward (the JAX
    ``_bwd_pair_pallas``, :1105), whose global lse and delta make (dq, dk,
    dv) this key chunk's exact share of the gradient."""
    if kv_valid_len is None:
        kv_valid_len = k.shape[1]
    if on_cuda(q, k, v, o, lse, do, q_segment_ids, kv_segment_ids, delta):
        b, sq, hq, d = q.shape
        fused = bwd_uses_fused(b, sq, k.shape[1], hq, d, q.element_size(), short=short)
        return _flash_bwd_cuda(
            q, k, v, o, lse, do, causal, q_offset, kv_offset, kv_valid_len,
            q_segment_ids, kv_segment_ids, fused, delta=delta, scale=scale,
        )
    return flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=causal, q_offset=q_offset,
        kv_offset=kv_offset, kv_valid_len=kv_valid_len,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids, delta=delta, scale=scale,
    )


def _bwd_launch(entry: str, a: dict) -> None:
    """One backward entry point; ``a`` holds the operands _flash_bwd_cuda
    prepared (every entry takes the same argument list)."""
    _build.launch(entry, a["q"].device, *bwd_launch_args(a))


def bwd_launch_args(a: dict) -> tuple:
    """The arguments of lvt_flash_bwd, _dkv and _dq before the stream, from
    the operands ``bwd_operands`` prepared."""
    q, k, v, do = a["q"], a["k"], a["v"], a["do"]
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    return (
        q, k, v, do, a["lse"], a["delta"], a["dq"], a["dk"], a["dv"], a["qseg"],
        a["kseg"], a["seg_ranges"], a["tile_order"], a["meta"],
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), do.stride(0), do.stride(1),
        sq if a["qseg"] is not None else 0,
        a["kseg"].shape[1] if a["kseg"] is not None else 0,
        b, sq, skv, hq, hkv, d, int(a["causal"]),
        1.0 / math.sqrt(d) if a.get("scale") is None else a["scale"], _DTYPE_CODE[q.dtype],
    )


def flash_bwd_fused(a: dict) -> None:
    """K4: dk, dv and the f32 dq sums of the prepared operands ``a``."""
    _bwd_launch("lvt_flash_bwd", a)
    _build.count(flash_bwd_fused)


def flash_bwd_dkv(a: dict) -> None:
    """K5, first pass: dk and dv of the prepared operands ``a``."""
    _bwd_launch("lvt_flash_bwd_dkv", a)
    _build.count(flash_bwd_dkv)


def flash_bwd_dq(a: dict) -> None:
    """K5, second pass: dq of the prepared operands ``a``."""
    _bwd_launch("lvt_flash_bwd_dq", a)
    _build.count(flash_bwd_dq)


flash_bwd_fused.launches = flash_bwd_dkv.launches = flash_bwd_dq.launches = 0


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, q_offset, kv_offset, kv_len,
                    qseg, kseg, fused, delta=None, scale=None):
    """K4 (fused) or K5 on CUDA tensors. -> (dq, dk, dv) in q's dtype."""
    a = bwd_operands(q, k, v, o, lse, do, causal, q_offset, kv_offset, kv_len,
                     qseg, kseg, fused, delta=delta)
    a["scale"] = scale
    if fused:
        flash_bwd_fused(a)
        return a["dq"].to(q.dtype), a["dk"], a["dv"]
    flash_bwd_dkv(a)
    flash_bwd_dq(a)
    return a["dq"], a["dk"], a["dv"]


def bwd_operands(q, k, v, o, lse, do, causal, q_offset, kv_offset, kv_len,
                 qseg, kseg, fused, delta=None) -> dict:
    """Check and prepare what the backward entry points take: delta =
    rowsum(do * o) in f32 [B, Hq, Sq] (the JAX _flash_core_bwd :874), or the
    ``delta`` given (a ring pair's global one; o is then not read), the
    mask scalars on the device, with segments the tiles' id ranges
    (bwd_seg_ranges), the kv-major grid's order (bwd_tile_order, causal) and
    the kv ids padded to rows of a multiple of 4 (their TMA map), and the
    outputs (dq an f32 buffer of zeros for K4, the input
    dtype for K5). bf16 operands are held to what the tensor maps and grids
    of the Hopper backward take (_check_bwd_sm90)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash backward kernels take bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in (64, 128):
        raise ValueError(f"flash backward kernels take head dim 64 or 128 (a ragged one "
                         f"padded to a multiple of 128 by flash_attention), got {d}")
    if k.shape != v.shape or k.shape[0] != b or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if ((o is not None and o.shape != q.shape) or do.shape != q.shape
            or lse.shape != (b, hq, sq) or (delta is not None and delta.shape != (b, hq, sq))):
        raise ValueError(
            f"o/do must be {tuple(q.shape)} and lse/delta {(b, hq, sq)}, got "
            f"{None if o is None else tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}, "
            f"{None if delta is None else tuple(delta.shape)}"
        )
    do = do.to(q.dtype)
    if do.stride(3) != 1 or do.stride(2) != d:
        do = do.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_operand(name, x, d)
    if q.dtype == torch.bfloat16:
        _check_bwd_sm90(b, sq, skv, hq, hkv)
    dev = q.device
    meta = _device_meta(dev, q_offset, kv_offset, kv_len)
    seg_ranges = tile_order = None
    if qseg is not None:
        if qseg.shape != (b, sq) or kseg.shape != (b, skv):
            raise ValueError("segment ids must be [B, Sq] and [B, Skv]")
        qseg = qseg.to(torch.int32).contiguous()
        kseg = kseg.to(torch.int32)
        if sq and skv:
            seg_ranges = bwd_seg_ranges(qseg, kseg)
            if causal:
                tile_order = bwd_tile_order(seg_ranges, sq, meta)
        # rows of a multiple of 4 ids: TMA strides are multiples of 16 bytes
        kseg = torch.nn.functional.pad(kseg, (0, _round_up(skv, 4) - skv)).contiguous()

    if delta is None:
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    return dict(
        q=q, k=k, v=v, do=do, lse=lse.float().contiguous(),
        delta=delta.float().contiguous(),
        qseg=qseg, kseg=kseg, seg_ranges=seg_ranges, tile_order=tile_order,
        meta=meta, causal=causal,
        dq=(torch.zeros((b, sq, hq, d), dtype=torch.float32, device=dev) if fused
            else torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev)),
        dk=torch.empty((b, skv, hkv, d), dtype=q.dtype, device=dev),
        dv=torch.empty((b, skv, hkv, d), dtype=q.dtype, device=dev),
    )


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: IntLike = 0,
    kv_offset: IntLike = 0,
    kv_valid_len: Optional[IntLike] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4/K5 (``scale``: the forward's, 1/sqrt(D)
    when None), the FA-2 backward as the Pallas kernels compute it
    (:454-693): delta = rowsum(do * o) in f32 (or the
    ``delta`` [B, Hq, Sq] given, as flash_attention_bwd takes it); p =
    exp(s * scale - lse) where unmasked, else 0 (the forward's masks); dv =
    p^T.do with p cast to do's dtype; ds = p * (do.v^T - delta) * scale; dk =
    ds^T.q and dq = ds.k with ds cast to the input dtype; f32 products, GQA
    grads summed per kv head. -> (dq, dk, dv) in the input dtype; dk and dv
    are 0 past kv_valid_len."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kv_len = skv if kv_valid_len is None else min(max(int(kv_valid_len), 0), skv)
    dev = q.device
    scale = 1.0 / math.sqrt(d) if scale is None else scale

    qg = q.reshape(b, sq, hkv, g, d).float()
    dog = do.reshape(b, sq, hkv, g, d)
    kf, vf = k[:, :kv_len].float(), v[:, :kv_len].float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    mask = torch.ones((1, sq, kv_len), dtype=torch.bool, device=dev)
    if causal:
        qpos = int(q_offset) + torch.arange(sq, device=dev)
        kpos = int(kv_offset) + torch.arange(kv_len, device=dev)
        mask = mask & (kpos[None, :] <= qpos[:, None])[None]
    if q_segment_ids is not None:
        mask = mask & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :kv_len])
    mask = mask[:, None, None]  # [B|1, 1, 1, Sq, Skv]
    lse5 = lse.float().reshape(b, hkv, g, sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse5), 0.0)
    if delta is None:
        delta = (do.float() * o.float()).sum(-1).reshape(b, sq, hkv, g).permute(0, 2, 3, 1)
    else:
        delta = delta.float().reshape(b, hkv, g, sq)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dog.float())
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog.float(), vf)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(), qg)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), kf)

    def full(x):  # [B, kv_len, Hkv, D] -> [B, Skv, Hkv, D], zero past kv_len
        return torch.cat([x, x.new_zeros((b, skv - kv_len, hkv, d))], 1) if kv_len < skv else x

    return (dq.reshape(b, sq, hq, d).to(q.dtype), full(dk).to(k.dtype),
            full(dv).to(v.dtype))


def flash_attention_bwd_reference_by_group(q, k, v, o, lse, do, *, causal: bool = True):
    """flash_attention_bwd_reference one kv head's GQA group at a time (no
    offsets, no segments): the f32 logits of a group's q heads alone, which
    fit on the card at a 16K row where all heads' would not. -> (dq, dk,
    dv) as flash_attention_bwd_reference."""
    hkv = k.shape[2]
    g = q.shape[2] // hkv
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for h in range(hkv):
        hq, hk = slice(h * g, (h + 1) * g), slice(h, h + 1)
        dq[:, :, hq], dk[:, :, hk], dv[:, :, hk] = flash_attention_bwd_reference(
            q[:, :, hq], k[:, :, hk], v[:, :, hk], o[:, :, hq], lse[:, hq], do[:, :, hq],
            causal=causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# K2: causal flash forward against an int8 KV cache
# ---------------------------------------------------------------------------


def flash_attention_quant(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    q_offset: IntLike = 0,
    kv_offset: IntLike = 0,
    kv_valid_len: Optional[IntLike] = None,
    return_lse: bool = False,
):
    """Causal attention of q [B, Sq, Hq, D] against int8 codes k_q, v_q
    [B, Skv, Hkv, D] with f32 scales [B, Skv, Hkv, 1] (chunked prefill into
    an int8 cache; forward only, no segments). -> o [B, Sq, Hq, D] in q's
    dtype (and lse [B, Hq, Sq] f32 when return_lse)."""
    if kv_valid_len is None:
        kv_valid_len = k_q.shape[1]
    elif torch.is_tensor(kv_valid_len) and kv_valid_len.ndim:
        kv_valid_len = kv_valid_len.reshape(-1)[0]
    if on_cuda(q, k_q, k_scale, v_q, v_scale):
        o, lse = _flash_quant_cuda(
            q, k_q, k_scale, v_q, v_scale, q_offset, kv_offset, kv_valid_len
        )
    else:
        o, lse = flash_attention_quant_reference(
            q, k_q, k_scale, v_q, v_scale, q_offset=q_offset,
            kv_offset=kv_offset, kv_valid_len=kv_valid_len,
        )
    return (o, lse) if return_lse else o


flash_attention_quant.launches = 0  # CUDA kernel launches


# K2 is the int8 instance of the Hopper forward: blocks of 128 query rows at
# both head dims, kv tiles of 128 rows, the causal grid (Hq, B, q tiles); its
# tensor maps read the int8 K/V through their strides in boxes of D bytes x
# 128 rows and its producer loads the scales through theirs.
SM90_QUANT_BLOCK_Q = 128


def _flash_quant_cuda(q, k, ks, v, vs, q_offset, kv_offset, kv_len):
    o, lse, args = flash_quant_args(q, k, ks, v, vs, q_offset, kv_offset, kv_len)
    _build.launch("lvt_flash_fwd_quant", q.device, *args)
    _build.count(flash_attention_quant)
    return o, lse


def flash_quant_args(q, k, ks, v, vs, q_offset, kv_offset, kv_len):
    """Check q, the int8 cache and its scales for K2 and prepare its launch:
    -> (o, lse, the arguments of lvt_flash_fwd_quant before the stream). The
    cache and the scales are passed with their own strides, never copied;
    the codes' rows must be 16-byte aligned (the tensor maps' strides)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(
            f"int8 flash kernel takes bf16 q and int8 k/v, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {ks.dtype}/{vs.dtype}")
    if d not in (64, 128):
        raise ValueError(f"int8 flash kernel takes head dim 64 or 128, got {d}")
    if k.shape != v.shape or k.shape[0] != b or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if ks.shape != (b, skv, hkv, 1) or vs.shape != ks.shape:
        raise ValueError(
            f"scales must be [B, Skv, Hkv, 1] = {(b, skv, hkv, 1)}, got "
            f"{tuple(ks.shape)} and {tuple(vs.shape)}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, d)
    _check_sm90(b, sq, skv, hq, d, SM90_QUANT_BLOCK_Q)

    dev = q.device
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    meta = _device_meta(dev, q_offset, kv_offset, kv_len)
    return o, lse, (
        q, k, v, ks, vs, o, lse, meta,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        ks.stride(0), ks.stride(1), ks.stride(2),
        vs.stride(0), vs.stride(1), vs.stride(2),
        b, sq, skv, hq, hkv, d, 1.0 / math.sqrt(d),
    )


def flash_attention_quant_reference(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    q_offset: IntLike = 0,
    kv_offset: IntLike = 0,
    kv_valid_len: Optional[IntLike] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, in the kernel's order of operations:
    codes cast to q's dtype, s = (q.k * 1/sqrt(D)) * k_scale in f32, causal
    and kv_valid_len masks, l sums p, and p * v_scale is cast to q's dtype
    before the P.V product. -> (o [B,Sq,Hq,D], lse [B,Hq,Sq]); an empty row
    gives o = 0 and lse = -2^30. Keys past kv_valid_len are sliced off."""
    b, sq, hq, d = q.shape
    skv, hkv = k_q.shape[1], k_q.shape[2]
    g = hq // hkv
    kv_len = skv if kv_valid_len is None else min(max(int(kv_valid_len), 0), skv)
    dev = q.device

    def rows(scale):  # [B, S, Hkv, 1] -> [B, Hkv, 1, 1, S] f32
        return scale[:, :kv_len, :, 0].float().permute(0, 2, 1)[:, :, None, None, :]

    k = k_q[:, :kv_len].to(q.dtype).float()
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (1.0 / math.sqrt(d))
    s = s * rows(k_scale)
    qpos = int(q_offset) + torch.arange(sq, device=dev)
    kpos = int(kv_offset) + torch.arange(kv_len, device=dev)
    mask = kpos[None, :] <= qpos[:, None]  # [Sq, Skv]
    s.masked_fill_(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True) if kv_len else torch.full(
        s.shape[:-1] + (1,), NEG_INF, device=dev
    )
    p = s.sub_(m).exp_().masked_fill_(~mask, 0.0)  # s is not used again
    l = p.sum(-1, keepdim=True)  # [B, Hkv, G, Sq, 1]
    pv = p.mul_(rows(v_scale)).to(q.dtype).float()
    o = torch.einsum("bhgqk,bkhd->bqhgd", pv, v_q[:, :kv_len].to(q.dtype).float())
    o = o / torch.where(l == 0, 1.0, l).permute(0, 3, 1, 2, 4)
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l))[..., 0]
    return o.reshape(b, sq, hq, d).to(q.dtype), lse.reshape(b, hq, sq)


# ---------------------------------------------------------------------------
# K3: non-causal attention over short sequences (the ViT), forward only
# ---------------------------------------------------------------------------


def short_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    return_lse: bool = False,
):
    """Non-causal attention over a whole short sequence (the ViT's 1025
    tokens), no masks: q [B, S, Hq, D], k/v [B, S, Hkv, D] -> o (and lse
    [B, Hq, S] f32 when return_lse). Differentiable in q, k, v: the backward
    feeds K3's own (o, lse) to K4/K5 with causal off, as the JAX
    ``_short_attention_bwd`` (:1246-1279) does."""
    o, lse = _ShortAttention.apply(q, k, v)
    return (o, lse) if return_lse else o


short_attention.launches = 0  # CUDA kernel launches


class _ShortAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _short_cuda(q, k, v) if on_cuda(q, k, v) else short_attention_reference(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do, causal=False, short=True)


def _short_cuda(q, k, v):
    o, lse, args = short_attn_args(q, k, v)
    _build.launch("lvt_short_attn", q.device, *args)
    _build.count(short_attention)
    return o, lse


def short_attn_args(q, k, v):
    """Check q/k/v for K3 and prepare its launch: -> (o, lse, the arguments
    of lvt_short_attn before the stream)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"short attention kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d != 64:
        raise ValueError(f"short attention kernel takes head dim 64, got {d}")
    if k.shape != v.shape or k.shape[:2] != (b, s) or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, d)
    _check_sm90(b, s, s, hq, d)
    dev = q.device
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    return o, lse, (
        q, k, v, o, lse,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        b, s, hq, hkv, 1.0 / math.sqrt(d),
    )


def short_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 (the Pallas `_short_nc_kernel`): f32
    logits, one softmax pass with p = exp(s - max) cast to v's dtype before
    P.V, the divide by max(l, 1e-30) after P.V, lse = m + log(max(l, 1e-30)).
    -> (o [B, S, Hq, D], lse [B, Hq, S]). GQA grouped, K/V never repeated."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d).float()
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    m = sc.amax(-1, keepdim=True)
    p = sc.sub_(m).exp_()  # sc is not used again
    l = p.sum(-1, keepdim=True).clamp_min_(1e-30)  # [B, Hkv, G, S, 1]
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l))[..., 0].reshape(b, hq, s)
    return o.reshape(b, s, hq, d).to(q.dtype), lse
