"""Flash attention forward: a hand-written CUDA kernel for Hopper.

Counterpart of long_vita_tpu/ops/flash_attention.py:flash_attention (:1488),
whose forward is the Pallas kernel `_fwd_kernel` (:144). The CUDA source is
``csrc/flash_fwd.cu``; it is built with nvcc at first use (ops/_build.py).

Public contract, as in the JAX package: model layout ``[B, S, H, D]``; the
q/kv position offsets are taken from element ``[0, 0]`` of the positions when
given; ``kv_valid_len`` is batch-uniform (element 0 of a ``[B]`` vector);
returns ``o`` or ``(o, lse)`` with lse f32 ``[B, Hq, Sq]``.

Dispatch is by device (ops/_target.py): a CUDA tensor launches the kernel or
raises; a CPU tensor takes ``flash_attention_reference``, the plain PyTorch
version of the kernel's semantics.

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

from long_vita_tpu_torch.ops._target import on_cuda

NEG_INF = -(2.0**30)

IntLike = Union[int, torch.Tensor]

_C_ARGTYPES = (
    [ctypes.c_void_p] * 8       # q k v o lse qseg kseg meta
    + [ctypes.c_longlong] * 10  # batch/seq strides of q k v o, segment batch strides
    + [ctypes.c_int] * 7        # batch sq skv hq hkv d causal
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale dtype stream
)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _lib():
    from long_vita_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    fn = lib.lvt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = _C_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _lib()


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
    (and lse [B, Hq, Sq] f32 when return_lse)."""
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
    if on_cuda(q, k, v, q_segment_ids, kv_segment_ids):
        o, lse = _flash_cuda(
            q, k, v, causal, q_offset, kv_offset, kv_valid_len,
            q_segment_ids, kv_segment_ids,
        )
    else:
        o, lse = flash_attention_reference(
            q, k, v, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            kv_valid_len=kv_valid_len,
        )
    return (o, lse) if return_lse else o


flash_attention.launches = 0  # CUDA kernel launches (the wrapper counts them)


def _check_operand(name: str, x: torch.Tensor, d: int) -> None:
    if x.dim() != 4 or x.shape[3] != d:
        raise ValueError(f"{name}: expected [B, S, H, {d}], got {tuple(x.shape)}")
    if x.stride(3) != 1 or x.stride(2) != d:
        raise ValueError(
            f"{name}: the [H, D] dims must be packed (strides {x.stride()})"
        )
    vec = 16 // x.element_size()
    if x.dtype == torch.bfloat16 and (
        x.data_ptr() % 16 or x.stride(0) % vec or x.stride(1) % vec
    ):
        raise ValueError(f"{name}: rows must be 16-byte aligned for the kernel")


def _flash_cuda(q, k, v, causal, q_offset, kv_offset, kv_len, qseg, kseg):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head dim 64 or 128, got {d}")
    if k.shape != v.shape or k.shape[0] != b or hq % hkv:
        raise ValueError(
            f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, d)
    if qseg is not None:
        if qseg.shape != (b, sq) or kseg.shape != (b, skv):
            raise ValueError("segment ids must be [B, Sq] and [B, Skv]")
        qseg = qseg.to(torch.int32).contiguous()
        kseg = kseg.to(torch.int32).contiguous()

    dev = q.device
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    # offsets and length stay on the device (no host sync); the kernel reads
    # them, as the Pallas kernel reads its scalar-prefetch operands
    meta = torch.empty(3, dtype=torch.int32, device=dev)
    meta[0] = q_offset
    meta[1] = kv_offset
    meta[2] = kv_len
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lvt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(),
            qseg.data_ptr() if qseg is not None else None,
            kseg.data_ptr() if kseg is not None else None,
            meta.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), o.stride(0), o.stride(1),
            sq if qseg is not None else 0, skv if kseg is not None else 0,
            b, sq, skv, hq, hkv, d, int(causal), 1.0 / math.sqrt(d),
            _DTYPE_CODE[q.dtype], stream,
        )
    if err:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return o, lse


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: -> (o [B,Sq,Hq,D], lse [B,Hq,Sq]).

    f32 logits and softmax statistics, p cast to v's dtype before P.V, GQA
    grouped (K/V never repeated). Keys past kv_valid_len are sliced off
    rather than masked; masked keys get p = 0, so an empty row gives o = 0
    and lse = -2^30."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kv_len = skv if kv_valid_len is None else min(max(int(kv_valid_len), 0), skv)
    k, v = k[:, :kv_len], v[:, :kv_len]
    dev = q.device

    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(d))
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
