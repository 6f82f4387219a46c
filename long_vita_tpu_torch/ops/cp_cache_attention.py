"""Context-parallel attention against a sequence-sharded KV cache.

Counterpart of long_vita_tpu/ops/cp_cache_attention.py: ``_local_partial``
(:24), ``_shard_update`` (:110), ``cp_cache_update_attend`` (:162),
``cp_cached_attention`` (:197). The cache shards over cp by SEQUENCE: rank
r holds global slots [r * C, (r + 1) * C). A query chunk attends the local
shard with exact global positions (q and kv offsets, kv_valid_len) and the
partials merge across ranks by an lse-weighted ``all_reduce_sum``. A shard
with no valid slot gives o = 0 and lse = -2^30, whose weight exp(lse -
max lse) is 0.

On CUDA a chunk of 128 rows or more (a multiple of 128) with batch-uniform
offsets runs K1 on a bf16 shard and K2 on an int8 shard with its scales;
decode rows and per-row ([B]) offsets take the plain partial, as the JAX
package takes its XLA fallback there.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from long_vita_tpu_torch.ops._target import on_cuda
from long_vita_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_quant,
)
from long_vita_tpu_torch.parallel.comm import Comm

IntLike = Union[int, torch.Tensor]


def _is_vector(x) -> bool:
    return torch.is_tensor(x) and x.ndim == 1


def local_partial(
    q: torch.Tensor,
    k_shard: torch.Tensor,
    v_shard: torch.Tensor,
    q_offset: IntLike,
    shard_start: int,
    valid_len: IntLike,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of q [B, Sq, Hq, D] against the local shard [B, C, Hkv, D]
    (int8 with scales [B, C, Hkv, 1] when given): key slot j sits at global
    position shard_start + j and is valid below valid_len; the causal mask
    compares global positions. q_offset / valid_len: scalars or [B]."""
    b, sq, hq, d = q.shape
    per_row = _is_vector(q_offset) or _is_vector(valid_len)
    if on_cuda(q, k_shard) and sq >= 128 and sq % 128 == 0 and not per_row:
        if k_scale is not None:
            return flash_attention_quant(
                q, k_shard, k_scale, v_shard, v_scale, q_offset=q_offset,
                kv_offset=shard_start, kv_valid_len=valid_len, return_lse=True,
            )
        with torch.no_grad():
            return flash_attention(
                q, k_shard, v_shard, causal=True, q_offset=q_offset, kv_offset=shard_start,
                kv_valid_len=valid_len, return_lse=True,
            )
    # the plain partial (JAX :64-106): positions-based masks, lse out, the
    # int8 scales folded into the products
    skv, hkv = k_shard.shape[1], k_shard.shape[2]
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d)
    bf = torch.bfloat16
    if k_scale is not None:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(bf).float(), k_shard.to(bf).float())
        ks = k_scale[..., 0].permute(0, 2, 1).float()[:, :, None, None, :]
        s = s * ks / math.sqrt(d)
    else:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_shard.float()) / math.sqrt(d)
    q_pos = torch.as_tensor(q_offset, device=dev).reshape(-1, 1) + torch.arange(sq, device=dev)
    vlen = torch.as_tensor(valid_len, device=dev).reshape(-1, 1)
    kv_idx = torch.arange(skv, device=dev)
    mask = ((shard_start + kv_idx)[None, None, :] <= q_pos[:, :, None]) & (
        kv_idx[None, None, :] < vlen[:, :, None])  # [B or 1, Sq, C]
    mask = mask.expand(b, sq, skv)[:, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    lse = torch.where(l == 0, NEG_INF, m + torch.log(torch.where(l == 0, 1.0, l)))
    p = torch.exp(s - lse[..., None])
    if v_scale is not None:
        vs = v_scale[..., 0].permute(0, 2, 1).float()[:, :, None, None, :]
        o = torch.einsum("bhgqk,bkhd->bqhgd", (p * vs).to(bf).float(), v_shard.to(bf).float())
    else:
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_shard.dtype).float(), v_shard.float())
    return o.reshape(b, sq, hq, d).to(q.dtype), lse.reshape(b, hq, sq)


def shard_update(buf: torch.Tensor, new_rows: torch.Tensor, cache_len: IntLike, rank: int) -> None:
    """Write new_rows [B, s, ...] (the chunk's rows, the same on every rank)
    at GLOBAL slot cache_len into this rank's shard buf [B, C, ...] of one
    layer, in place: only the rows whose slot lies in [rank * C, (rank + 1)
    * C) land here. cache_len: an int, or [B] (each row at its own
    frontier, ragged decode)."""
    c, s = buf.shape[1], new_rows.shape[1]
    if _is_vector(cache_len):
        b = new_rows.shape[0]
        off = cache_len.to(torch.long)[:, None] + torch.arange(s, device=buf.device)[None] - rank * c
        keep = (off >= 0) & (off < c)
        rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)
        buf[rows[keep], off[keep]] = new_rows[keep].to(buf.dtype)
        return
    lo, hi = max(cache_len, rank * c), min(cache_len + s, (rank + 1) * c)
    if lo < hi:
        buf[:, lo - rank * c: hi - rank * c] = new_rows[:, lo - cache_len: hi - cache_len].to(buf.dtype)


def cp_cache_update_attend(
    q, ck_shard, cv_shard, k_new, v_new, ks_shard, vs_shard, k_sc, v_sc,
    layer_idx: int, cache_len: IntLike, q_offset: IntLike, comm: Comm,
    q_sharded: bool = False,
) -> torch.Tensor:
    """Shard-local cache write + partial-merged attention (JAX :162).

    ck/cv_shard [L, B, C, Hkv, D] this rank's cache shards (written in
    place); k/v_new [B, s, Hkv, D] the chunk's kv rows, the same on every
    rank; with int8 shards their scales and the chunk's. Writes the rows at
    global slot cache_len of layer layer_idx, then attends q against the
    updated layer with cache_len + s valid slots. -> o."""
    s = k_new.shape[1]
    shard_update(ck_shard[layer_idx], k_new, cache_len, comm.rank)
    shard_update(cv_shard[layer_idx], v_new, cache_len, comm.rank)
    ks_l = vs_l = None
    if ks_shard is not None:
        shard_update(ks_shard[layer_idx], k_sc, cache_len, comm.rank)
        shard_update(vs_shard[layer_idx], v_sc, cache_len, comm.rank)
        ks_l, vs_l = ks_shard[layer_idx], vs_shard[layer_idx]
    return cp_cached_attention(
        q, ck_shard[layer_idx], cv_shard[layer_idx], q_offset, cache_len + s, comm,
        ks_l, vs_l, q_sharded=q_sharded,
    )


def cp_cached_attention(
    q: torch.Tensor,
    k_shard: torch.Tensor,
    v_shard: torch.Tensor,
    q_offset: IntLike,
    cache_len: IntLike,
    comm: Comm,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    q_sharded: bool = False,
) -> torch.Tensor:
    """Merge the ranks' partials (JAX :197). q [B, Sq, Hq, D] (this rank's
    contiguous 1/cp of the chunk when q_sharded), k/v_shard [B, C, Hkv, D];
    q_offset: the global position of the chunk's first row; cache_len: the
    global count of valid slots (scalars, or [B] for ragged decode).

    q_sharded (chunked prefill): the chunk's q is all-gathered here, every
    rank attends the whole chunk against its shard, and each keeps the rows
    it contributed, so the projections around this call run on 1/cp of the
    chunk. The merge: lse_max over ranks, w = exp(lse - lse_max), one
    all_reduce_sum of [o * w, w] and o = sum(o * w) / max(sum(w), 1e-30)."""
    r, c = comm.rank, k_shard.shape[1]
    shard_start = r * c
    if torch.is_tensor(cache_len):
        valid_len = (cache_len - shard_start).clamp(0, c)
    else:
        valid_len = min(max(cache_len - shard_start, 0), c)
    sq_local = q.shape[1]
    if q_sharded:
        q = comm.all_gather(q, 1)
    o, lse = local_partial(q, k_shard, v_shard, q_offset, shard_start, valid_len,
                           k_scale, v_scale)  # o [B, Sq, H, D], lse [B, H, Sq]
    lse_max = comm.all_gather(lse[None], 0).amax(0)
    w_q = torch.exp(lse - lse_max).transpose(1, 2)[..., None]  # [B, Sq, H, 1]
    merged = comm.all_reduce_sum(torch.cat([o.float() * w_q, w_q], -1))
    if q_sharded:
        merged = merged[:, r * sq_local: (r + 1) * sq_local]
    o_sum, w_sum = merged[..., :-1], merged[..., -1:]
    return (o_sum / w_sum.clamp_min(1e-30)).to(q.dtype)
