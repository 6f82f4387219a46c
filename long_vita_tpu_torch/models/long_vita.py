"""LongVITA VLM on one device: InternViT + pixel-shuffle projector + Qwen2.5.

Counterpart of long_vita_tpu/models/long_vita.py: tiles are encoded, the CLS
token stripped and the patches projected; the projected rows are scattered
into the token embeddings at ``image_indices`` ([2, N_tiles, T] of (batch,
seq) positions); the decoder then runs as plain Qwen2.

Training takes the same forward with the remat levels (the decoder's per
qwen2.remat_ops; the tower recomputes each layer at any level, and "vit"
with a trainable tower adds a chunk-level checkpoint around tower and
projector), freeze_vision (the tower and its CLS strip under
torch.no_grad, the projector differentiable) and return_aux (the MoE aux
loss summed over the decoder's layers, 0 for a dense decoder).

Under context parallelism (``parallel``, a qwen2.ParallelConfig with cp >
1) every rank runs this forward on its own shard: the frozen tower encodes
this rank's 1/cp of the tiles (K3 in serving) and the tower features are
all-gathered (JAX's tile-sharded encode, :113-150; a serving mesh shards the
tiles over its cp x tp ranks, ``encode_images``); the projected rows are
scattered into this rank's sequence shard in chunks of tiles
(merge_image_embeddings_chunked, :178); the decoder runs ring, Ulysses or
hybrid attention. A trainable tower encodes every tile on every rank (JAX
takes its plain attention there; the port keeps the kernels). On a tp
shard of the decoder (parallel/sharding.shard_params) the embedding and
the head are vocab-parallel (models/qwen2.py) and the tower is replicated.

Training over tp (``parallel`` with tp > 1, no cache) pins JAX's training
layout [B@dp, S@(cp, tp), H] for the whole forward (:268-310): the
vocab-parallel lookup lands in this rank's 1/tp slice of its cp shard
(qwen2.embed_tokens_vp), each projected image row is scattered into the
rank whose slice holds its position, and the decoder runs sequence
parallel. A cp shard that does not split over tp is cut as GSPMD pads it:
each slice has ceil(S_cp / tp) rows, the last ones ending in zero rows
that no tile row, attention or logit row reaches. A trainable tower
encodes every tile on every rank (JAX's XLA path, :323-330), a frozen one
its share of the cp x tp ranks' tiles.
``head=False`` returns the budget rows of this rank's cp shard, the same
rows on every tp rank (JAX's in_specs P(dp, cp, None) for the
vocab-parallel CE): each tp rank contributes the rows of its slice and the
rows are summed over tp (``reduce_from_tp``: exact, one real row and zeros;
the gradient passes through, the CE having summed it over tp).

Under 2-D tp (the tree bound to a tq communicator, JAX's [B@dp, S@(cp,
tp), H@tq], :280-290) the rows are also cut over the hidden dim: the
lookup on the 2-D table lands in the rank's [B, S/tp, H/tq] slice, each
projected image row's hidden slice is scattered into it (the tower and
the projector replicated, as in JAX: each tq rank encodes the tiles and
keeps its slice of the projector's output, so their gradients are summed
over tq with the rest of the world), and ``head=False`` returns the budget
rows' hidden slices (loss.vocab_parallel_ce sums the partial logits over
tq).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional, Union

import torch
from torch import nn

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.models import qwen2
from long_vita_tpu_torch.models.intern_vit import VisionParams, init_vit_params, intern_vit
from long_vita_tpu_torch.models.projector import (
    ProjectorParams,
    init_projector_params,
    project_features,
)
from long_vita_tpu_torch.models.qwen2 import KVCache, Qwen2Params
from long_vita_tpu_torch.parallel.comm import reduce_from_tp, seq_slice


class LongVITAParams(nn.Module):
    """The VLM's weights: the JAX package's ``{"text", "vision", "projector"}``."""

    def __init__(self, *, text: Qwen2Params, vision: VisionParams, projector: ProjectorParams):
        super().__init__()
        self.text, self.vision, self.projector = text, vision, projector


def encode_images(
    params: LongVITAParams,
    images: torch.Tensor,
    cfg: LongVITAConfig,
    *,
    chunk: int = 0,
    attn_impl: str = "auto",
    remat: Union[bool, str] = False,
    freeze_tower: bool = False,
    parallel=None,
) -> torch.Tensor:
    """[N_tiles, H, W, 3] -> [N_tiles, image_token_length, lm_hidden].

    parallel (a mesh whose cp x tp ranks of a replica number P > 1; the
    tower frozen, or serving): rank r of ``parallel.tile_comm`` encodes
    tiles [r * n / P, (r + 1) * n / P) of the stack padded with zero tiles
    to a multiple of P, the tower features are all-gathered over those
    ranks, and the projector runs on all of them (the JAX split, :112-150:
    the tower in the shard_map over every axis of size > 1, the projector
    outside), so every rank scatters the whole set.

    ``chunk`` > 0 encodes the tiles in batches of ``chunk`` to bound the
    ViT's activation memory (the JAX package's lax.map over chunks). A last
    partial batch runs as it is: JAX pads it with zero tiles only because
    lax.map needs one shape, and every tile is encoded on its own, so the
    features are the same. attn_impl "short" selects the single-pass ViT
    attention kernel K3. freeze_tower runs the tower and its CLS strip under
    torch.no_grad (the JAX stop_gradient on the tower features, :81-88): no
    tower backward, while the projector keeps its gradients. remat (a level
    of qwen2.check_remat): a trainable tower recomputes each layer at any
    level (JAX's tower takes nothing_saveable, intern_vit.py:113-114); "vit"
    also recomputes tower and projector per chunk (:96-105), so that a chunk
    keeps only its tiles' pixels for the backward."""

    def encode(tiles):
        with torch.no_grad() if freeze_tower else contextlib.nullcontext():
            feats = intern_vit(
                params.vision, tiles, cfg.vision, attn_impl=attn_impl,
                remat=bool(remat) and not freeze_tower,
            )[:, 1:]  # strip CLS
        return project_features(params.projector, feats, cfg)

    def chunked(fn, x):
        n = x.shape[0]
        if not chunk or n <= chunk:
            return fn(x)
        return torch.cat([fn(x[i : i + chunk]) for i in range(0, n, chunk)], 0)

    if parallel is not None and parallel.tile_comm.size > 1:
        comm, n = parallel.tile_comm, images.shape[0]
        per = -(-n // comm.size)
        if per * comm.size > n:
            images = torch.cat([images, images.new_zeros((per * comm.size - n, *images.shape[1:]))])
        mine = images[comm.rank * per : (comm.rank + 1) * per]
        with torch.no_grad():
            feats = chunked(
                lambda t: intern_vit(params.vision, t, cfg.vision, attn_impl=attn_impl)[:, 1:], mine
            )
        feats = comm.all_gather(feats, 0)[:n]
        return chunked(lambda f: project_features(params.projector, f, cfg), feats)
    if remat == "vit" and not freeze_tower:
        fn = functools.partial(qwen2.remat_checkpoint, encode, remat=True)
    else:
        fn = encode
    return chunked(fn, images)


def merge_image_embeddings(
    inputs_embeds: torch.Tensor,
    image_embeds: torch.Tensor,
    image_indices: torch.Tensor,
) -> torch.Tensor:
    """Scatter projected tile rows into the token embeddings.

    inputs_embeds [B, S, H]; image_embeds [N_tiles, T, H]; image_indices
    [2, N_tiles, T] of (batch, seq) positions. Returns a new tensor; index
    pairs outside [0, B) x [0, S) are dropped."""
    b, s, h = inputs_embeds.shape
    b_idx = image_indices[0].reshape(-1).to(torch.long)
    s_idx = image_indices[1].reshape(-1).to(torch.long)
    keep = (b_idx >= 0) & (b_idx < b) & (s_idx >= 0) & (s_idx < s)
    flat = image_embeds.reshape(-1, h).to(inputs_embeds.dtype)
    out = inputs_embeds.clone()
    out[b_idx[keep], s_idx[keep]] = flat[keep]
    return out


def merge_image_embeddings_chunked(
    inputs_embeds: torch.Tensor,
    image_embeds: torch.Tensor,
    image_indices: torch.Tensor,
    chunk: int,
) -> torch.Tensor:
    """merge_image_embeddings a chunk of ``chunk`` tiles at a time (JAX
    :178): the same result (the indices are collision-free and rows outside
    the embeddings are dropped), with the gathered rows of one chunk alive
    at a time."""
    n = image_embeds.shape[0]
    for i in range(0, n, max(chunk, 1)):
        inputs_embeds = merge_image_embeddings(
            inputs_embeds, image_embeds[i : i + chunk], image_indices[:, i : i + chunk]
        )
    return inputs_embeds


def cp_logit_rows(logit_positions: torch.Tensor, seq_local: int, rank: int):
    """Which of the [B, M] logit rows (positions in the whole, permuted
    sequence) lie in this rank's shard [rank * seq_local, (rank + 1) *
    seq_local), and where: -> (mask [B, M], local positions [B, M]). Under
    sequence parallelism the shard is the cp shard (every tp rank of it
    takes the same rows; ``sp_logit_rows`` gathers them)."""
    local = logit_positions.long() - rank * seq_local
    return (local >= 0) & (local < seq_local), local


def sp_logit_rows(hidden: torch.Tensor, logit_positions: torch.Tensor, s_cp: int,
                  cp_rank: int, tp) -> torch.Tensor:
    """The budget rows of this rank's cp shard of ``s_cp`` tokens from the
    sequence-parallel hidden slice [B, ceil(s_cp / tp), H] (the last slices
    end in pad rows where s_cp does not split over tp; no budget row lies
    there): -> [1, N, H], the rows of cp_logit_rows(logit_positions, s_cp,
    cp_rank)'s mask in (row, m) order, the same on every tp rank. Each tp
    rank fills the rows that lie in its slice, zeros elsewhere, and the
    rows are summed over tp (reduce_from_tp)."""
    b, s_sp, _ = hidden.shape
    mask, local = cp_logit_rows(logit_positions, s_cp, cp_rank)
    rows = torch.arange(b, device=hidden.device)[:, None].expand_as(mask)[mask]
    local = local[mask] - tp.rank * s_sp
    mine = (local >= 0) & (local < s_sp)
    picked = hidden[rows, local.clamp(0, s_sp - 1)]
    picked = torch.where(mine[:, None], picked, torch.zeros_like(picked))
    return reduce_from_tp(picked, tp)[None]


def long_vita_forward(
    params: LongVITAParams,
    input_ids: torch.Tensor,
    position_ids: torch.Tensor,
    cfg: LongVITAConfig,
    *,
    images: Optional[torch.Tensor] = None,
    image_indices: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    segment_ids: Optional[torch.Tensor] = None,
    logit_positions: Optional[torch.Tensor] = None,
    vision_chunk: int = 0,
    attn_impl: str = "auto",
    remat: Union[bool, str] = False,
    return_aux: bool = False,
    freeze_vision: bool = False,
    head: bool = True,
    parallel=None,
    return_anchor: bool = False,
):
    """The full VLM forward, on one device or on this rank's shard.

    logit_positions: optional [B, M] positions whose rows alone reach the
    vocabulary head (the logits-masked head). head=False returns those
    (final-normed) hidden rows instead of logits. remat: the decoder's and
    the tower's recompute level (qwen2.check_remat, encode_images). freeze_vision: the
    tower runs without gradients and with the single-pass attention K3
    ("short"), as in the JAX package (:321-331). -> (logits [B, S or M,
    vocab] f32, or hidden rows; the cache at its new length, or None), and
    with return_aux the MoE aux loss (qwen2_decoder's), 0 for a dense decoder.

    parallel (cp > 1, no cache): input_ids, position_ids and segment_ids
    are this rank's [B, S/cp] shard of the (permuted) sequence; images and
    image_indices are the whole batch's, the indices into the whole
    sequence; logit_positions [B, M] index the whole sequence too, and the
    result holds the rows of those that lie in this rank's shard, flattened
    to [1, N_local, ...] in (row, m) order (cp_logit_rows gives the mask):
    the loss sums them over ranks (training/train_step.py). With tp > 1 too
    (a tp shard of the tree, training): the sequence-parallel forward of
    the module docstring, the same rows on every tp rank of a cp shard;
    under 2-D tp (the tree bound to a tq communicator too) their hidden
    slices.

    Pipelined (``parallel`` with pp > 1, no cache, params.text a stage's
    tree: training): the first stage alone looks the tokens up and encodes
    and scatters the tiles, the decoder runs the pipeline
    (qwen2._pipelined_decoder), and the last stage alone gathers the budget
    rows and applies the head; the other stages return None for the
    result. JAX keeps every leaf outside the layer stack replicated over pp
    and computes all of it on every stage, the output psum'd to each; the
    port's stages hold the same leaves and skip the work whose result only
    the other end reads. Under tp the lookup lands in the rank's sequence
    slice (qwen2.embed_tokens_vp: the same rows as JAX's plain lookup under
    its [B@dp, S@(cp, tp), H] constraint, :295-301) and head=True is the
    plain head over the gathered rows (JAX's rule: no vocab-parallel CE
    under pp, train_step.py:75-85). return_anchor: the pipeline's anchor
    last (parallel/pipeline.py; 0 without pp)."""
    qwen2.check_remat(remat)
    cp = parallel.cp if parallel is not None and kv_cache is None else 1
    sp = (parallel is not None and kv_cache is None
          and parallel.mesh.shape["tp"] * parallel.mesh.shape["tq"] > 1
          and params.text.tp_comm is not None)
    tq = params.text.tq_comm
    stage = params.text.pp if parallel is not None and kv_cache is None else None
    if stage is not None and not stage.first:
        inputs_embeds, images = None, None
    elif sp:
        tp = params.text.tp_comm
        s_cp = input_ids.shape[1]
        inputs_embeds = qwen2.embed_tokens_vp(params.text, input_ids)
        # the first position of this rank's slice in the whole sequence, and
        # its real rows (the rest pad an S_cp that does not split over tp)
        width = seq_slice(s_cp, tp.size)
        offset = parallel.comm.rank * s_cp + tp.rank * width
        real = min(max(s_cp - tp.rank * width, 0), width)
    else:
        inputs_embeds = qwen2.embed_tokens(params.text, input_ids)
        offset = parallel.comm.rank * input_ids.shape[1] if cp > 1 else 0
    if images is not None:
        image_embeds = encode_images(
            params, images, cfg, chunk=vision_chunk,
            attn_impl="short" if freeze_vision else attn_impl,
            remat=remat, freeze_tower=freeze_vision,
            parallel=parallel if freeze_vision and (cp > 1 or sp) else None,
        )
        if cp > 1 or sp:
            if tq is not None:  # the rank's hidden slice of the rows
                h = inputs_embeds.shape[-1]
                image_embeds = image_embeds.narrow(-1, tq.rank * h, h)
            idx = image_indices.clone()
            idx[1] -= offset
            if sp and real < width:  # no tile row lands in a pad row
                idx[1] = torch.where(idx[1] < real, idx[1], -1)
            inputs_embeds = merge_image_embeddings_chunked(
                inputs_embeds, image_embeds, idx, vision_chunk or 256
            )
        else:
            inputs_embeds = merge_image_embeddings(inputs_embeds, image_embeds, image_indices)
    hidden, new_cache, aux, anchor = qwen2.qwen2_decoder(
        params.text, inputs_embeds, position_ids, cfg.text,
        kv_cache=kv_cache, segment_ids=segment_ids, attn_impl=attn_impl,
        remat=remat, parallel=parallel, return_aux=True, return_anchor=True,
    )
    if hidden is None:  # a pipeline stage before the last
        out = None
    elif logit_positions is not None and sp:
        hidden = sp_logit_rows(hidden, logit_positions, position_ids.shape[1],
                               parallel.comm.rank if cp > 1 else 0, params.text.tp_comm)
    elif logit_positions is not None and cp > 1:
        mask, local = cp_logit_rows(logit_positions, hidden.shape[1], parallel.comm.rank)
        rows = torch.arange(hidden.shape[0], device=hidden.device)[:, None].expand_as(mask)
        hidden = hidden[rows[mask], local[mask]][None]
    elif logit_positions is not None:
        hidden = torch.take_along_dim(hidden, logit_positions[:, :, None].long(), dim=1)
    if hidden is not None:
        out = qwen2.lm_head(params.text, hidden) if head else hidden
    result = (out, new_cache)
    if return_aux:
        result += (aux,)
    if return_anchor:
        result += (anchor,)
    return result


def init_long_vita_params(
    generator: torch.Generator,
    cfg: LongVITAConfig,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> LongVITAParams:
    """Random decoder, tower and projector (see each module's initializer)."""
    return LongVITAParams(
        text=qwen2.init_qwen2_params(generator, cfg.text, dtype, device),
        vision=init_vit_params(generator, cfg.vision, dtype, device),
        projector=init_projector_params(generator, cfg, dtype, device),
    )
