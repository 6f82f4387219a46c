"""Qwen2.5 decoder: parameters as nn.Modules, the forward as plain functions.

Counterpart of long_vita_tpu/models/qwen2.py (text path). Architecture:
RMSNorm (eps 1e-6), GQA attention with q/k/v bias and rotate-half RoPE, a
SwiGLU MLP or, in a layer that carries a router, the mixture of experts of
ops/moe.py (its aux loss summed over the layers), untied lm_head.

Differences from the JAX package, all of form rather than of numbers:
  - the stacked ``[L, ...]`` parameter pytree scanned by ``lax.scan`` becomes
    a ``ModuleList`` of ``DecoderLayer``s walked by a Python loop, each layer
    optionally under torch.utils.checkpoint (remat);
  - parameters are created with requires_grad=False; training turns it on
    for what it differentiates (utils/convert.set_requires_grad);
  - dense weights are kept in ``nn.Linear`` orientation ``[out, in]`` (the
    JAX kernels are ``[in, out]``; utils/convert.py transposes), int8 codes
    too; packed int4 weights keep the JAX layout ``[in/2, out]`` that K6
    reads;
  - the KV cache is a pair of preallocated ``[L, B, Smax, Hkv, D]`` buffers
    (int8 codes plus ``[L, B, Smax, Hkv, 1]`` f32 scales when quantized)
    written in place, where JAX threads a donated scan carry;
  - a projection's LoRA adapter is a ``lora`` submodule (``LoraAdapter``, a
    [in, r] and b [r, out] in the JAX layout) where JAX keeps a ``"lora"``
    entry in the projection's pytree node;
  - the remat levels are torch.utils.checkpoint around each layer, the
    selective ones through create_selective_checkpoint_contexts
    (``remat_ops``);
  - under context parallelism (``parallel``, a ``ParallelConfig`` over the
    port's mesh of ranks) every rank runs this code on its own shard, as
    inside JAX's shard_map: without a cache the inputs are this rank's
    sequence shard and attention is ring, Ulysses or hybrid over the cp
    communicator; with a cache (sharded over cp by slot) the inputs and
    the result are the whole chunk on every rank, and a chunk whose length
    divides by cp runs its projections on this rank's 1/cp of the rows
    (JAX's q_sharded layout, :349-425);
  - under tensor parallelism the tree itself is this rank's shard
    (parallel/sharding.shard_params) and carries its ``tp_comm``: the
    projections' local widths give the local head counts, o_proj and
    down_proj are followed by an all_reduce_sum over tp (an int4 one is
    replicated: its input is all-gathered instead), the embedding lookup
    is summed over tp and the head's logits are all-gathered over tp,
    where JAX's GSPMD inserts the same collectives;
  - training over tp (sequence parallelism, JAX's training layout
    [B@dp, S@(cp, tp), H], long_vita.py:268-310) is Megatron's sequence
    parallelism written out: x is this rank's 1/tp slice of its cp shard's
    sequence (ceil(S_cp / tp) rows where S_cp does not split: the last
    slices end in zero rows, GSPMD's padding, which the gather drops and
    the reduce-scatter restores as zeros), RMSNorm runs on the slice,
    ``gather_seq`` (all-gather, its backward a reduce-scatter) precedes
    q/k/v and gate/up, ``scatter_seq`` (reduce-scatter, its backward an
    all-gather) follows o_proj and down_proj, and the lookup is
    vocab-parallel straight into the slice (``embed_tokens_vp``, JAX :918).
    Attention runs on the rank's q and kv heads over the whole cp shard
    (the ring over cp as before);
  - under FSDP (``Qwen2Params.fsdp``, parallel/sharding.shard_params(...,
    fsdp=True)) the tree holds 1/dp of each weight and parallel/fsdp.py
    gathers a layer's norms and projection weights over dp just before the
    layer runs (inside remat's checkpoint, so the recompute gathers again),
    the embedding before the lookup and the head before its GEMM, and
    reduce-scatters their gradients; a saved gathered weight is gathered
    again in the backward (``fsdp.streaming``), so one unit's whole weights
    are alive at a time. JAX's GSPMD inserts the same collectives inside
    the scan. Inside pipeline stages (JAX's text_param_specs(fsdp=True,
    pp=True)) a stage's layers stream the same way in every tick that runs
    them (``_pipelined_decoder``), the first stage gathering the embedding
    and the last the head;
  - under 2-D tensor parallelism (``Qwen2Params.tq_comm``, the tq axis:
    JAX's training layout [B@dp, S@(cp, tp), H@tq], long_vita.py:280-290,
    where GSPMD derives every collective) x is also cut over the hidden
    dim: RMSNorm sums its squares over tq before the rsqrt and scales the
    rank's slice of its weight; a column projection takes the partial
    product of the rank's hidden slice, summed over tq (``reduce_from_tp``
    over the tq communicator: the gradient passes through) before the
    bias; a row projection's input, the same on every tq rank, goes
    through ``copy_to_tp`` over tq (its gradient summed) and its product
    gives the rank's output slice, reduce-scattered over tp as before. q,
    k and v, and so the attention, are the same on every tq rank of a tp
    index (computed tq times); the lookup on the 2-D table lands in the slice as under 1-D tp
    (ids clamped, as JAX's plain lookup there), and the head sums its
    partial logits over tq. Serving over tq (a cache; JAX's engine on its
    tp2d specs) runs the same [B, S, H/tq] hidden slices without sequence
    parallelism: a row product's slice is summed over tp by one
    all_reduce_sum, the quantised trees take JAX's 2-D cuts (int8 codes as
    their weight, the scale with the output; int4 by its output dim alone,
    so its input is gathered over tq for a column product and over tp for
    a row one), and the head's logits are summed over tq, then gathered
    over tp;
  - over pp (``Qwen2Params.pp``, a stage's tree: parallel/sharding.
    shard_params cuts it) the decoder runs its stage's layers in the
    pipeline's schedule (``_pipelined_decoder``, parallel/pipeline.py),
    the activation moving between stages in autograd Functions, where JAX
    runs one shard_map over the pp axis;
  - a MoE layer over the mesh (JAX :602-667 and GSPMD) routes, in
    training, each dp shard's tokens as one batch: expert parallelism over
    dp (``Qwen2Params.ep_comm``, the experts cut over dp, rows exchanged
    with their owners, ops/moe.py) at dp > 1, the batch spread over the cp
    ranks (global slot ids and capacity, the aux from the summed
    statistics), under tp the experts' intermediate dim cut like the dense
    gate/up and down (each tp rank routes the gathered tokens and its
    partial output is reduce-scattered, or all-reduced in serving); in
    serving one call (a prefill or verify chunk, a decode step) is one
    batch, over cp's q-sharded chunk every rank's rows; over pp each
    microbatch is one call and the aux travels with the activation.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from long_vita_tpu_torch.config import TextConfig
from long_vita_tpu_torch.ops._target import on_cuda
from long_vita_tpu_torch.ops.attention import (
    dot_product_attention,
    quant_prefill_attention,
    xla_attention_quant,
)
from long_vita_tpu_torch.ops.quant_matmul import w4_matmul
from long_vita_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from long_vita_tpu_torch.parallel.comm import (
    copy_to_tp,
    gather_from_tp,
    gather_seq,
    reduce_from_tp,
    scatter_seq,
    seq_slice,
)
from long_vita_tpu_torch.parallel.fsdp import embed_table, gathered_layer, head_weight, streaming

CacheLen = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoERoute:
    """Where a MoE layer's routing batch and experts lie (ops/moe.moe_mlp):
    ``ep`` the expert communicator (None: every expert here), ``seq`` the
    ranks that hold the batch's tokens (None: this rank's alone),
    ``share`` the ranks that route the same tokens for the aux's gradient
    (tp under sequence parallelism)."""

    ep: Any = None
    seq: Any = None
    share: int = 1


CP_ALGOS = ("ring", "ulysses", "hybrid")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The mesh context of context-parallel attention (JAX :36-60), and of
    the tile-sharded encode (``tile_comm``).

    mesh: a parallel.mesh.Mesh. cp_algo "ring" (zigzag ring attention, the
    inputs zigzag-permuted over cp), "ulysses" (head all-to-all, contiguous
    shards) or "hybrid" (Ulysses over cp_inner lanes inside ring groups, the
    inputs zigzag-permuted over cp // cp_inner); cp_window: the double
    ring's window (0 = the plain ring). microbatches: the pipeline's
    microbatches over a pp mesh (0: pp, as in JAX); the interleaved
    schedule's chunks a stage are its tree's (``Qwen2Params.pp.virtual``),
    where JAX reads ``virtual_pp`` here."""

    mesh: Any
    cp_algo: str = "ring"
    cp_inner: int = 1
    cp_window: int = 0
    microbatches: int = 0

    def __post_init__(self):
        if self.cp_algo not in CP_ALGOS:
            raise ValueError(f"cp_algo {self.cp_algo!r} not one of {CP_ALGOS}")
        if self.cp_algo == "hybrid" and self.cp % max(self.cp_inner, 1):
            raise ValueError(f"cp {self.cp} % cp_inner {self.cp_inner} != 0")

    @property
    def cp(self) -> int:
        return self.mesh.shape["cp"]

    @property
    def pp(self) -> int:
        return self.mesh.shape["pp"]

    @property
    def comm(self):
        """The cp communicator."""
        return self.mesh.cp_comm

    @property
    def tile_comm(self):
        """The ranks that encode one tile stack between them (JAX's
        tile_axes, long_vita.py:112-150): the cp x tp ranks of a replica."""
        return self.mesh.replica_comm


def _cp_attention_sharded(q, k, v, segment_ids, parallel: ParallelConfig) -> torch.Tensor:
    """Context-parallel attention of this rank's shard (JAX :255-347):
    ring (zigzag), ulysses (contiguous shards) or hybrid."""
    from long_vita_tpu_torch.ops.hybrid_cp import hybrid_attention
    from long_vita_tpu_torch.ops.ring_attention import ring_attention
    from long_vita_tpu_torch.ops.ulysses import ulysses_attention

    comm = parallel.comm
    if parallel.cp_algo == "hybrid":
        return hybrid_attention(q, k, v, comm, parallel.cp_inner, segment_ids, segment_ids,
                                parallel.cp_window)
    if parallel.cp_algo == "ulysses":
        return ulysses_attention(q, k, v, comm, segment_ids, segment_ids)
    return ring_attention(q, k, v, comm, segment_ids, segment_ids, parallel.cp_window)


def _cp_cached_update_attend(q, k, v, cache_kv, cache_len, position_ids,
                             parallel: ParallelConfig, q_sharded: bool) -> torch.Tensor:
    """Shard-local cache write + cached attention over cp (JAX :349-425).
    q_sharded: q, k and v are this rank's contiguous 1/cp of the chunk: the
    chunk's q, k and v are gathered in one all_gather (an int8 cache
    quantises the gathered rows, per token and head, as JAX quantises them
    before its gather), every rank attends the whole chunk against its
    shard, and keeps its own rows of the merged output (JAX's
    psum_scatter)."""
    from long_vita_tpu_torch.ops.cp_cache_attention import cp_cache_update_attend

    comm = parallel.comm
    ck_full, cv_full, ks_full, vs_full, layer_idx = cache_kv
    s_local, hq, hkv = q.shape[1], q.shape[2], k.shape[2]
    # the chunk's first global position (each row's, with a [B] frontier); a
    # sharded chunk's position_ids are this rank's rows
    q_off = position_ids[:, 0] if torch.is_tensor(cache_len) else position_ids[0, 0]
    if q_sharded:
        q_off = q_off - comm.rank * s_local
        q, k, v = comm.all_gather(torch.cat([q, k, v], 2), 1).split([hq, hkv, hkv], 2)
    if ks_full is not None:
        k_w, k_sc = quantize_kv(k)
        v_w, v_sc = quantize_kv(v)
    else:
        k_w, v_w = k.to(ck_full.dtype), v.to(cv_full.dtype)
        k_sc = v_sc = None
    out = cp_cache_update_attend(
        q, ck_full, cv_full, k_w, v_w, ks_full, vs_full, k_sc, v_sc, layer_idx, cache_len,
        q_off, comm,
    )
    return out[:, comm.rank * s_local:(comm.rank + 1) * s_local] if q_sharded else out


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class LoraAdapter(nn.Module):
    """A projection's low-rank update in the JAX layout: ``a`` [in, r] and
    ``b`` [r, out] (training/lora.py adds, merges, saves and loads them)."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = _frozen(a)
        self.b = _frozen(b)


class Dense(nn.Module):
    """One projection: ``weight`` [out, in], an optional ``bias`` [out] and
    an optional ``lora`` adapter."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 lora: Optional[LoraAdapter] = None):
        super().__init__()
        self.weight = _frozen(weight)
        self.bias = _frozen(bias) if bias is not None else None
        self.lora = lora


class QuantDense8(nn.Module):
    """An int8 weight-only projection (w8a16, models/quantize.py): codes
    ``weight_q`` int8 [out, in], per-output-channel ``scale`` f32 [out], and
    an optional ``bias`` [out] (the JAX entry {kernel_q, scale, bias})."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, lora: Optional[LoraAdapter] = None):
        super().__init__()
        self.weight_q = _frozen(weight_q)
        self.scale = _frozen(scale)
        self.bias = _frozen(bias) if bias is not None else None
        self.lora = lora


class QuantDense4(nn.Module):
    """A packed-int4 weight-only projection (w4a16, read by K6): ``packed``
    int8 [in/2, out] and group ``scales`` f32 [in/128, out] in the JAX
    layout, and an optional ``bias`` [out] (the JAX entry {kernel_p4,
    scale4, bias})."""

    def __init__(self, packed: torch.Tensor, scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, lora: Optional[LoraAdapter] = None):
        super().__init__()
        self.packed = _frozen(packed)
        self.scales = _frozen(scales)
        self.bias = _frozen(bias) if bias is not None else None
        self.lora = lora


Projection = Union[Dense, QuantDense8, QuantDense4]


class DecoderLayer(nn.Module):
    """One layer: the dense MLP's gate_proj, up_proj and down_proj, or (a MoE
    layer) ``router`` (weight [E, H]) and ``experts`` (ops/moe.Experts) in
    their place; a dense layer has no ``router`` attribute."""

    def __init__(
        self, *, input_norm, post_attn_norm, q_proj: Projection, k_proj: Projection,
        v_proj: Projection, o_proj: Projection, gate_proj: Optional[Projection] = None,
        up_proj: Optional[Projection] = None, down_proj: Optional[Projection] = None,
        router: Optional[Dense] = None, experts: Optional[nn.Module] = None,
    ):
        super().__init__()
        self.input_norm = _frozen(input_norm)
        self.post_attn_norm = _frozen(post_attn_norm)
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = q_proj, k_proj, v_proj, o_proj
        if router is not None:
            self.router, self.experts = router, experts
        else:
            self.gate_proj, self.up_proj, self.down_proj = gate_proj, up_proj, down_proj


class Qwen2Params(nn.Module):
    """The text decoder's weights (the JAX package's ``params["text"]``).
    ``tp_comm``: None for the whole tree; on a rank's tensor-parallel shard
    (parallel/sharding.shard_params) the tp communicator its collectives
    run on. ``fsdp``: None, or on an FSDP shard the parallel.fsdp.Fsdp
    that gathers its units over dp. ``pp``: None, or on a pipeline stage's
    tree (its ``layers`` the stage's, parallel/sharding.shard_params) the
    parallel.pipeline.Stage. ``tq_comm``: None, or on a 2-D tp shard the
    tq communicator (``tp_comm`` is then set too, a LocalComm at tp 1).
    ``ep_comm``: None, or on a MoE tree whose experts are cut over dp
    (expert parallelism) the dp communicator they are exchanged over."""

    tp_comm = None
    tq_comm = None
    fsdp = None
    pp = None
    ep_comm = None

    def __init__(
        self, *, embed: torch.Tensor, layers: list[DecoderLayer],
        final_norm: torch.Tensor, lm_head: Projection,
    ):
        super().__init__()
        self.embed = _frozen(embed)  # [V, H]
        self.layers = nn.ModuleList(layers)
        self.final_norm = _frozen(final_norm)
        self.lm_head = lm_head  # weight [V, H]


def out_features(entry: Projection) -> int:
    """A projection's output width (its local width on a tp shard)."""
    if isinstance(entry, QuantDense4):
        return entry.packed.shape[1]
    return (entry.weight_q if isinstance(entry, QuantDense8) else entry.weight).shape[0]


def kv_heads(params: Qwen2Params, cfg: TextConfig) -> int:
    """The kv heads the tree's layers compute: cfg's, or a tp shard's."""
    return out_features(params.layers[0].k_proj) // cfg.head_dim


# A fault for the 2-D serving gate that must catch it (chip_smoke.py), never
# set in serving or training: rms_norm under tq drops the sum of its squares
# over tq (each rank divides its own slice's squares by the whole width).
_RMS_UNSUMMED_OVER_TQ = False


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, tq=None) -> torch.Tensor:
    """RMSNorm with f32 variance; the weight multiplies the normalised x
    AFTER it is cast back to x's dtype (HF Qwen2RMSNorm numerics). tq (2-D
    tp): x is the rank's hidden slice, its squares are summed over tq
    before the mean, and the rank's slice of the (whole) weight scales it."""
    xf = x.float()
    if tq is None:
        var = xf.square().mean(-1, keepdim=True)
    else:
        h = x.shape[-1]
        sq = xf.square().sum(-1, keepdim=True)
        if not _RMS_UNSUMMED_OVER_TQ:
            # summed over tq both ways: each rank applies the sum to its own slice
            sq = copy_to_tp(reduce_from_tp(sq, tq), tq)
        var = sq / (h * tq.size)
        weight = weight.narrow(0, tq.rank * h, h)
    xf = xf * torch.rsqrt(var + eps)
    return weight * xf.to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """Preallocated cache: k/v are [L, B, Smax, Hkv, D], written in place.

    length: the number of valid positions — a Python int when it is
    batch-uniform, or a [B] integer tensor (ragged batched serving: each
    row's tokens stay packed from slot 0, writes land at each row's own
    frontier, and the causal mask hides what lies beyond it).

    An int8 cache (``zeros(..., quantize=True)``) stores int8 codes in k/v
    and one f32 scale per (token, kv head) in k_scale/v_scale
    [L, B, Smax, Hkv, 1]: about half the bytes per token of a bf16 cache."""

    k: torch.Tensor
    v: torch.Tensor
    length: CacheLen
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def zeros(
        cls, cfg: TextConfig, batch: int, max_len: int,
        dtype: torch.dtype = torch.bfloat16, device=None,
        quantize: bool = False, kv_heads: Optional[int] = None,
    ) -> "KVCache":
        """kv_heads: the heads a rank holds (a tp shard's); cfg's by default."""
        shape = (
            cfg.num_hidden_layers, batch, max_len,
            kv_heads or cfg.num_key_value_heads, cfg.head_dim,
        )
        if quantize:
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                length=0,
                k_scale=torch.zeros(shape[:-1] + (1,), device=device),
                v_scale=torch.zeros(shape[:-1] + (1,), device=device),
            )
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=0,
        )


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: [..., D] -> (int8 codes, f32 scale
    [..., 1]). scale = max(amax, 1e-8) / 127; codes round half to even and
    clip to +-127, bit for bit the JAX package's quantize_kv."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8), scale


def _with_lora(entry: Projection, x: torch.Tensor, out: torch.Tensor,
               cfg: TextConfig) -> torch.Tensor:
    """Add a projection's low-rank update when it carries an adapter and
    cfg.lora_r is set (JAX :146-157): out + ((x @ a) @ b) * alpha / r. The
    adapters ride the layers, so training, serving, speculative decoding
    and beam search all see them with no separate path."""
    if entry.lora is None or cfg.lora_r == 0:
        return out
    scale = cfg.lora_alpha / cfg.lora_r
    return out + ((x @ entry.lora.a) @ entry.lora.b) * scale


def _product(entry: Projection, x: torch.Tensor) -> torch.Tensor:
    """x times the projection's weight, without bias or LoRA: int8 codes
    cast to x's dtype, the product, then the scale in x's dtype; packed
    int4 through w4_matmul (K6 for decode-sized row counts, the dequantise
    route for prefill chunks)."""
    if isinstance(entry, QuantDense8):
        return F.linear(x, entry.weight_q.to(x.dtype)) * entry.scale.to(x.dtype)
    if isinstance(entry, QuantDense4):
        return w4_matmul(x, entry.packed, entry.scales)
    return F.linear(x, entry.weight)


def _proj(entry: Projection, x: torch.Tensor, cfg: TextConfig, tq=None) -> torch.Tensor:
    """A projection without its bias (callers add it in the param dtype
    after the product, as the JAX package does), plus its LoRA update.
    Dispatches on the layout as the JAX _proj (:174-184) (``_product``). tq
    (a column projection under 2-D tp): x is the rank's hidden slice and
    the weight its input rows (int8 codes too, their scale per output
    column), each rank's scaled partial product summed over tq; LoRA's
    ``a`` is replicated, its rows of the slice taken and that product
    summed over tq too, before ``b``. An int4 weight keeps its whole input
    dim (JAX cuts int4 by its output dim alone), so x is all-gathered over
    tq first and K6 computes the whole product."""
    if tq is not None:
        if isinstance(entry, QuantDense4):
            return _proj(entry, tq.all_gather(x, -1), cfg)
        out = reduce_from_tp(_product(entry, x), tq)
        if entry.lora is None or cfg.lora_r == 0:
            return out
        h = x.shape[-1]
        xa = reduce_from_tp(x @ entry.lora.a.narrow(0, tq.rank * h, h), tq)
        return out + (xa @ entry.lora.b) * (cfg.lora_alpha / cfg.lora_r)
    return _with_lora(entry, x, _product(entry, x), cfg)


def _row_proj(entry: Projection, x: torch.Tensor, cfg: TextConfig, tp,
              sp: bool = False, tq=None) -> torch.Tensor:
    """A row-parallel projection (o_proj, down_proj) on a tp shard: this
    rank's slice of the input dim, then one all_reduce_sum over tp (sp: a
    reduce-scatter along the sequence into this rank's slice, through
    autograd); an int4 one is replicated (quantize.quantized_param_specs),
    so its input is all-gathered over tp and the whole product computed.
    tp None: _proj. tq (2-D tp): x is the same on every tq rank and the
    weight holds the rank's output rows, so the product is the rank's
    hidden slice, summed over tp (sp, training: x passes copy_to_tp over tq,
    its gradient summed over tq, and the sum is the reduce-scatter along
    the sequence; serving: one all_reduce_sum over tp, an int8 product
    scaled on each tp rank first); LoRA's ``a`` (cut over tp) gives a
    product the same on every tq rank, and the rank's columns of the
    replicated ``b`` follow. An int4 one (serving) keeps its whole input
    dim and cuts its output over tq (JAX's quantized_param_specs): its
    input is all-gathered over tp and K6 computes the rank's output
    columns."""
    if tq is not None:
        if isinstance(entry, QuantDense4):
            xg = tp.all_gather(x, -1)
            return _lora_cols(entry, xg, w4_matmul(xg, entry.packed, entry.scales), cfg, tq)
        out = _lora_cols(entry, x, _product(entry, copy_to_tp(x, tq) if sp else x), cfg, tq,
                         sp)
        return scatter_seq(out, tp, 1) if sp else tp.all_reduce_sum(out)
    if tp is None:
        return _proj(entry, x, cfg)
    if sp:
        return scatter_seq(_proj(entry, x, cfg), tp, 1)
    if isinstance(entry, QuantDense4):
        return _proj(entry, tp.all_gather(x, -1), cfg)
    return tp.all_reduce_sum(_proj(entry, x, cfg))


def _lora_cols(entry: Projection, x: torch.Tensor, out: torch.Tensor, cfg: TextConfig, tq,
               sp: bool = False) -> torch.Tensor:
    """``out`` (the rank's output columns of a row projection under 2-D tp)
    plus the same columns of its LoRA update: x @ a, copied over tq under
    sequence parallelism (its gradient summed there), times the rank's
    columns of ``b``."""
    if entry.lora is None or cfg.lora_r == 0:
        return out
    h = out.shape[-1]
    xa = x @ entry.lora.a
    if sp:
        xa = copy_to_tp(xa, tq)
    return out + (xa @ entry.lora.b.narrow(1, tq.rank * h, h)) * (cfg.lora_alpha / cfg.lora_r)


def _row_write(buf: torch.Tensor, new: torch.Tensor, cache_len: torch.Tensor) -> None:
    """buf [B, Smax, ...] <- new [B, s, ...] at per-row offsets cache_len [B].

    Positions past the buffer are DROPPED (the JAX scatter's mode="drop"):
    rows past capacity keep stepping in a ragged batch and their writes
    must not land anywhere."""
    b, s = new.shape[:2]
    idx = cache_len.to(torch.long)[:, None] + torch.arange(s, device=buf.device)[None]
    keep = (idx >= 0) & (idx < buf.shape[1])
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    buf[rows[keep], idx[keep]] = new[keep]


def _attention_block(
    layer: DecoderLayer,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: TextConfig,
    cache_kv: Optional[tuple],
    cache_len: Optional[CacheLen],
    position_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    attn_impl: str,
    parallel: Optional[ParallelConfig] = None,
    q_sharded: bool = False,
    tp=None,
    sp: bool = False,
    tq=None,
) -> torch.Tensor:
    b, s, _ = x.shape
    d = cfg.head_dim

    q = _proj(layer.q_proj, x, cfg, tq) + layer.q_proj.bias
    k = _proj(layer.k_proj, x, cfg, tq) + layer.k_proj.bias
    v = _proj(layer.v_proj, x, cfg, tq) + layer.v_proj.bias
    # the heads this rank computes: cfg's, or a tp shard's local ones
    hq, hkv = q.shape[-1] // d, k.shape[-1] // d
    q = q.reshape(b, s, hq, d)
    k = k.reshape(b, s, hkv, d)
    v = v.reshape(b, s, hkv, d)
    q, k = apply_rope(q, k, cos, sin)
    cp = parallel.cp if parallel is not None else 1

    if cache_kv is not None and cp > 1:
        out = _cp_cached_update_attend(q, k, v, cache_kv, cache_len, position_ids, parallel,
                                       q_sharded)
    elif cp > 1:
        out = _cp_attention_sharded(q, k, v, segment_ids, parallel)
    elif cache_kv is not None:
        # views [B, Smax, Hkv, D] (scales [B, Smax, Hkv, 1]) of layer_idx
        ck_full, cv_full, ks_full, vs_full, layer_idx = cache_kv
        quant = ks_full is not None
        bufs = [ck_full[layer_idx], cv_full[layer_idx]]
        if quant:
            k_w, k_sc = quantize_kv(k)
            v_w, v_sc = quantize_kv(v)
            bufs += [ks_full[layer_idx], vs_full[layer_idx]]
            new = [k_w, v_w, k_sc, v_sc]
        else:
            new = [k.to(bufs[0].dtype), v.to(bufs[1].dtype)]
        if torch.is_tensor(cache_len):
            for buf, x_new in zip(bufs, new):
                _row_write(buf, x_new, cache_len)
            kv_valid = (cache_len + s).expand(b)
        else:
            # dynamic_update_slice semantics: the start clamps so the write fits
            start = min(max(cache_len, 0), bufs[0].shape[1] - s)
            for buf, x_new in zip(bufs, new):
                buf[:, start : start + s] = x_new
            kv_valid = torch.full((b,), cache_len + s, dtype=torch.long, device=x.device)
            # the frontier is known on the host: slots past it are masked in
            # any case, so attention is handed only the written prefix
            bufs = [buf[:, : cache_len + s] for buf in bufs]
        skv = bufs[0].shape[1]
        kv_positions = torch.arange(skv, device=x.device)[None].expand(b, skv)
        if quant:
            ck, cv, ks, vs = bufs
            if s > 1:
                out = quant_prefill_attention(
                    q, ck, ks, cv, vs, q_positions=position_ids,
                    kv_valid_len=kv_valid, impl=attn_impl,
                )
            else:
                out = xla_attention_quant(
                    q, ck, ks, cv, vs, q_positions=position_ids,
                    kv_positions=kv_positions, kv_valid_len=kv_valid,
                )
        else:
            out = dot_product_attention(
                q, bufs[0], bufs[1],
                causal=True,
                q_positions=position_ids,
                kv_positions=kv_positions,
                kv_valid_len=kv_valid,
                impl=attn_impl,
            )
    else:
        out = dot_product_attention(
            q, k, v,
            causal=True,
            q_positions=position_ids,
            kv_positions=position_ids,
            q_segment_ids=segment_ids,
            kv_segment_ids=segment_ids,
            impl=attn_impl,
        )
    return _row_proj(layer.o_proj, out.reshape(b, s, hq * d), cfg, tp, sp, tq)


def _mlp_block(layer: DecoderLayer, x: torch.Tensor, cfg: TextConfig, tp=None, sp=False,
               tq=None, moe: Optional[MoERoute] = None):
    """Dense SwiGLU (on a tp shard, this rank's slice of the intermediate
    dim, then down_proj's all-reduce), or the MoE MLP when the layer carries
    a router (JAX :602-667; ``moe`` where its batch and experts lie, one
    device's by default), its tp-partial output reduced as down_proj's.
    -> (out, the layer's aux loss or None). sp: x is the gathered sequence
    and out this rank's slice; tq: 2-D tp (x and out hidden slices too,
    _proj and _row_proj)."""
    if hasattr(layer, "router"):
        from long_vita_tpu_torch.ops.moe import moe_mlp

        moe = moe or MoERoute()
        out, aux = moe_mlp(layer, x, top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor, axis_name=moe.ep,
                           seq_comm=moe.seq, aux_share=moe.share)
        if tp is not None and tp.size > 1:
            out = scatter_seq(out, tp, 1) if sp else tp.all_reduce_sum(out)
        return out, aux
    gate = _proj(layer.gate_proj, x, cfg, tq)
    up = _proj(layer.up_proj, x, cfg, tq)
    return _row_proj(layer.down_proj, F.silu(gate) * up, cfg, tp, sp, tq), None


def check_moe_mesh(cfg: TextConfig, dp: int = 1, cp: int = 1, tp: int = 1, pp: int = 1,
                   tq: int = 1) -> None:
    """The MoE meshes JAX rejects: at dp > 1 the experts are cut over dp
    (expert parallelism, sharding.py:88-97), so dp must divide them (JAX's
    device_put fails otherwise); 2-D tp does not compose with MoE
    (mesh.py:129-130, its words). cp, tp, pp and FSDP compose."""
    if cfg.num_experts > 0 and tq > 1:
        raise ValueError(f"model geometry cannot shard over tq {tq}: 2-D TP (tq > 1) does not "
                         "compose with MoE/EP")
    if cfg.num_experts > 0 and dp > 1 and cfg.num_experts % dp:
        raise ValueError(f"{cfg.num_experts} experts do not divide over dp {dp}: expert "
                         "parallelism cuts the expert dim over dp")


def moe_route(params: "Qwen2Params", parallel: Optional[ParallelConfig], sp: bool,
              spread: bool) -> MoERoute:
    """The MoE layers' routing context of a decoder call: the tree's expert
    communicator, the cp ranks when the call's tokens are spread over them
    (``spread``: training's sequence shards, or a q-sharded cached chunk),
    and the tp ranks that route the same gathered tokens under sequence
    parallelism."""
    seq = parallel.comm if spread and parallel is not None and parallel.cp > 1 else None
    return MoERoute(params.ep_comm, seq, params.tp_comm.size if sp else 1)


def decoder_layer(
    layer: DecoderLayer,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: TextConfig,
    cache_kv,
    cache_len,
    position_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    attn_impl: str,
    parallel: Optional[ParallelConfig] = None,
    q_sharded: bool = False,
    tp=None,
    sp: bool = False,
    tq=None,
    moe: Optional[MoERoute] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (x, the MoE aux loss of the layer, None for a dense one). tp: the
    tree's tp communicator (row-parallel all-reduces), or None. sp
    (sequence parallelism): x is this rank's slice of the sequence; each
    normed input is gathered over tp before its column projections and
    each row projection reduce-scattered back into the slice. tq (2-D tp,
    with sp): x is also the rank's hidden slice (see the module
    docstring). moe: a MoE layer's routing context (moe_route)."""

    def gathered(h):  # position_ids hold the whole sequence's true length
        return gather_seq(h, tp, 1, position_ids.shape[1]) if sp else h

    x = x + _attention_block(
        layer, gathered(rms_norm(x, layer.input_norm, cfg.rms_norm_eps, tq)), cos, sin, cfg,
        cache_kv, cache_len, position_ids, segment_ids, attn_impl, parallel, q_sharded, tp, sp,
        tq,
    )
    out, aux = _mlp_block(layer,
                          gathered(rms_norm(x, layer.post_attn_norm, cfg.rms_norm_eps, tq)),
                          cfg, tp, sp, tq, moe)
    return x + out, aux


REMAT_LEVELS = (True, "full", "dots", "flash", "vit", False, None)


def check_remat(remat) -> bool:
    """Validate a remat level of the JAX package (qwen2._remat_policy :776)
    -> whether a layer recomputes in the backward. True, "full" and "vit"
    save only each layer's input (jax.checkpoint with nothing_saveable;
    "vit" adds the tower's chunk-level remat, models/long_vita.py);
    "dots" and "flash" save what ``remat_ops`` names; False or None keep
    everything."""
    if not any(remat is level or (isinstance(level, str) and remat == level)
               for level in REMAT_LEVELS):
        raise ValueError(f"unknown remat level {remat!r}; one of {REMAT_LEVELS}")
    return remat not in (False, None)


def remat_ops(remat) -> Optional[list]:
    """The ops whose outputs a recomputed layer keeps (JAX's checkpoint
    policies, :776-794), or None to keep nothing but the layer's input:
      - "dots": dots_with_no_batch_dims_saveable, i.e. the outputs of the
        products without batch dims, aten.mm and aten.addmm here (every
        projection and LoRA product; the attention's bmm recomputes);
      - "flash": save_only_these_names("flash_out", "flash_lse"), i.e. the
        flash forward's (o, lse) (ops.flash_attention's custom op
        lvt::flash_fwd, K1 on the card), so the backward never runs it
        again; the plain attention of the CPU has nothing to save there.
    Everything else is recomputed."""
    check_remat(remat)
    if remat == "dots":
        return [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
    if remat == "flash":
        from long_vita_tpu_torch.ops import flash_attention  # noqa: F401 (registers lvt::flash_fwd)

        return [torch.ops.lvt.flash_fwd.default]
    return None


def remat_checkpoint(fn, *args, remat=True):
    """fn(*args) under torch.utils.checkpoint at the level ``remat``: the
    whole call recomputes in the backward, except the outputs of
    remat_ops(remat), which are kept."""
    ops = remat_ops(remat)
    kw = {}
    if ops is not None:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, ops)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def qwen2_decoder(
    params: Qwen2Params,
    inputs_embeds: torch.Tensor,
    position_ids: torch.Tensor,
    cfg: TextConfig,
    *,
    kv_cache: Optional[KVCache] = None,
    segment_ids: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat: Union[bool, str] = False,
    parallel: Optional[ParallelConfig] = None,
    return_aux: bool = False,
    return_anchor: bool = False,
):
    """Run the decoder. inputs_embeds [B, S, H]; position_ids [B|1, S].

    Sequence parallel (a tp shard of the tree under a ``parallel`` mesh of
    tp > 1, no cache: training): inputs_embeds and the result are this
    rank's 1/tp slice [B, S/tp, H] of the sequence whose position_ids and
    segment_ids [B, S] are given whole (this rank's cp shard under cp); see
    the module docstring. Under 2-D tp (a tree bound to a tq communicator)
    the slice is [B, S/tp, H/tq]; with a cache (serving over tq) the rows
    are whole and the hidden dim the rank's 1/tq, [B, S, H/tq], in and
    out.

    parallel (cp > 1): without a cache, inputs_embeds, position_ids and
    segment_ids are this rank's sequence shard (zigzag-permuted for ring and
    hybrid) and so is the result; with a cache (this rank's slot shard) they
    are the whole chunk, the same on every rank, and so is the result.

    remat: without a cache, each layer runs again in the backward
    (remat_checkpoint): True / "full" / "vit" keep only its input (the
    counterpart of jax.checkpoint with nothing_saveable), "dots" its
    products' outputs too, "flash" the flash forward's (o, lse).

    Pipelined (a pipeline stage's tree, ``params.pp``, under a ``parallel``
    mesh of pp > 1, no cache: training): _pipelined_decoder.

    -> (final_norm(hidden) [B, S, H], the cache at length + S, or None),
    and with return_aux the MoE aux loss summed over the layers (f32, 0 for
    a dense decoder), with return_anchor the pipeline's anchor
    (parallel/pipeline.py: a zero the caller adds to its loss; a constant 0
    without pp). The cache's buffers are written in place; the returned
    KVCache shares them."""
    if parallel is not None and parallel.pp > 1 and kv_cache is None:
        return _pipelined_decoder(params, inputs_embeds, position_ids, cfg, segment_ids,
                                  attn_impl, remat, parallel, return_aux, return_anchor)
    recompute = check_remat(remat) and kv_cache is None
    seq = inputs_embeds.shape[1]
    cp = parallel.cp if parallel is not None else 1
    tp, tq = params.tp_comm, params.tq_comm
    sp = (tp is not None and kv_cache is None and parallel is not None
          and parallel.mesh.shape["tp"] * parallel.mesh.shape["tq"] > 1)
    # a cached chunk that divides by cp runs on this rank's 1/cp of its rows
    q_sharded = kv_cache is not None and cp > 1 and seq > 1 and seq % cp == 0
    if q_sharded:
        lo, hi = parallel.comm.rank * (seq // cp), (parallel.comm.rank + 1) * (seq // cp)
        inputs_embeds = inputs_embeds[:, lo:hi]
        position_ids = position_ids[:, lo:hi]
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
    moe = moe_route(params, parallel, sp, kv_cache is None or q_sharded) \
        if cfg.num_experts else None
    x = inputs_embeds
    cache_len = kv_cache.length if kv_cache is not None else None
    aux = None  # a dense decoder adds no work for it
    fs = params.fsdp
    run = decoder_layer if fs is None else functools.partial(_streamed_layer, fs)
    with streaming(params):
        for i, layer in enumerate(params.layers):
            cache_kv = None
            if kv_cache is not None:
                cache_kv = (kv_cache.k, kv_cache.v, kv_cache.k_scale, kv_cache.v_scale, i)
            args = (layer, x, cos, sin, cfg, cache_kv, cache_len, position_ids,
                    segment_ids, attn_impl, parallel, q_sharded, tp, sp, tq, moe)
            if recompute:
                x, aux_l = remat_checkpoint(run, *args, remat=remat)
            else:
                x, aux_l = run(*args)
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
    new_cache = None
    if kv_cache is not None:
        new_cache = dataclasses.replace(kv_cache, length=kv_cache.length + seq)
    hidden = rms_norm(x, params.final_norm, cfg.rms_norm_eps, tq)
    if q_sharded:
        hidden = parallel.comm.all_gather(hidden, 1)
    out = (hidden, new_cache)
    if return_aux:
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        out += (aux,)
    if return_anchor:
        out += (torch.zeros((), dtype=torch.float32, device=hidden.device),)
    return out


def _pipelined_decoder(params: Qwen2Params, inputs_embeds, position_ids, cfg: TextConfig,
                       segment_ids, attn_impl, remat, parallel: ParallelConfig, return_aux,
                       return_anchor):
    """The decoder over the pp axis (JAX's _pipelined_decoder :797-911):
    this rank runs its stage's layers (``params.pp``, a
    parallel.pipeline.Stage; ``params.layers`` its L / pp layers, or its
    ``virtual`` chunks chunk-major) in the GPipe or, with virtual > 1, the
    interleaved schedule (parallel/pipeline.run_schedule). The batch splits
    into parallel.microbatches (0: pp) microbatches of consecutive rows;
    the activation travels between stages, and each stage takes a
    microbatch's rope tables, positions and segment ids from its own copy
    (every stage holds the whole batch's position_ids and segment_ids
    [B, S]). inputs_embeds: the embeddings on the first stage (under
    sequence parallelism this rank's 1/tp slice [B, S / tp, H], the slice
    a stage's activation keeps: JAX's [B@dp, S@(cp, tp), H] inside the
    stage), None on the others. Each layer recomputes in the backward at
    the remat level (remat_checkpoint), under both schedules: JAX remats
    the interleaved schedule's whole ticks instead, only so that XLA does
    not stack the chunk's sliced weights per tick (pipeline.py:182-193),
    which eager PyTorch never does; the numbers are the same. A MoE
    layer routes each microbatch as one call (its dp shard's rows under
    expert parallelism), and the microbatch's aux travels with its
    activation (an ``aux`` leaf of the shifted tree, each stage adding its
    layers'), as JAX's carry does (:842-911). On an FSDP stage tree
    (``params.fsdp``, JAX's text_param_specs(fsdp=True, pp=True)) each
    layer runs on its weights gathered over dp in the tick that runs it
    (``_streamed_layer``, inside ``fsdp.streaming``): a microbatch's pass
    through a layer is one unit, gathered once (twice under remat: the
    recompute) and reduce-scattered once, and every dp rank of the stage
    runs the same ticks, so its gathers and scatters come in the same
    order on each. -> as qwen2_decoder: hidden
    the final-normed [B, S(/tp), H] on the last stage, None on the others;
    the MoE aux, the mean over microbatches on the last stage (JAX
    :909-911), 0 on the others; the anchor."""
    from long_vita_tpu_torch.parallel.pipeline import run_schedule

    stage = params.pp
    if stage is None:
        raise ValueError("a pp mesh runs a pipeline stage's tree "
                         "(parallel/sharding.shard_params over the mesh)")
    tp = params.tp_comm
    sp = tp is not None and parallel.mesh.shape["tp"] > 1
    b, s = position_ids.shape
    m = parallel.microbatches or stage.size
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    recompute = check_remat(remat)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)

    def split(x):
        return x.reshape(m, b // m, *x.shape[1:])

    local = {"cos": split(cos), "sin": split(sin), "pos": split(position_ids)}
    if segment_ids is not None:
        local["seg"] = split(segment_ids)
    s_x = seq_slice(s, tp.size) if sp else s
    dev = params.embed.device
    specs = {"x": ((b // m, s_x, cfg.hidden_size), params.embed.dtype, dev)}
    moe = moe_route(params, parallel, sp, False) if cfg.num_experts else None
    if moe is not None:
        specs["aux"] = ((), torch.float32, dev)

    fs = params.fsdp
    run = decoder_layer if fs is None else functools.partial(_streamed_layer, fs)

    def body(chunk, t):
        x, aux = t["x"], t.get("aux")
        for layer in chunk:
            args = (layer, x, t["cos"], t["sin"], cfg, None, None, t["pos"], t.get("seg"),
                    attn_impl, parallel, False, tp, sp, None, moe)
            x, aux_l = remat_checkpoint(run, *args, remat=remat) if recompute else run(*args)
            if aux_l is not None:
                aux = aux + aux_l
        return {"x": x} if moe is None else {"x": x, "aux": aux}

    first = None
    if stage.first:
        first = {"x": split(inputs_embeds)}
        if moe is not None:
            first["aux"] = torch.zeros((m,), dtype=torch.float32, device=dev)
    with streaming(params):
        out, anchor = run_schedule(params.layers, first, body, stage.comm, m=m,
                                   virtual=stage.virtual, specs=specs, local=local,
                                   stats=stage.stats)
    hidden = None
    aux = torch.zeros((), dtype=torch.float32, device=position_ids.device)
    if out is not None:
        hidden = rms_norm(out["x"].reshape(b, s_x, cfg.hidden_size), params.final_norm,
                          cfg.rms_norm_eps)
        if moe is not None:
            # the mean: the Switch aux does not grow with a call's tokens, so a
            # sum would scale the coefficient m-fold (JAX :908-911)
            aux = out["aux"].mean()
    result = (hidden, None)
    if return_aux:
        result += (aux,)
    if return_anchor:
        result += (anchor,)
    return result


def _streamed_layer(fs, layer: DecoderLayer, *args):
    """decoder_layer on the layer's weights gathered over dp (an FSDP
    shard, parallel/fsdp.gathered_layer)."""
    return decoder_layer(gathered_layer(layer, fs), *args)


def embed_tokens(params: Qwen2Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Row lookup. Ids past the table clamp to its last row, as the JAX
    gather does (a finished row of a ragged batch feeds back eos, which
    lies past the vocabulary of the tiny test configuration).

    On a tp shard (vocab-parallel, JAX's embed_tokens_vp :918 as GSPMD
    serves it): the id is clamped to the whole table first, each rank looks
    up the rows its slice holds with zeros elsewhere, and the rows are
    summed over tp, which is exact (one real row plus zeros). On an FSDP
    shard the table is gathered over dp first."""
    tp = params.tp_comm
    table = embed_table(params)
    n = table.shape[0]
    if tp is None:
        return F.embedding(input_ids.clamp(max=n - 1), table)
    local = input_ids.clamp(max=n * tp.size - 1) - tp.rank * n
    hit = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    return tp.all_reduce_sum(torch.where(hit[..., None], rows, torch.zeros_like(rows)))


def embed_tokens_vp(params: Qwen2Params, input_ids: torch.Tensor) -> torch.Tensor:
    """The training lookup on a tp shard (JAX :918, VocabParallelEmbedding
    with sequence parallelism): each rank looks up the ids that fall in its
    vocab slice, zeros elsewhere (an id past the whole table is zeros on
    every rank, as JAX's vp path gives, where the plain lookup clamps), and
    the partial rows are reduce-scattered over tp along the sequence
    (``scatter_seq``): -> this rank's slice [B, ceil(S/tp), H], bit for bit
    the plain rows (one real row plus zeros), the last slices ending in
    zero rows where S does not split over tp. The embedding's gradient is
    the all-gathered rows' gradient at the rank's own ids. On an FSDP shard
    the rank's tp slice of the table is gathered over dp first. On a 2-D tp
    shard the table is the rank's [V/tp, H/tq] block and the rows its
    hidden slice. Where JAX looks the ids up plainly (long_vita.py:293-301:
    under tq, on a pipeline stage, or at an S that does not split over tp)
    they are clamped to the whole table first: past the table, the last
    row."""
    tp = params.tp_comm
    table = embed_table(params)
    n = table.shape[0]
    if params.tq_comm is not None or params.pp is not None or input_ids.shape[1] % tp.size:
        input_ids = input_ids.clamp(max=n * tp.size - 1)
    local = input_ids.long() - tp.rank * n
    hit = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    return scatter_seq(torch.where(hit[..., None], rows, torch.zeros_like(rows)), tp, 1)


def lm_head(params: Qwen2Params, hidden: torch.Tensor) -> torch.Tensor:
    """Vocab logits in f32, as the JAX head's preferred_element_type=f32.

    A bf16 product rounded to bf16 before the argmax would be a different
    result, so: on CUDA the bf16 GEMM writes f32 directly (torch.mm with
    out_dtype=float32, f32 accumulation in cuBLAS; _F32Logits gives it a
    backward); elsewhere the operands are widened to f32 first, which is
    exact for bf16. A quantized head (JAX :969-982): int4 through
    w4_matmul with f32 out; int8 codes cast to the hidden dtype, the f32
    product, then the f32 scale. On a tp shard (vocab-parallel) each rank
    computes its [..., V / tp] logits and they are all-gathered over tp:
    the whole row, exactly (differentiable, Megatron's plain head: the
    hidden rows' gradient summed over tp, each rank's logits taking its
    slice of theirs; the training head of a pp mesh, JAX's rule). On an FSDP shard the weight is gathered over dp
    first (and gathered again for the backward). On a 2-D tp shard hidden
    is the rank's hidden slice and the weight its [V/tp, H/tq] block: the
    f32 partial logits are summed over tq first (JAX's plain head under
    tq, train_step.py:75-84); an int8 head's partial logits are scaled
    before that sum, and an int4 one (serving: its whole hidden dim, its
    vocabulary over tp) takes the hidden rows all-gathered over tq."""
    entry = params.lm_head
    tp, tq = params.tp_comm, params.tq_comm
    if tp is not None:
        hidden = copy_to_tp(hidden, tp)
    if isinstance(entry, QuantDense4):
        if tq is not None:  # the whole hidden dim: JAX cuts int4 by its output dim alone
            hidden, tq = tq.all_gather(hidden, -1), None
        logits = w4_matmul(hidden, entry.packed, entry.scales, out_dtype=torch.float32)
    elif isinstance(entry, QuantDense8):
        logits = _f32_logits(hidden, entry.weight_q.to(hidden.dtype)) * entry.scale
    else:
        with streaming(params):
            logits = _f32_logits(hidden, head_weight(params))
    if tq is not None:
        logits = reduce_from_tp(logits, tq)
    return logits if tp is None else gather_from_tp(logits, tp, -1)


def _f32_logits(hidden: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """hidden [..., H] x w [V, H] -> f32 logits [..., V]."""
    if w.dtype != torch.float32 and on_cuda(hidden, w):
        out = _F32Logits.apply(hidden.reshape(-1, hidden.shape[-1]), w)
        return out.reshape(*hidden.shape[:-1], w.shape[0])
    return F.linear(hidden.float(), w.float())


class _F32Logits(torch.autograd.Function):
    """flat [N, H] x weight [V, H] -> f32 logits [N, V] from one bf16 GEMM.
    torch.mm with out_dtype has no derivative, so the backward is written
    out, at the precision of JAX's transpose rule (an f32 product of the f32
    logit gradient and the bf16 operand, cast once to the operand's dtype):
    the gradient is split into two bf16 halves, hi = bf16(g) and lo =
    bf16(g - hi), which carry 16 of its 24 mantissa bits, and each product
    is the f32 sum of two bf16 GEMMs. The weight's gradient is formed
    BACKWARD_ROWS of its rows at a time: its f32 sums whole would be 5 GB
    each for the 72B's [152064, 8192] head."""

    BACKWARD_ROWS = 16384

    @staticmethod
    def forward(ctx, flat, w):
        ctx.save_for_backward(flat, w)
        return torch.mm(flat, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        flat, w = ctx.saved_tensors
        hi = g.to(w.dtype)
        lo = (g - hi.float()).to(w.dtype)

        def product(a_hi, a_lo, b, dtype):
            out = torch.empty((a_hi.shape[0], b.shape[1]), dtype=dtype, device=b.device)
            for i in range(0, a_hi.shape[0], _F32Logits.BACKWARD_ROWS):
                r = slice(i, i + _F32Logits.BACKWARD_ROWS)
                out[r] = (torch.mm(a_hi[r], b, out_dtype=torch.float32)
                          + torch.mm(a_lo[r], b, out_dtype=torch.float32))
            return out

        d_flat = product(hi, lo, w, flat.dtype) if ctx.needs_input_grad[0] else None
        d_w = product(hi.t(), lo.t(), flat, w.dtype) if ctx.needs_input_grad[1] else None
        return d_flat, d_w


def init_qwen2_params(
    generator: torch.Generator,
    cfg: TextConfig,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Qwen2Params:
    """Random init as the JAX package's (normal * 0.02 weights, zero biases,
    unit norms), drawn from ``generator`` on ``device`` (the generator's
    device when None). One layer at a time, so the f32 draws never hold
    more than one matrix beside the bf16 weights. With cfg.num_experts,
    each layer's MLP is a router and its experts (ops/moe.Experts)."""
    device = torch.device(device) if device is not None else generator.device
    h, i = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def dense(out_f, in_f, bias=False):
        w = torch.randn((out_f, in_f), generator=generator, device=device) * 0.02
        b = torch.zeros(out_f, dtype=dtype, device=device) if bias else None
        return Dense(w.to(dtype), b)

    def ones():
        return torch.ones(h, dtype=dtype, device=device)

    def mlp():
        if cfg.num_experts == 0:
            return dict(gate_proj=dense(i, h), up_proj=dense(i, h), down_proj=dense(h, i))
        from long_vita_tpu_torch.ops.moe import init_moe_params

        moe = init_moe_params(generator, cfg.num_experts, h, i, dtype, device)
        return dict(router=moe.router, experts=moe.experts)

    layers = [
        DecoderLayer(
            input_norm=ones(),
            post_attn_norm=ones(),
            q_proj=dense(hq * d, h, bias=True),
            k_proj=dense(hkv * d, h, bias=True),
            v_proj=dense(hkv * d, h, bias=True),
            o_proj=dense(h, hq * d),
            **mlp(),
        )
        for _ in range(cfg.num_hidden_layers)
    ]
    embed = torch.randn((cfg.vocab_size, h), generator=generator, device=device) * 0.02
    return Qwen2Params(
        embed=embed.to(dtype),
        layers=layers,
        final_norm=ones(),
        lm_head=dense(cfg.vocab_size, h),
    )
