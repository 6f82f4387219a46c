"""Which rank holds which slice: parameters over tp, batches over dp and cp.

Counterpart of long_vita_tpu/parallel/sharding.py. JAX annotates each weight
with a PartitionSpec (``text_param_specs`` :33, ``long_vita_param_specs``
:125), places the tree with ``shard_params`` (:153), and GSPMD inserts the
Megatron collectives. The port has no compiler to insert them, so a spec
here names the torch dim of each parameter that shards over tp (None:
replicated), ``shard_params`` cuts this rank's tree from the whole one, and
models/qwen2.py calls the collectives itself on the tree's ``tp_comm``:

  - column-parallel (q, k, v, gate, up; their biases): the rank's slice of
    the output dim, torch dim 0 of an ``[out, in]`` weight (JAX's
    ``[in, out]`` dim -1);
  - row-parallel (o_proj, down_proj): the slice of the input dim, torch
    dim 1; one all_reduce_sum over tp follows the product;
  - the embedding and the head: the vocab dim (vocab-parallel lookup summed
    over tp, logits all-gathered over tp);
  - norms, the vision tower and the projector: replicated (the tower's
    tiles shard over the mesh instead, models/long_vita.encode_images).

Where tp exceeds the kv heads (tp % Hkv == 0), rank t holds q heads [t *
Hq / tp, (t + 1) * Hq / tp) and the one kv head that group reads, so a kv
head is replicated over tp / Hkv ranks (GSPMD would cut it into parts of a
head). Quantised trees take models/quantize.quantized_param_specs on top.

Training (JAX shards the train state with the same specs,
train_step.py:267-297) takes ``shard_params(..., own=True)``: each shard a
leaf tensor with its own storage, so that the whole tree can be dropped
(serving keeps views). ``leaf_layout`` is the per-leaf table the gradient
reduction and the global norm read: a leaf is replicated (its gradient is
partial on each rank under sequence parallelism and summed over the world),
sharded over tp (summed over dp x cp), or a kv slice shared by tp // Hkv
ranks (summed over those and dp x cp). ``gather_params`` / ``gather_named``
put shards back together (checkpoints, LoRA files, tests);
``shard_named`` cuts a whole name -> tensor dict (a checkpoint) the same
way, and ``slice_leaf`` cuts one tensor (the per-rank checkpoint loader,
utils/checkpoint_io.py).

FSDP (JAX ``text_param_specs(fsdp=True)`` :39-79: ZeRO-3 weight
streaming) cuts one more dim of each decoder weight over dp, the one tp
leaves whole (``fsdp_dim``; torch's ``[out, in]``): a column weight's
input dim (torch dim 1), a row weight's output dim (dim 0), the norms;
the embedding and the head their vocabulary into tp x dp pieces, piece t
* dp + d on rank (t, d) (JAX's ``(AXIS_TP, AXIS_DP)``), so the dp gather
gives the rank's tp slice. Biases, final_norm, the tower, the projector
and LoRA's adapters stay as they were. ``shard_params(..., fsdp=True)``
cuts such a tree and binds ``Qwen2Params.fsdp`` (parallel/fsdp.py
gathers a layer's weights before it runs); a Leaf then carries its dp
piece too, and ``gather_named`` gathers over dp before tp.

Pipeline stages (JAX ``text_param_specs(pp=True)``: the layer dim over
pp) keep a stage's layers alone in the rank's tree, its L / pp layers or,
for the interleaved schedule, its virtual chunks chunk-major
(parallel/pipeline.stage_layers), named by their local index
(``layers.0`` ...) and bound to ``Qwen2Params.pp`` (a
parallel.pipeline.Stage); every other leaf is whole on every stage. A
Leaf of a stage's layer carries its global layer (``pp_layer``):
``shard_named`` takes a checkpoint's tensors of those global names and
``gather_named`` gathers the stages' layers back under them, so that a
checkpoint is written and read by global layer whatever the schedule. FSDP inside
pipeline stages (JAX ``text_param_specs(fsdp=True, pp=True)``: ``col =
P(pp, dp, tp)``, ``row = P(pp, tp, dp)``, norms ``P(pp, dp)``) cuts each of
the stage's layers over dp as FSDP alone cuts a layer (its layers by pp,
then each layer's ``fsdp_dim`` over dp); the embedding and the head keep
their (tp, dp) cut on every stage, the first stage gathering the one and
the last the other. ``shard_named`` and ``gather_named`` move whole
tensors to and from that layout over dp, then tp, then pp.

A MoE layer (JAX ``text_param_specs(moe=True)`` :88-97) keeps its router
replicated and cuts its experts' intermediate dim over tp like the dense
MLP (gate and up [E, H, I] along I, torch dim 2; down [E, I, H] along I,
dim 1), and at dp > 1 their expert dim (dim 0) over dp: expert
parallelism, piece d on dp rank d (``Leaf.ep``, ``ep_index``), bound to
``Qwen2Params.ep_comm`` (the mesh's dp communicator). Under FSDP the dense
leaves of a MoE layer stream over dp as a dense layer's do, while the
expert stacks keep dp for EP and are never gathered (parallel/fsdp.py).
Checkpoints gather the experts over dp and tp into the one-device format.

2-D tensor parallelism (JAX ``text_param_specs(tp2d=True)`` :57-79: the
tq axis) cuts the other matrix dim of each decoder weight over tq
(``tq_dim``; torch's ``[out, in]``): a column weight's input dim (torch
dim 1, JAX's ``[L, in@tq, out@tp]``), a row weight's output dim (dim 0,
``[L, in@tp, out@tq]``), the embedding's and the head's hidden dim (dim 1,
``[V@tp, H@tq]`` and ``[H@tq, V@tp]``); piece q on tq rank q. Biases, the
norms, LoRA's adapters, the tower and the projector stay replicated over
tq, as in JAX; a bias (and a LoRA factor cut over tp) is used after the
sum over tq, the same on every tq rank (``Leaf.tq_same``), where a norm
(and the rest) is used on the rank's hidden slice. kv heads keep the
whole-head rule over tp. ``shard_params`` binds ``Qwen2Params.tq_comm``
(and ``tp_comm``, a LocalComm at tp 1), and gathers go over tq as well.
Serving takes the same cuts, and a quantised tree JAX's adapter of them
(``long_vita_tq_specs``, quantize.quantized_tq_specs); FSDP, pp and MoE
do not compose with tq (validate_geometry).

The batch slices (JAX ``batch_spec`` :165, P(dp, cp), and
``activation_spec`` :170) are ``rank_rows`` and ``rank_seq``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from long_vita_tpu_torch.parallel.mesh import Mesh, MeshConfig, validate_geometry

Specs = dict[str, Optional[int]]  # parameter name -> the torch dim sharded over tp

COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")


def text_param_specs(params) -> Specs:
    """The decoder's specs, by ``named_parameters`` name of its dense layout
    (``layers.{i}.q_proj.weight``; a quantised tree takes
    quantize.quantized_param_specs on top). A LoRA adapter follows its
    projection: ``b`` [r, out] splits its out dim in a column projection,
    ``a`` [in, r] its in dim in a row one; the other factor is replicated.
    A MoE layer's router is replicated and its experts split their
    intermediate dim (gate and up dim 2, down dim 1; JAX :88-97)."""
    specs: Specs = {"embed": 0, "final_norm": None, "lm_head.weight": 0}
    for i, layer in enumerate(params.layers):
        p = f"layers.{i}."
        specs[p + "input_norm"] = specs[p + "post_attn_norm"] = None
        if hasattr(layer, "router"):
            specs[p + "router.weight"] = None
            specs[p + "experts.gate"] = specs[p + "experts.up"] = 2
            specs[p + "experts.down"] = 1
        for name, split in [(n, "col") for n in COLUMN] + [(n, "row") for n in ROW]:
            entry = getattr(layer, name, None)
            if entry is None:
                continue
            col = split == "col"
            specs[f"{p}{name}.weight"] = 0 if col else 1
            if entry.bias is not None:
                specs[f"{p}{name}.bias"] = 0 if col else None
            if entry.lora is not None:
                specs[f"{p}{name}.lora.a"] = None if col else 0
                specs[f"{p}{name}.lora.b"] = 1 if col else None
    if params.lm_head.bias is not None:
        specs["lm_head.bias"] = 0
    return specs


def long_vita_param_specs(params) -> Specs:
    """Specs of a whole tree: a LongVITAParams (the tower and projector
    replicated) or a Qwen2Params; a quantised decoder's entries through
    quantized_param_specs (JAX :125-150)."""
    from long_vita_tpu_torch.models.long_vita import LongVITAParams
    from long_vita_tpu_torch.models.quantize import quantized_param_specs

    lv = isinstance(params, LongVITAParams)
    text = params.text if lv else params
    specs = quantized_param_specs(text, text_param_specs(text))
    if not lv:
        return specs
    out = {f"text.{k}": v for k, v in specs.items()}
    for name, _ in params.named_parameters():
        if not name.startswith("text."):
            out[name] = None
    return out


def _piece(t: torch.Tensor, dim: int, index: int, pieces: int) -> torch.Tensor:
    """Piece ``index`` of ``pieces`` equal slices of t's dim ``dim``: a view
    (contiguous for dim 0 of a contiguous tensor, strided otherwise)."""
    n = t.shape[dim]
    if n % pieces:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {pieces} pieces")
    return t.narrow(dim, index * (n // pieces), n // pieces)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """Where one parameter lies over tp: ``dim`` the torch dim cut into
    ``pieces`` equal slices (None: replicated over tp), ``index`` the slice
    this rank holds, and ``share`` the tp ranks that hold that same slice
    (tp // Hkv for a kv projection at tp > Hkv, else 1); under FSDP, of
    that slice, piece ``dp_index`` of ``dp`` along ``fsdp_dim`` (None: not
    cut over dp); over pp, ``pp_layer`` the global layer of a leaf of the
    stage's layers (None: a leaf every stage holds); under 2-D tp, piece
    ``tq_index`` of ``tq`` along ``tq_dim`` (None: replicated over tq), and
    ``tq_same`` for a leaf replicated over tq that the tq ranks use after
    their sum, all in the same way (a bias): its gradient is the same on
    each; under expert parallelism, of a MoE layer's expert stack, piece
    ``ep_index`` of ``ep`` along the expert dim (dim 0; ep 1: whole).

    Who sums a leaf's gradient over which ranks (train_step._Reduction)
    and how it counts in grad_norm (optimizer.tp_global_norm): a leaf cut
    over tp, over every rank that holds its slice (dp x cp); a replicated
    one, partial on each rank, over the world; an expert stack, over cp
    alone: the exchange's backward brought every dp rank's tokens to its
    owner, so its gradient there is the whole dp sum already, and it
    counts once per owner (summed over dp and tp in the norm, as an FSDP
    piece). The router is replicated and summed like any replicated
    leaf (its gradient is partial over tp too: its gates multiply the
    experts' tp-partial outputs)."""

    dim: Optional[int]
    pieces: int = 1
    index: int = 0
    share: int = 1
    fsdp_dim: Optional[int] = None
    dp: int = 1
    dp_index: int = 0
    pp_layer: Optional[int] = None
    tq_dim: Optional[int] = None
    tq: int = 1
    tq_index: int = 0
    tq_same: bool = False
    ep: int = 1
    ep_index: int = 0

    @property
    def sharded(self) -> bool:
        """Cut over tp."""
        return self.dim is not None

    @property
    def fsdp(self) -> bool:
        """Cut over dp."""
        return self.fsdp_dim is not None

    @property
    def staged(self) -> bool:
        """A layer of this rank's pipeline stage (cut over pp)."""
        return self.pp_layer is not None

    @property
    def cut_tq(self) -> bool:
        """Cut over tq (2-D tp)."""
        return self.tq_dim is not None

    @property
    def expert(self) -> bool:
        """An expert stack cut over dp (expert parallelism)."""
        return self.ep > 1

    @property
    def partial(self) -> bool:
        """Replicated over tp and tq and used on the rank's slice of the
        sequence or of the hidden dim: its gradient on a rank is a part of
        the whole one, summed over every rank that holds it."""
        return not (self.sharded or self.cut_tq or self.tq_same or self.expert)


def layer_of(name: str) -> Optional[int]:
    """The layer index in a decoder parameter's name (``text.layers.3.
    q_proj.weight`` or ``layers.3.q_proj.weight``), or None."""
    parts = name.removeprefix("text.").split(".")
    return int(parts[1]) if len(parts) > 2 and parts[0] == "layers" else None


def renamed(name: str, layer: int) -> str:
    """``name`` with its layer index replaced by ``layer``."""
    head, rest = name.split("layers.", 1)
    return f"{head}layers.{layer}.{rest.split('.', 1)[1]}"


def leaf_rule(name: str, dim: Optional[int], tp_index: int, tp: int, hkv: int,
              fsdp_dim: Optional[int] = None, dp_index: int = 0, dp: int = 1,
              tq_dim: Optional[int] = None, tq_index: int = 0, tq: int = 1, ep: int = 1,
              ep_index: int = 0) -> Leaf:
    """The Leaf of parameter ``name`` whose spec is ``dim``, on tp rank
    ``tp_index`` of ``tp`` (and, with ``fsdp_dim``, dp rank ``dp_index`` of
    ``dp``; with ``tq_dim``, tq rank ``tq_index`` of ``tq``): whole kv
    heads, so with tp > Hkv a k/v projection splits into Hkv pieces and
    rank t takes the piece of its q heads' kv head. Nothing is cut over an
    axis of one rank. Under tq > 1 a leaf with a tp spec that tq leaves
    whole is ``tq_same``. With ``ep`` > 1 an expert stack is cut over dp
    (piece ``ep_index``)."""
    fs = dict(fsdp_dim=fsdp_dim, dp=dp, dp_index=dp_index) if fsdp_dim is not None and dp > 1 \
        else {}
    if tq > 1:
        fs.update(dict(tq_dim=tq_dim, tq=tq, tq_index=tq_index) if tq_dim is not None
                  else dict(tq_same=dim is not None))
    if ep > 1 and ".experts." in name:
        fs.update(ep=ep, ep_index=ep_index)
    if dim is None or tp == 1:
        return Leaf(None, **fs)
    if tp > hkv and (".k_proj." in name or ".v_proj." in name):
        share = tp // hkv
        return Leaf(dim, hkv, tp_index // share, share, **fs)
    return Leaf(dim, tp, tp_index, **fs)


def fsdp_dim(name: str) -> Optional[int]:
    """The torch dim FSDP cuts over dp of a dense decoder parameter, by its
    name in the tree (``text.layers.3.o_proj.weight``, or without
    ``text.`` in a Qwen2Params): a column weight's 1, a row weight's 0, a
    norm's, the embedding's and the head's 0; None for everything else
    (biases, final_norm, LoRA, the tower and the projector)."""
    if name.startswith(("vision.", "projector.")):
        return None
    name = name.removeprefix("text.")
    if name in ("embed", "lm_head.weight"):
        return 0
    parts = name.split(".")
    if len(parts) == 3 and parts[0] == "layers" and parts[2] in ("input_norm",
                                                                  "post_attn_norm"):
        return 0
    if len(parts) == 4 and parts[0] == "layers" and parts[3] == "weight":
        if parts[2] in COLUMN:
            return 1
        if parts[2] in ROW:
            return 0
    return None


def tq_dim(name: str) -> Optional[int]:
    """The torch dim 2-D tp cuts over tq of a decoder parameter, by its name
    in the tree (``text.layers.3.o_proj.weight``, or without ``text.``):
    the one FSDP cuts over dp (a column weight's input, 1; a row weight's
    output, 0), but the embedding's and the head's hidden dim (1) where
    FSDP cuts their vocabulary, and no norm; None for everything else
    (biases, norms, LoRA, the tower and the projector: replicated)."""
    if name.removeprefix("text.") in ("embed", "lm_head.weight"):
        return 1
    return None if name.endswith("_norm") else fsdp_dim(name)


def dense_spec(name: str) -> Optional[int]:
    """The spec of a dense parameter of the decoder by its name in the tree
    (``text.layers.3.o_proj.weight``; no LoRA, no quantisation): what
    text_param_specs gives such a tree, for a loader that has no tree yet."""
    if name.endswith(("embed", "lm_head.weight", "lm_head.bias")):
        return 0
    for proj in COLUMN:
        if f".{proj}." in name:
            return 0
    for proj in ROW:
        if f".{proj}.weight" in name:
            return 1
    return None


def long_vita_tq_specs(params) -> Specs:
    """Every parameter's tq dim (``tq_dim``, by name; None: replicated over
    tq), a quantised decoder's entries through
    quantize.quantized_tq_specs."""
    from long_vita_tpu_torch.models.long_vita import LongVITAParams
    from long_vita_tpu_torch.models.quantize import quantized_tq_specs

    lv = isinstance(params, LongVITAParams)
    text = params.text if lv else params
    specs = quantized_tq_specs(text, {n: tq_dim(n) for n, _ in text.named_parameters()})
    if not lv:
        return specs
    out = {f"text.{k}": v for k, v in specs.items()}
    out.update({n: None for n, _ in params.named_parameters() if not n.startswith("text.")})
    return out


def leaf_layout(params, cfg, tp_index: int, tp: int, dp_index: int = 0,
                dp: int = 1, stage=None, tq_index: int = 0, tq: int = 1,
                ep: int = 1) -> dict[str, Leaf]:
    """name -> Leaf for every parameter of ``params`` (a whole tree or a
    shard: the names and specs are the same) on tp rank ``tp_index``, and
    with dp > 1 FSDP's dp rank ``dp_index`` of ``dp``, with tq > 1 2-D tp's
    tq rank ``tq_index`` of ``tq``; with ``stage`` (a
    parallel.pipeline.Stage, the tree that stage's) each leaf of local
    layer i carries the global layer stage.layers()[i]. ``cfg``: a
    LongVITAConfig or TextConfig (the kv heads). ep > 1: the expert stacks
    are cut over that many dp ranks, this rank's piece ``dp_index``."""
    hkv = getattr(cfg, "text", cfg).num_key_value_heads
    ids = stage.layers() if stage is not None else None
    tq_dims = long_vita_tq_specs(params) if tq > 1 else {}
    out = {}
    for name, dim in long_vita_param_specs(params).items():
        leaf = leaf_rule(name, dim, tp_index, tp, hkv, fsdp_dim(name), dp_index, dp,
                         tq_dims.get(name), tq_index, tq, ep, dp_index)
        i = layer_of(name) if ids is not None else None
        out[name] = dataclasses.replace(leaf, pp_layer=ids[i]) if i is not None else leaf
    return out


def _text(params):
    return getattr(params, "text", params)


def rank_layout(params, cfg, mesh: Mesh) -> Optional[dict[str, Leaf]]:
    """The layout of a rank's tree as it is cut: over tp when it is bound
    to a tp communicator, over tq when it is bound to a tq one (2-D tp),
    over dp when it is FSDP-sharded (``Qwen2Params.fsdp``), over pp when it
    is a pipeline stage's (``Qwen2Params.pp``), its experts over dp under
    expert parallelism (``Qwen2Params.ep_comm``); None for a whole tree."""
    text = _text(params)
    tp = mesh.shape["tp"] if text.tp_comm is not None else 1
    tq = mesh.shape["tq"] if text.tq_comm is not None else 1
    dp = mesh.shape["dp"] if text.fsdp is not None else 1
    ep = mesh.shape["dp"] if text.ep_comm is not None else 1
    if tp == 1 and tq == 1 and dp == 1 and ep == 1 and text.pp is None:
        return None
    return leaf_layout(params, cfg, mesh.tp_index, tp, mesh.dp_index, dp, text.pp,
                       mesh.tq_index, tq, ep)


def slice_leaf(t: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    """This rank's slice of a whole tensor (a view; t itself when
    replicated): its tp piece, of that its tq piece, then its dp piece."""
    if leaf.dim is not None:
        t = _piece(t, leaf.dim, leaf.index, leaf.pieces)
    if leaf.expert:
        t = _piece(t, 0, leaf.ep_index, leaf.ep)
    if leaf.tq_dim is not None:
        t = _piece(t, leaf.tq_dim, leaf.tq_index, leaf.tq)
    if leaf.fsdp_dim is not None:
        t = _piece(t, leaf.fsdp_dim, leaf.dp_index, leaf.dp)
    return t


def stage_tree(params, layers: list):
    """A shallow copy of ``params`` (a LongVITAParams or Qwen2Params) whose
    decoder holds ``layers`` (its other modules and every tensor shared)."""
    import copy

    from long_vita_tpu_torch.models.long_vita import LongVITAParams

    text = copy.copy(_text(params))
    text._modules = {**text._modules, "layers": torch.nn.ModuleList(layers)}
    if not isinstance(params, LongVITAParams):
        return text
    new = copy.copy(params)
    new._modules = {**params._modules, "text": text}
    return new


def shard_params(params, mesh: Mesh, cfg, *, own: bool = False, fsdp: bool = False,
                 virtual_pp: int = 1):
    """This rank's tree over ``mesh``'s tp axis (JAX :153): a new
    LongVITAParams or Qwen2Params of the same classes whose tensors are the
    rank's slices of ``params`` (views where the slice is a view; K6's int4
    column slices are contiguous copies), the decoder bound to
    ``mesh.tp_comm`` (``Qwen2Params.tp_comm``). ``params`` stays as it is.
    Quantise the whole tree before sharding it: int8's per-column scale is
    a max over the whole input dim. ``cfg`` (a LongVITAConfig or
    TextConfig) gives the kv heads, and validate_geometry runs on it
    first. own (training): every tensor, replicated ones too, is a
    contiguous copy with its own storage, so that nothing of ``params`` is
    kept alive by the shard. fsdp (training, dp > 1): the decoder's
    weights are cut over dp too (see the module docstring) and the tree is
    bound to ``parallel.fsdp.Fsdp(mesh.dp_comm)``; a dense tree only. Over
    pp (training, JAX's ``text_param_specs(pp=True)``: the layer dim over
    pp) the decoder keeps the stage's layers alone, ``virtual_pp`` chunks
    of them chunk-major (parallel/pipeline.stage_layers), and is bound to
    ``parallel.pipeline.Stage(mesh.pp_comm, L, virtual_pp)``
    (``Qwen2Params.pp``); every other leaf is whole on every stage; with
    fsdp the stage's layers are cut over dp too. Over tq (JAX's ``tp2d``,
    training and serving) the decoder's weights are cut over tq too
    (``long_vita_tq_specs``: a quantised tree's codes, scales and packed
    int4 as JAX's adapter cuts them) and the tree is bound to
    ``mesh.tq_comm`` (and to ``mesh.tp_comm`` at tp 1 too, a LocalComm).
    A MoE tree at dp > 1 has its
    experts cut over dp (expert parallelism) and is bound to
    ``mesh.dp_comm`` (``Qwen2Params.ep_comm``). tp 1 without FSDP, EP, pp
    or tq returns ``params``."""
    from long_vita_tpu_torch.models.long_vita import LongVITAParams
    from long_vita_tpu_torch.models.qwen2 import check_moe_mesh
    from long_vita_tpu_torch.parallel.fsdp import Fsdp
    from long_vita_tpu_torch.parallel.pipeline import Stage

    tp, dp, pp = mesh.shape["tp"], mesh.shape["dp"] if fsdp else 1, mesh.shape["pp"]
    tq = mesh.shape["tq"]
    text_cfg = getattr(cfg, "text", cfg)
    ep = mesh.shape["dp"] if text_cfg.num_experts and mesh.shape["dp"] > 1 else 1
    if tp == 1 and dp == 1 and pp == 1 and tq == 1 and ep == 1:
        return params
    validate_geometry(text_cfg, MeshConfig(dp=dp, pp=pp, tp=tp, tq=tq), virtual_pp=virtual_pp,
                      fsdp=fsdp)
    check_moe_mesh(text_cfg, dp=mesh.shape["dp"], tp=tp, pp=pp, tq=tq)
    quantised = any(n.endswith((".weight_q", ".packed")) for n, _ in params.named_parameters())
    if quantised and dp > 1:
        raise ValueError("FSDP shards a dense tree (training); this one is quantised")
    stage = None
    if pp > 1:
        stage = Stage(mesh.pp_comm, len(_text(params).layers), virtual_pp)
        params = stage_tree(params, [_text(params).layers[g] for g in stage.layers()])
    layout = leaf_layout(params, text_cfg, mesh.tp_index, tp, mesh.dp_index, dp, stage,
                         mesh.tq_index, tq, ep)
    tensors = {}
    for name, t in params.named_parameters():
        piece = slice_leaf(t.detach(), layout[name])
        if own:
            piece = piece.clone(memory_format=torch.contiguous_format)
        elif name.endswith((".packed", ".scales")) and (layout[name].sharded
                                                         or layout[name].cut_tq):
            piece = piece.contiguous()  # K6 reads contiguous codes and scales
        tensors[name] = piece
    local = _rebuild(params, tensors)
    text = local.text if isinstance(local, LongVITAParams) else local
    text.tp_comm = mesh.tp_comm if tp > 1 or tq > 1 else None
    text.tq_comm = mesh.tq_comm if tq > 1 else None
    text.fsdp = Fsdp(mesh.dp_comm) if dp > 1 else None
    text.pp = stage
    text.ep_comm = mesh.dp_comm if ep > 1 else None
    return local


def shard_named(tensors: dict, layout: dict[str, Leaf]) -> dict:
    """A whole name -> tensor dict (a checkpoint's) -> this rank's slices
    (views) of the names in ``layout``; other names pass whole. A layout
    of a pipeline stage takes the tensors of its layers' global names under
    its local ones (in the layout's order) and drops the other stages'."""
    if not any(leaf.staged for leaf in layout.values()):
        return {n: slice_leaf(t, layout[n]) if n in layout else t for n, t in tensors.items()}
    out = {}
    for n, leaf in layout.items():
        src = renamed(n, leaf.pp_layer) if leaf.staged else n
        if src in tensors:
            out[n] = slice_leaf(tensors[src], leaf)
    out.update({n: t for n, t in tensors.items() if n not in layout and layer_of(n) is None})
    return out


def gather_named(tensors: dict, layout: dict[str, Leaf], tp_comm, *, device=None,
                 keep: bool = True, dp_comm=None, stage=None, tq_comm=None) -> Optional[dict]:
    """Shards (name -> this rank's slice) -> the whole tensors, leaf by leaf
    in ``tensors``' order (every tp rank, and under FSDP every dp rank,
    under 2-D tp every tq rank, calls it with the same names): an FSDP leaf
    is all-gathered over ``dp_comm`` along its fsdp_dim first, a leaf cut
    over tq over ``tq_comm`` along its tq_dim, a tp-sharded one then over
    ``tp_comm`` along its dim, and of a slice that ``share`` ranks hold one
    copy is kept (an expert stack is all-gathered over ``dp_comm`` along
    its expert dim first); a layer of a pipeline ``stage`` is then all-gathered over
    its pp communicator (every stage calls it with its local names) and
    kept under each stage's global name (the one-device order). Each whole
    tensor is moved to ``device`` (default: where it was gathered) before
    the next leaf is gathered. keep False: the gathers run, nothing is
    kept, and None is returned (the ranks other than a checkpoint's
    writer)."""
    out = {} if keep else None
    for name, t in tensors.items():
        leaf = layout.get(name, Leaf(None))
        whole = t.detach()
        if leaf.expert:
            whole = dp_comm.all_gather(whole.contiguous(), 0)
        if leaf.fsdp:
            whole = dp_comm.all_gather(whole.contiguous(), leaf.fsdp_dim)
        if leaf.cut_tq:
            whole = tq_comm.all_gather(whole.contiguous(), leaf.tq_dim)
        if leaf.sharded and tp_comm.size > 1:
            whole = tp_comm.all_gather(whole.contiguous(), leaf.dim)
            if leaf.share > 1:
                parts = torch.chunk(whole, tp_comm.size, leaf.dim)[::leaf.share]
                whole = torch.cat(parts, leaf.dim)
        named = [(name, whole)]
        if leaf.staged:
            i = layer_of(name)
            parts = stage.comm.all_gather(whole[None].contiguous(), 0)
            named = [(renamed(name, stage.layers(p)[i]), parts[p]) for p in range(stage.size)]
        if keep:
            for n, w in named:
                out[n] = w.to(device) if device is not None else w.clone()
    return out


def gather_params(local, mesh: Mesh, cfg, *, device=None):
    """A rank's shard (shard_params) -> the whole tree, every tp (and FSDP
    dp, tq, and pp) rank the same one (a pipeline stage's layers back in
    canonical order), on ``device`` (default: the shard's), bound to
    no communicator (checkpoints, export). A whole tree is returned as it
    is."""
    layout = rank_layout(local, cfg, mesh)
    if layout is None:
        return local
    named = dict(local.named_parameters())
    stage = _text(local).pp
    gathered = gather_named(named, layout, mesh.tp_comm, device=device, dp_comm=mesh.dp_comm,
                            stage=stage, tq_comm=mesh.tq_comm)
    if stage is not None:  # a template of the whole decoder's layers
        local = stage_tree(local, [_text(local).layers[0]] * stage.n_layers)
    whole = _rebuild(local, gathered)
    text = _text(whole)
    text.tp_comm = text.tq_comm = text.fsdp = text.pp = text.ep_comm = None
    return whole


def _rebuild(module, tensors: dict, prefix: str = ""):
    """A module tree of the same classes and structure as ``module`` whose
    parameters are ``tensors`` (by ``named_parameters`` name); its other
    attributes are shared."""
    import copy

    new = copy.copy(module)
    new._parameters = {
        n: None if p is None else torch.nn.Parameter(tensors[prefix + n], requires_grad=False)
        for n, p in module._parameters.items()
    }
    new._modules = {n: None if m is None else _rebuild(m, tensors, f"{prefix}{n}.")
                    for n, m in module._modules.items()}
    return new


def rank_rows(mesh: Mesh, batch: int) -> slice:
    """The rows of a [batch, ...] array this rank holds: its dp index's
    1/dp of them."""
    dp = mesh.shape["dp"]
    if batch % dp:
        raise ValueError(f"batch {batch} % dp {dp} != 0")
    per = batch // dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def rank_seq(mesh: Mesh, seq_len: int) -> slice:
    """The positions of a [B, seq_len, ...] array this rank holds: its cp
    index's contiguous 1/cp of the (zigzag-permuted) sequence."""
    cp = mesh.shape["cp"]
    if seq_len % cp:
        raise ValueError(f"sequence {seq_len} % cp {cp} != 0")
    per = seq_len // cp
    return slice(mesh.cp_index * per, (mesh.cp_index + 1) * per)
