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

The batch slices (JAX ``batch_spec`` :165, P(dp, cp), and
``activation_spec`` :170) are ``rank_rows`` and ``rank_seq``.
"""
from __future__ import annotations

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
    MoE layers have no tp layout in the port (qwen2.check_moe_mesh)."""
    specs: Specs = {"embed": 0, "final_norm": None, "lm_head.weight": 0}
    for i, layer in enumerate(params.layers):
        p = f"layers.{i}."
        specs[p + "input_norm"] = specs[p + "post_attn_norm"] = None
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


def shard_params(params, mesh: Mesh, cfg):
    """This rank's tree over ``mesh``'s tp axis (JAX :153): a new
    LongVITAParams or Qwen2Params of the same classes whose tensors are the
    rank's slices of ``params`` (views where the slice is a view; K6's int4
    column slices are contiguous copies), the decoder bound to
    ``mesh.tp_comm`` (``Qwen2Params.tp_comm``). ``params`` stays as it is.
    Quantise the whole tree before sharding it: int8's per-column scale is
    a max over the whole input dim. ``cfg`` (a LongVITAConfig or
    TextConfig) gives the kv heads, and validate_geometry runs on it
    first. tp 1 returns ``params``."""
    from long_vita_tpu_torch.models.long_vita import LongVITAParams
    from long_vita_tpu_torch.models.qwen2 import check_moe_mesh

    tp = mesh.shape["tp"]
    if tp == 1:
        return params
    text_cfg = getattr(cfg, "text", cfg)
    validate_geometry(text_cfg, MeshConfig(tp=tp))
    check_moe_mesh(text_cfg, tp=tp)
    specs = long_vita_param_specs(params)
    t_rank, hkv = mesh.tp_index, text_cfg.num_key_value_heads
    # whole kv heads: with tp > Hkv, the k/v projections split into Hkv
    # pieces and rank t takes the piece of its q heads' kv head
    kv_pieces, kv_index = (hkv, t_rank // (tp // hkv)) if tp > hkv else (tp, t_rank)
    tensors = {}
    for name, t in params.named_parameters():
        dim = specs[name]
        if dim is None:
            tensors[name] = t
            continue
        kv = ".k_proj." in name or ".v_proj." in name
        piece = _piece(t, dim, kv_index if kv else t_rank, kv_pieces if kv else tp)
        if name.endswith((".packed", ".scales")):
            piece = piece.contiguous()  # K6 reads contiguous codes and scales
        tensors[name] = piece
    local = _rebuild(params, tensors)
    (local.text if isinstance(local, LongVITAParams) else local).tp_comm = mesh.tp_comm
    return local


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
