"""LoRA adapters: add, merge, save and load.

Counterpart of long_vita_tpu/training/lora.py (the reference's LoRA flag
group, long_vita_megatron/training/arguments.py:263-281: --lora-r,
--lora-alpha, --lora-target-modules, --lora-load). An adapter is a
``LoraAdapter`` submodule (``lora``) of each targeted projection of every
decoder layer, in the JAX layout (a [in, r], b [r, out]), so training,
serving, speculative decoding and beam search all apply it with no
separate path (models/qwen2._with_lora). Training freezes everything but
the adapters through the optimizer's mask (optim.lora_only); merge_lora
folds W + A B * alpha / r for export.

Differences from the JAX package: A is drawn from a ``torch.Generator``
(jax.random cannot be reproduced in torch; tests carry JAX's adapters across
with utils/convert), and a module is changed in place where JAX returns a
new tree (add_lora_params, load_lora) or builds a new tree that shares the
untouched tensors (merge_lora). save_lora writes the JAX package's files
(lora_weights.npz with ``{target}.a`` [L, in, r] and ``{target}.b`` [L, r,
out], and lora_config.json); bfloat16 adapters are written as float32 (numpy
has no bfloat16; the widening is exact) and load_lora casts to ``dtype``, as
JAX's does.

On a tp shard (parallel/sharding.shard_params; the decoder's tp_comm set)
the adapters follow sharding.py's LoRA specs: ``b`` splits its out dim in
a column projection, ``a`` its in dim in a row one, the other factor
replicated. add_lora_params draws each ``a`` whole and keeps the rank's
slice, so every geometry draws the same adapters; merge_lora folds per
shard (the slice of the whole merge); save_lora gathers them over tp and
tp rank 0 writes; load_lora cuts the rank's slices. On a 2-D tp shard
(its tq_comm set too) the adapters are those of the rank's tp index, each
replicated over tq (JAX replicates them): the decoder takes the rows or
columns of its hidden slice from them (models/qwen2.py).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence, Union

import numpy as np
import torch

from long_vita_tpu_torch.config import TextConfig
from long_vita_tpu_torch.models.long_vita import LongVITAParams
from long_vita_tpu_torch.models.qwen2 import (
    DecoderLayer,
    Dense,
    LoraAdapter,
    Qwen2Params,
)

Params = Union[LongVITAParams, Qwen2Params]

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")
ALL_TARGETS = DEFAULT_TARGETS + ("gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    alpha: int = 32
    targets: Sequence[str] = DEFAULT_TARGETS


def _text(params: Params) -> Qwen2Params:
    return params.text if isinstance(params, LongVITAParams) else params


def _row_piece(name: str, t: torch.Tensor, tp) -> torch.Tensor:
    """Of a whole adapter factor, the slice a tp rank holds: ``a`` [in, r]
    of a row projection split on its in dim; everything else as it is
    (``b`` is handled by its local shape)."""
    if tp is None or name not in ("o_proj", "down_proj"):
        return t
    n = t.shape[0] // tp.size
    return t[tp.rank * n:(tp.rank + 1) * n]


def _in_out(entry) -> tuple[int, int]:
    """A projection's (in, out) features, whatever its layout."""
    if isinstance(entry, Dense):
        out_f, in_f = entry.weight.shape
        return in_f, out_f
    if hasattr(entry, "weight_q"):  # int8 codes [out, in]
        out_f, in_f = entry.weight_q.shape
        return in_f, out_f
    return 2 * entry.packed.shape[0], entry.packed.shape[1]  # packed int4 [in/2, out]


@torch.no_grad()
def add_lora_params(
    params: Params,
    cfg: TextConfig,
    lcfg: LoraConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
) -> tuple[Params, TextConfig]:
    """Attach adapters to the decoder's projections, in place: B = 0, so the
    adapted model is exactly the base model at step 0 (standard LoRA init);
    A ~ N(0, 1) / r, drawn in f32 from ``generator`` (on its device) and
    cast to ``dtype``, target by target and layer by layer. The adapters lie
    on the layer's device. On a tp shard each ``a`` is drawn whole and the
    rank keeps its slice; on an FSDP shard the adapters are whole (they
    stay replicated over dp, JAX's specs); on a pipeline stage's tree every
    layer's are drawn and the stage keeps its layers'. -> (params, cfg with
    the lora fields)."""
    text = _text(params)
    tp, fs, stage = text.tp_comm, text.fsdp, text.pp
    dp = fs.comm.size if fs is not None else 1
    # FSDP (dp) and 2-D tp (tq) cut the dim of a weight that tp leaves whole
    dp *= text.tq_comm.size if text.tq_comm is not None else 1
    # the decoder's layers in drawing order, None where another stage holds it
    layers = list(text.layers)
    if stage is not None:
        local = dict(zip(stage.layers(), layers))
        layers = [local.get(g) for g in range(stage.n_layers)]
    for t in lcfg.targets:
        if t not in ALL_TARGETS:
            raise ValueError(f"lora target {t!r} not in decoder layers (dense targets: {ALL_TARGETS})")
    for t in lcfg.targets:
        template = getattr(text.layers[0], t)
        for layer in layers:
            entry = getattr(layer, t) if layer is not None else template
            d_in, d_out = _in_out(entry)
            if tp is not None and t in ("o_proj", "down_proj"):
                d_in *= tp.size  # the whole input dim of a row projection
            # FSDP and tq cut a column weight's input dim and a row weight's output dim
            if t in ("o_proj", "down_proj"):
                d_out *= dp
            else:
                d_in *= dp
            dev = text.layers[0].input_norm.device
            a = torch.randn((d_in, lcfg.r), generator=generator, device=generator.device,
                            dtype=torch.float32) / lcfg.r
            if layer is None:
                continue
            a = _row_piece(t, a, tp)
            entry.lora = LoraAdapter(a.to(dev, dtype),
                                     torch.zeros((lcfg.r, d_out), dtype=dtype, device=dev))
    return params, dataclasses.replace(cfg, lora_r=lcfg.r, lora_alpha=lcfg.alpha)


@torch.no_grad()
def merge_lora(params: Params, cfg: TextConfig) -> Params:
    """Fold every adapter into its base weight: W + (A B)^T * alpha / r in
    f32, cast back to W's dtype. -> a new params tree without adapters that
    shares every other tensor with ``params`` (export, merged serving). On
    a tp shard the rank's slice of the whole merge, a shard of the same
    tp_comm."""
    if cfg.lora_r == 0:
        return params
    if (_text(params).fsdp is not None or _text(params).pp is not None
            or _text(params).tq_comm is not None):
        raise ValueError("merge_lora takes a whole tree or a tp shard; gather an FSDP shard, a "
                         "2-D tp shard or a pipeline stage's tree first "
                         "(parallel/sharding.gather_params)")
    scale = cfg.lora_alpha / cfg.lora_r
    text = _text(params)
    layers = []
    for layer in text.layers:
        projs = {}
        for name in ALL_TARGETS:
            entry = getattr(layer, name)
            if entry.lora is None:
                projs[name] = entry
                continue
            if not isinstance(entry, Dense):
                raise ValueError(f"merge_lora folds into dense weights, not {type(entry).__name__}")
            w = entry.weight
            delta = (entry.lora.a.float() @ entry.lora.b.float()) * scale  # [in, out]
            projs[name] = Dense((w.float() + delta.t()).to(w.dtype), entry.bias)
        layers.append(DecoderLayer(input_norm=layer.input_norm,
                                   post_attn_norm=layer.post_attn_norm, **projs))
    new_text = Qwen2Params(embed=text.embed, layers=layers, final_norm=text.final_norm,
                           lm_head=text.lm_head)
    new_text.tp_comm = text.tp_comm
    if isinstance(params, LongVITAParams):
        return LongVITAParams(text=new_text, vision=params.vision, projector=params.projector)
    return new_text


def lora_subtree(params: Params) -> dict[str, dict[str, torch.Tensor]]:
    """The adapters alone (the --lora-load artifact): target -> {"a": [L,
    in, r], "b": [L, r, out]}, stacked over the layers as the JAX tree."""
    out = {}
    layers = _text(params).layers
    for t in ALL_TARGETS:
        entries = [getattr(layer, t).lora for layer in layers]
        if entries and entries[0] is not None:
            out[t] = {"a": torch.stack([e.a.detach() for e in entries]),
                      "b": torch.stack([e.b.detach() for e in entries])}
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _adapters(params: Params, cfg: TextConfig) -> dict[str, dict[str, torch.Tensor]]:
    """lora_subtree of the whole tree; of a tp shard, the adapters gathered
    over tp first (every tp rank calls it)."""
    from long_vita_tpu_torch.parallel.sharding import gather_named, leaf_layout

    text = _text(params)
    tp = text.tp_comm
    if text.pp is not None:
        raise ValueError("the adapters of a pipeline stage's tree: gather it first "
                         "(parallel/sharding.gather_params)")
    if tp is None:
        return lora_subtree(params)
    layout = leaf_layout(text, cfg, tp.rank, tp.size)
    whole = gather_named({n: p for n, p in text.named_parameters() if ".lora." in n},
                         layout, tp)
    out = {}
    for t in ALL_TARGETS:
        keys = [f"layers.{i}.{t}.lora." for i in range(len(text.layers))]
        if keys and keys[0] + "a" in whole:
            out[t] = {f: torch.stack([whole[k + f] for k in keys]) for f in ("a", "b")}
    return out


def save_lora(path: str, params: Params, cfg: TextConfig, lcfg: LoraConfig) -> None:
    """Write the adapters as lora_weights.npz + lora_config.json. On a tp
    shard every tp rank calls it: the adapters are gathered over tp and tp
    rank 0 writes (of a 2-D shard, tq rank 0 of it)."""
    tp, tq = _text(params).tp_comm, _text(params).tq_comm
    adapters = _adapters(params, cfg)
    if (tp is not None and tp.rank != 0) or (tq is not None and tq.rank != 0):
        return
    os.makedirs(path, exist_ok=True)
    flat = {}
    for t, ab in adapters.items():
        flat[f"{t}.a"] = _host(ab["a"])
        flat[f"{t}.b"] = _host(ab["b"])
    np.savez(os.path.join(path, "lora_weights.npz"), **flat)
    with open(os.path.join(path, "lora_config.json"), "w") as f:
        json.dump({"r": lcfg.r, "alpha": lcfg.alpha, "targets": list(lcfg.targets)}, f)


@torch.no_grad()
def load_lora(path: str, params: Params, cfg: TextConfig,
              dtype: torch.dtype = torch.float32) -> tuple[Params, TextConfig]:
    """Attach the adapters of a save_lora directory (either package's) to
    ``params`` in place, cast to ``dtype``, on each layer's device.
    -> (params, cfg with the directory's r and alpha)."""
    with open(os.path.join(path, "lora_config.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "lora_weights.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    layers = _text(params).layers
    tp = _text(params).tp_comm
    if _text(params).pp is not None:
        raise ValueError("load_lora takes a whole tree or a tp shard, not a pipeline stage's")
    for t in meta["targets"]:
        a, b = arrays[f"{t}.a"], arrays[f"{t}.b"]
        if a.shape[0] != len(layers):
            raise ValueError(f"{t}: adapters for {a.shape[0]} layers, the model has {len(layers)}")
        for i, layer in enumerate(layers):
            dev = layer.input_norm.device
            b_i = torch.from_numpy(np.array(b[i]))
            if tp is not None and t not in ("o_proj", "down_proj"):
                # a column projection's b: the rank's slice of its out dim
                # (the local projection's width; whole kv heads at tp > Hkv)
                from long_vita_tpu_torch.parallel.sharding import leaf_rule

                leaf = leaf_rule(f"layers.{i}.{t}.lora.b", 1, tp.rank, tp.size,
                                 cfg.num_key_value_heads)
                n = b_i.shape[1] // leaf.pieces
                b_i = b_i[:, leaf.index * n:(leaf.index + 1) * n]
            getattr(layer, t).lora = LoraAdapter(
                _row_piece(t, torch.from_numpy(np.array(a[i])), tp).to(dev, dtype),
                b_i.to(dev, dtype),
            )
    return params, dataclasses.replace(cfg, lora_r=meta["r"], lora_alpha=meta["alpha"])
