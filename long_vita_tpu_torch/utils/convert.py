"""Weights from the JAX package into the port's modules.

``params_from_jax`` takes the JAX decoder's parameter tree with its arrays
already on the host as numpy (``jax.tree.map(np.asarray, params)`` on the
caller's side; this module imports no JAX) and builds a ``Qwen2Params``;
``long_vita_params_from_jax`` does the same for the whole VLM tree
({"text", "vision", "projector"}) and builds a ``LongVITAParams``:

  - the stacked ``[L, ...]`` layer arrays are split per layer;
  - each dense kernel ``[in, out]`` is transposed to ``nn.Linear``'s
    ``[out, in]``;
  - bfloat16 arrays (numpy dtype ``bfloat16`` from ml_dtypes) travel as a
    ``uint16`` view and are reinterpreted as ``torch.bfloat16``, bit for bit.

``set_requires_grad`` turns gradients on and off as the JAX training step
differentiates the same tree.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from long_vita_tpu_torch.models.intern_vit import (
    LayerNormParams,
    VisionParams,
    VitEmbeddings,
    VitLayer,
)
from long_vita_tpu_torch.models.long_vita import LongVITAParams
from long_vita_tpu_torch.models.projector import ProjectorParams
from long_vita_tpu_torch.models.qwen2 import Dense, DecoderLayer, Qwen2Params

_QUANT_OR_LORA = ("kernel_q", "kernel_p4", "lora")


def _tensor(arr, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous host copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device).contiguous()


def params_from_jax(
    tree: dict[str, Any], device=None, dtype: Optional[torch.dtype] = None
) -> Qwen2Params:
    """JAX qwen2 tree (or a LongVITA tree with a "text" entry) of numpy
    arrays -> Qwen2Params on ``device``, cast to ``dtype`` when given."""
    tree = tree.get("text", tree)
    layers = tree["layers"]
    for name, entry in layers.items():
        if isinstance(entry, dict) and any(key in entry for key in _QUANT_OR_LORA):
            raise NotImplementedError(
                f"layers.{name} is quantized or carries LoRA adapters; the port "
                "takes dense kernels only (ROADMAP: port queue, w8a16/w4 with K6)"
            )
    if "router" in layers:
        raise NotImplementedError("MoE layers are ported later (ROADMAP: the rest)")

    def t(arr):
        return _tensor(arr, device, dtype)

    def dense(name, i, bias=False):
        entry = layers[name]
        w = t(np.asarray(entry["kernel"][i]).T)  # [in, out] -> [out, in]
        return Dense(w, t(entry["bias"][i]) if bias else None)

    n_layers = np.asarray(layers["input_norm"]).shape[0]
    out_layers = [
        DecoderLayer(
            input_norm=t(layers["input_norm"][i]),
            post_attn_norm=t(layers["post_attn_norm"][i]),
            q_proj=dense("q_proj", i, bias=True),
            k_proj=dense("k_proj", i, bias=True),
            v_proj=dense("v_proj", i, bias=True),
            o_proj=dense("o_proj", i),
            gate_proj=dense("gate_proj", i),
            up_proj=dense("up_proj", i),
            down_proj=dense("down_proj", i),
        )
        for i in range(n_layers)
    ]
    return Qwen2Params(
        embed=t(tree["embed"]["embedding"]),
        layers=out_layers,
        final_norm=t(tree["final_norm"]),
        lm_head=Dense(t(np.asarray(tree["lm_head"]["kernel"]).T)),
    )


def vision_params_from_jax(
    tree: dict[str, Any], device=None, dtype: Optional[torch.dtype] = None
) -> VisionParams:
    """JAX InternViT tree (``params["vision"]``) -> VisionParams."""

    def t(arr):
        return _tensor(arr, device, dtype)

    emb, layers = tree["embeddings"], tree["layers"]

    def dense(entry, i=None):
        kernel, bias = entry["kernel"], entry["bias"]
        if i is not None:
            kernel, bias = kernel[i], bias[i]
        return Dense(t(np.asarray(kernel).T), t(bias))  # [in, out] -> [out, in]

    def norm(name, i):
        return LayerNormParams(t(layers[name]["scale"][i]), t(layers[name]["bias"][i]))

    n_layers = np.asarray(layers["ls1"]).shape[0]
    return VisionParams(
        embeddings=VitEmbeddings(
            patch_embed=dense(emb["patch_embed"]),
            cls_token=t(emb["cls_token"]),
            pos_embed=t(emb["pos_embed"]),
        ),
        layers=[
            VitLayer(
                norm1=norm("norm1", i), qkv=dense(layers["qkv"], i),
                proj=dense(layers["proj"], i), ls1=t(layers["ls1"][i]),
                norm2=norm("norm2", i), fc1=dense(layers["fc1"], i),
                fc2=dense(layers["fc2"], i), ls2=t(layers["ls2"][i]),
            )
            for i in range(n_layers)
        ],
    )


def projector_params_from_jax(
    tree: dict[str, Any], device=None, dtype: Optional[torch.dtype] = None
) -> ProjectorParams:
    """JAX projector tree (``params["projector"]``) -> ProjectorParams."""

    def t(arr):
        return _tensor(arr, device, dtype)

    return ProjectorParams(
        pre_norm=LayerNormParams(t(tree["pre_norm"]["scale"]), t(tree["pre_norm"]["bias"])),
        fc1=Dense(t(np.asarray(tree["fc1"]["kernel"]).T)),
        fc2=Dense(t(np.asarray(tree["fc2"]["kernel"]).T)),
    )


def long_vita_params_from_jax(
    tree: dict[str, Any], device=None, dtype: Optional[torch.dtype] = None
) -> LongVITAParams:
    """JAX LongVITA tree {"text", "vision", "projector"} of numpy arrays ->
    LongVITAParams on ``device``, cast to ``dtype`` when given."""
    return LongVITAParams(
        text=params_from_jax(tree["text"], device, dtype),
        vision=vision_params_from_jax(tree["vision"], device, dtype),
        projector=projector_params_from_jax(tree["projector"], device, dtype),
    )


def set_requires_grad(
    params: LongVITAParams, *, freeze_text: bool = False, freeze_vision: bool = False
) -> None:
    """requires_grad per parameter, as the JAX training step takes
    gradients (train_step.py:61-68, trainer.py:186-194, optimizer.py:52-71):

      - freeze_text: the text tree sits behind jax.lax.stop_gradient, so its
        weights get no gradient: off (activation gradients still flow
        through the decoder);
      - freeze_vision: the tower's features are stop_gradient'd (the tower
        runs under torch.no_grad here): off for the tower;
      - everything else is on, the projector always: a leaf frozen only by
        the optimizer's mask (freeze_projector, freeze_embed) keeps its
        gradient, which clip_by_global_norm and the grad_norm metric count,
        and takes a zero update."""
    for name, p in params.named_parameters():
        if name.startswith("text."):
            p.requires_grad_(not freeze_text)
        elif name.startswith("vision."):
            p.requires_grad_(not freeze_vision)
        else:
            p.requires_grad_(True)
