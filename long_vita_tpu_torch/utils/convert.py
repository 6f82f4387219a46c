"""Weights from the JAX package into the port's modules.

``params_from_jax`` takes the JAX decoder's parameter tree with its arrays
already on the host as numpy (``jax.tree.map(np.asarray, params)`` on the
caller's side; this module imports no JAX) and builds a ``Qwen2Params``;
``long_vita_params_from_jax`` does the same for the whole VLM tree
({"text", "vision", "projector"}) and builds a ``LongVITAParams``;
``generic_vit_from_jax`` takes a generic tower's tree
(models/generic_vit.py: CLIP, SigLIP, EVA):

  - the stacked ``[L, ...]`` layer arrays are split per layer;
  - each dense kernel ``[in, out]`` is transposed to ``nn.Linear``'s
    ``[out, in]``;
  - a serving tree quantized by the JAX package's models/quantize.py comes
    across as it is: int8 entries ({kernel_q, scale}) as ``QuantDense8``
    with the codes transposed to ``[out, in]``, packed int4 entries
    ({kernel_p4, scale4}) as ``QuantDense4`` in the JAX layout; codes and
    scales keep their dtypes (``dtype`` casts only float weights);
  - a projection's LoRA adapters ({"lora": {"a": [L, in, r], "b": [L, r,
    out]}}) come across per layer as its ``LoraAdapter``, in the JAX layout
    (the model applies them when its cfg's lora_r is set);
  - a MoE layer's router kernel [H, E] comes across as a ``Dense`` [E, H]
    and its experts (gate, up [E, H, I], down [E, I, H]) in the JAX layout
    as ``ops.moe.Experts``;
  - bfloat16 arrays (numpy dtype ``bfloat16`` from ml_dtypes) travel as a
    ``uint16`` view and are reinterpreted as ``torch.bfloat16``, bit for bit.

The tensors land on the card (``device="cuda"``) unless the caller passes
another device, ``device="cpu"`` included; on a machine without a card the
default raises rather than building a model that would serve on the host.

``jax_path`` is the way back, the name map of the port's training
checkpoints (training/checkpoint.py): a parameter's name -> its JAX path, the
row of the stacked ``[L, ...]`` leaf that holds it, and whether the port
holds it transposed (a dense ``weight`` [out, in] is the JAX ``kernel`` [in,
out]). It covers every tree these functions build from a float JAX tree:
the decoder (LoRA ``a``/``b`` and a MoE layer's ``router`` and ``experts``
included), the InternViT tower and the projector.

``set_requires_grad`` turns gradients on and off as the JAX training step
differentiates the same tree.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from long_vita_tpu_torch.models.generic_vit import (
    GenericViTConfig,
    GenericViTLayer,
    GenericViTParams,
)
from long_vita_tpu_torch.models.intern_vit import (
    LayerNormParams,
    VisionParams,
    VitEmbeddings,
    VitLayer,
)
from long_vita_tpu_torch.models.long_vita import LongVITAParams
from long_vita_tpu_torch.models.projector import ProjectorParams
from long_vita_tpu_torch.models.qwen2 import (
    DecoderLayer,
    Dense,
    LoraAdapter,
    QuantDense4,
    QuantDense8,
    Qwen2Params,
)
from long_vita_tpu_torch.ops.moe import Experts


def _target(device) -> torch.device:
    """The device the tensors go to; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the converted weights go to the card by default; "
            "pass device='cpu' to build them on the host"
        )
    return device


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
    tree: dict[str, Any], device="cuda", dtype: Optional[torch.dtype] = None
) -> Qwen2Params:
    """JAX qwen2 tree (or a LongVITA tree with a "text" entry) of numpy
    arrays -> Qwen2Params on ``device``, cast to ``dtype`` when given."""
    device = _target(device)
    tree = tree.get("text", tree)
    layers = tree["layers"]

    def t(arr):
        return _tensor(arr, device, dtype)

    def kept(arr):  # int8 codes and f32 scales keep their dtype
        return _tensor(arr, device, None)

    def projection(entry, i=None, bias=False):
        def at(key):
            return np.asarray(entry[key] if i is None else entry[key][i])

        b = t(at("bias")) if bias else None
        lora = None
        if "lora" in entry:  # a [in, r], b [r, out]: the layout the port keeps
            ab = entry["lora"]
            lora = LoraAdapter(t(ab["a"][i]), t(ab["b"][i]))
        if "kernel_q" in entry:  # codes [in, out] -> [out, in]
            return QuantDense8(kept(at("kernel_q").T), kept(at("scale")), b, lora)
        if "kernel_p4" in entry:
            return QuantDense4(kept(at("kernel_p4")), kept(at("scale4")), b, lora)
        return Dense(t(at("kernel").T), b, lora)  # [in, out] -> [out, in]

    def mlp(i):
        if "router" not in layers:
            return dict(gate_proj=projection(layers["gate_proj"], i),
                        up_proj=projection(layers["up_proj"], i),
                        down_proj=projection(layers["down_proj"], i))
        ex = layers["experts"]
        return dict(router=projection(layers["router"], i),
                    experts=Experts(t(ex["gate"][i]), t(ex["up"][i]), t(ex["down"][i])))

    n_layers = np.asarray(layers["input_norm"]).shape[0]
    out_layers = [
        DecoderLayer(
            input_norm=t(layers["input_norm"][i]),
            post_attn_norm=t(layers["post_attn_norm"][i]),
            q_proj=projection(layers["q_proj"], i, bias=True),
            k_proj=projection(layers["k_proj"], i, bias=True),
            v_proj=projection(layers["v_proj"], i, bias=True),
            o_proj=projection(layers["o_proj"], i),
            **mlp(i),
        )
        for i in range(n_layers)
    ]
    return Qwen2Params(
        embed=t(tree["embed"]["embedding"]),
        layers=out_layers,
        final_norm=t(tree["final_norm"]),
        lm_head=projection(tree["lm_head"]),
    )


def vision_params_from_jax(
    tree: dict[str, Any], device="cuda", dtype: Optional[torch.dtype] = None
) -> VisionParams:
    """JAX InternViT tree (``params["vision"]``) -> VisionParams."""
    device = _target(device)

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
    tree: dict[str, Any], device="cuda", dtype: Optional[torch.dtype] = None
) -> ProjectorParams:
    """JAX projector tree (``params["projector"]``) -> ProjectorParams."""
    device = _target(device)

    def t(arr):
        return _tensor(arr, device, dtype)

    return ProjectorParams(
        pre_norm=LayerNormParams(t(tree["pre_norm"]["scale"]), t(tree["pre_norm"]["bias"])),
        fc1=Dense(t(np.asarray(tree["fc1"]["kernel"]).T)),
        fc2=Dense(t(np.asarray(tree["fc2"]["kernel"]).T)),
    )


def generic_vit_from_jax(
    tree: dict[str, Any], cfg: GenericViTConfig, device="cuda",
    dtype: Optional[torch.dtype] = None,
) -> GenericViTParams:
    """JAX generic-tower tree (models/generic_vit.py's pytree) ->
    GenericViTParams on ``device``, cast to ``dtype`` when given."""
    device = _target(device)

    def t(arr):
        return _tensor(arr, device, dtype)

    def dense(entry, i=None):
        kernel, bias = entry["kernel"], entry["bias"]
        if i is not None:
            kernel, bias = kernel[i], bias[i]
        return Dense(t(np.asarray(kernel).T), t(bias))  # [in, out] -> [out, in]

    def norm(entry, i=None):
        scale, bias = entry["scale"], entry["bias"]
        return LayerNormParams(t(scale if i is None else scale[i]),
                               t(bias if i is None else bias[i]))

    layers = tree["layers"]
    return GenericViTParams(
        patch_embed=dense(tree["patch_embed"]),
        pos_embed=t(tree["pos_embed"]),
        cls_token=t(tree["cls_token"]) if cfg.add_class_token else None,
        pre_norm=norm(tree["pre_norm"]) if cfg.pre_layernorm else None,
        final_norm=norm(tree["final_norm"]) if cfg.final_layernorm else None,
        layers=[
            GenericViTLayer(
                norm1=norm(layers["norm1"], i), qkv=dense(layers["qkv"], i),
                proj=dense(layers["proj"], i), norm2=norm(layers["norm2"], i),
                fc1=dense(layers["fc1"], i), fc2=dense(layers["fc2"], i),
                ls1=t(layers["ls1"][i]) if cfg.use_layer_scale else None,
                ls2=t(layers["ls2"][i]) if cfg.use_layer_scale else None,
            )
            for i in range(cfg.num_hidden_layers)
        ],
    )


def long_vita_params_from_jax(
    tree: dict[str, Any], device="cuda", dtype: Optional[torch.dtype] = None
) -> LongVITAParams:
    """JAX LongVITA tree {"text", "vision", "projector"} of numpy arrays ->
    LongVITAParams on ``device``, cast to ``dtype`` when given."""
    return LongVITAParams(
        text=params_from_jax(tree["text"], device, dtype),
        vision=vision_params_from_jax(tree["vision"], device, dtype),
        projector=projector_params_from_jax(tree["projector"], device, dtype),
    )


def jax_path(name: str) -> tuple[tuple[str, ...], Optional[int], bool]:
    """A port parameter's name -> (its leaf's path in the JAX tree, the row
    of the stacked [L, ...] leaf that holds it or None, whether the port
    holds it transposed): ``text.layers.3.q_proj.weight`` -> (("text",
    "layers", "q_proj", "kernel"), 3, True); ``text.embed`` -> (("text",
    "embed", "embedding"), None, False)."""
    parts = name.split(".")
    layer = None
    if "layers" in parts:
        k = parts.index("layers")
        layer = int(parts.pop(k + 1))
    if parts[-1] == "embed":
        parts.append("embedding")
    transpose = parts[-1] == "weight"
    if transpose:
        parts[-1] = "kernel"
    return tuple(parts), layer, transpose


def port_name(path: tuple, layer: Optional[int]) -> tuple[str, bool]:
    """jax_path's inverse: a JAX leaf's path and row -> (the port
    parameter's name, whether the port holds it transposed)."""
    parts = list(path)
    if parts[-1] == "embedding":
        parts.pop()
    transposed = parts[-1] == "kernel"
    if transposed:
        parts[-1] = "weight"
    if layer is not None:
        parts.insert(parts.index("layers") + 1, str(layer))
    return ".".join(parts), transposed


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
