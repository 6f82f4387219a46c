"""HF checkpoint loaders for the alternative vision towers.

Counterpart of long_vita_tpu/utils/vision_loaders.py: standard HF
``CLIPVisionModel`` / ``SiglipVisionModel`` safetensors (``vision_model.
embeddings.*``, ``.self_attn.{q,k,v}_proj``, ...) straight into the
``models/generic_vit.py`` modules, read with the port's own
``SafetensorsIndex``. As the reference's converters do:

  - CLIP: ln_pre kept, ln_post and visual.proj dropped
    (ckpt_converter_clip.py:39,59-62);
  - SigLIP: post_layernorm, the attention-pool head and the text tower
    dropped (ckpt_converter_siglip.py:80-88);
  - EVA has no loader in the reference (its script names a module that is
    not in the tree): ``init_generic_vit_params(generator, eva_4b())``.

q, k and v are concatenated in that order along the output rows (the
tower's ``qkv.reshape(b, s, 3, nh, d)`` split), and the patch conv [out, 3,
p, p] becomes the patchify GEMM's weight [out, p*p*3] in (kh, kw, c) order,
as checkpoint_io.load_vision_params does. Weights land on the card unless
``device`` says otherwise.
"""
from __future__ import annotations

import json
import os

import torch

from long_vita_tpu_torch.models.generic_vit import (
    GenericViTConfig,
    GenericViTLayer,
    GenericViTParams,
)
from long_vita_tpu_torch.models.intern_vit import LayerNormParams
from long_vita_tpu_torch.models.qwen2 import Dense
from long_vita_tpu_torch.utils.checkpoint_io import SafetensorsIndex
from long_vita_tpu_torch.utils.convert import _target


def _prefix(idx: SafetensorsIndex) -> str:
    return "vision_model." if any(k.startswith("vision_model.") for k in idx.keys()) else ""


def _patchify(idx: SafetensorsIndex, name: str, device, dtype) -> torch.Tensor:
    """conv [out, 3, p, p] -> [out, p*p*3] in (kh, kw, c) order."""
    conv = idx.get(name).to(device)
    return conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1).to(dtype).contiguous()


def _encoder_layers(idx, cfg: GenericViTConfig, pre: str, device, dtype) -> list:
    def t(name):
        return idx.tensor(name, device, dtype)

    def dense(p, name):
        return Dense(t(p + name + ".weight"), t(p + name + ".bias"))

    def norm(p, name):
        return LayerNormParams(t(p + name + ".weight"), t(p + name + ".bias"))

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"{pre}encoder.layers.{i}."
        qkv = Dense(*(torch.cat([t(f"{p}self_attn.{x}_proj.{kind}") for x in "qkv"], 0)
                      for kind in ("weight", "bias")))
        layers.append(GenericViTLayer(
            norm1=norm(p, "layer_norm1"), qkv=qkv, proj=dense(p, "self_attn.out_proj"),
            norm2=norm(p, "layer_norm2"), fc1=dense(p, "mlp.fc1"), fc2=dense(p, "mlp.fc2"),
        ))
    return layers


def load_clip_vit_params(path: str, cfg: GenericViTConfig, dtype=torch.bfloat16,
                         device="cuda") -> GenericViTParams:
    """HF CLIPVisionModel checkpoint directory -> GenericViTParams. Expects
    ``pre_layernorm=True, final_layernorm=False`` (ln_post is dropped, as by
    the reference's converter); OpenAI CLIP's patch conv has no bias."""
    device = _target(device)
    idx = SafetensorsIndex(path)
    pre = _prefix(idx)

    def t(name):
        return idx.tensor(name, device, dtype)

    params = GenericViTParams(
        patch_embed=Dense(_patchify(idx, pre + "embeddings.patch_embedding.weight", device, dtype),
                          torch.zeros(cfg.hidden_size, dtype=dtype, device=device)),
        cls_token=t(pre + "embeddings.class_embedding").reshape(1, 1, cfg.hidden_size),
        pos_embed=t(pre + "embeddings.position_embedding.weight"),
        # HF spells it "pre_layrnorm" (sic)
        pre_norm=LayerNormParams(t(pre + "pre_layrnorm.weight"), t(pre + "pre_layrnorm.bias")),
        layers=_encoder_layers(idx, cfg, pre, device, dtype),
    )
    idx.close()
    return params


def load_siglip_vit_params(path: str, cfg: GenericViTConfig, dtype=torch.bfloat16,
                           device="cuda") -> GenericViTParams:
    """HF SiglipVisionModel checkpoint directory -> GenericViTParams; no CLS
    token; post_layernorm, the head and a text tower are ignored."""
    device = _target(device)
    idx = SafetensorsIndex(path)
    pre = _prefix(idx)
    params = GenericViTParams(
        patch_embed=Dense(
            _patchify(idx, pre + "embeddings.patch_embedding.weight", device, dtype),
            idx.tensor(pre + "embeddings.patch_embedding.bias", device, dtype)),
        pos_embed=idx.tensor(pre + "embeddings.position_embedding.weight", device, dtype),
        layers=_encoder_layers(idx, cfg, pre, device, dtype),
    )
    idx.close()
    return params


def vit_config_from_hf(path: str, family: str) -> GenericViTConfig:
    """A GenericViTConfig from an HF config.json (a vision config, or a
    two-tower one with a ``vision_config`` entry); family "clip" | "siglip"."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    hf = hf.get("vision_config", hf)
    common = dict(
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        image_size=hf["image_size"],
        patch_size=hf.get("patch_size", 14),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-6),
    )
    if family == "clip":
        return GenericViTConfig(**common, add_class_token=True, pre_layernorm=True,
                                hidden_act=hf.get("hidden_act", "quick_gelu"))
    if family == "siglip":
        act = hf.get("hidden_act", "gelu_pytorch_tanh")
        return GenericViTConfig(**common, add_class_token=False,
                                hidden_act="gelu_tanh" if act == "gelu_pytorch_tanh" else act)
    raise ValueError(f"unknown vision family {family!r} (clip|siglip)")
