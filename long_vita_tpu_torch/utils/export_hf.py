"""Export the port's parameters back to HF LongVITA safetensors.

Counterpart of long_vita_tpu/utils/export_hf.py, the reverse of
utils/checkpoint_io.py (the reference's mcore->HF direction,
tools/hf2mcore_long_vita.py:374-517): the same names, shapes and dtypes, the
same 4 GiB shards in the same order (``model.safetensors`` alone, or
``model-0000i-of-0000n.safetensors`` with ``model.safetensors.index.json``),
and the same config.json, written through the port's own safetensors writer
(checkpoint_io.save_safetensors), one tensor at a time from the device.
"""
from __future__ import annotations

import json
import os
from typing import Union

import torch

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.models.long_vita import LongVITAParams
from long_vita_tpu_torch.models.qwen2 import Dense, Qwen2Params
from long_vita_tpu_torch.utils.checkpoint_io import save_safetensors

_SHARD_BYTES = 4 * 1024**3


def _w(entry) -> torch.Tensor:
    if not isinstance(entry, Dense):
        raise ValueError(
            f"export takes dense weights, not {type(entry).__name__}: export the "
            "parameters before weight quantization"
        )
    return entry.weight


def flatten_to_hf(
    params: Union[LongVITAParams, Qwen2Params], cfg: LongVITAConfig
) -> dict[str, torch.Tensor]:
    """The port's modules -> an HF-named state dict of tensors on their
    device (views where the layout already is HF's), in the JAX exporter's
    order."""
    out: dict[str, torch.Tensor] = {}
    t = params.text if isinstance(params, LongVITAParams) else params
    out["model.embed_tokens.weight"] = t.embed
    out["model.norm.weight"] = t.final_norm
    out["lm_head.weight"] = _w(t.lm_head)
    for i, layer in enumerate(t.layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = layer.input_norm
        out[p + "post_attention_layernorm.weight"] = layer.post_attn_norm
        for name in ("q_proj", "k_proj", "v_proj"):
            out[p + f"self_attn.{name}.weight"] = _w(getattr(layer, name))
            out[p + f"self_attn.{name}.bias"] = getattr(layer, name).bias
        out[p + "self_attn.o_proj.weight"] = _w(layer.o_proj)
        for name in ("gate_proj", "up_proj", "down_proj"):
            out[p + f"mlp.{name}.weight"] = _w(getattr(layer, name))

    if isinstance(params, LongVITAParams):
        emb = params.vision.embeddings
        vp = "model.vision_model."
        out[vp + "embeddings.class_embedding"] = emb.cls_token
        out[vp + "embeddings.position_embedding"] = emb.pos_embed[None]
        p_sz = cfg.vision.patch_size
        kern = emb.patch_embed.weight  # [H, p*p*3] in (kh, kw, c) order
        out[vp + "embeddings.patch_embedding.weight"] = (
            kern.reshape(-1, p_sz, p_sz, 3).permute(0, 3, 1, 2)
        )
        out[vp + "embeddings.patch_embedding.bias"] = emb.patch_embed.bias
        for i, layer in enumerate(params.vision.layers):
            p = f"{vp}encoder.layers.{i}."
            out[p + "ls1"] = layer.ls1
            out[p + "ls2"] = layer.ls2
            out[p + "norm1.weight"] = layer.norm1.scale
            out[p + "norm1.bias"] = layer.norm1.bias
            out[p + "norm2.weight"] = layer.norm2.scale
            out[p + "norm2.bias"] = layer.norm2.bias
            for hf, entry in (("attn.qkv", layer.qkv), ("attn.proj", layer.proj),
                              ("mlp.fc1", layer.fc1), ("mlp.fc2", layer.fc2)):
                out[p + hf + ".weight"] = _w(entry)
                out[p + hf + ".bias"] = entry.bias

        proj = params.projector
        pp = "model.vision_projection."
        out[pp + "pre_proj_layernorm.weight"] = proj.pre_norm.scale
        out[pp + "pre_proj_layernorm.bias"] = proj.pre_norm.bias
        out[pp + "mlp.0.weight"] = _w(proj.fc1)
        out[pp + "mlp.2.weight"] = _w(proj.fc2)
    return out


def hf_config(cfg: LongVITAConfig) -> dict:
    """config.json in the HF LongVITA schema."""
    t, v = cfg.text, cfg.vision
    out = {
        "architectures": ["LongVITAForCausalLM"],
        "model_type": "long_vita",
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads,
        "rms_norm_eps": t.rms_norm_eps,
        "rope_theta": t.rope_theta,
        "max_position_embeddings": t.max_position_embeddings,
        "tie_word_embeddings": t.tie_word_embeddings,
        "bos_token_id": t.bos_token_id,
        "eos_token_id": t.eos_token_id,
        "hidden_act": "silu",
        "torch_dtype": "bfloat16",
        "use_cache": True,
    }
    if v is not None:
        out["visual"] = {
            "architectures": ["InternVisionModel"],
            "model_type": "intern_vit_6b",
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_hidden_layers,
            "num_attention_heads": v.num_attention_heads,
            "image_size": v.image_size,
            "patch_size": v.patch_size,
            "layer_norm_eps": v.layer_norm_eps,
            "hidden_act": "gelu",
            "norm_type": "layer_norm",
            "qkv_bias": True,
            "qk_normalization": False,
        }
    return out


def save_hf_checkpoint(
    params: Union[LongVITAParams, Qwen2Params], cfg: LongVITAConfig, out_dir: str,
    tokenizer=None,
) -> None:
    """Write sharded safetensors + index + config.json (+ tokenizer)."""
    os.makedirs(out_dir, exist_ok=True)
    if tokenizer is not None:
        tokenizer.save_pretrained(out_dir)
    sd = flatten_to_hf(params, cfg)

    # shard by size, in order
    shards: list[dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for name, t in sd.items():
        nbytes = t.numel() * t.element_size()
        if sizes[-1] + nbytes > _SHARD_BYTES and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += nbytes

    weight_map = {}
    n = len(shards)
    for i, shard in enumerate(shards):
        fname = "model.safetensors" if n == 1 else f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        save_safetensors(shard, os.path.join(out_dir, fname))
        for name in shard:
            weight_map[name] = fname
    if n > 1:
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map},
                      f, indent=2)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=2)
