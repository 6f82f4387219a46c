"""Graft a base LLM + vision tower into a fresh Long-VITA model.

Counterpart of long_vita_tpu/utils/graft.py (reference
tools/finetune_long_vita.py:480-530): stage 1 starts from a stock
Qwen2.5-Instruct checkpoint and a stock InternViT-300M checkpoint — the
vision tower is grafted on, the projector is freshly initialized, and the
embedding table is resized for the 17 multimodal tokens (vocab 152064
already has headroom, so resizing is a no-op for the released geometry).

The two checkpoints are read through utils/checkpoint_io.py; with
``out_dir`` the grafted model is also written there as one Long-VITA *_HF
directory through utils/export_hf.py. The fresh projector is drawn from a
``torch.Generator`` seeded with ``seed``: the same distribution as the JAX
package's, other numbers.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from long_vita_tpu_torch.config import LongVITAConfig, TextConfig, VisionConfig
from long_vita_tpu_torch.models.long_vita import LongVITAParams
from long_vita_tpu_torch.models.projector import init_projector_params
from long_vita_tpu_torch.utils.checkpoint_io import (
    SafetensorsIndex,
    load_text_params,
    load_vision_params,
)
from long_vita_tpu_torch.utils.convert import _target
from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint


def graft_checkpoints(
    llm_dir: str,
    vit_dir: str,
    *,
    dtype=torch.bfloat16,
    seed: int = 0,
    device="cuda",
    out_dir: Optional[str] = None,
    mesh=None,
    fsdp: bool = False,
    virtual_pp: int = 1,
) -> tuple[LongVITAParams, LongVITAConfig]:
    """-> (params, cfg) for a fresh Long-VITA from stock checkpoints.

    llm_dir: HF Qwen2-family checkpoint (config.json + safetensors).
    vit_dir: HF InternViT checkpoint (InternVisionModel naming, i.e. keys
             like `embeddings.*` / `encoder.layers.*` without the grafted
             `model.vision_model.` prefix).
    out_dir: when given, the grafted model is saved there as well.
    mesh: a parallel.mesh.Mesh with tp > 1 (or dp > 1 with fsdp, FSDP's
          cut, or pp > 1, the stage's layers, virtual_pp chunks of them):
          the decoder is this rank's shard, read slice by slice
          (utils/checkpoint_io.load_text_params); out_dir is then refused
          (export writes whole trees).
    """
    device = _target(device)
    with open(os.path.join(llm_dir, "config.json")) as f:
        llm_cfg = json.load(f)
    with open(os.path.join(vit_dir, "config.json")) as f:
        vit_cfg = json.load(f)

    text_fields = {f.name for f in dataclasses.fields(TextConfig)}
    vis_fields = {f.name for f in dataclasses.fields(VisionConfig)}
    vision = VisionConfig(**{k: v for k, v in vit_cfg.items() if k in vis_fields})
    downsample = 0.5
    cfg = LongVITAConfig(
        text=TextConfig(**{k: v for k, v in llm_cfg.items() if k in text_fields}),
        vision=vision,
        vision_downsample_ratio=downsample,
        image_token_length=int((vision.grid * downsample) ** 2),
    )

    if mesh is not None and out_dir is not None and (
            mesh.shape["tp"] * mesh.shape["tq"] > 1 or mesh.shape["pp"] > 1
            or (fsdp and mesh.shape["dp"] > 1)):
        raise ValueError("graft_checkpoints(out_dir=...) writes a whole tree; load it without "
                         "a tp, tq, pp or FSDP mesh")
    llm_idx = SafetensorsIndex(llm_dir)
    text = load_text_params(llm_idx, cfg, dtype, device=device, mesh=mesh, fsdp=fsdp,
                            virtual_pp=virtual_pp)
    llm_idx.close()

    vit_idx = SafetensorsIndex(vit_dir)
    # stock InternViT checkpoints have no grafted prefix
    prefix = (
        "model.vision_model."
        if any(k.startswith("model.vision_model.") for k in vit_idx.keys())
        else ""
    )
    vision_params = load_vision_params(vit_idx, cfg, dtype, prefix=prefix, device=device)
    vit_idx.close()

    gen = torch.Generator(device=device).manual_seed(seed)
    params = LongVITAParams(
        text=text, vision=vision_params,
        projector=init_projector_params(gen, cfg, dtype, device),
    )
    if out_dir is not None:
        save_hf_checkpoint(params, cfg, out_dir)
    return params, cfg
