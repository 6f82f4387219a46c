"""Weights from the JAX package into the port's modules.

``params_from_jax`` takes the JAX decoder's parameter tree with its arrays
already on the host as numpy (``jax.tree.map(np.asarray, params)`` on the
caller's side; this module imports no JAX) and builds a ``Qwen2Params``:

  - the stacked ``[L, ...]`` layer arrays are split per layer;
  - each dense kernel ``[in, out]`` is transposed to ``nn.Linear``'s
    ``[out, in]``;
  - bfloat16 arrays (numpy dtype ``bfloat16`` from ml_dtypes) travel as a
    ``uint16`` view and are reinterpreted as ``torch.bfloat16``, bit for bit.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

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
