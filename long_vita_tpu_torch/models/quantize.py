"""Weight-only quantization for serving: int8 (w8a16) and int4 (w4a16).

Counterpart of long_vita_tpu/models/quantize.py. The text decoder's seven
projections and the head are quantized; the embedding, norms, biases, LoRA
adapters and the vision tower and projector stay as they are. MoE trees are refused, as in
the JAX package (its :74-75).

  - int8: per-output-channel symmetric codes, scale = max|w| / 127 over the
    contraction dim (``QuantDense8``: codes [out, in] in nn.Linear
    orientation, scale f32 [out]);
  - int4: split-half packed codes with a scale per (128-row input group,
    output column), scale = max|w_group| / 7, codes clipped to -8..7
    (``QuantDense4``: packed int8 [in/2, out] and f32 scales [in/128, out],
    the JAX package's layout, read by K6).

The JAX package quantizes on the host with numpy (``*_host``), so that a
16 GB TPU v5e never holds the bf16 and quantized trees together. One H100
holds both, so the port quantizes matrix by matrix on the parameters'
device: the peak is the parameters plus one matrix's temporaries. The codes
and scales equal numpy's bit for bit: f32 division (by a tensor: PyTorch's
CUDA division by a Python scalar multiplies by its reciprocal, which can
differ in the last bit), round half to even as ``np.rint``, the same clips. Each function returns a new tree that shares
every unquantized tensor with the input and leaves the input untouched.
``quantized_param_specs`` adapts the tensor-parallel specs of
parallel/sharding.py to a quantised tree (JAX :159-193), and
``quantized_tq_specs`` the 2-D layout's tq dims (serving over tq).
"""
from __future__ import annotations

from typing import Union

import torch

from long_vita_tpu_torch.models.long_vita import LongVITAParams
from long_vita_tpu_torch.models.qwen2 import (
    DecoderLayer,
    Dense,
    QuantDense4,
    QuantDense8,
    Qwen2Params,
)
from long_vita_tpu_torch.ops.quant_matmul import GROUP

# the seven dense projections of a decoder layer
PROJ_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)

Params = Union[LongVITAParams, Qwen2Params]


def quantize_kernel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[out, in] -> (int8 codes [out, in], f32 scale [out]): per output
    channel, scale = max|w| / 127 over in (1 where the row is all zero), so
    x @ dequant(q).T == (x @ q.T) * scale."""
    wf = w.float()
    a = wf.abs().amax(dim=-1)
    scale = torch.where(a > 0, a / a.new_tensor(127.0), torch.ones_like(a))
    q = torch.round(wf / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8).contiguous(), scale.contiguous()


def pack_int4_torch(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in -8..7 [in, out] -> packed int8 [in/2, out] (low nibble:
    top-half row p, high nibble: bottom-half row in/2 + p)."""
    half = q.shape[-2] // 2
    top = q[..., :half, :].to(torch.int32) & 0xF
    bot = q[..., half:, :].to(torch.int32) & 0xF
    return ((bot << 4) | top).to(torch.uint8).view(torch.int8)


def quantize_kernel_int4(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """nn.Linear weight [out, in] -> (packed int8 [in/2, out], f32 scales
    [in/group, out]) of its [in, out] transpose, as the JAX package's
    quantize_int4_grouped: group 128 when in % 256 == 0, else in/2."""
    wf = w.float().t().contiguous()  # [in, out]
    n_in, n_out = wf.shape
    group = GROUP if n_in % (2 * GROUP) == 0 else n_in // 2
    if n_in % (2 * group) != 0:
        raise ValueError(f"in dim {n_in} not divisible by 2*{group}")
    g = wf.reshape(n_in // group, group, n_out)
    a = g.abs().amax(dim=-2)
    scales = torch.where(a > 0, a / a.new_tensor(7.0), torch.ones_like(a))
    q = torch.round(g / scales[:, None, :]).clamp_(-8, 7).to(torch.int8)
    return pack_int4_torch(q.reshape(n_in, n_out)).contiguous(), scales.contiguous()


def _int8(entry: Dense) -> QuantDense8:
    q, scale = quantize_kernel(entry.weight)
    return QuantDense8(q, scale, entry.bias, entry.lora)


def _int4(entry: Dense) -> QuantDense4:
    packed, scales = quantize_kernel_int4(entry.weight)
    return QuantDense4(packed, scales, entry.bias, entry.lora)


def _quantize(params: Params, entry_fn, head: bool) -> Params:
    text = params.text if isinstance(params, LongVITAParams) else params
    if any(hasattr(layer, "router") for layer in text.layers):
        raise ValueError("weight_quant does not cover MoE expert stacks")
    if not all(isinstance(getattr(layer, n), Dense) for layer in text.layers for n in PROJ_NAMES):
        raise ValueError(
            "weight_quant takes dense projections, not a tree that is quantized already"
        )
    layers = []
    for layer in text.layers:
        projs = {name: entry_fn(getattr(layer, name)) for name in PROJ_NAMES}
        layers.append(DecoderLayer(
            input_norm=layer.input_norm, post_attn_norm=layer.post_attn_norm, **projs,
        ))
    new_text = Qwen2Params(
        embed=text.embed, layers=layers, final_norm=text.final_norm,
        lm_head=entry_fn(text.lm_head) if head else text.lm_head,
    )
    if isinstance(params, LongVITAParams):
        return LongVITAParams(text=new_text, vision=params.vision, projector=params.projector)
    return new_text


@torch.no_grad()
def quantize_weights_int8(params: Params, head: bool = True) -> Params:
    """w8a16 serving tree: the seven projections (and the head unless
    head=False) as int8 codes with per-output-channel scales."""
    return _quantize(params, _int8, head)


@torch.no_grad()
def quantize_weights_int4(params: Params, head: bool = True) -> Params:
    """w4a16 serving tree: the seven projections (and the head unless
    head=False) as packed int4 with 128-row group scales, read by K6."""
    return _quantize(params, _int4, head)


def quantized_param_specs(text: Qwen2Params, specs: dict) -> dict:
    """Adapt the dense layout's tp specs (parallel/sharding.text_param_specs,
    by parameter name) to a quantised decoder (JAX :159-193). int8:
    ``weight_q`` keeps the weight's split, and its per-output-column
    ``scale`` follows the output split (column-parallel) or is replicated
    (row-parallel). int4: ``packed`` [in/2, out] and ``scales`` [in/128,
    out] shard the output dim only (torch dim 1), so a row-parallel int4
    projection is replicated, its LoRA ``a`` too: split-half packing puts
    inputs i and i + in/2 in one byte, so packed rows are no contiguous
    input range. Every other entry is left as it is."""
    specs = dict(specs)
    for path, entry in text.named_modules():
        if not isinstance(entry, (QuantDense8, QuantDense4)):
            continue
        col = specs.pop(f"{path}.weight") == 0
        if isinstance(entry, QuantDense8):
            specs[f"{path}.weight_q"] = 0 if col else 1
            specs[f"{path}.scale"] = 0 if col else None
        else:
            specs[f"{path}.packed"] = specs[f"{path}.scales"] = 1 if col else None
            if entry.lora is not None and not col:
                specs[f"{path}.lora.a"] = None
    return specs


def quantized_tq_specs(text: Qwen2Params, tq_specs: dict) -> dict:
    """Adapt the 2-D layout's tq dims (parallel/sharding.tq_dim, by
    parameter name: a column weight's input dim 1, a row weight's output
    dim 0, the head's hidden dim 1) to a quantised decoder (JAX :159-193
    on ``text_param_specs(tp2d=True)``). int8: ``weight_q`` keeps the
    weight's cut, and ``scale`` [out] follows the output dim (cut over tq
    for a row projection, whose output is tq's; whole for a column one and
    the head). int4: ``packed`` and ``scales`` cut their output dim alone
    (torch dim 1), so a row projection's over tq and a column one's, and
    the head's, not over tq at all (their output is tp's)."""
    from long_vita_tpu_torch.parallel.sharding import tq_dim

    tq_specs = dict(tq_specs)
    for path, entry in text.named_modules():
        if not isinstance(entry, (QuantDense8, QuantDense4)):
            continue
        dim = tq_dim(f"{path}.weight")
        if isinstance(entry, QuantDense8):
            tq_specs[f"{path}.weight_q"] = dim
            tq_specs[f"{path}.scale"] = 0 if dim == 0 else None
        else:
            tq_specs[f"{path}.packed"] = tq_specs[f"{path}.scales"] = 1 if dim == 0 else None
    return tq_specs
