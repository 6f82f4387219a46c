"""Checkpoint I/O: released Long-VITA *_HF safetensors -> the port's modules.

Counterpart of long_vita_tpu/utils/checkpoint_io.py. It reads the same HF key
schema (modeling_long_vita.py / modeling_intern_vit.py /
resampler_projector.py):
  model.embed_tokens.weight, model.layers.{i}.self_attn.{q,k,v,o}_proj.*,
  model.layers.{i}.mlp.{gate,up,down}_proj.weight,
  model.layers.{i}.{input,post_attention}_layernorm.weight, model.norm.weight,
  lm_head.weight,
  model.vision_model.embeddings.{class_embedding,position_embedding,
    patch_embedding.{weight,bias}},
  model.vision_model.encoder.layers.{i}.{ls1,ls2,attn.qkv.*,attn.proj.*,
    mlp.fc{1,2}.*,norm{1,2}.*},
  model.vision_projection.pre_proj_layernorm.{weight,bias},
  model.vision_projection.mlp.{0,2}.weight
and builds ``Qwen2Params`` / ``VisionParams`` / ``ProjectorParams`` /
``LongVITAParams`` directly. The port keeps dense weights in ``nn.Linear``'s
``[out, in]``, which is the HF layout, so where the JAX loader transposes
into ``[in, out]`` kernels (and utils/convert.py transposes back) the port
takes the tensor as it is; the patch embedding's conv weight ``[H, C, p, p]``
becomes the ``[H, p*p*C]`` (kh, kw, c) matrix of the JAX kernel's order.

The format is parsed here, with no ``safetensors`` package: an 8-byte
little-endian header length, a JSON header of {name: {dtype, shape,
data_offsets}}, then the raw bytes. Each file is memory-mapped and each
tensor goes to ``device`` on its own, cast there to ``dtype``, so host
memory never holds the model. BF16 travels as its bits (a ``uint16`` view
reinterpreted as ``torch.bfloat16``). ``save_safetensors`` writes the format
for utils/export_hf.py, one tensor at a time from the device.

Weights land on the card (``device="cuda"``) unless the caller passes
another device; without a card the default raises.

Over a tensor-parallel mesh (``mesh=``, training) a rank reads only its
slices of each sharded tensor from the memory-mapped file (a column slice
is a row range of bytes, a row-parallel slice a strided range), and the
tree it returns is bit for bit ``parallel/sharding.shard_params(whole,
mesh, cfg, own=True)`` of the whole load, bound to the mesh's tp_comm; the
whole tree is never built. With ``fsdp=True`` (over dp > 1) a rank reads
only its (tp, dp) piece of each FSDP leaf (a norm's, the embedding's and
the head's are row ranges, a column weight's a strided range), as
``shard_params(..., fsdp=True)`` would cut it, and the tree is bound to
the mesh's dp_comm too. Over tq (2-D tp) a rank reads only its (tp, tq)
block of each decoder weight, the embedding and the head, as
``shard_params`` cuts it over a tq mesh, bound to the mesh's tq_comm too.
``SafetensorsIndex.bytes_read`` counts the bytes copied out of the files.
"""
from __future__ import annotations

import glob
import json
import os
import struct
from typing import Callable, Optional, Union

import numpy as np
import torch

from long_vita_tpu_torch.config import LongVITAConfig
from long_vita_tpu_torch.models.intern_vit import (
    LayerNormParams,
    VisionParams,
    VitEmbeddings,
    VitLayer,
)
from long_vita_tpu_torch.models.long_vita import LongVITAParams
from long_vita_tpu_torch.models.projector import ProjectorParams
from long_vita_tpu_torch.models.qwen2 import DecoderLayer, Dense, Qwen2Params
from long_vita_tpu_torch.utils.convert import _target

# safetensors dtype -> (numpy dtype of the raw bytes, torch dtype)
_DTYPES = {
    "BOOL": (np.bool_, torch.bool),
    "U8": (np.uint8, torch.uint8),
    "I8": (np.int8, torch.int8),
    "I16": (np.int16, torch.int16),
    "U16": (np.uint16, torch.uint16),
    "I32": (np.int32, torch.int32),
    "I64": (np.int64, torch.int64),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "F32": (np.float32, torch.float32),
    "F64": (np.float64, torch.float64),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


def read_header(path: str) -> tuple[dict, int]:
    """-> ({name: {"dtype", "shape", "data_offsets"}}, offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsIndex:
    """Reads tensors across sharded .safetensors files by name, lazily."""

    def __init__(self, path: str):
        self.path = path
        self.name_to_file: dict[str, str] = {}
        index_file = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index_file):
            with open(index_file) as f:
                weight_map = json.load(f)["weight_map"]
            for name, fname in weight_map.items():
                self.name_to_file[name] = os.path.join(path, fname)
        else:
            for fname in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
                for name in read_header(fname)[0]:
                    self.name_to_file[name] = fname
        self._open_files: dict[str, tuple] = {}  # file -> (map, header, data offset)
        self.bytes_read = 0  # bytes copied out of the files by tensor()

    def __contains__(self, name: str) -> bool:
        return name in self.name_to_file

    def keys(self):
        return self.name_to_file.keys()

    def get(self, name: str) -> torch.Tensor:
        """The tensor as stored, a host view of the file's map (no copy)."""
        fname = self.name_to_file[name]
        if fname not in self._open_files:
            header, start = read_header(fname)
            # copy-on-write: a writable map that torch can wrap; nothing is
            # ever written through it
            self._open_files[fname] = (np.memmap(fname, np.uint8, mode="c"), header, start)
        mm, header, start = self._open_files[fname]
        info = header[name]
        np_dtype, t_dtype = _DTYPES[info["dtype"]]
        b, e = info["data_offsets"]
        arr = np.asarray(mm[start + b : start + e]).view(np_dtype).reshape(info["shape"])
        return torch.from_numpy(arr).view(t_dtype)

    def tensor(self, name: str, device, dtype: Optional[torch.dtype],
               cut: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        """The tensor on ``device`` (a contiguous copy), cast to ``dtype``
        when given; ``cut`` takes the part to read (a view of the map)."""
        host = self.get(name)
        if cut is not None:
            host = cut(host)
        self.bytes_read += host.nbytes
        return host.to(device=device, dtype=dtype, copy=True).contiguous()

    def close(self):
        self._open_files.clear()


def _host_bytes(t: torch.Tensor) -> memoryview:
    """The raw bytes of a tensor, copied to the host."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.cpu().numpy()).cast("B")


def save_safetensors(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` as one safetensors file, one tensor at a time from
    its device. As the safetensors package does, the data is laid out by
    element size (largest first, so every tensor is aligned), then name,
    and the header is padded with spaces to a multiple of 8 bytes."""
    entries = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header, offset = {}, 0
    for name, t in entries:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in entries:
            f.write(_host_bytes(t))


def load_text_params(
    idx: SafetensorsIndex, cfg: LongVITAConfig, dtype=torch.bfloat16,
    prefix: str = "model.", device="cuda", mesh=None, fsdp: bool = False,
    virtual_pp: int = 1,
) -> Qwen2Params:
    """The decoder; over ``mesh``'s tp axis (and with fsdp its dp axis, or
    its tq axis) this rank's slices of it, read from the files, and bound
    to mesh.tp_comm (and an FSDP Fsdp over mesh.dp_comm, or mesh.tq_comm);
    over its pp axis the stage's layers alone (``virtual_pp`` chunks of
    them chunk-major, parallel/pipeline.stage_layers; with fsdp too, of
    each its dp slices), bound to a parallel.pipeline.Stage over
    mesh.pp_comm."""
    device = _target(device)
    tp = mesh.shape["tp"] if mesh is not None else 1
    tq = mesh.shape["tq"] if mesh is not None else 1
    dp = mesh.shape["dp"] if mesh is not None and fsdp else 1
    pp = mesh.shape["pp"] if mesh is not None else 1
    stage = None
    if tp > 1 or tq > 1 or dp > 1 or pp > 1:
        from long_vita_tpu_torch.parallel.mesh import MeshConfig, validate_geometry
        from long_vita_tpu_torch.parallel.pipeline import Stage
        from long_vita_tpu_torch.parallel.sharding import (
            dense_spec,
            fsdp_dim,
            leaf_rule,
            slice_leaf,
            tq_dim,
        )

        validate_geometry(cfg.text, MeshConfig(dp=dp, pp=pp, tp=tp, tq=tq),
                          virtual_pp=virtual_pp, fsdp=fsdp)
        if pp > 1:
            stage = Stage(mesh.pp_comm, cfg.text.num_hidden_layers, virtual_pp)

    def t(name, tree=None):
        """The file's tensor ``name``; over tp, tq and dp this rank's slice
        of the tree's parameter ``tree`` (replicated when None)."""
        if (tp == 1 and tq == 1 and dp == 1) or tree is None:
            return idx.tensor(name, device, dtype)
        leaf = leaf_rule(tree, dense_spec(tree), mesh.tp_index, tp, cfg.text.num_key_value_heads,
                         fsdp_dim(tree), mesh.dp_index, dp, tq_dim(tree), mesh.tq_index, tq)
        return idx.tensor(name, device, dtype, lambda view: slice_leaf(view, leaf))

    lm_head_key = "lm_head.weight"
    if lm_head_key not in idx:  # tied embeddings fallback
        lm_head_key = prefix + "embed_tokens.weight"
    layers = []
    for i in (stage.layers() if stage is not None else range(cfg.text.num_hidden_layers)):
        p = f"{prefix}layers.{i}."

        def proj(name, bias=False):
            tree = f"text.layers.{i}.{name.split('.')[-1]}."
            return Dense(t(p + name + ".weight", tree + "weight"),
                         t(p + name + ".bias", tree + "bias") if bias else None)

        layers.append(DecoderLayer(
            input_norm=t(p + "input_layernorm.weight", f"text.layers.{i}.input_norm"),
            post_attn_norm=t(p + "post_attention_layernorm.weight",
                             f"text.layers.{i}.post_attn_norm"),
            q_proj=proj("self_attn.q_proj", bias=True),
            k_proj=proj("self_attn.k_proj", bias=True),
            v_proj=proj("self_attn.v_proj", bias=True),
            o_proj=proj("self_attn.o_proj"),
            gate_proj=proj("mlp.gate_proj"),
            up_proj=proj("mlp.up_proj"),
            down_proj=proj("mlp.down_proj"),
        ))
    text = Qwen2Params(
        embed=t(prefix + "embed_tokens.weight", "text.embed"),
        layers=layers,
        final_norm=t(prefix + "norm.weight"),
        lm_head=Dense(t(lm_head_key, "text.lm_head.weight")),
    )
    if tp > 1 or tq > 1:
        text.tp_comm = mesh.tp_comm
    if tq > 1:
        text.tq_comm = mesh.tq_comm
    text.pp = stage
    if dp > 1:
        from long_vita_tpu_torch.parallel.fsdp import Fsdp

        text.fsdp = Fsdp(mesh.dp_comm)
    return text


def load_vision_params(
    idx: SafetensorsIndex, cfg: LongVITAConfig, dtype=torch.bfloat16,
    prefix: str = "model.vision_model.", device="cuda",
) -> VisionParams:
    device = _target(device)

    def t(name):
        return idx.tensor(name, device, dtype)

    # conv [H, C, p, p] -> [H, p*p*C] in (kh, kw, c) order: the transpose of
    # the JAX kernel conv.transpose(2, 3, 1, 0).reshape(-1, H)
    conv = idx.get(prefix + "embeddings.patch_embedding.weight").to(device)
    patch = conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1).to(dtype).contiguous()
    emb = VitEmbeddings(
        patch_embed=Dense(patch, t(prefix + "embeddings.patch_embedding.bias")),
        cls_token=t(prefix + "embeddings.class_embedding"),
        pos_embed=t(prefix + "embeddings.position_embedding")[0],
    )

    def dense(p, name):
        return Dense(t(p + name + ".weight"), t(p + name + ".bias"))

    def norm(p, name):
        return LayerNormParams(t(p + name + ".weight"), t(p + name + ".bias"))

    layers = []
    for i in range(cfg.vision.num_hidden_layers):
        p = f"{prefix}encoder.layers.{i}."
        layers.append(VitLayer(
            norm1=norm(p, "norm1"), qkv=dense(p, "attn.qkv"), proj=dense(p, "attn.proj"),
            ls1=t(p + "ls1"), norm2=norm(p, "norm2"), fc1=dense(p, "mlp.fc1"),
            fc2=dense(p, "mlp.fc2"), ls2=t(p + "ls2"),
        ))
    return VisionParams(embeddings=emb, layers=layers)


def load_projector_params(
    idx: SafetensorsIndex, cfg: LongVITAConfig, dtype=torch.bfloat16,
    prefix: str = "model.vision_projection.", device="cuda",
) -> ProjectorParams:
    device = _target(device)

    def t(name):
        return idx.tensor(name, device, dtype)

    return ProjectorParams(
        pre_norm=LayerNormParams(
            t(prefix + "pre_proj_layernorm.weight"), t(prefix + "pre_proj_layernorm.bias")
        ),
        fc1=Dense(t(prefix + "mlp.0.weight")),
        fc2=Dense(t(prefix + "mlp.2.weight")),
    )


def load_long_vita_checkpoint(
    path: str,
    cfg: Optional[LongVITAConfig] = None,
    dtype=torch.bfloat16,
    device="cuda",
    mesh=None,
    stats: Optional[dict] = None,
    fsdp: bool = False,
    virtual_pp: int = 1,
) -> tuple[Union[LongVITAParams, Qwen2Params], LongVITAConfig]:
    """Load a released Long-VITA-*_HF checkpoint directory. -> (a
    LongVITAParams, or the decoder's Qwen2Params alone when the directory
    holds no vision tower, and the configuration). mesh (a
    parallel.mesh.Mesh with tp > 1, or dp > 1 with fsdp): this rank's
    shard, read slice by slice (see the module docstring); with pp > 1 the
    decoder's layers of this rank's stage alone (virtual_pp: its chunks,
    load_text_params). stats: a dict that receives "bytes_read", the bytes
    copied out of the files."""
    device = _target(device)
    if cfg is None:
        cfg = LongVITAConfig.from_json(os.path.join(path, "config.json"))
    idx = SafetensorsIndex(path)
    text = load_text_params(idx, cfg, dtype, device=device, mesh=mesh, fsdp=fsdp,
                            virtual_pp=virtual_pp)
    params: Union[LongVITAParams, Qwen2Params] = text
    if cfg.vision is not None and any(k.startswith("model.vision_model.") for k in idx.keys()):
        params = LongVITAParams(
            text=text,
            vision=load_vision_params(idx, cfg, dtype, device=device),
            projector=load_projector_params(idx, cfg, dtype, device=device),
        )
    if stats is not None:
        stats["bytes_read"] = idx.bytes_read
    idx.close()
    return params, cfg
