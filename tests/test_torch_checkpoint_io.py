"""PyTorch port: utils/checkpoint_io.py, export_hf.py and graft.py against the
JAX package's, on synthetic HF-schema safetensors at tiny_test_config().

Tolerance: none. Every loaded tensor must equal, bit for bit, the JAX
loader's tree passed through utils/convert.long_vita_params_from_jax (bf16
and f32 on disk, loaded as bf16 and as f32, single-file and sharded
directories); the port's own format reader must return the safetensors
package's bits; what the port exports, the JAX loader must read back as the
tree it came from.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file, save_file

from long_vita_tpu.config import tiny_test_config as jax_tiny
from long_vita_tpu.utils import export_hf as jax_export
from long_vita_tpu.utils.checkpoint_io import load_long_vita_checkpoint as jax_load
from long_vita_tpu.utils.graft import graft_checkpoints as jax_graft
from long_vita_tpu_torch.config import LongVITAConfig, tiny_test_config
from long_vita_tpu_torch.models.long_vita import LongVITAParams
from long_vita_tpu_torch.models.qwen2 import Qwen2Params
from long_vita_tpu_torch.utils import export_hf
from long_vita_tpu_torch.utils.checkpoint_io import (
    SafetensorsIndex,
    load_long_vita_checkpoint,
    read_header,
    save_safetensors,
)
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax, params_from_jax
from long_vita_tpu_torch.utils.graft import graft_checkpoints


def hf_state_dict(cfg, seed=0, vision=True, prefix="model.vision_model."):
    """A random HF-schema state dict (numpy f32), norms and scales included."""
    t, v = cfg.text, cfg.vision
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1

    hd, kvd = t.num_attention_heads * t.head_dim, t.num_key_value_heads * t.head_dim
    sd = {
        "model.embed_tokens.weight": r(t.vocab_size, t.hidden_size),
        "model.norm.weight": 1 + r(t.hidden_size),
        "lm_head.weight": r(t.vocab_size, t.hidden_size),
    }
    for i in range(t.num_hidden_layers):
        p = f"model.layers.{i}."
        sd |= {
            p + "input_layernorm.weight": 1 + r(t.hidden_size),
            p + "post_attention_layernorm.weight": 1 + r(t.hidden_size),
            p + "self_attn.q_proj.weight": r(hd, t.hidden_size),
            p + "self_attn.q_proj.bias": r(hd),
            p + "self_attn.k_proj.weight": r(kvd, t.hidden_size),
            p + "self_attn.k_proj.bias": r(kvd),
            p + "self_attn.v_proj.weight": r(kvd, t.hidden_size),
            p + "self_attn.v_proj.bias": r(kvd),
            p + "self_attn.o_proj.weight": r(t.hidden_size, hd),
            p + "mlp.gate_proj.weight": r(t.intermediate_size, t.hidden_size),
            p + "mlp.up_proj.weight": r(t.intermediate_size, t.hidden_size),
            p + "mlp.down_proj.weight": r(t.hidden_size, t.intermediate_size),
        }
    if not vision:
        return sd
    sd |= {
        prefix + "embeddings.class_embedding": r(1, 1, v.hidden_size),
        prefix + "embeddings.position_embedding": r(1, v.num_patches + 1, v.hidden_size),
        prefix + "embeddings.patch_embedding.weight": r(v.hidden_size, 3, v.patch_size, v.patch_size),
        prefix + "embeddings.patch_embedding.bias": r(v.hidden_size),
    }
    for i in range(v.num_hidden_layers):
        p = f"{prefix}encoder.layers.{i}."
        sd |= {
            p + "ls1": r(v.hidden_size), p + "ls2": r(v.hidden_size),
            p + "attn.qkv.weight": r(3 * v.hidden_size, v.hidden_size),
            p + "attn.qkv.bias": r(3 * v.hidden_size),
            p + "attn.proj.weight": r(v.hidden_size, v.hidden_size),
            p + "attn.proj.bias": r(v.hidden_size),
            p + "mlp.fc1.weight": r(v.intermediate_size, v.hidden_size),
            p + "mlp.fc1.bias": r(v.intermediate_size),
            p + "mlp.fc2.weight": r(v.hidden_size, v.intermediate_size),
            p + "mlp.fc2.bias": r(v.hidden_size),
            p + "norm1.weight": 1 + r(v.hidden_size), p + "norm1.bias": r(v.hidden_size),
            p + "norm2.weight": 1 + r(v.hidden_size), p + "norm2.bias": r(v.hidden_size),
        }
    if prefix == "model.vision_model.":
        in_dim = v.hidden_size * 4
        sd |= {
            "model.vision_projection.pre_proj_layernorm.weight": 1 + r(in_dim),
            "model.vision_projection.pre_proj_layernorm.bias": r(in_dim),
            "model.vision_projection.mlp.0.weight": r(v.hidden_size, in_dim),
            "model.vision_projection.mlp.2.weight": r(t.hidden_size, v.hidden_size),
        }
    return sd


def write_checkpoint(path, sd, disk_dtype, shards=1, config=None):
    """sd into ``shards`` safetensors files (an index file when more than
    one), cast to ``disk_dtype``, by the safetensors package."""
    os.makedirs(path, exist_ok=True)
    names = list(sd)
    parts = np.array_split(np.arange(len(names)), shards)
    weight_map = {}
    for i, part in enumerate(parts):
        fname = "model.safetensors" if shards == 1 else f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file({names[j]: torch.from_numpy(sd[names[j]]).to(disk_dtype) for j in part},
                  os.path.join(path, fname))
        weight_map |= {names[j]: fname for j in part}
    if shards > 1:
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)


def _raw(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def assert_same_modules(got: torch.nn.Module, want: torch.nn.Module) -> int:
    """Every parameter equal, bit for bit, with the same name, dtype and
    shape. -> the number of parameters held."""
    g, w = dict(got.named_parameters()), dict(want.named_parameters())
    assert g.keys() == w.keys()
    for name in g:
        assert g[name].dtype == w[name].dtype and g[name].shape == w[name].shape, name
        assert _raw(g[name]) == _raw(w[name]), name
    return len(g)


def jax_to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shards", [1, 3], ids=["single", "sharded"])
@pytest.mark.parametrize("disk", [torch.bfloat16, torch.float32], ids=["disk_bf16", "disk_f32"])
@pytest.mark.parametrize("load", [torch.bfloat16, torch.float32], ids=["load_bf16", "load_f32"])
def test_loader_matches_jax_loader_bit_for_bit(tmp_path, shards, disk, load):
    cfg = tiny_test_config()
    write_checkpoint(tmp_path, hf_state_dict(cfg), disk, shards)
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[load]
    jparams, _ = jax_load(str(tmp_path), jax_tiny(), dtype=jdtype)
    want = long_vita_params_from_jax(jax_to_np(jparams), device="cpu")
    got, got_cfg = load_long_vita_checkpoint(str(tmp_path), cfg, dtype=load, device="cpu")
    assert isinstance(got, LongVITAParams) and got_cfg is cfg
    assert assert_same_modules(got, want) > 50
    assert got.text.embed.dtype == load


def test_text_only_and_tied_embeddings(tmp_path):
    """A directory without a vision tower gives the decoder alone; without
    lm_head.weight the head is the embedding table, as in the JAX loader."""
    cfg = tiny_test_config()
    sd = hf_state_dict(cfg, vision=False)
    del sd["lm_head.weight"]
    write_checkpoint(tmp_path, sd, torch.bfloat16)
    jparams, _ = jax_load(str(tmp_path), jax_tiny(), dtype=jnp.bfloat16)
    assert set(jparams) == {"text"}
    got, _ = load_long_vita_checkpoint(str(tmp_path), cfg, device="cpu")
    assert isinstance(got, Qwen2Params)
    assert_same_modules(got, params_from_jax(jax_to_np(jparams), device="cpu"))
    assert torch.equal(got.lm_head.weight, got.embed)


def test_config_json_through_the_port_config(tmp_path):
    """config.json is read by the port's own LongVITAConfig.from_json."""
    cfg = tiny_test_config()
    write_checkpoint(tmp_path, hf_state_dict(cfg), torch.bfloat16,
                     config=export_hf.hf_config(cfg))
    got, got_cfg = load_long_vita_checkpoint(str(tmp_path), device="cpu")
    assert got_cfg == LongVITAConfig.from_json(str(tmp_path / "config.json"))
    assert got_cfg.text == cfg.text and got_cfg.vision == cfg.vision
    assert len(got.text.layers) == cfg.text.num_hidden_layers


def test_reader_matches_the_safetensors_package(tmp_path):
    """SafetensorsIndex parses the format itself: every dtype the loader can
    meet comes back with the package's bits, shapes and names."""
    rng = np.random.default_rng(3)
    f32 = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    tensors = {
        "f32": f32, "bf16": f32.to(torch.bfloat16), "f16": f32.to(torch.float16),
        "f64": f32.double()[:2], "i8": torch.arange(-8, 8, dtype=torch.int8).reshape(4, 4),
        "u8": torch.arange(9, dtype=torch.uint8), "i32": torch.arange(6, dtype=torch.int32),
        "i64": torch.arange(3, dtype=torch.int64), "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3),
    }
    save_file(tensors, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    want = load_file(str(tmp_path / "model.safetensors"))
    idx = SafetensorsIndex(str(tmp_path))
    assert set(idx.keys()) == set(want)
    for name, w in want.items():
        g = idx.get(name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _raw(g) == _raw(w), name
    idx.close()


def test_writer_is_read_by_the_safetensors_package(tmp_path):
    """save_safetensors' files pass the package's own checks (aligned,
    contiguous offsets, no holes) and hold the tensors' bits."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((6, 10)).astype(np.float32))
    tensors = {"b.bf16": x.to(torch.bfloat16), "a.f32": x, "c.t": x.t(), "d.i8": x.to(torch.int8),
               "e.bool": x > 0}
    path = str(tmp_path / "w.safetensors")
    save_safetensors(tensors, path)
    header, start = read_header(path)
    assert start % 8 == 0 and set(header) == set(tensors)
    with safe_open(path, framework="pt") as f:
        for name, t in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype and torch.equal(got, t.contiguous()), name


@pytest.mark.parametrize("shard_bytes", [4 * 1024**3, 40_000], ids=["one_file", "sharded"])
def test_export_read_back_by_the_jax_loader(tmp_path, monkeypatch, shard_bytes):
    """The port's exporter writes the JAX exporter's names, shards, index
    and config.json; the JAX loader reads it back as the tree it came from,
    bit for bit, and so does the port's loader."""
    for mod in (export_hf, jax_export):
        monkeypatch.setattr(mod, "_SHARD_BYTES", shard_bytes)
    write_checkpoint(tmp_path / "src", hf_state_dict(tiny_test_config(), seed=5), torch.bfloat16)
    jparams, jcfg = jax_load(str(tmp_path / "src"), jax_tiny(), dtype=jnp.bfloat16)
    cfg = tiny_test_config()
    port = long_vita_params_from_jax(jax_to_np(jparams), device="cpu")
    export_hf.save_hf_checkpoint(port, cfg, str(tmp_path / "port"))
    jax_export.save_hf_checkpoint(jparams, jcfg, str(tmp_path / "jax"))

    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert (len(names) > 3) == (shard_bytes < 1e6)
    for name in ("config.json", "model.safetensors.index.json"):
        if name in names:
            with open(tmp_path / "port" / name) as f, open(tmp_path / "jax" / name) as g:
                assert json.load(f) == json.load(g), name
    for name in names:
        if name.endswith(".safetensors"):
            got = read_header(str(tmp_path / "port" / name))[0]
            want = read_header(str(tmp_path / "jax" / name))[0]
            assert {k: (v["dtype"], v["shape"]) for k, v in got.items()} == \
                {k: (v["dtype"], v["shape"]) for k, v in want.items()}, name

    back, _ = jax_load(str(tmp_path / "port"), jax_tiny(), dtype=jnp.bfloat16)
    flat_w, flat_b = jax.tree.leaves(jax_to_np(jparams)), jax.tree.leaves(jax_to_np(back))
    assert len(flat_w) == len(flat_b)
    for w, b in zip(flat_w, flat_b):
        assert w.dtype == b.dtype and w.shape == b.shape and w.tobytes() == b.tobytes()
    again, _ = load_long_vita_checkpoint(str(tmp_path / "port"), device="cpu")
    assert_same_modules(again, port)


def test_export_refuses_quantized_weights():
    from long_vita_tpu_torch.models.qwen2 import init_qwen2_params
    from long_vita_tpu_torch.models.quantize import quantize_weights_int8

    cfg = tiny_test_config()
    q = quantize_weights_int8(init_qwen2_params(torch.Generator().manual_seed(0), cfg.text))
    with pytest.raises(ValueError, match="dense weights"):
        export_hf.flatten_to_hf(q, cfg)


def _stock_dirs(tmp_path):
    cfg = tiny_test_config()
    t, v = cfg.text, cfg.vision
    llm, vit = tmp_path / "qwen", tmp_path / "vit"
    write_checkpoint(llm, hf_state_dict(cfg, seed=6, vision=False), torch.bfloat16, config={
        "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size, "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "num_key_value_heads": t.num_key_value_heads, "rope_theta": t.rope_theta,
    })
    vit_sd = {k: a for k, a in hf_state_dict(cfg, seed=7, prefix="").items()
              if not k.startswith(("model.", "lm_head"))}
    write_checkpoint(vit, vit_sd, torch.float32, config={
        "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
        "num_hidden_layers": v.num_hidden_layers, "num_attention_heads": v.num_attention_heads,
        "image_size": v.image_size, "patch_size": v.patch_size,
    })
    return str(llm), str(vit)


def test_graft_matches_jax_graft(tmp_path):
    """Stock Qwen2 + stock InternViT (no grafted prefix) -> the JAX graft's
    configuration and decoder and tower bits; the fresh projector has the
    JAX one's shapes and scale (its numbers come from another generator).
    With out_dir the graft is one *_HF directory the loader reads back."""
    llm, vit = _stock_dirs(tmp_path)
    jparams, jcfg = jax_graft(llm, vit, dtype=jnp.float32)
    out = tmp_path / "grafted"
    got, cfg = graft_checkpoints(llm, vit, dtype=torch.float32, device="cpu", out_dir=str(out))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = long_vita_params_from_jax(jax_to_np(jparams), device="cpu")
    assert_same_modules(got.text, want.text)
    assert_same_modules(got.vision, want.vision)
    for (n, g), (_, w) in zip(got.projector.named_parameters(), want.projector.named_parameters()):
        assert g.shape == w.shape and g.dtype == w.dtype, n
        assert abs(g.float().std().item() - w.float().std().item()) < 0.01, n
    back, _ = load_long_vita_checkpoint(str(out), cfg, dtype=torch.float32, device="cpu")
    assert_same_modules(back, got)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_default_device_is_the_card(tmp_path):
    cfg = tiny_test_config()
    write_checkpoint(tmp_path, hf_state_dict(cfg, vision=False), torch.bfloat16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_long_vita_checkpoint(str(tmp_path), cfg)
