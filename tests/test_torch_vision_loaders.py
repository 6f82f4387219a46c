"""PyTorch port: the CLIP and SigLIP checkpoint loaders (utils/vision_loaders.py)
against the JAX package's.

Tiny HF CLIPVisionModel and SiglipVisionModel checkpoints are written by the
test (transformers builds the models, safetensors writes the files; a copy
without the ``vision_model.`` prefix and a two-tower config.json too). The
port's loaded tree equals the JAX loader's tree converted by
utils/convert.generic_vit_from_jax, tensor for tensor and bit for bit (f32
and bf16); its features equal JAX's to 1e-5 and the HF encoder's output (the
hidden state before the dropped post-LN) to 2e-5, as tests/
test_vision_loaders.py holds JAX's; vit_config_from_hf equals JAX's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from long_vita_tpu.models.generic_vit import generic_vit as jax_generic_vit
from long_vita_tpu.utils import vision_loaders as jvl
from long_vita_tpu_torch.models.generic_vit import generic_vit
from long_vita_tpu_torch.utils import vision_loaders as tvl
from long_vita_tpu_torch.utils.checkpoint_io import save_safetensors
from long_vita_tpu_torch.utils.convert import generic_vit_from_jax

transformers = pytest.importorskip("transformers")


def _hf_model(family):
    torch.manual_seed(0)
    kw = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
              image_size=28, patch_size=14)
    if family == "clip":
        cfg = transformers.CLIPVisionConfig(hidden_act="quick_gelu", **kw)
        model = transformers.CLIPVisionModel(cfg).eval()
    else:
        cfg = transformers.SiglipVisionConfig(hidden_act="gelu_pytorch_tanh", **kw)
        model = transformers.SiglipVisionModel(cfg).eval()
    with torch.no_grad():  # non-trivial norms and biases
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.2 * torch.randn_like(p))
    return model, cfg


def _write(model, cfg, out, prefix=True, two_tower=False):
    out.mkdir()
    sd = {k if prefix else k.removeprefix("vision_model."): v.contiguous()
          for k, v in model.state_dict().items()}
    save_safetensors(sd, str(out / "model.safetensors"))
    hf = cfg.to_dict()
    json.dump({"vision_config": hf} if two_tower else hf, open(out / "config.json", "w"))
    return str(out)


@pytest.fixture(scope="module", params=["clip", "siglip"])
def checkpoint(request, tmp_path_factory):
    family = request.param
    model, cfg = _hf_model(family)
    root = tmp_path_factory.mktemp(family)
    return family, model, {
        "plain": _write(model, cfg, root / "plain"),
        "no_prefix": _write(model, cfg, root / "no_prefix", prefix=False),
        "two_tower": _write(model, cfg, root / "two_tower", two_tower=True),
    }


def _loaders(family):
    if family == "clip":
        return jvl.load_clip_vit_params, tvl.load_clip_vit_params
    return jvl.load_siglip_vit_params, tvl.load_siglip_vit_params


@pytest.mark.parametrize("layout", ["plain", "no_prefix", "two_tower"])
def test_config_from_hf_matches_jax(checkpoint, layout):
    family, _, paths = checkpoint
    got = tvl.vit_config_from_hf(paths[layout], family)
    want = jvl.vit_config_from_hf(paths[layout], family)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="unknown vision family"):
        tvl.vit_config_from_hf(paths[layout], "eva")


@pytest.mark.parametrize("layout", ["plain", "no_prefix"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loaded_tree_equals_jax(checkpoint, layout, dtype):
    family, _, paths = checkpoint
    jload, tload = _loaders(family)
    cfg = tvl.vit_config_from_hf(paths[layout], family)
    tree = jax.tree.map(np.asarray, jload(paths[layout], cfg, dtype=getattr(jnp, dtype)))
    want = generic_vit_from_jax(tree, cfg, device="cpu")
    got = tload(paths[layout], cfg, dtype=getattr(torch, dtype), device="cpu")
    got_named, want_named = dict(got.named_parameters()), dict(want.named_parameters())
    assert got_named.keys() == want_named.keys()
    for n, p in got_named.items():
        assert p.dtype == getattr(torch, dtype), n
        assert torch.equal(p, want_named[n]), n


def test_features_match_jax_and_hf(checkpoint):
    family, model, paths = checkpoint
    jload, tload = _loaders(family)
    cfg = tvl.vit_config_from_hf(paths["plain"], family)
    pix = torch.randn(2, 3, 28, 28, generator=torch.Generator().manual_seed(1))
    nhwc = pix.permute(0, 2, 3, 1).contiguous()
    got = generic_vit(tload(paths["plain"], cfg, dtype=torch.float32, device="cpu"), nhwc, cfg)
    want = jax_generic_vit(jload(paths["plain"], cfg, dtype=jnp.float32),
                           jnp.asarray(nhwc.numpy()), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        hf = model(pix, output_hidden_states=True).hidden_states[-1]
    np.testing.assert_allclose(got.numpy(), hf.numpy(), atol=2e-5)


def test_loaders_default_to_the_card(checkpoint):
    family, _, paths = checkpoint
    _, tload = _loaders(family)
    cfg = tvl.vit_config_from_hf(paths["plain"], family)
    if torch.cuda.is_available():
        assert next(tload(paths["plain"], cfg).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tload(paths["plain"], cfg)
