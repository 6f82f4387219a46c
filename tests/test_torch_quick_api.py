"""PyTorch port: the package's quick API (long_vita_tpu_torch.build_engine,
load_checkpoint, VisionConfig, the lazy SamplingParams and InferenceEngine)
against the JAX package's (long_vita_tpu.build_engine and the rest), on
one exported checkpoint directory: a tiny decoder (f32, vocabulary 4224)
with a tower at 448 px (two layers of width 32, so the default front end's
256 tokens a tile fit it) and the committed Qwen2 tokenizer fixture
(tests/data/qwen2_tokenizer_tiny), which each package reads with its own
load_tokenizer. Tolerance: none (greedy token ids and text identical).
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import long_vita_tpu
import long_vita_tpu.utils.compile_cache as jax_compile_cache
import long_vita_tpu_torch
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_tokenizer import FIXTURE


def quick_config():
    base = tiny_test_config(vocab_size=4224)
    return dataclasses.replace(base, vision=dataclasses.replace(base.vision, image_size=448),
                               image_token_length=256)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = quick_config()
    params = init_long_vita_params(torch.Generator().manual_seed(5), cfg)
    with torch.no_grad():  # wider weights: greedy decoding that is not a loop
        for name, p in params.text.named_parameters():
            if p.ndim == 2 and "embed" not in name:
                p.mul_(8)
    path = tmp_path_factory.mktemp("quick")
    save_hf_checkpoint(params, cfg, str(path))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(f"{FIXTURE}/{name}", path)
    return str(path)


def test_quick_api_names():
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams

    assert long_vita_tpu_torch.SamplingParams is SamplingParams
    assert long_vita_tpu_torch.InferenceEngine is InferenceEngine
    assert set(long_vita_tpu_torch.__all__) >= {"LongVITAConfig", "VisionConfig",
                                                "load_checkpoint", "build_engine"}
    with pytest.raises(AttributeError):
        long_vita_tpu_torch.no_such_name  # noqa: B018


def test_load_checkpoint_matches_jax(checkpoint):
    params, cfg = long_vita_tpu_torch.load_checkpoint(checkpoint, dtype=torch.float32,
                                                      device="cpu")
    _, jcfg = long_vita_tpu.load_checkpoint(checkpoint)
    assert cfg == quick_config() and cfg.text.vocab_size == jcfg.text.vocab_size
    assert cfg.vision.image_size == jcfg.vision.image_size == 448


@pytest.mark.parametrize("media", ["text", "image"])
def test_build_engine_matches_jax(checkpoint, media, monkeypatch, one_torch_thread):
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: None)
    # one prefill chunk holds the whole prompt: the JAX engine's per-chunk
    # media scatter wraps rows of earlier chunks (tests/test_torch_engine.py)
    kw = dict(max_seq_len=1024, chunk=512, dtype_name="float32")
    port = long_vita_tpu_torch.build_engine(checkpoint, device="cpu", **kw)
    ref = long_vita_tpu.build_engine(checkpoint, **kw)
    assert port.device.type == "cpu" and len(port.mm.tokenizer) == len(ref.mm.tokenizer) == 4135
    extra = {}
    content = "what does the checkpoint say?"
    if media == "image":
        extra["images"] = [np.random.default_rng(7).integers(0, 256, (448, 448, 3), np.uint8)]
        content = "<image>\nDescribe the picture."
    msgs = [{"role": "user", "content": content}]
    got = port.generate(msgs, sampling=long_vita_tpu_torch.SamplingParams(max_new_tokens=10),
                        **extra)
    want = ref.generate(msgs, sampling=long_vita_tpu.SamplingParams(max_new_tokens=10),
                        **extra)
    assert got.prompt_tokens == want.prompt_tokens
    assert got.prompt_tokens > (256 if media == "image" else 10)
    assert got.token_ids == want.token_ids and got.text == want.text
    assert len(set(got.token_ids)) > 3, got.token_ids
