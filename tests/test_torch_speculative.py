"""PyTorch port: prompt-lookup speculative decoding (inference/speculative.py
and the engine's speculative_k) against long_vita_tpu/inference/speculative.py
and the JAX engine, f32 on the CPU.

Speculation is lossless: greedy tokens with speculative_k=4 equal plain
greedy decode and the JAX engine's speculative run, which takes the same
number of verify steps (_spec_steps). Logprobs agree to 1e-4 absolute (as
tests/test_torch_engine.py). The 128-group geometry serves int4 weights, so
each 4-row verify step runs K6's route (its plain version here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import long_vita_tpu_torch.inference.speculative as port_spec
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.inference.speculative import draft_tokens as jax_draft_tokens
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.ops import quant_matmul as tqm
from long_vita_tpu_torch.utils.convert import params_from_jax
from test_torch_engine import _MM
from test_torch_quantize import GEOMETRIES, jax_params, one_torch_thread  # noqa: F401

TOL = dict(rtol=0, atol=1e-4)
KW = dict(max_seq_len=512, chunk=64, decode_segment=8)
QUANT = {"tiny": None, "g128": "int4"}


def test_draft_tokens_ngram_lookup():
    draft = port_spec.draft_tokens
    h = np.asarray([5, 6, 7, 1, 2, 3, 9, 9, 1, 2, 3], np.int32)
    np.testing.assert_array_equal(draft(h, 3), [9, 9, 1])
    np.testing.assert_array_equal(draft(h, 8), [9, 9, 1, 2, 3])
    assert draft(np.asarray([1, 2, 3, 4], np.int32), 4).size == 0
    np.testing.assert_array_equal(draft(np.asarray([7, 3, 8, 1, 2, 3], np.int32), 2), [8, 1])
    assert draft(np.asarray([4], np.int32), 4).size == 0


def test_draft_tokens_match_jax_on_random_histories():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 60))
        h = rng.integers(0, int(rng.integers(2, 12)), n).astype(np.int32)
        k, ngram = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        got = port_spec.draft_tokens(h, k, ngram)
        want = jax_draft_tokens(h, k, ngram)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def engines(request):
    cfg = GEOMETRIES[request.param]()
    p = jax_params(cfg, seed=0)
    tp = params_from_jax(p, device="cpu")
    quant = QUANT[request.param]
    kw = dict(KW, weight_quant=quant)
    return {
        "cfg": cfg,
        "quant": quant,
        "jax_spec": JaxEngine({"text": p}, cfg, _MM(), cache_dtype=jnp.float32,
                              speculative_k=4, **kw),
        "plain": InferenceEngine(tp, cfg, _MM(), cache_dtype=torch.float32, **kw),
        "spec": InferenceEngine(tp, cfg, _MM(), cache_dtype=torch.float32, speculative_k=4, **kw),
    }


def _prompts(cfg):
    rng = np.random.default_rng(4)
    pattern = rng.integers(0, cfg.text.vocab_size, 16).tolist()
    return [
        (rng.integers(0, cfg.text.vocab_size, 40).tolist(), 12),
        (pattern * 6, 20),  # repeats: n-gram lookup proposes drafts
        (rng.integers(0, cfg.text.vocab_size, 64).tolist(), 6),
    ]


def test_speculative_matches_plain_and_jax(engines):
    e = engines
    for ids, n_new in _prompts(e["cfg"]):
        sp = dict(max_new_tokens=n_new, return_logprobs=True)
        plain = e["plain"].generate(input_ids=ids, sampling=SamplingParams(**sp))
        e["spec"]._spec_steps = e["jax_spec"]._spec_steps = 0
        dequant = tqm.w4_matmul_dequant.calls
        got = e["spec"].generate(input_ids=ids, sampling=SamplingParams(**sp))
        want = e["jax_spec"].generate(input_ids=ids, sampling=JaxSP(**sp))
        assert got.token_ids == plain.token_ids == want.token_ids
        assert e["spec"]._spec_steps == e["jax_spec"]._spec_steps > 0
        assert e["spec"]._spec_steps < n_new or n_new <= 6
        np.testing.assert_allclose(got.logprobs, plain.logprobs, **TOL)
        np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)
        if e["quant"] == "int4":  # verify steps, decode and the head: kernel route
            assert tqm.w4_matmul_dequant.calls == dequant


def test_acceptance_with_oracle_drafts(engines, monkeypatch):
    """Drafts that propose the model's true continuation: each verify step
    accepts k - 1 drafts and emits k tokens, and the output is unchanged."""
    e = engines
    ids = np.random.default_rng(5).integers(0, e["cfg"].text.vocab_size, 33).tolist()
    sp = SamplingParams(max_new_tokens=16)
    plain = e["plain"].generate(input_ids=ids, sampling=sp)
    full = np.concatenate([ids, plain.token_ids]).astype(np.int32)
    monkeypatch.setattr(port_spec, "draft_tokens", lambda h, k, ngram_max=3: full[len(h):len(h) + k])
    e["spec"]._spec_steps = 0
    got = e["spec"].generate(input_ids=ids, sampling=sp)
    assert got.token_ids == plain.token_ids
    assert e["spec"]._spec_steps == -(-(16 - 1) // 4)  # 15 tokens after the first, 4 a step


def test_sampled_requests_and_cache_tail_use_plain_decode(engines):
    """A sampled request bypasses speculation; a prompt too close to the
    cache's end finishes with plain decode steps (the tail)."""
    e = engines
    ids = list(range(3, 60))
    sp = SamplingParams(greedy=False, temperature=0.8, top_k=5, max_new_tokens=6)
    e["spec"]._spec_steps = 0
    assert (e["spec"].generate(input_ids=ids, sampling=sp, seed=3).token_ids
            == e["plain"].generate(input_ids=ids, sampling=sp, seed=3).token_ids)
    assert e["spec"]._spec_steps == 0
    long_ids = np.random.default_rng(6).integers(0, e["cfg"].text.vocab_size, 500).tolist()
    sp = SamplingParams(max_new_tokens=11)
    got = e["spec"].generate(input_ids=long_ids, sampling=sp)
    assert got.token_ids == e["plain"].generate(input_ids=long_ids, sampling=sp).token_ids
    assert len(got.token_ids) == 11


@pytest.mark.parametrize("k", [1, -1])
def test_speculative_k_validation(engines, k):
    e = engines
    with pytest.raises(ValueError, match="speculative_k"):
        InferenceEngine(e["plain"].params, e["cfg"], _MM(), speculative_k=k)
