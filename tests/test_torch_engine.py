"""PyTorch port: the serving slice as a whole, inference/engine.py against the
JAX InferenceEngine (f32 on the CPU, max_seq_len 512, chunk 64).

Greedy tokens must be identical. Last-row hidden states agree to 1e-4
absolute and logprobs to 1e-4 absolute (f32 GEMMs summed in another order
through two layers, then a log-softmax over 512 logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.data.multimodal import ExpandedInputs
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models.qwen2 import init_qwen2_params
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=0, atol=1e-4)


class _Tok:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in ids)


class _MM:
    """The duck-typed multimodal tokenizer of tests/test_quant_quality.py."""

    tokenizer = _Tok()

    def expand(self, input_ids, images=(), videos=(), labels=None, max_num_frame=None):
        return ExpandedInputs(list(input_ids), None, None)

    def encode_chat(self, messages):  # a "tokenizer" of space-separated ids
        return [int(t) for m in messages for t in m["content"].split()]


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_test_config()
    p = init_qwen2_params(jax.random.PRNGKey(0), cfg.text)
    rng = np.random.default_rng(0)

    def fill(path, a):  # randomise norms and biases; widen the kernels
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 4

    p = jax.tree_util.tree_map_with_path(fill, p)
    kw = dict(max_seq_len=512, chunk=64, decode_segment=8)
    jax_eng = JaxEngine({"text": p}, cfg, _MM(), cache_dtype=jnp.float32, **kw)
    port = InferenceEngine(params_from_jax(p), cfg, _MM(), cache_dtype=torch.float32, **kw)
    return jax_eng, port, cfg


def test_generate_greedy_tokens_identical(engines):
    jax_eng, port, cfg = engines
    prompt = np.random.default_rng(1).integers(0, cfg.text.vocab_size, 150).tolist()
    want = jax_eng.generate(input_ids=prompt, sampling=JaxSP(max_new_tokens=20, return_logprobs=True))
    got = port.generate(input_ids=prompt, sampling=SamplingParams(max_new_tokens=20, return_logprobs=True))
    assert got.token_ids == want.token_ids
    assert len(set(got.token_ids)) > 3, got.token_ids  # not a degenerate loop
    assert got.prompt_tokens == want.prompt_tokens == 150
    assert got.text == want.text
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)


def test_prefill_last_row_matches(engines):
    """150 ids: three chunks, then the last-row recompute (150 is not a
    chunk multiple); the incremental API gives the same as prefill()."""
    jax_eng, port, cfg = engines
    prompt = np.random.default_rng(2).integers(0, cfg.text.vocab_size, 150).tolist()
    _, want, _ = jax_eng.prefill(prompt)
    cache, got, n = port.prefill(prompt)
    assert n == 150 and cache.length == 150
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    job = port.start_prefill(prompt)
    steps = 0
    while not port.prefill_step(job):
        steps += 1
    assert steps + 1 == 3
    _, inc, _ = port.finish_prefill(job)
    np.testing.assert_allclose(inc.numpy(), got.numpy(), rtol=0, atol=0)


def test_generate_batch_ragged_identical(engines):
    jax_eng, port, cfg = engines
    rng = np.random.default_rng(3)
    reqs = [{"input_ids": rng.integers(0, cfg.text.vocab_size, n).tolist()} for n in (40, 150, 100)]
    want = jax_eng.generate_batch(reqs, sampling=JaxSP(max_new_tokens=12, return_logprobs=True))
    got = port.generate_batch(reqs, sampling=SamplingParams(max_new_tokens=12, return_logprobs=True))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.prompt_tokens for r in got] == [40, 150, 100]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, **TOL)
    # a stop token cuts each row where it first appears, in both engines
    stop = got[0].token_ids[4]
    want = jax_eng.generate_batch(reqs, sampling=JaxSP(max_new_tokens=12, stop_token_ids=(stop,)))
    got = port.generate_batch(reqs, sampling=SamplingParams(max_new_tokens=12, stop_token_ids=(stop,)))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert len(got[0].token_ids) <= 4


def test_messages_go_through_the_tokenizer(engines):
    _, port, _ = engines
    msgs = [{"role": "user", "content": " ".join(map(str, range(3, 90)))}]
    sp = SamplingParams(max_new_tokens=6)
    want = port.generate(input_ids=list(range(3, 90)), sampling=sp).token_ids
    assert port.generate(msgs, sampling=sp).token_ids == want
    assert port.generate_batch([{"messages": msgs}], sampling=sp)[0].token_ids == want


def test_sampled_generate_is_seeded(engines):
    _, port, cfg = engines
    prompt = list(range(70))
    sp = SamplingParams(greedy=False, temperature=0.7, top_p=0.9, max_new_tokens=10)
    a = port.generate(input_ids=prompt, sampling=sp, seed=5)
    b = port.generate(input_ids=prompt, sampling=sp, seed=5)
    assert a.token_ids == b.token_ids and len(a.token_ids) == 10
    assert all(0 <= t < cfg.text.vocab_size for t in a.token_ids)


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(kv_quant=True), "K2"),
        (dict(weight_quant="int8"), "K6"),
        (dict(mesh=object()), "multi-GPU"),
        (dict(prefix_cache_entries=4), "server"),
        (dict(speculative_k=4), "server"),
    ],
)
def test_later_slices_raise(engines, kw, item):
    _, port, cfg = engines
    with pytest.raises(NotImplementedError, match=item):
        InferenceEngine(port.params, cfg, _MM(), **kw)


def test_media_raises(engines):
    _, port, _ = engines
    with pytest.raises(NotImplementedError, match="K3"):
        port.generate(input_ids=[1, 2, 3], images=[np.zeros((4, 4, 3))])
