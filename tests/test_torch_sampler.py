"""PyTorch port: inference/sampler.py against the JAX sampler.

jax.random and torch.Generator draw different bits, so sampled tokens are
not compared. What is compared: greedy picks (exact) and the truncated
logits the categorical draw sees — the JAX side is captured by patching
jax.random.categorical. The keep/cut masks must be identical and the kept
logits agree to 1e-6 relative (f32 division by the temperature).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.inference import sampler as js
from long_vita_tpu_torch.inference import sampler as ts


def _logits(seed, b=3, v=512):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32) * 3


def test_sampling_params_mirror_the_jax_fields():
    assert [f.name for f in dataclasses.fields(ts.SamplingParams)] == [
        f.name for f in dataclasses.fields(js.SamplingParams)
    ]
    assert ts.SamplingParams() == ts.SamplingParams(**dataclasses.asdict(js.SamplingParams()))


def test_greedy_is_exact():
    lg = _logits(0)
    want = np.asarray(js.sample(jnp.asarray(lg), jax.random.PRNGKey(0), js.SamplingParams()))
    got = ts.sample(torch.as_tensor(lg), torch.Generator(), ts.SamplingParams())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "kw",
    [
        dict(temperature=0.7),
        dict(top_k=20),
        dict(top_p=0.9),
        dict(temperature=0.7, top_p=0.9),
        dict(temperature=1.3, top_k=50, top_p=0.8),
    ],
)
def test_truncation_matches_jax(monkeypatch, kw):
    lg = _logits(1)
    seen = {}

    def capture(rng, logits, axis=-1):
        seen["logits"] = np.asarray(logits)
        return jnp.zeros(logits.shape[0], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    js.sample(jnp.asarray(lg), jax.random.PRNGKey(0), js.SamplingParams(greedy=False, **kw))
    want = seen["logits"]
    got = ts.truncate_logits(torch.as_tensor(lg), ts.SamplingParams(greedy=False, **kw)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = np.isfinite(want)
    assert 0 < keep.sum() < keep.size or kw == dict(temperature=0.7)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_sampled_tokens_stay_inside_the_mask_and_follow_the_seed():
    lg = torch.as_tensor(_logits(2))
    sp = ts.SamplingParams(greedy=False, temperature=0.7, top_p=0.9)
    keep = torch.isfinite(ts.truncate_logits(lg, sp))
    draws = [ts.sample(lg, torch.Generator().manual_seed(s), sp) for s in range(20)]
    for tok in draws:
        assert keep[torch.arange(3), tok].all()
    again = ts.sample(lg, torch.Generator().manual_seed(7), sp)
    assert torch.equal(again, draws[7])
