"""PyTorch port: quantized-weight serving, InferenceEngine(weight_quant="int8"
| "int4") against the JAX engine with the same option, on the same f32 tree
(CPU, max_seq_len 512, chunk 64), at the tiny geometry and the 128-group
one of tests/test_torch_quantize.py (where every int4 product of a decode
step, a prefill chunk and the head takes the kernel route: K6's plain version
in the port).

Greedy tokens must be identical; logprobs agree to 1e-4 absolute (f32 GEMMs
summed in another order through two layers, then a log-softmax over 512
logits, as tests/test_torch_engine.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.ops import quant_matmul as tqm
from long_vita_tpu_torch.utils.convert import params_from_jax
from test_torch_engine import _MM
from test_torch_quantize import GEOMETRIES, jax_params, one_torch_thread  # noqa: F401

TOL = dict(rtol=0, atol=1e-4)
KW = dict(max_seq_len=512, chunk=64, decode_segment=8)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def model(request):
    cfg = GEOMETRIES[request.param]()
    p = jax_params(cfg, seed=0)
    return request.param, cfg, p, params_from_jax(p, device="cpu")


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_engine_matches_jax(model, quant):
    """Solo generate (150 ids: three chunks and the last-row recompute) and a
    ragged batch of 40 / 150 / 100 ids."""
    geometry, cfg, p, tp = model
    jax_eng = JaxEngine({"text": p}, cfg, _MM(), cache_dtype=jnp.float32, weight_quant=quant, **KW)
    port = InferenceEngine(tp, cfg, _MM(), cache_dtype=torch.float32, weight_quant=quant, **KW)
    kind = tq.QuantDense8 if quant == "int8" else tq.QuantDense4
    assert isinstance(port.text.layers[0].q_proj, kind) and isinstance(port.text.lm_head, kind)
    assert isinstance(tp.layers[0].q_proj, tq.Dense)  # the caller's tree is untouched
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.text.vocab_size, 150).tolist()
    sp = dict(max_new_tokens=16, return_logprobs=True)
    dequant = tqm.w4_matmul_dequant.calls
    want = jax_eng.generate(input_ids=prompt, sampling=JaxSP(**sp))
    got = port.generate(input_ids=prompt, sampling=SamplingParams(**sp))
    assert got.token_ids == want.token_ids
    assert len(set(got.token_ids)) > 3, got.token_ids
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)
    if quant == "int4" and geometry == "g128":  # every product took the kernel route
        assert tqm.w4_matmul_dequant.calls == dequant
    reqs = [{"input_ids": rng.integers(0, cfg.text.vocab_size, n).tolist()} for n in (40, 150, 100)]
    want = jax_eng.generate_batch(reqs, sampling=JaxSP(**sp))
    got = port.generate_batch(reqs, sampling=SamplingParams(**sp))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, **TOL)


def test_unknown_weight_quant_raises(model):
    _, cfg, p, tp = model
    with pytest.raises(ValueError, match="weight_quant"):
        JaxEngine({"text": p}, cfg, _MM(), weight_quant="fp8")
    with pytest.raises(ValueError, match="weight_quant"):
        InferenceEngine(tp, cfg, _MM(), weight_quant="fp8")
