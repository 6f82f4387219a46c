"""PyTorch port: serving a MoE model over tp 2, cp 2 and cp 2 x tp 2 against
the JAX engine on a CPU mesh of the same geometry, at
tiny_test_config(num_experts=4) in f32 with capacity factor 0.5, so that
copies drop (every case asserts the port dropped some): each call (a
prefill chunk, a verify chunk, a decode step) is one routing batch, over
cp's q-sharded chunks every rank's rows with the global slot ids, and over
tp each rank runs its slice of the experts' ffn, its partial output summed
over tp. Greedy tokens identical, logprobs within 1e-4:

  - generate with chunked prefill (chunks of 64, a 44-row last chunk) and
    decode, on each mesh;
  - a continuous-pool row joining mid-flight at cp 2;
  - the speculative pool (prompt-lookup verify chunks of 4 rows) at cp 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.data.image_processor import ImageProcessor as JaxIP
from long_vita_tpu.data.multimodal import MultimodalTokenizer as JaxMM
from long_vita_tpu.inference.continuous import ContinuousEngine as JaxCE
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models.long_vita import init_long_vita_params
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu_torch.config import tiny_test_config as port_tiny_config
from long_vita_tpu_torch.data.image_processor import ImageProcessor
from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
from long_vita_tpu_torch.inference.continuous import ContinuousEngine
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.ops import moe as tmoe
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_cp_serving import _drive, _prompts, _same_results
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_serving import _fill, tiny_tokenizer

KW = dict(max_seq_len=512, chunk=64)
RANK_TIMEOUT = 120.0
MESHES = {"tp2": dict(tp=2), "cp2": dict(cp=2), "cp2xtp2": dict(cp=2, tp=2)}


def _moe(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_experts=4, moe_capacity_factor=0.5))


@pytest.fixture(scope="module")
def model():
    """Random MoE weights (_fill's norms and biases, seed 0), the JAX engine
    on each mesh over them (made on first use), and the port's tree."""
    cfg = _moe(tiny_test_config())
    p = _fill(init_long_vita_params(jax.random.PRNGKey(0), cfg), 0)
    return p, {}, long_vita_params_from_jax(p, device="cpu"), _moe(port_tiny_config()), \
        tiny_tokenizer(), cfg


def _jax_engine(model, mesh: str, speculative_k: int = 0):
    p, engines, _, _, tok, cfg = model
    key = (mesh, speculative_k)
    if key not in engines:
        dims = MESHES[mesh]
        jmesh = j_make_mesh(JMeshConfig(**dims),
                            devices=jax.devices()[:int(np.prod(list(dims.values())))])
        engines[key] = JaxEngine(
            jax.tree.map(jnp.asarray, p), cfg,
            JaxMM(tok, image_processor=JaxIP(image_size=56), image_token_length=4),
            cache_dtype=jnp.float32, mesh=jmesh, speculative_k=speculative_k, **KW)
    return engines[key]


def _port_engine(model, comm, mesh: str, **kw):
    _, _, params, cfg, tok, _ = model
    mm = MultimodalTokenizer(tok, image_processor=ImageProcessor(image_size=56),
                             image_token_length=4)
    return InferenceEngine(params, cfg, mm, cache_dtype=torch.float32,
                           mesh=make_mesh(MeshConfig(**MESHES[mesh]), comm), **{**KW, **kw})


def _on_ranks(mesh: str, fn):
    n = int(np.prod(list(MESHES[mesh].values())))
    tmoe.reset_stats()
    out = run_thread_ranks(fn, n, timeout=RANK_TIMEOUT, join_timeout=4 * RANK_TIMEOUT)
    assert tmoe.stats()["dropped"] > 0, tmoe.stats()
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_generate_matches_jax_on_the_mesh(model, mesh, one_torch_thread):
    prompt = _prompts(1, (300,))[0]
    want = _jax_engine(model, mesh).generate(
        input_ids=prompt, sampling=JaxSP(max_new_tokens=10, return_logprobs=True))

    def rank(comm):
        return _port_engine(model, comm, mesh).generate(
            input_ids=prompt, sampling=SamplingParams(max_new_tokens=10, return_logprobs=True))

    for got in _on_ranks(mesh, rank):
        _same_results([got], [want])


def test_moe_pool_row_matches_jax_at_cp2(model, one_torch_thread):
    """A row joins the slot pool mid-flight; the first prompt spans both cp
    ranks' shards."""
    prompts = _prompts(0, (300, 55))
    sp = dict(max_new_tokens=8, return_logprobs=True)
    schedule = [("add", prompts[0]), ("step",), ("add", prompts[1])]
    want = _drive(JaxCE(_jax_engine(model, "cp2"), JaxSP(**sp), max_slots=2, tick=3), schedule)

    def rank(comm):
        eng = _port_engine(model, comm, "cp2")
        return _drive(ContinuousEngine(eng, SamplingParams(**sp), max_slots=2, tick=3),
                      schedule)

    for got in _on_ranks("cp2", rank):
        _same_results(got, want)


def test_moe_speculative_pool_matches_jax_at_cp2(model, one_torch_thread):
    """speculative_k = 4: one batched verify chunk a tick, routed as one
    call over the pool's rows."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, 12).tolist()
    prompts = [base * 25, rng.integers(0, 256, 49).tolist()]  # the first repeats itself
    sp = dict(max_new_tokens=8, return_logprobs=True)
    schedule = [("add", prompts[0]), ("step",), ("add", prompts[1])]
    want = _drive(JaxCE(_jax_engine(model, "cp2", speculative_k=4), JaxSP(**sp), max_slots=2,
                        tick=3), schedule)

    def rank(comm):
        eng = _port_engine(model, comm, "cp2", speculative_k=4)
        got = _drive(ContinuousEngine(eng, SamplingParams(**sp), max_slots=2, tick=3), schedule)
        return got, eng._spec_steps

    for got, steps in _on_ranks("cp2", rank):
        _same_results(got, want)
        assert steps > 0
