"""PyTorch port: serving over 2-D tensor parallelism: the InferenceEngine (the tq
axis: every decoder weight cut over both matrix dims, the activations'
hidden dim over tq) against the JAX engine on a CPU mesh of the same
geometry, at tiny_test_config() in f32, on thread-ranks:

  - meshes tq 2 and tp 2 x tq 2 (cp 2 x tq 2 and cp 2 x tp 2 x tq 2 in
    tests/test_torch_tq_serving_cp.py);
  - cases: greedy generate of a 150-id prompt (three chunks of 64 and the
    last-row recompute), a prompt with a 4-tile image, a ragged
    generate_batch, an int8 cache, and int8 and int4 weights (the whole
    tree quantised, then cut over tp and tq);
  - greedy tokens identical, logprobs within 1e-4 (1e-3 with an int8
    cache, as the cp and tp tests allow; the ragged batch into an int8
    cache at tp 2 x tq 2, where JAX's tq engine is itself 1.12e-3 off its
    one-device engine, within 1e-4 of that one-device engine), every rank
    the same tokens and
    logprob bits, and each rank's cache holding num_kv_heads / tp heads;
  - each rank's 2-D shard of the dense, int8 and int4 trees against the
    shard JAX's shard_params puts on the same device of its mesh, bit for
    bit (JAX's quantized_param_specs on the tp2d specs);
  - a MoE model refuses tq, with JAX's words.

The pool, beam search, speculative decoding, the prefix cache and the
lockstep server over tp 2 x tq 2 are cases of tests/test_torch_tp_serving.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models import quantize as jquant
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.parallel.sharding import shard_params as j_shard_params
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models.quantize import quantize_weights_int4, quantize_weights_int8
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import shard_params
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_engine import _MM
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_tp_engine import CASES, KW, NEW, QUANT_TOL, TOL, _compare, _jax_tree, _run

RANK_TIMEOUT = 120.0
MESHES = {"tq2": dict(tq=2), "tp2_tq2": dict(tp=2, tq=2), "cp2_tq2": dict(cp=2, tq=2),
          "cp2_tp2_tq2": dict(cp=2, tp=2, tq=2)}
# every case on tp 2 x tq 2; the quantised trees on tq 2 (cp 2 x tq 2 and cp
# 2 x tp 2 x tq 2: tests/test_torch_tq_serving_cp.py)
RUNS = [("tp2_tq2", c) for c in CASES if c != "int8_cache"] + [("tp2_tq2", "int8_cache_text"),
    ("tq2", "text"), ("tq2", "int8_weights"), ("tq2", "int4_weights")]


# the int8 cache's text request alone (its ragged batch: test_int8_cache_batch_on_tp2_tq2)
CASES = {**CASES, "int8_cache_text": (CASES["int8_cache"][0], ("text",))}


@pytest.fixture(scope="module")
def model():
    cfg, p = _jax_tree()
    return cfg, p, long_vita_params_from_jax(p, device="cpu"), {}


def _jmesh(mesh: str):
    dims = MESHES[mesh]
    n = int(np.prod(list(dims.values())))
    return j_make_mesh(JMeshConfig(**dims), devices=jax.devices()[:n])


def _want(model, mesh: str, case: str):
    """The JAX engine's answers on the same mesh (one engine a mesh and
    option set, kept for the module)."""
    cfg, p, _, memo = model
    opts, parts = CASES[case]
    key = (mesh, tuple(sorted(opts.items())))
    if key not in memo:
        memo[key] = (JaxEngine(jax.tree.map(jnp.asarray, p), cfg, _MM(), cache_dtype=jnp.float32,
                               mesh=_jmesh(mesh), **KW, **opts), {})
    eng, answers = memo[key]
    missing = tuple(x for x in parts if x not in answers)
    if missing:
        answers.update(_run(eng, JaxSP(max_new_tokens=NEW, return_logprobs=True), missing))
    return {x: answers[x] for x in parts}


def _port_run(params, cfg, comm, mesh: str, case: str):
    opts, parts = CASES[case]
    m = make_mesh(MeshConfig(**MESHES[mesh]), comm)
    eng = InferenceEngine(params, cfg, _MM(), cache_dtype=torch.float32, mesh=m, **KW, **opts)
    assert eng.text.tq_comm is m.tq_comm and eng.text.tp_comm is m.tp_comm
    cache = eng._make_cache(1, 512)
    assert cache.k.shape[3] == cfg.text.num_key_value_heads // m.shape["tp"]
    assert cache.k.shape[2] == 512 // m.shape["cp"]
    return _run(eng, SamplingParams(max_new_tokens=NEW, return_logprobs=True), parts)


@pytest.mark.parametrize("mesh,case", RUNS, ids=[f"{m}-{c}" for m, c in RUNS])
def test_tq_engine_matches_jax_engine_on_the_mesh(model, mesh, case, one_torch_thread):
    cfg, _, port, _ = model
    want = _want(model, mesh, case)
    n = int(np.prod(list(MESHES[mesh].values())))
    res = run_thread_ranks(lambda comm: _port_run(port, cfg, comm, mesh, case), n,
                           timeout=RANK_TIMEOUT)
    assert all(r == res[0] for r in res)  # the same tokens and logprob bits on every rank
    _compare(res[0], want, QUANT_TOL if CASES[case][0].get("kv_quant") else TOL)


def test_int8_cache_batch_on_tp2_tq2(model, one_torch_thread):
    """The ragged batch into an int8 cache at tp 2 x tq 2. JAX's own engine
    on this mesh is 1.12e-3 off its one-device engine here (its q, k and
    v are summed over tq in another order, which moves some int8 codes of
    the cache by one step), more than the 1e-3 an int8 cache is allowed,
    while the port's tq engine is 6.3e-5 off JAX's one-device one. So the
    tokens are held to JAX's engine on the same mesh, and the logprobs to
    its one-device engine at the text cases' 1e-4; JAX's own deviation is
    asserted, so that this test notices if it goes."""
    cfg, p, port, memo = model
    opts = CASES["int8_cache"][0]
    same_mesh = _want(model, "tp2_tq2", "int8_cache")["batch"]
    one = JaxEngine(jax.tree.map(jnp.asarray, p), cfg, _MM(), cache_dtype=jnp.float32, **KW,
                    **opts)
    one_device = _run(one, JaxSP(max_new_tokens=NEW, return_logprobs=True), ("batch",))["batch"]
    jax_dev = max(np.abs(np.subtract(a[1], b[1])).max() for a, b in zip(same_mesh, one_device))
    assert jax_dev > QUANT_TOL["atol"]
    res = run_thread_ranks(lambda comm: _port_run(port, cfg, comm, "tp2_tq2", "int8_cache"), 4,
                           timeout=RANK_TIMEOUT)
    assert all(r == res[0] for r in res)
    assert [t for t, _ in res[0]["batch"]] == [t for t, _ in same_mesh]
    _compare({"batch": res[0]["batch"]}, {"batch": one_device}, TOL)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_2d_shards_match_jax_shard_params(model, quant):
    """tp 2 x tq 2: each rank's leaves of the (quantised) tree equal the
    pieces JAX's shard_params puts on the same device, bit for bit."""
    cfg, p, port, _ = model
    jtree = p
    if quant == "int8":
        jtree, port = jquant.quantize_weights_int8_host(p), quantize_weights_int8(port)
    elif quant == "int4":
        jtree, port = jquant.quantize_weights_int4_host(p), quantize_weights_int4(port)
    jmesh = _jmesh("tp2_tq2")
    placed = j_shard_params(jax.tree.map(jnp.asarray, jtree), jmesh)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)[0, 0, 0]  # [tp, tq]

    def device_tree(dev_id):
        def piece(a):
            return next(np.asarray(s.data) for s in a.addressable_shards
                        if s.device.id == dev_id)

        return jax.tree.map(piece, placed)

    def rank(comm):
        m = make_mesh(MeshConfig(tp=2, tq=2), comm)
        return m.tp_index, m.tq_index, dict(shard_params(port, m, cfg).named_parameters())

    for t, q, local in run_thread_ranks(rank, 4, timeout=RANK_TIMEOUT):
        want = dict(long_vita_params_from_jax(device_tree(ids[t, q]), device="cpu")
                    .named_parameters())
        assert local.keys() == want.keys()
        for n, x in local.items():
            assert torch.equal(x, want[n]), n


def test_moe_refuses_tq_with_jax_words():
    """JAX's engine takes a MoE model over tp and cp but not tq (its
    validate_geometry, mesh.py:129-130): the port's engine raises with the
    same words, on every rank, before it shards anything."""
    from long_vita_tpu_torch.config import tiny_test_config as port_tiny
    from long_vita_tpu_torch.models.long_vita import init_long_vita_params as port_init

    base = port_tiny()
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_experts=4))
    params = port_init(torch.Generator().manual_seed(0), cfg)

    def rank(comm):
        InferenceEngine(params, cfg, None, mesh=make_mesh(MeshConfig(tq=2), comm), **KW)

    with pytest.raises(ValueError, match="2-D TP \\(tq > 1\\) does not compose with MoE"):
        run_thread_ranks(rank, 2, timeout=30)
