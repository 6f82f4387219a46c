"""PyTorch port: the InferenceEngine over a tensor-parallel mesh (each rank
holding its shard of the weights and the cache's kv heads) against the JAX
engine on a CPU mesh of MeshConfig(tp=2), at tiny_test_config() in f32.

Cases: greedy generate of a 150-id prompt (three chunks of 64 and the
last-row recompute), a prompt with a 4-tile image (a thumbnail and a 2 x 2
grid, the tiles encoded 1/tp a rank), a ragged generate_batch, an int8
cache, and int8 and int4 weights (the whole tree quantised, then sharded).
The port runs on 2 thread-ranks (ThreadComm) and in two gloo processes.
Greedy tokens must be identical and logprobs within 1e-4 (1e-3 with an
int8 cache, as the cp tests allow) on every rank, and every rank must
sample the same tokens with the same logprob bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models.long_vita import init_long_vita_params
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_engine import IMG_TAG, _MM
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_serving import _fill

TOL = dict(rtol=0, atol=1e-4)
QUANT_TOL = dict(rtol=0, atol=1e-3)
KW = dict(max_seq_len=512, chunk=64, decode_segment=8)
NEW = 10
RANK_TIMEOUT = 120.0

# case -> (engine options, requests)
CASES = {
    "text": ({}, ("text",)),
    "image": ({}, ("image",)),
    "ragged_batch": ({}, ("batch",)),
    "int8_cache": (dict(kv_quant=True), ("text", "batch")),
    "int8_weights": (dict(weight_quant="int8"), ("text",)),
    "int4_weights": (dict(weight_quant="int4"), ("text",)),
}


def _jax_tree():
    cfg = tiny_test_config()
    return cfg, _fill(init_long_vita_params(jax.random.PRNGKey(0), cfg), 0)


def _requests():
    rng = np.random.default_rng(1)
    tiles = rng.standard_normal((5, 56, 56, 3)).astype(np.float32)  # thumbnail + 2 x 2
    image = rng.integers(0, 400, 100).tolist() + [IMG_TAG] + rng.integers(0, 400, 5).tolist()
    text = rng.integers(0, 500, 150).tolist()
    return dict(text=text, image=(image, tiles),
                batch=[{"input_ids": text[:40]}, {"input_ids": text},
                       {"input_ids": rng.integers(0, 400, 100).tolist()}])


def _run(engine, sp, parts):
    reqs, out = _requests(), {}
    if "text" in parts:
        out["text"] = [engine.generate(input_ids=reqs["text"], sampling=sp)]
    if "image" in parts:
        ids, tiles = reqs["image"]
        out["image"] = [engine.generate(input_ids=ids, images=[(tiles, (2, 2))], sampling=sp)]
    if "batch" in parts:
        out["batch"] = engine.generate_batch(reqs["batch"], sampling=sp)
    return {k: [(r.token_ids, r.logprobs) for r in v] for k, v in out.items()}


def _port_run(params, cfg, comm, case):
    opts, parts = CASES[case]
    eng = InferenceEngine(params, cfg, _MM(), cache_dtype=torch.float32,
                          mesh=make_mesh(MeshConfig(tp=comm.size), comm), **KW, **opts)
    assert eng._make_cache(1, 512).k.shape[3] == cfg.text.num_key_value_heads // comm.size
    return _run(eng, SamplingParams(max_new_tokens=NEW, return_logprobs=True), parts)


@pytest.fixture(scope="module")
def model():
    cfg, p = _jax_tree()
    return cfg, p, long_vita_params_from_jax(p, device="cpu"), {}


def _want(model, case):
    """The JAX engine's answers on the tp-2 CPU mesh (one engine an option
    set, kept for the module)."""
    cfg, p, _, memo = model
    opts, parts = CASES[case]
    key = tuple(sorted(opts.items()))
    if key not in memo:
        jmesh = j_make_mesh(JMeshConfig(tp=2), devices=jax.devices()[:2])
        memo[key] = (JaxEngine(jax.tree.map(jnp.asarray, p), cfg, _MM(), cache_dtype=jnp.float32,
                               mesh=jmesh, **KW, **opts), {})
    eng, answers = memo[key]
    missing = tuple(x for x in parts if x not in answers)
    if missing:
        answers.update(_run(eng, JaxSP(max_new_tokens=NEW, return_logprobs=True), missing))
    return {x: answers[x] for x in parts}


def _compare(got, want, tol):
    for key, rows in want.items():
        assert [t for t, _ in got[key]] == [t for t, _ in rows], key
        for (_, g), (_, w) in zip(got[key], rows):
            np.testing.assert_allclose(g, w, err_msg=key, **tol)
        assert all(len(set(t)) > 2 for t, _ in got[key])  # not a degenerate loop


@pytest.mark.parametrize("case", list(CASES))
def test_tp_engine_matches_jax_tp_engine(model, case, one_torch_thread):
    cfg, _, port, _ = model
    want = _want(model, case)
    res = run_thread_ranks(lambda comm: _port_run(port, cfg, comm, case), 2,
                           timeout=RANK_TIMEOUT)
    assert res[1] == res[0]  # the same tokens and logprob bits on every rank
    _compare(res[0], want, QUANT_TOL if CASES[case][0].get("kv_quant") else TOL)


GLOO_CASES = ("text", "image", "ragged_batch", "int4_weights")


def _gloo_engine_worker(rank, world, init, out):
    torch.set_num_threads(1)
    try:
        from long_vita_tpu_torch.parallel.comm import init_process_group

        comm = init_process_group(rank, world, init, backend="gloo", timeout=RANK_TIMEOUT)
        cfg, p = _jax_tree()
        port = long_vita_params_from_jax(p, device="cpu")
        out.put((rank, {case: _port_run(port, cfg, comm, case) for case in GLOO_CASES}))
        torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        out.put((rank, f"raised {type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"))


def test_tp_engine_over_two_gloo_processes(model):
    from test_torch_comm import run_gloo

    got = run_gloo(_gloo_engine_worker, 2, join_timeout=300)
    assert all(isinstance(got.get(r), dict) for r in (0, 1)), got
    assert got[1] == got[0]
    for case in GLOO_CASES:
        _compare(got[0][case], _want(model, case), TOL)


def test_tp_engine_refuses_a_geometry_that_does_not_shard(model):
    """validate_geometry first (JAX :84): 4 q heads do not split over 8."""
    cfg, _, port, _ = model

    def rank(comm):
        InferenceEngine(port, cfg, _MM(), mesh=make_mesh(MeshConfig(tp=8), comm), **KW)

    with pytest.raises(ValueError, match="attention heads 4 % tp 8"):
        run_thread_ranks(rank, 8, timeout=30)
