"""PyTorch port: the InferenceEngine over cp x tq and cp x tp x tq (a
cache sharded over cp by slot, the weights cut over tp and tq) against the
JAX engine on a CPU mesh of the same geometry, at tiny_test_config() in
f32, on thread-ranks (tests/test_torch_tq_serving.py's cases and checks):
text, a 4-tile image, an int8 cache and int4 weights on cp 2 x tq 2; text,
a ragged batch, int8 weights and an int8 cache on cp 2 x tp 2 x tq 2.
Greedy tokens identical, logprobs within 1e-4 (1e-3 with an int8 cache),
every rank the same bits.
"""
import numpy as np
import pytest

from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_tq_serving import (  # noqa: F401 (model: a fixture)
    CASES,
    MESHES,
    QUANT_TOL,
    RANK_TIMEOUT,
    TOL,
    _compare,
    _port_run,
    _want,
    model,
)

RUNS = [("cp2_tq2", "text"), ("cp2_tq2", "image"), ("cp2_tq2", "int8_cache"),
        ("cp2_tq2", "int4_weights"), ("cp2_tp2_tq2", "text"), ("cp2_tp2_tq2", "ragged_batch"),
        ("cp2_tp2_tq2", "int8_weights"), ("cp2_tp2_tq2", "int8_cache")]


@pytest.mark.parametrize("mesh,case", RUNS, ids=[f"{m}-{c}" for m, c in RUNS])
def test_cp_tq_engine_matches_jax_engine_on_the_mesh(model, mesh, case, one_torch_thread):
    cfg, _, port, _ = model
    want = _want(model, mesh, case)
    n = int(np.prod(list(MESHES[mesh].values())))
    res = run_thread_ranks(lambda comm: _port_run(port, cfg, comm, mesh, case), n,
                           timeout=RANK_TIMEOUT)
    assert all(r == res[0] for r in res)  # the same tokens and logprob bits on every rank
    _compare(res[0], want, QUANT_TOL if CASES[case][0].get("kv_quant") else TOL)
