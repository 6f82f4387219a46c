"""PyTorch port: the Trainer of a MoE model over pipeline stages against
JAX's make_train_step on the same mesh (tests/test_torch_ep_training.py's
configuration: 4 experts, top-2, capacity factor 0.5, copies dropped),
thread-ranks on the CPU, 3 steps: losses, grad_norm and the gathered
parameters at 1e-5 relative.

  - pp 2 (one layer a stage, 2 microbatches of a row): each microbatch is
    one routing batch, its aux carried with the activation from stage to
    stage and averaged over the microbatches (JAX :842-911);
  - dp 2 x pp 2 with 4 rows: expert parallelism inside each stage, every
    dp shard of a microbatch its own routing batch.
"""
import pytest

from long_vita_tpu_torch.training.trainer import MeshConfig
from test_torch_ep_training import check, jax_reference, run_case
from test_torch_quantize import one_torch_thread  # noqa: F401

CASES = {
    "pp2": dict(mesh=MeshConfig(pp=2), rows=2),
    "dp2_pp2_4rows": dict(mesh=MeshConfig(dp=2, pp=2), rows=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_moe_over_pp_matches_jax(case, one_torch_thread):
    m, rows = CASES[case]["mesh"], CASES[case]["rows"]
    want = jax_reference(m, rows=rows)
    for got in run_case(m, rows=rows):
        check(got, want)
