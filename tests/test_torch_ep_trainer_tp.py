"""PyTorch port: the Trainer of a MoE model over tp and cp (local mode)
against JAX's make_train_step on the same mesh (tests/test_torch_ep_training.py's
configuration: 4 experts, top-2, capacity factor 0.5, copies dropped in
every case), thread-ranks on the CPU, 3 steps: losses, grad_norm and the
gathered parameters at 1e-5 relative.

  - tp 2: every tp rank routes the gathered sequence, its ffn slice's
    partial output reduce-scattered;
  - cp 2 x tp 2 (ring): the whole batch over the cp ranks, one routing
    batch with the global slot ids and capacity.
"""
import pytest

from long_vita_tpu_torch.training.trainer import MeshConfig
from test_torch_ep_training import check, jax_reference, run_case
from test_torch_quantize import one_torch_thread  # noqa: F401

CASES = {
    "tp2": MeshConfig(tp=2),
    "cp2_tp2_ring": MeshConfig(cp=2, tp=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_moe_over_the_mesh_matches_jax(case, one_torch_thread):
    m = CASES[case]
    want = jax_reference(m)
    for got in run_case(m):
        check(got, want)
