"""PyTorch port: the Trainer of a MoE model over dp (expert parallelism)
against JAX's make_train_step on the same mesh (tests/test_torch_ep_training.py's
configuration: 4 experts, top-2, capacity factor 0.5, copies dropped in
every case), thread-ranks on the CPU, 3 steps: losses, grad_norm and the
gathered parameters at 1e-5 relative.

  - dp 2: each dp rank routes its row alone and holds 2 of the 4 experts;
  - dp 2 x tp 2: the experts' ffn cut over tp too (sequence parallel);
  - dp 2 x cp 2 (ring): each dp shard's tokens over its cp ranks, in the
    zigzag order, one routing batch with the global slot ids.
"""
import pytest

from long_vita_tpu_torch.training.trainer import MeshConfig
from test_torch_ep_training import check, jax_reference, run_case
from test_torch_quantize import one_torch_thread  # noqa: F401

CASES = {
    "dp2_ep": MeshConfig(dp=2),
    "dp2_tp2": MeshConfig(dp=2, tp=2),
    "dp2_cp2_ring": MeshConfig(dp=2, cp=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_moe_over_the_mesh_matches_jax(case, one_torch_thread):
    m = CASES[case]
    want = jax_reference(m)
    for got in run_case(m):
        check(got, want)
