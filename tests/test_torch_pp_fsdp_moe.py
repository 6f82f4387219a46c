"""PyTorch port: a MoE model under FSDP inside pipeline stages, which JAX
composes (init_train_state(..., fsdp=True) on a dp x pp mesh: the dense
leaves of each stage's layers cut over dp, the expert stacks over dp for
expert parallelism), against JAX's make_train_step on the same mesh, on
the CPU in thread-ranks (tests/test_torch_ep_training.py's configuration:
4 experts, top-2, capacity factor 0.5, copies dropped), 3 steps of 4 rows
at dp 2 x pp 2: losses, grad_norm and the gathered parameters at 1e-5
relative. Each stage streams its layers' attention weights and norms over
dp and never gathers its experts; every dp shard of a microbatch is its
own routing batch, its aux carried from stage to stage.
"""
from long_vita_tpu_torch.training.trainer import MeshConfig
from test_torch_ep_training import check, jax_reference, run_case
from test_torch_quantize import one_torch_thread  # noqa: F401


def test_trainer_moe_with_fsdp_over_dp2_pp2_matches_jax(one_torch_thread):
    m = MeshConfig(dp=2, pp=2)
    want = jax_reference(m, rows=4, fsdp=True)
    for got in run_case(m, rows=4, fsdp=True):
        check(got, want)
