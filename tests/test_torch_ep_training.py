"""PyTorch port: training a MoE model over the mesh (expert parallelism over
dp, the experts' ffn over tp, one routing batch over cp) against the JAX
package on the same mesh, on the CPU at tiny_test_config(num_experts=4)
(f32; top-2, capacity factor 0.5, so that copies drop: every case asserts
the port dropped some; moe_aux_loss_coef 0.1):

  - one step's gradients of every leaf (summed as the step sums them,
    gathered over dp and tp) and the loss against jax.grad of JAX's loss_fn
    on the same mesh: dp 2 (EP), dp 2 x tp 2, dp 2 x cp 2 (ring, zigzag
    order), cp 2 x tp 2 (local mode over the cp ranks): 1e-4 + 1e-6; and
    sequences that do not split into cp x tp equal slices (S 63 over tp 2,
    also against one device; S 52 over cp 2 x tp 4, 4 kv heads);
  - planted faults: the expert gradients summed over dp as if replicated,
    and grad_norm counting them as if replicated over dp, must fail the
    Trainer's comparison at dp 2 (which passes without them).

The helpers here (the configuration, JAX's reference step on a mesh, the
port's Trainer on thread-ranks, the comparison) serve the other
tests/test_torch_ep_*.py files: the Trainer over dp in _trainer.py, over
tp and cp in _trainer_tp.py, over pp in _pipeline.py, FSDP, checkpoints
and the rejections in _fsdp.py, serving in _serving.py.
"""
import dataclasses

import jax
import numpy as np
import pytest

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.data import dataset as jdata
from long_vita_tpu.models.qwen2 import ParallelConfig as JParallel
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu.training import trainer as jtrainer
from long_vita_tpu_torch.config import tiny_test_config as port_tiny_config
from long_vita_tpu_torch.ops import moe as tmoe
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.sharding import gather_named, rank_layout, shard_params
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import S, _jnp, _named, _pack
from test_torch_training import _jax_params as _jax_params_of


def moe_config(cfg, layers: int = 2):
    """The tiny VLM with 4 experts a layer, capacity factor 0.5 (copies
    drop) and an aux coefficient that weighs in the gradients."""
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_experts=4, moe_capacity_factor=0.5, moe_aux_loss_coef=0.1,
        num_hidden_layers=layers))


CFG = moe_config(tiny_test_config())
PORT_CFG = moe_config(port_tiny_config())
RTOL = 1e-5
TIMEOUT = 180
STEPS = 3
OPTIM = dict(lr=1e-3, warmup_steps=1, total_steps=6)
SPECS = [(1, 2, (40,)), (2, 1, (20, 50)), (3, 0, (30,)), (4, 2, (12, 44)), (5, 1, (36,)),
         (6, 0, (16, 48)), (7, 1, (24,)), (8, 0, (8, 56)), (9, 2, (32,)), (10, 1, (44,)),
         (11, 0, (28,)), (12, 1, (10, 30))]


def packs(cls, n: int = 6, seq: int = S):
    return [_pack(s, k, c, cls, seq) for s, k, c in SPECS[:n]]


def jax_params(cfg=CFG):
    """The tiny MoE VLM with non-trivial norms and biases (f32)."""
    return _jax_params_of(0, cfg)


def jmesh(m: MeshConfig):
    jm = JMeshConfig(dp=m.dp, pp=m.pp, cp=m.cp, tp=m.tp)
    return j_make_mesh(jm, devices=jax.devices()[:jm.size])


_REFERENCE: dict = {}


def jax_reference(m: MeshConfig, *, cfg=CFG, rows: int = 2, fsdp: bool = False,
                  steps: int = STEPS):
    """JAX's init_train_state and make_train_step on the mesh of ``m``'s
    geometry (its EP shard_map at dp > 1), the tower frozen, ``steps``
    steps of ``rows`` rows: -> (named params, [metrics])."""
    key = (m, cfg.text.num_hidden_layers, rows, fsdp, steps)
    if key in _REFERENCE:
        return _REFERENCE[key]
    jp = jax_params(cfg)
    mesh = jmesh(m) if m.size > 1 else None
    jtx = jopt.make_optimizer(jp, jopt.OptimizerConfig(**OPTIM, freeze_vision=True), 2)
    state = jts.init_train_state(jp, jtx, mesh, fsdp=fsdp)
    step = jts.make_train_step(cfg, jtx, mesh, remat=False, vision_chunk=2, freeze_vision=True,
                               freeze_text=False, use_ring=m.cp > 1)
    metrics = []
    n_packs = rows * steps
    for b in jtrainer.batch_iterator(iter(packs(jdata.Pack, n_packs)), rows, S, m.cp):
        state, mt = step(state, _jnp(b))
        metrics.append({k: float(v) for k, v in mt.items()})
    _REFERENCE[key] = (_named(state.params), metrics)
    return _REFERENCE[key]


def train(params, m: MeshConfig, comm, *, cfg=PORT_CFG, rows: int = 2, fsdp: bool = False,
          steps: int = STEPS, save_dir=None, resume=False):
    """One rank: a Trainer over ``comm`` (the whole tree handed in; the
    Trainer cuts the rank's shard) -> (losses, grad norms, the parameters
    gathered over dp, tp and pp)."""
    tcfg = TrainerConfig(
        seq_len=S, logit_budget=S, global_batch=rows, steps=steps, mesh=m, remat=False,
        vision_chunk=2, fsdp=fsdp, save_dir=save_dir, resume=resume,
        save_interval=steps if save_dir else 0,
        optim=topt.OptimizerConfig(**OPTIM, freeze_vision=True))
    tr = Trainer(params, cfg, tcfg, comm=comm)
    norms = []
    inner = tr.step_fn

    def logged(state, batch):
        state, mt = inner(state, batch)
        norms.append(float(mt["grad_norm"]))
        return state, mt

    tr.step_fn = logged
    stream = batch_iterator(iter(packs(tloss.Pack, rows * steps)), rows, S, m.cp)
    losses = tr.train(stream)["losses"]
    if tr.mesh is None:
        return losses, norms, {n: p.detach() for n, p in tr.state.params.named_parameters()}
    layout = rank_layout(tr.state.params, cfg, tr.mesh)
    named = dict(tr.state.params.named_parameters())
    if layout is None:
        return losses, norms, {n: p.detach() for n, p in named.items()}
    gathered = gather_named(named, layout, tr.mesh.tp_comm, dp_comm=tr.mesh.dp_comm,
                            stage=tr.state.params.text.pp)
    return losses, norms, gathered


def check(got, want):
    losses, norms, params = got
    wparams, wmetrics = want
    np.testing.assert_allclose(losses, [mt["loss"] for mt in wmetrics], rtol=RTOL)
    np.testing.assert_allclose(norms, [mt["grad_norm"] for mt in wmetrics], rtol=RTOL)
    assert set(params) == set(wparams)
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), wparams[n].numpy(), rtol=RTOL, atol=1e-5, err_msg=n)


def run_case(m: MeshConfig, **kw):
    """The Trainer on every rank of ``m`` (thread-ranks); asserts the port
    dropped copies. -> each rank's (losses, norms, params)."""
    whole = long_vita_params_from_jax(jax_params(kw.pop("jcfg", CFG)), device="cpu")
    tmoe.reset_stats()
    got = run_thread_ranks(lambda comm: train(whole, m, comm, **kw), m.size, timeout=TIMEOUT)
    assert tmoe.stats()["dropped"] > 0, tmoe.stats()
    return got


# ---- one step's gradients against JAX's loss_fn ---------------------------------


GRAD_MESHES = {"dp2": MeshConfig(dp=2), "dp2_tp2": MeshConfig(dp=2, tp=2),
               "dp2_cp2_ring": MeshConfig(dp=2, cp=2), "cp2_tp2_ring": MeshConfig(cp=2, tp=2)}


@pytest.mark.parametrize("geom", list(GRAD_MESHES))
def test_moe_gradients_over_the_mesh_match_jax(geom, one_torch_thread):
    """One step's loss (the CE plus the aux term, JAX's mean over dp of
    each shard's aux) and every leaf's gradient, summed over the ranks as
    the step sums them (an expert stack over cp alone) and gathered over
    dp and tp, against jax.grad of JAX's loss_fn on the same mesh."""
    from long_vita_tpu_torch.training.distributed import local_rows, make_global_batch

    _check_moe_gradients(GRAD_MESHES[geom])


def _kv4(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_key_value_heads=4))


UNEVEN = {
    # rows of 63 tokens over tp 2: every tp rank routes the 63 gathered
    # tokens, never the pad row that ends rank 1's slice
    "tp2_s63": dict(m=MeshConfig(tp=2), s=63),
    # 52 over cp 2 x tp 4 (4 kv heads): cp shards of 26 tokens, slices of
    # 7. Against the mesh alone: the routing batch is in zigzag order, so
    # copies drop by that order, in JAX as in the port (JAX's one-device
    # loss is 3.6e-5 off its cp mesh's here, 4.6e-6 at S 64 over cp 2)
    "cp2_tp4_s52": dict(m=MeshConfig(cp=2, tp=4), s=52, kv4=True, whole=False),
}


@pytest.mark.parametrize("case", list(UNEVEN))
def test_moe_uneven_sequence_matches_jax(case, one_torch_thread):
    """A sequence that does not split into cp x tp equal slices, which
    JAX's loss_fn trains (GSPMD pads its layout): the pad rows are routed
    nowhere, so capacity, the global slot ids and the drops are JAX's. The
    loss and every gradient against JAX's loss_fn on the same mesh and on
    one device (where the routing order is the same), as above."""
    kw = UNEVEN[case]
    cfgs = (_kv4(CFG), _kv4(PORT_CFG)) if kw.get("kv4") else (CFG, PORT_CFG)
    _check_moe_gradients(kw["m"], kw["s"], *cfgs, whole=kw.get("whole", True))


def _check_moe_gradients(m: MeshConfig, s: int = S, jcfg=CFG, cfg=PORT_CFG, whole=False):
    """One step's loss and gradients of the port over ``m`` (thread-ranks,
    2 rows of ``s`` tokens) against JAX's loss_fn on the same mesh (and,
    ``whole``, on one device too): the loss at 1e-5, the gradients at
    1e-4 + 1e-6; asserts the port dropped copies."""
    from long_vita_tpu_torch.training.distributed import local_rows, make_global_batch

    jp = jax_params(jcfg)
    jbatch = next(jtrainer.batch_iterator(iter(packs(jdata.Pack, 2, s)), 2, s, m.cp))
    refs = [(JParallel(jmesh(m)), jbatch)]
    if whole:
        refs.append((None, next(jtrainer.batch_iterator(iter(packs(jdata.Pack, 2, s)), 2, s, 1))))
    wants = []
    for jpar, b in refs:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, b: jts.loss_fn(p, b, jcfg, jpar, False, 2, True)[0]))(jp, _jnp(b))
        wants.append((float(jl), _named(jg)))
    tree = long_vita_params_from_jax(jp, device="cpu")
    batch = next(batch_iterator(iter(packs(tloss.Pack, 2, s)), 2, s, m.cp))
    tmoe.reset_stats()

    def rank(comm):
        from long_vita_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(m, comm)
        local = shard_params(tree, mesh, cfg, own=True)
        grads, loss, _, _ = tts._backward(
            local, make_global_batch(local_rows(batch, mesh, 2), mesh, "cpu"), cfg, False,
            2, True, False, mesh=mesh, parallel=tts.make_parallel_config(mesh))
        layout = rank_layout(local, cfg, mesh)
        return loss, gather_named(grads, layout, mesh.tp_comm, dp_comm=mesh.dp_comm)

    got = run_thread_ranks(rank, m.size, timeout=TIMEOUT)
    assert tmoe.stats()["dropped"] > 0, tmoe.stats()
    for loss, grads in got:
        for jl, want in wants:
            np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
            assert set(grads) == {n for n in want if not n.startswith("vision.")}
            for n, g in grads.items():
                np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=n)


# ---- planted faults ----------------------------------------------------------------


@pytest.mark.parametrize("fault", ["_EXPERTS_SUMMED_OVER_DP", "_NORM_EXPERTS_ONCE_OVER_DP"])
def test_planted_fault_in_the_expert_reduction_fails(fault, monkeypatch, one_torch_thread):
    """The Trainer's comparison at dp 2 (tests/test_torch_ep_trainer.py)
    with the expert stacks' gradients summed over dp x cp as if they were
    replicated over dp, or grad_norm counting them as a leaf replicated
    over dp (each rank its own experts alone): the gate must see each."""
    m = MeshConfig(dp=2)
    want = jax_reference(m)
    for g in run_case(m):  # the gate passes without the fault
        check(g, want)
    monkeypatch.setattr(tts, fault, True)
    got = run_case(m)
    with pytest.raises(AssertionError):
        for g in got:
            check(g, want)
