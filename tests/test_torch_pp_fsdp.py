"""PyTorch port: FSDP inside pipeline stages (dp x pp, JAX's
text_param_specs(fsdp=True, pp=True)) against the JAX package, on the CPU
at tiny_test_config() with 4 decoder layers (f32; thread-ranks, one a rank
of the mesh):

  - the Trainer with FSDP at dp 2 x pp 2 (GPipe, remat off: the
    saved-tensor hooks), dp 2 x pp 2 x virtual_pp 2 (remat on: the
    recompute) and dp 2 x pp 2 x tp 2 against JAX's
    init_train_state(..., fsdp=True) / make_train_step on the same mesh
    over 3 steps: losses, grad_norm and the gathered parameters at 1e-5
    relative; every rank reports the same losses;
  - each step's gathers, regathers and scatters on every rank equal
    parallel/fsdp.step_counts of its stage, and at most one unit's
    gathered weights are alive at any gather (``live_units()`` peak 1);
  - every dp rank of a stage makes the same dp collectives and pipeline
    shifts in the same order (recorded on thread-ranks under a timeout);
  - gradient accumulation over dp 2 x pp 2 against JAX's
    make_grad_accum_steps on the same mesh;
  - the planted faults fail the comparison: grad_norm without its dp sum
    of squares, the reduce-scatter replaced by the rank's own slice, and
    the embedding's and head's shards not summed over pp.

Checkpoints, the slice loader and train.main are in
tests/test_torch_pp_fsdp_checkpoint.py.
"""
import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.data import dataset as jdata
from long_vita_tpu.parallel import pipeline as jpl
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu.training import trainer as jtrainer
from long_vita_tpu_torch.parallel import fsdp as tfsdp
from long_vita_tpu_torch.parallel import pipeline as tpipe
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.sharding import gather_params
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_pp_training import BATCH, CFG, OPTIM, RTOL, STEPS, _check, _jax_params, _packs
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import S, _jnp, _named

TIMEOUT = 180

_REFERENCE: dict = {}


def _reference(mesh: dict, v: int = 1, remat=False, accum: bool = False):
    """JAX's FSDP train step on the pp mesh ``mesh`` (the tower frozen;
    ``accum``: two micro-batches of BATCH rows a step), STEPS steps:
    -> (named params in canonical order, [metrics])."""
    key = (tuple(sorted(mesh.items())), v, remat, accum)
    if key in _REFERENCE:
        return _REFERENCE[key]
    jmcfg = JMeshConfig(**mesh)
    jmesh = j_make_mesh(jmcfg, devices=jax.devices()[:jmcfg.size])
    jparams = _jax_params(0)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**OPTIM, freeze_vision=True), 2)
    flags = dict(freeze_vision=True, remat=remat, vision_chunk=2, virtual_pp=v)
    state = jts.init_train_state(jparams, jtx, jmesh, fsdp=True, virtual_pp=v)
    metrics = []
    batches = list(jtrainer.batch_iterator(iter(_packs(jdata.Pack) * 2), BATCH, S, 1))
    if accum:
        grad_fn, accum_fn, apply_fn = jts.make_grad_accum_steps(CFG, jtx, jmesh, **flags)
        for i in range(STEPS):
            acc = loss_sum = count_sum = None
            for mb in batches[2 * i:2 * i + 2]:
                g, loss, count = grad_fn(state.params, _jnp(mb))
                if acc is None:
                    acc, loss_sum, count_sum = g, loss, count
                else:
                    acc, loss_sum, count_sum = accum_fn(acc, g), loss_sum + loss, count_sum + count
            state, m = apply_fn(state, acc, loss_sum, count_sum, jnp.asarray(2.0))
            metrics.append({k: float(x) for k, x in m.items()})
    else:
        step = jts.make_train_step(CFG, jtx, jmesh, **flags)
        for b in batches[:STEPS]:
            state, m = step(state, _jnp(b))
            metrics.append({k: float(x) for k, x in m.items()})
    params = jax.tree.map(np.asarray, state.params)
    if v > 1:
        params["text"]["layers"] = jpl.permute_layer_stack(params["text"]["layers"],
                                                          mesh["pp"], v, inverse=True)
    _REFERENCE[key] = (_named(jax.tree.map(jnp.asarray, params)), metrics)
    return _REFERENCE[key]


def _train(params, mesh, comm, *, v=1, remat=False, accum=False):
    """One rank: a Trainer with FSDP over ``comm`` (the whole tree handed
    in) -> (losses, grad norms, the whole parameters, [each step's
    Fsdp.stats], its stage index)."""
    tcfg = TrainerConfig(
        seq_len=S, logit_budget=S, global_batch=2 * BATCH if accum else BATCH,
        micro_batch=BATCH if accum else 0,
        steps=STEPS, mesh=mesh, remat=remat, vision_chunk=2, virtual_pp=v, fsdp=True,
        optim=topt.OptimizerConfig(**OPTIM, freeze_vision=True))
    tr = Trainer(copy.deepcopy(params), CFG, tcfg, comm=comm)
    text = tr.state.params.text
    assert text.fsdp is not None and text.pp is not None and text.pp.virtual == v
    norms, stats = [], []
    name = "apply_fn" if accum else "step_fn"
    inner = getattr(tr, name)

    def logged(*a):
        state, m = inner(*a)
        norms.append(float(m["grad_norm"]))
        stats.append(dict(text.fsdp.stats))
        text.fsdp.reset_stats()
        return state, m

    setattr(tr, name, logged)
    losses = tr.train(batch_iterator(iter(_packs(tloss.Pack) * 2), BATCH, S, 1))["losses"]
    whole = gather_params(tr.state.params, tr.mesh, CFG)
    return (losses, norms, {n: p.detach().clone() for n, p in whole.named_parameters()}, stats,
            text.pp.index)


def _ranks(mesh: MeshConfig, **kw):
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    res = run_thread_ranks(lambda comm: _train(whole, mesh, comm, **kw), mesh.size,
                           timeout=TIMEOUT)
    assert all(r[0] == res[0][0] and r[1] == res[0][1] for r in res)
    return res


CASES = {
    "dp2_pp2": dict(mesh=dict(dp=2, pp=2), v=1, remat=False),
    "dp2_pp2_v2_remat": dict(mesh=dict(dp=2, pp=2), v=2, remat=True),
    "dp2_pp2_tp2": dict(mesh=dict(dp=2, pp=2, tp=2), v=1, remat=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_with_fsdp_over_pp_matches_jax(case, one_torch_thread):
    """Losses, grad_norm and parameters against JAX's FSDP step on the same
    mesh; every step's gather, regather and scatter counts on every rank
    equal step_counts of its stage, and one unit is alive at a time."""
    kw = CASES[case]
    want = _reference(kw["mesh"], kw["v"], kw["remat"])
    mesh = MeshConfig(**kw["mesh"])
    layers = CFG.text.num_hidden_layers // mesh.pp
    for losses, norms, params, stats, stage in _ranks(mesh, v=kw["v"], remat=kw["remat"]):
        _check((losses, norms, params), want)
        counts = tfsdp.step_counts(layers, mesh.pp, stage == 0, stage == mesh.pp - 1,
                                   kw["remat"])
        for s in stats:
            assert {k: s[k] for k in counts} == counts, (stage, s)
            assert s["peak_live"] == 1, s


def test_grad_accumulation_with_fsdp_over_pp_matches_jax(one_torch_thread):
    """Two micro-batches of four rows a step over dp 2 x pp 2 (each dp
    rank's two rows are the pipeline's M = 2 microbatches of one row)
    against JAX's make_grad_accum_steps on the same mesh."""
    want = _reference(dict(dp=2, pp=2), 1, accum=True)
    for got in _ranks(MeshConfig(dp=2, pp=2), accum=True):
        _check(got[:3], want)


def test_dp_ranks_of_a_stage_run_the_same_ticks_in_the_same_order(monkeypatch,
                                                                     one_torch_thread):
    """One step at dp 2 x pp 2 (GPipe, remat off) and at virtual_pp 2 with
    remat, each rank's sequence of dp gathers, regathers, reduce-scatters
    and pipeline shifts (forward and backward, with the shapes moved),
    recorded on thread-ranks under a timeout: the two dp ranks of a stage
    record the same sequence, and the two stages of a dp index the same
    shifts."""
    log = threading.local()
    gather, scatter = tfsdp._Unit.gather, tfsdp._Unit.scatter
    fwd, bwd = tpipe._Shift.forward, tpipe._Shift.backward

    def rec(event):
        getattr(log, "events", []).append(event)

    def logged_gather(self, register):
        rec(("regather" if not register else "gather",
             tuple(tuple(s.shape) for s in self.shards)))
        return gather(self, register)

    def logged_scatter(self, grads):
        rec(("scatter", tuple(tuple(s.shape) for s in self.shards)))
        return scatter(self, grads)

    def logged_fwd(ctx, comm, dst, src, specs, stats, token, *xs):
        rec(("shift", dst is not None, src is not None))
        return fwd(ctx, comm, dst, src, specs, stats, token, *xs)

    def logged_bwd(ctx, g_token, *g):
        rec(("shift_back", ctx.dst is not None, ctx.src is not None))
        return bwd(ctx, g_token, *g)

    monkeypatch.setattr(tfsdp._Unit, "gather", logged_gather)
    monkeypatch.setattr(tfsdp._Unit, "scatter", logged_scatter)
    monkeypatch.setattr(tpipe._Shift, "forward", staticmethod(logged_fwd))
    monkeypatch.setattr(tpipe._Shift, "backward", staticmethod(logged_bwd))
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    mesh = MeshConfig(dp=2, pp=2)
    for v, remat in ((1, False), (2, True)):
        tcfg = TrainerConfig(seq_len=S, logit_budget=S, global_batch=BATCH, steps=1, mesh=mesh,
                             remat=remat, vision_chunk=2, virtual_pp=v, fsdp=True,
                             optim=topt.OptimizerConfig(**OPTIM, freeze_vision=True))

        def rank(comm):
            tr = Trainer(copy.deepcopy(whole), CFG, tcfg, comm=comm)
            log.events = []
            tr.train(batch_iterator(iter(_packs(tloss.Pack)), BATCH, S, 1))
            return tr.mesh.dp_index, tr.mesh.pp_index, log.events

        res = run_thread_ranks(rank, mesh.size, timeout=60)
        by = {(d, p): ev for d, p, ev in res}
        for p in range(2):
            assert by[(0, p)] == by[(1, p)], (v, p)
            assert sum(e[0] == "scatter" for e in by[(0, p)]) > 0
        shifts = [[e for e in by[(0, p)] if e[0].startswith("shift")] for p in range(2)]
        assert len(shifts[0]) == len(shifts[1]) == 2 * tpipe.ticks(2, 2, v)


FAULTS = {
    "norm_unsummed_over_dp": (tts, "_NORM_UNSUMMED_OVER_DP", True),
    "local_slice_not_scattered": (tfsdp, "_LOCAL_SLICE_NOT_SCATTERED", True),
    "shared_shards_unsummed_over_pp": (tts, "_UNSUMMED_OVER_PP", True),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_comparison(fault, monkeypatch, one_torch_thread):
    module, name, value = FAULTS[fault]
    want = _reference(dict(dp=2, pp=2))
    monkeypatch.setattr(module, name, value)
    with pytest.raises(AssertionError):  # the ranks disagree, or disagree with JAX
        for r in _ranks(MeshConfig(dp=2, pp=2)):
            _check(r[:3], want, rtol=RTOL)
