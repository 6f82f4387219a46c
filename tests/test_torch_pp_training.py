"""PyTorch port: training over pipeline stages (GPipe and the interleaved
schedule) against the JAX package, on the CPU at tiny_test_config() with 4
decoder layers (f32; thread-ranks, one a rank of the mesh):

  - the Trainer at pp 2, pp 2 x v 2, pp 4 x tp 2 (JAX's
    test_training.py:368-385 geometry) and dp 2 x pp 2 x tp 2 (JAX's
    multi-controller "pp2" geometry, batch dp x pp) against JAX's train
    step on the same mesh (init_train_state and make_train_step with its
    virtual_pp, the interleaved stack compared in canonical order) over 3
    steps: losses, grad_norm and the gathered parameters at 1e-5 relative;
    every rank reports the same losses; pp 2 x tp 2 on 63-token rows (a
    stage's slices padded) against JAX on the same mesh and on one device;
  - stage 1 (freeze_vision and freeze_text: the projector alone moves,
    every other leaf keeps its bits) with remat over pp 2 x v 2, and
    gradient accumulation over pp 2, against JAX on the same mesh;
  - the interleaved schedule against GPipe in the port (1e-6);
  - train.main(device="cpu") from a recipe with mesh {pp: 2} in two gloo
    processes, each reading its stage's layers of the *_HF directory,
    against JAX's Trainer on the same recipe.
"""
import copy
import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.data import dataset as jdata
from long_vita_tpu.parallel import pipeline as jpl
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu.training import trainer as jtrainer
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.sharding import gather_params
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_comm import run_gloo
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import S, _jnp, _named, _pack
from test_torch_training import _jax_params as _jax_params_of

BASE = tiny_test_config()
CFG = dataclasses.replace(BASE, text=dataclasses.replace(BASE.text, num_hidden_layers=4))
RTOL = 1e-5
TIMEOUT = 180
STEPS = 3
BATCH = 4
OPTIM = dict(lr=1e-3, warmup_steps=1, total_steps=6)


def _jax_params(seed=0):
    """The 4-layer tiny VLM with non-trivial norms and biases (f32)."""
    return _jax_params_of(seed, CFG)


SPECS = [(1, 2, (40,)), (2, 1, (20, 50)), (3, 0, (30,)), (4, 2, (12, 44)), (5, 1, (36,)),
         (6, 0, (16, 48)), (7, 1, (24,)), (8, 0, (8, 56)), (9, 2, (32,)), (10, 1, (44,)),
         (11, 0, (28,)), (12, 1, (10, 30))]


def _packs(cls, seq=S):
    # the 4-layer configuration's vocabulary and tile tokens are the 2-layer one's
    return [_pack(s, n, c, cls, seq) for s, n, c in SPECS]


_REFERENCE: dict = {}


def _reference(mesh: dict, v: int = 1, fv: bool = True, ft: bool = False, remat=False,
               accum: bool = False, seq: int = S):
    """JAX's train step (with ``accum`` its gradient accumulation, two
    micro-batches of BATCH / 2 rows) on the pp mesh ``mesh`` (one device
    when {}), STEPS steps on the whole batches of ``seq``-token rows: ->
    (named params in canonical order, [metrics])."""
    key = (tuple(sorted(mesh.items())), v, fv, ft, remat, accum, seq)
    if key in _REFERENCE:
        return _REFERENCE[key]
    jmcfg = JMeshConfig(**mesh)
    jmesh = j_make_mesh(jmcfg, devices=jax.devices()[:jmcfg.size]) if mesh else None
    jparams = _jax_params(0)
    flags = dict(freeze_vision=fv, freeze_text=ft, remat=remat, vision_chunk=2)
    pp_kw = dict(virtual_pp=v) if mesh else {}
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**OPTIM, freeze_vision=fv,
                                                            freeze_text=ft), 2)
    state, metrics = jts.init_train_state(jparams, jtx, jmesh, **pp_kw), []
    rows = BATCH // 2 if accum else BATCH
    batches = list(jtrainer.batch_iterator(iter(_packs(jdata.Pack, seq)), rows, seq, 1))
    if accum:
        grad_fn, accum_fn, apply_fn = jts.make_grad_accum_steps(CFG, jtx, jmesh, **pp_kw,
                                                                **flags)
        for i in range(STEPS):
            acc = loss_sum = count_sum = None
            for mb in batches[2 * i:2 * i + 2]:
                g, loss, count = grad_fn(state.params, _jnp(mb))
                if acc is None:
                    acc, loss_sum, count_sum = g, loss, count
                else:
                    acc, loss_sum, count_sum = accum_fn(acc, g), loss_sum + loss, count_sum + count
            state, m = apply_fn(state, acc, loss_sum, count_sum, jnp.asarray(2.0))
            metrics.append({k: float(v) for k, v in m.items()})
    else:
        step = jts.make_train_step(CFG, jtx, jmesh, **pp_kw, **flags)
        for b in batches[:STEPS]:
            state, m = step(state, _jnp(b))
            metrics.append({k: float(v) for k, v in m.items()})
    params = jax.tree.map(np.asarray, state.params)
    if mesh.get("pp", 1) > 1 and v > 1:
        params["text"]["layers"] = jpl.permute_layer_stack(params["text"]["layers"],
                                                          mesh["pp"], v, inverse=True)
    _REFERENCE[key] = (_named(jax.tree.map(jnp.asarray, params)), metrics)
    return _REFERENCE[key]


def _train(params, mesh, comm, *, v=1, fv=True, ft=False, remat=False, accum=False, seq=S):
    """One rank: a Trainer over ``comm`` (the whole tree handed in; the
    Trainer cuts the rank's stage and shard) on ``seq``-token rows ->
    (losses, grad norms, the whole parameters gathered over tp and pp)."""
    tcfg = TrainerConfig(
        seq_len=seq, logit_budget=seq, global_batch=BATCH, micro_batch=BATCH // 2 if accum else 0,
        steps=STEPS, mesh=mesh, remat=remat, vision_chunk=2, virtual_pp=v,
        optim=topt.OptimizerConfig(**OPTIM, freeze_vision=fv, freeze_text=ft))
    tr = Trainer(copy.deepcopy(params), CFG, tcfg, comm=comm)
    norms = []
    name = "apply_fn" if accum else "step_fn"
    inner = getattr(tr, name)

    def logged(*a):
        state, m = inner(*a)
        norms.append(float(m["grad_norm"]))
        return state, m

    setattr(tr, name, logged)
    rows = BATCH // 2 if accum else BATCH
    losses = tr.train(batch_iterator(iter(_packs(tloss.Pack, seq)), rows, seq,
                                     mesh.cp))["losses"]
    whole = gather_params(tr.state.params, tr.mesh, CFG) if tr.mesh is not None else \
        tr.state.params
    return losses, norms, {n: p.detach().clone() for n, p in whole.named_parameters()}


def _check(got, want, rtol=RTOL, atol=1e-5):
    losses, norms, params = got
    wparams, wmetrics = want
    np.testing.assert_allclose(losses, [m["loss"] for m in wmetrics], rtol=rtol)
    np.testing.assert_allclose(norms, [m["grad_norm"] for m in wmetrics], rtol=rtol)
    assert set(params) == set(wparams)
    for n, p in params.items():
        # rtol and atol 1e-5, as the tp trainer's test: Adam's 1 / sqrt(v)
        # lifts the rounding of a tiny gradient
        np.testing.assert_allclose(p.numpy(), wparams[n].numpy(), rtol=rtol, atol=atol,
                                   err_msg=n)


def _ranks(mesh: MeshConfig, **kw):
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    res = run_thread_ranks(lambda comm: _train(whole, mesh, comm, **kw), mesh.size,
                           timeout=TIMEOUT)
    assert all(r[0] == res[0][0] and r[1] == res[0][1] for r in res)
    return res


CASES = {
    "pp2": dict(mesh=dict(pp=2), v=1),
    "pp2_v2": dict(mesh=dict(pp=2), v=2),
    "pp4_tp2": dict(mesh=dict(pp=4, tp=2), v=1),
    "dp2_pp2_tp2": dict(mesh=dict(dp=2, pp=2, tp=2), v=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_over_pp_matches_jax(case, one_torch_thread):
    kw = CASES[case]
    want = _reference(kw["mesh"], kw["v"])
    for got in _ranks(MeshConfig(**kw["mesh"]), v=kw["v"]):
        _check(got, want)


def test_uneven_sequence_over_pp2_tp2_matches_jax(one_torch_thread):
    """Rows of 63 tokens over pp 2 x tp 2: each stage's activation is the
    rank's slice of 32 rows, rank 1's ending in a pad row, and the first
    stage looks the ids up plainly (JAX's lookup on a pp mesh). Losses,
    grad_norm and parameters after 3 steps against JAX's train step on the
    same mesh and on one device."""
    wants = [_reference(dict(pp=2, tp=2), seq=63), _reference({}, seq=63)]
    for got in _ranks(MeshConfig(pp=2, tp=2), seq=63):
        for want in wants:
            _check(got, want)


def test_stage1_with_remat_over_pp2_v2_matches_jax(one_torch_thread):
    """Stage 1 (both towers frozen, the projector trained) with remat over
    pp 2 x v 2: losses, grad_norm and parameters against JAX on the same
    mesh, and nothing but the projector moved a bit."""
    want = _reference(dict(pp=2), 2, ft=True, remat=True)
    start = {n: p.detach().clone()
             for n, p in long_vita_params_from_jax(_jax_params(0), device="cpu")
             .named_parameters()}
    for got in _ranks(MeshConfig(pp=2), v=2, ft=True, remat=True):
        _check(got, want)
        moved = {n for n, p in got[2].items() if not torch.equal(p, start[n])}
        assert moved and all(n.startswith("projector.") for n in moved), sorted(moved)[:5]


def test_grad_accumulation_over_pp2_matches_jax(one_torch_thread):
    """Two micro-batches of two rows a step over pp 2 (each one microbatch
    a stage, M = pp) against JAX's make_grad_accum_steps on the same mesh."""
    want = _reference(dict(pp=2), 1, accum=True)
    for got in _ranks(MeshConfig(pp=2), accum=True):
        _check(got, want)


def test_interleaved_matches_gpipe(one_torch_thread):
    """pp 2 x v 2 against pp 2 GPipe in the port, both with remat: each
    microbatch meets the same layers in the same order (the gradients sum
    their microbatches in another order): losses, grad_norm and parameters
    at 1e-6 relative, the parameters 1e-5 absolute (Adam's 1 / sqrt(v)
    lifts a tiny gradient's rounding, as in _check)."""
    gpipe = _ranks(MeshConfig(pp=2), v=1, remat=True)[0]
    inter = _ranks(MeshConfig(pp=2), v=2, remat=True)[0]
    _check(inter, (gpipe[2], [{"loss": a, "grad_norm": b} for a, b in zip(*gpipe[:2])]),
           rtol=1e-6)


# ---- the recipe entry in two gloo processes ------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from test_torch_tp_checkpoint import _recipe_files

    return _recipe_files(tmp_path_factory.mktemp("pp_ckpt"))


def _main_worker(rank, world, init, recipe_path, out):
    torch.set_num_threads(1)
    try:
        import long_vita_tpu_torch.tokenizer as port_tokenizer
        from long_vita_tpu_torch.training import train as ttrain
        from test_torch_serving import tiny_tokenizer

        tok = tiny_tokenizer()
        port_tokenizer.load_tokenizer = lambda path, template="long_vita": tok
        os.environ.update(LVT_COORDINATOR=init.removeprefix("tcp://"),
                          LVT_NUM_PROCESSES=str(world), LVT_PROCESS_ID=str(rank))
        out.put((rank, ttrain.main(["--config", recipe_path], device="cpu")["losses"]))
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        out.put((rank, f"raised {type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"))


def test_main_over_pp2_gloo_processes_matches_jax(files, tmp_path, monkeypatch):
    """``train.main(["--config", r.yaml], device="cpu")`` with mesh {pp: 2}
    (two rows a step: a microbatch a stage) in two gloo processes, each
    reading its stage's layer of the *_HF directory, against JAX's Trainer
    on the same recipe (on one device: its Trainer meshes every device it
    has): the 3 losses within 1e-5 relative, both ranks the same; the
    checkpoint the run writes holds the whole tree in canonical order."""
    import long_vita_tpu.tokenizer as jax_tokenizer
    import long_vita_tpu.training.distributed as jax_distributed
    import long_vita_tpu.utils.compile_cache as jax_compile_cache
    from long_vita_tpu.training import train as jtrain
    from long_vita_tpu_torch.training.checkpoint import _read
    from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint
    from test_torch_recipe import _recipe
    from test_torch_serving import tiny_tokenizer

    recipe = _recipe(files, mesh={"pp": 2},
                     run={"save_dir": str(tmp_path / "save"), "global_batch": 2})
    path = tmp_path / "recipe.yaml"
    path.write_text(yaml.safe_dump(recipe))
    got = run_gloo(_main_worker, 2, str(path), join_timeout=TIMEOUT)
    assert sorted(got) == [0, 1], got
    assert not any(isinstance(v, str) for v in got.values()), got
    assert got[0] == got[1]

    tok = tiny_tokenizer()
    monkeypatch.setattr(jax_tokenizer, "load_tokenizer", lambda path, template="long_vita": tok)
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: None)
    monkeypatch.setattr(jax_distributed, "maybe_initialize", lambda *a, **k: None)
    jrecipe = dict(recipe, mesh={}, run={k: v for k, v in recipe["run"].items()
                                         if k != "save_dir"})
    trainer, stream, _ = jtrain.build_from_recipe(jrecipe)
    want = trainer.train(itertools.islice(stream, 3), tokenizer=tok)["losses"]
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
    whole, _ = load_long_vita_checkpoint(str(files / "ckpt"), dtype=torch.float32, device="cpu")
    saved = _read(str(tmp_path / "save"), None)
    assert saved["step"] == 3
    assert {n: tuple(t.shape) for n, t in saved["params"].items()} == {
        n: tuple(p.shape) for n, p in whole.named_parameters()}
    # the tower was frozen and the layers' bits moved only where training moved them:
    # the vision tower comes back bit for bit from both stages' copies
    for n, p in whole.named_parameters():
        if n.startswith("vision."):
            assert torch.equal(saved["params"][n], p), n
