"""PyTorch port: FSDP inside pipeline stages — the shards, the per-rank
slice loader, geometry-free checkpoints and the recipe entry — on the CPU
at tiny_test_config() with 4 decoder layers (f32; thread-ranks, and gloo
processes for train.main):

  - each rank's tree (shard_params(..., fsdp=True) over dp 2 x pp 2, dp 2
    x pp 2 x v 2 and dp 2 x pp 2 x tp 2) against the shard JAX's
    shard_params(fsdp=True, pp=True) puts on the same device of its mesh,
    bit for bit, leaf by leaf; gather_params puts the whole tree back;
  - ``load_long_vita_checkpoint(..., mesh=, fsdp=True)`` reads only the
    stage's layers and of them its dp (and tp) slices: bit for bit that
    shard of the whole load, and the bytes read and resident those of its
    slices plus the replicated leaves;
  - a checkpoint written at dp 2 x pp 2 under FSDP resumes at one device,
    and one written at one device resumes at dp 2 x pp 2: the resumed run
    holds, gathered, the file's parameters and moments bit for bit;
  - ``train.main(device="cpu")`` from a recipe with mesh {dp: 2, pp: 2} and
    run.fsdp in four gloo processes against JAX's Trainer on the same
    recipe.
"""
import copy
import itertools
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from long_vita_tpu.parallel import pipeline as jpl
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.parallel.sharding import shard_params as j_shard_params
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import fsdp_dim, gather_named, gather_params, shard_params
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training.checkpoint import _read
from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint
from test_torch_comm import run_gloo
from test_torch_pp_training import CFG, OPTIM, _jax_params, _packs
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import S

TIMEOUT = 120
GEOMS = {"dp2_pp2": dict(dp=2, pp=2, v=1), "dp2_pp2_v2": dict(dp=2, pp=2, v=2),
         "dp2_pp2_tp2": dict(dp=2, pp=2, tp=2, v=1)}


def _mesh(g: dict) -> MeshConfig:
    return MeshConfig(**{k: n for k, n in g.items() if k != "v"})


@pytest.mark.parametrize("geom", list(GEOMS))
def test_pp_fsdp_shards_match_jax(geom):
    g = GEOMS[geom]
    m, v = _mesh(g), g["v"]
    jparams = _jax_params(0)
    jmesh = j_make_mesh(JMeshConfig(dp=m.dp, pp=m.pp, tp=m.tp), devices=jax.devices()[:m.size])
    laid = {**jparams, "text": {**jparams["text"], "layers": jpl.permute_layer_stack(
        jparams["text"]["layers"], m.pp, v)}}
    jsharded = j_shard_params(laid, jmesh, fsdp=True, pp=True)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)[:, :, 0, :, 0]  # [dp, pp, tp]

    def device_tree(dev_id):
        def piece(a):
            return next(np.asarray(s.data) for s in a.addressable_shards
                        if s.device.id == dev_id)

        return jax.tree.map(piece, jsharded)

    whole = long_vita_params_from_jax(jparams, device="cpu")

    def rank(comm):
        mesh = make_mesh(m, comm)
        local = shard_params(whole, mesh, CFG, fsdp=True, virtual_pp=v)
        assert local.text.fsdp.comm is mesh.dp_comm and local.text.pp.comm is mesh.pp_comm
        back = gather_params(local, mesh, CFG)
        return (mesh.dp_index, mesh.pp_index, mesh.tp_index, dict(local.named_parameters()),
                back)

    for d, p, t, local, back in run_thread_ranks(rank, m.size, timeout=TIMEOUT):
        want = dict(long_vita_params_from_jax(device_tree(ids[d, p, t]), device="cpu")
                    .named_parameters())
        assert local.keys() == want.keys()
        for n, x in local.items():
            assert torch.equal(x, want[n]), n
        for n, x in back.named_parameters():
            assert torch.equal(x, dict(whole.named_parameters())[n]), n


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("pp_fsdp_ckpt") / "ckpt"
    save_hf_checkpoint(init_long_vita_params(torch.Generator().manual_seed(3), CFG), CFG,
                       str(path))
    return str(path)


def _weight(name: str) -> bool:
    """An FSDP leaf cut over tp too (every one but the norms)."""
    return fsdp_dim(name) is not None and "norm" not in name


@pytest.mark.parametrize("geom", list(GEOMS))
def test_loader_reads_the_stages_dp_slices_alone(ckpt, geom):
    g = GEOMS[geom]
    m, v = _mesh(g), g["v"]
    whole_stats = {}
    whole, cfg = load_long_vita_checkpoint(ckpt, dtype=torch.float32, device="cpu",
                                           stats=whole_stats)
    text_whole = sum(p.nbytes for p in whole.text.parameters())

    def rank(comm):
        mesh = make_mesh(m, comm)
        stats = {}
        local, _ = load_long_vita_checkpoint(ckpt, dtype=torch.float32, device="cpu",
                                             mesh=mesh, stats=stats, fsdp=True, virtual_pp=v)
        want = shard_params(whole, mesh, cfg, own=True, fsdp=True, virtual_pp=v)
        assert local.text.pp.layers() == want.text.pp.layers()
        assert local.text.fsdp is not None and local.text.fsdp.comm is mesh.dp_comm
        got, ref = dict(local.named_parameters()), dict(want.named_parameters())
        assert got.keys() == ref.keys()
        for n, x in got.items():
            assert torch.equal(x, ref[n]), n
        held = sum(x.nbytes for n, x in got.items() if n.startswith("text."))
        streamed = sum(x.nbytes for n, x in got.items() if _weight(n))
        return stats["bytes_read"], held, sum(x.nbytes for x in got.values()), streamed

    res = run_thread_ranks(rank, m.size, timeout=TIMEOUT)
    for read, held, resident, _ in res:
        assert read == whole_stats["bytes_read"] - text_whole + held
        assert resident == sum(p.nbytes for p in whole.parameters()) - text_whole + held
    # the FSDP weights: each stage's layers' once over the stage's dp and tp
    # ranks, the embedding and the head once over every stage's
    streamed = [p.nbytes for n, p in whole.named_parameters() if _weight(n)]
    shared = whole.text.embed.nbytes + whole.text.lm_head.weight.nbytes
    assert sum(r[3] for r in res) == sum(streamed) + (m.pp - 1) * shared


# ---- resuming across geometries ---------------------------------------------------


def _run(params, mesh: MeshConfig, steps: int, save_dir, batches):
    """Train to ``steps`` on ``mesh`` with FSDP (resuming from save_dir when
    it holds a checkpoint): -> (the start step, the losses of the steps run,
    the parameters and moments gathered right after the resume)."""

    def rank(comm):
        tcfg = TrainerConfig(seq_len=S, logit_budget=S, global_batch=4, steps=steps,
                             remat=False, vision_chunk=2, mesh=mesh, fsdp=True,
                             save_dir=save_dir,
                             optim=topt.OptimizerConfig(**OPTIM, freeze_vision=True))
        tr = Trainer(copy.deepcopy(params), CFG, tcfg, comm=comm)
        layout = tr._layout()

        def gathered(named):
            if layout is None:
                return {n: t.detach().clone() for n, t in named.items()}
            return gather_named(named, layout, tr.mesh.tp_comm, dp_comm=tr.mesh.dp_comm,
                                stage=tr.state.params.text.pp)

        resumed = (gathered(dict(tr.state.params.named_parameters())),
                   gathered(tr.state.opt_state.mu), gathered(tr.state.opt_state.nu))
        losses = tr.train(iter(batches[tr.start_step:]))["losses"]
        return tr.start_step, losses, resumed

    if mesh.size == 1:
        return rank(None)
    res = run_thread_ranks(rank, mesh.size, timeout=TIMEOUT)
    assert all(r[1] == res[0][1] for r in res)
    return res[0]


@pytest.mark.parametrize("first,then", [("dp2_pp2", "one_device"), ("one_device", "dp2_pp2")])
def test_checkpoint_resumes_between_pp_fsdp_and_one_device(tmp_path, first, then,
                                                           one_torch_thread):
    meshes = {"dp2_pp2": MeshConfig(dp=2, pp=2), "one_device": MeshConfig()}
    params = long_vita_params_from_jax(_jax_params(0), device="cpu")
    batches = list(batch_iterator(iter(_packs(tloss.Pack)), 4, S))
    start, head, _ = _run(params, meshes[first], 2, str(tmp_path), batches)
    assert start == 0 and len(head) == 2
    saved = _read(str(tmp_path), 2)
    assert {n: tuple(t.shape) for n, t in saved["params"].items()} == {
        n: tuple(p.shape) for n, p in params.named_parameters()}  # the one-device format
    start, tail, (p2, mu2, nu2) = _run(params, meshes[then], 3, str(tmp_path), batches)
    assert start == 2 and len(tail) == 1 and np.isfinite(tail[0])
    for got, key in ((p2, "params"), (mu2, "mu"), (nu2, "nu")):
        assert got.keys() == saved[key].keys(), key
        for n, t in got.items():
            assert torch.equal(t, saved[key][n]), (key, n)


# ---- the recipe entry in four gloo processes ---------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from test_torch_tp_checkpoint import _recipe_files

    return _recipe_files(tmp_path_factory.mktemp("pp_fsdp_recipe"))


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


def test_main_over_dp2_pp2_fsdp_gloo_processes_matches_jax(files, tmp_path, monkeypatch):
    """``train.main(["--config", r.yaml], device="cpu")`` with mesh {dp: 2,
    pp: 2} and run.fsdp (four rows a step: two a dp rank, one a microbatch)
    in four gloo processes, each reading its stage's layer and of it its dp
    slice, against JAX's Trainer on the same recipe (on one device: its
    Trainer meshes every device it has): the 3 losses within 1e-5
    relative, every rank the same; the checkpoint the run writes holds the
    whole tree."""
    import long_vita_tpu.tokenizer as jax_tokenizer
    import long_vita_tpu.training.distributed as jax_distributed
    import long_vita_tpu.utils.compile_cache as jax_compile_cache
    from long_vita_tpu.training import train as jtrain
    from test_torch_recipe import _recipe
    from test_torch_serving import tiny_tokenizer

    recipe = _recipe(files, mesh={"dp": 2, "pp": 2},
                     run={"save_dir": str(tmp_path / "save"), "global_batch": 4, "fsdp": True})
    path = tmp_path / "recipe.yaml"
    path.write_text(yaml.safe_dump(recipe))
    got = run_gloo(_main_worker, 4, str(path), join_timeout=300)
    assert sorted(got) == [0, 1, 2, 3], got
    assert not any(isinstance(v, str) for v in got.values()), got
    assert got[0] == got[1] == got[2] == got[3]

    tok = tiny_tokenizer()
    monkeypatch.setattr(jax_tokenizer, "load_tokenizer", lambda path, template="long_vita": tok)
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: None)
    monkeypatch.setattr(jax_distributed, "maybe_initialize", lambda *a, **k: None)
    jrecipe = dict(recipe, mesh={}, run={k: v for k, v in recipe["run"].items()
                                         if k not in ("save_dir", "fsdp")})
    trainer, stream, _ = jtrain.build_from_recipe(jrecipe)
    want = trainer.train(itertools.islice(stream, 3), tokenizer=tok)["losses"]
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
    whole, _ = load_long_vita_checkpoint(str(files / "ckpt"), dtype=torch.float32, device="cpu")
    saved = _read(str(tmp_path / "save"), None)
    assert saved["step"] == 3
    assert {n: tuple(t.shape) for n, t in saved["params"].items()} == {
        n: tuple(p.shape) for n, p in whole.named_parameters()}
