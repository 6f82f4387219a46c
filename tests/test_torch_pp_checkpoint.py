"""PyTorch port: pipeline stages' parameters, the per-stage slice loader and
geometry-free checkpoints over pp, on the CPU at tiny_test_config() with 4
decoder layers (f32; thread-ranks):

  - each rank's tree (shard_params over pp 2, pp 2 x v 2, pp 2 x tp 2 and
    pp 2 x v 2 x tp 2) against the shard JAX's shard_params(pp=True) puts
    on the same device of its mesh (the interleaved stack laid out
    chunk-major first, as JAX's init_train_state does): bit for bit, leaf
    by leaf; gather_params puts the whole tree back in canonical order;
  - ``load_long_vita_checkpoint(..., mesh=)`` over pp reads the stage's
    layers alone: bit for bit the shard of the whole load, and the bytes
    it copies out of the files those of the stage's layers (and of their
    tp slices) plus every leaf outside the layer stack whole;
  - a run that saves and resumes across pp 2 -> pp off -> pp 2 x v 2 ->
    dp 2 x tp 2, a step in each (moments and step count carried), against
    an uninterrupted run on one device: the losses and the parameters at
    1e-5;
  - the difference from JAX pinned: JAX's load_checkpoint refuses a
    checkpoint whose recorded (pp, virtual_pp) layout differs from the
    run's (its stores keep the interleaved stack chunk-major), where the
    port's files hold the canonical layer order and need no record.
"""
import copy
import json

import jax
import numpy as np
import pytest
import torch

from long_vita_tpu.parallel import pipeline as jpl
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.parallel.sharding import shard_params as j_shard_params
from long_vita_tpu.training import checkpoint as jckpt
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import (
    gather_params,
    leaf_layout,
    renamed,
    shard_params,
    slice_leaf,
)
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint
from test_torch_pp_training import CFG, _jax_params, _packs
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import S

TIMEOUT = 120
GEOMS = [dict(pp=2, v=1, tp=1), dict(pp=2, v=2, tp=1), dict(pp=2, v=1, tp=2),
         dict(pp=2, v=2, tp=2)]
IDS = [f"pp{g['pp']}_v{g['v']}_tp{g['tp']}" for g in GEOMS]


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_stage_shards_match_jax(geom):
    pp, v, tp = geom["pp"], geom["v"], geom["tp"]
    jparams = _jax_params(0)
    jmesh = j_make_mesh(JMeshConfig(pp=pp, tp=tp), devices=jax.devices()[:pp * tp])
    laid = {**jparams, "text": {**jparams["text"], "layers": jpl.permute_layer_stack(
        jparams["text"]["layers"], pp, v)}}
    jsharded = j_shard_params(laid, jmesh, pp=True)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)[:, :, 0, :, 0][0]  # [pp, tp]

    def device_tree(dev_id):
        """The JAX tree of the pieces on device ``dev_id``."""
        def piece(a):
            return next(np.asarray(s.data) for s in a.addressable_shards
                        if s.device.id == dev_id)

        return jax.tree.map(piece, jsharded)

    whole = long_vita_params_from_jax(jparams, device="cpu")

    def rank(comm):
        mesh = make_mesh(MeshConfig(pp=pp, tp=tp), comm)
        local = shard_params(whole, mesh, CFG, virtual_pp=v)
        back = gather_params(local, mesh, CFG)
        return mesh.pp_index, mesh.tp_index, dict(local.named_parameters()), back

    for p, t, local, back in run_thread_ranks(rank, pp * tp, timeout=TIMEOUT):
        want = dict(long_vita_params_from_jax(device_tree(ids[p, t]), device="cpu")
                    .named_parameters())
        assert local.keys() == want.keys()
        for n, x in local.items():
            assert torch.equal(x, want[n]), n
        for n, x in back.named_parameters():
            assert torch.equal(x, dict(whole.named_parameters())[n]), n


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("pp_ckpt") / "ckpt"
    save_hf_checkpoint(init_long_vita_params(torch.Generator().manual_seed(3), CFG), CFG,
                       str(path))
    return str(path)


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_stage_loader_reads_the_stage_alone(ckpt, geom):
    pp, v, tp = geom["pp"], geom["v"], geom["tp"]
    whole_stats = {}
    whole, cfg = load_long_vita_checkpoint(ckpt, dtype=torch.float32, device="cpu",
                                           stats=whole_stats)
    text_whole = sum(p.nbytes for p in whole.text.parameters())

    def rank(comm):
        mesh = make_mesh(MeshConfig(pp=pp, tp=tp), comm)
        stats = {}
        local, _ = load_long_vita_checkpoint(ckpt, dtype=torch.float32, device="cpu",
                                             mesh=mesh, stats=stats, virtual_pp=v)
        want = shard_params(whole, mesh, cfg, own=True, virtual_pp=v)
        assert local.text.pp.layers() == want.text.pp.layers()
        assert local.text.pp.virtual == v and local.text.pp.comm is mesh.pp_comm
        got, ref = dict(local.named_parameters()), dict(want.named_parameters())
        assert got.keys() == ref.keys()
        for n, x in got.items():
            assert torch.equal(x, ref[n]), n
        assert len(local.text.layers) == cfg.text.num_hidden_layers // pp
        layout = leaf_layout(local, cfg, mesh.tp_index, tp, stage=local.text.pp)
        named = dict(whole.named_parameters())
        # the bytes of the text tensors this rank holds, cut from the whole ones
        held = sum(slice_leaf(named[_global(n, layout[n])].detach(), layout[n]).nbytes
                   for n in got if n.startswith("text."))
        return stats["bytes_read"], held, sum(x.nbytes for x in got.values())

    for read, held, resident in run_thread_ranks(rank, pp * tp, timeout=TIMEOUT):
        assert read == whole_stats["bytes_read"] - text_whole + held
        assert resident == sum(p.nbytes for p in whole.parameters()) - text_whole + held


def _global(name: str, leaf) -> str:
    return renamed(name, leaf.pp_layer) if leaf.staged else name


# ---- resuming across geometries ---------------------------------------------------


def _run(params, mesh: MeshConfig, v: int, steps: int, save_dir, batches):
    """Train to ``steps`` on ``mesh`` (resuming from save_dir when it holds
    a checkpoint): -> (start step, losses, the whole parameters)."""

    def rank(comm):
        tcfg = TrainerConfig(
            seq_len=S, logit_budget=S, global_batch=2, steps=steps, remat=False,
            vision_chunk=2, mesh=mesh, virtual_pp=v, save_dir=save_dir,
            optim=topt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6,
                                       freeze_vision=True))
        tr = Trainer(copy.deepcopy(params), CFG, tcfg, comm=comm)
        losses = tr.train(iter(batches[tr.start_step:]))["losses"]
        whole = tr.state.params if tr.mesh is None else gather_params(tr.state.params, tr.mesh,
                                                                      CFG)
        return tr.start_step, losses, {n: p.detach().clone() for n, p in whole.named_parameters()}

    if mesh.size == 1:
        return rank(None)
    res = run_thread_ranks(rank, mesh.size, timeout=TIMEOUT)
    assert all(r[1] == res[0][1] for r in res)
    return res[0]


def test_checkpoint_resumes_across_pp_geometries(tmp_path, one_torch_thread):
    params = long_vita_params_from_jax(_jax_params(0), device="cpu")
    batches = list(batch_iterator(iter(_packs(tloss.Pack)), 2, S))
    _, want, want_params = _run(params, MeshConfig(), 1, 4, None, batches)
    losses = []
    for step, (mesh, v) in enumerate([(MeshConfig(pp=2), 1), (MeshConfig(), 1),
                                      (MeshConfig(pp=2), 2), (MeshConfig(dp=2, tp=2), 1)]):
        start, got, got_params = _run(params, mesh, v, step + 1, str(tmp_path), batches)
        assert start == step and len(got) == 1
        losses += got
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for n, p in got_params.items():
        np.testing.assert_allclose(p.numpy(), want_params[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_jax_refuses_another_layout_where_the_port_resumes(tmp_path):
    """JAX's stores keep the interleaved stack chunk-major and record (pp,
    virtual_pp) beside them: its load_checkpoint refuses a run of another
    layout before it reads anything (checkpoint.py:103-112). The port's
    checkpoints hold the canonical layer order whatever the schedule
    (save_checkpoint gathers a stage's layers under their global names), so
    the same move, pp 2 x v 2 -> pp off, resumes
    (test_checkpoint_resumes_across_pp_geometries)."""
    (tmp_path / "layer_layout.json").write_text(json.dumps({"pp": 2, "virtual_pp": 2}))
    with pytest.raises(ValueError, match="resume requires the same geometry"):
        jckpt.load_checkpoint(str(tmp_path), None, layer_layout=(1, 1))
