"""PyTorch port: per-rank slice loading, geometry-free checkpoints and the
recipe entry over 2-D tensor parallelism (the tq axis), on the CPU at the
tiny configuration (f32):

  - ``load_long_vita_checkpoint(..., mesh=)`` on a tp 2 x tq 2 mesh gives
    each rank only its (tp, tq) blocks of the *_HF directory: bit for bit
    shard_params(own=True) of the whole load, the bytes it copies out of
    the files those of its blocks (and the tower and projector whole), and
    gather_params puts the whole tree back;
  - a checkpoint written by a tp 2 x tq 2 Trainer reloads at tp 1 and at
    tp 2 x tq 1: the parameters and Adam's moments bit for bit the 2-D
    run's gathered ones;
  - train.main(device="cpu") with mesh {tp: 2, tq: 2} in four gloo
    processes (each reading its blocks of the directory) against JAX's
    Trainer on the same recipe, and the checkpoint it writes in the tp-1
    format;
  - LoRA on 2-D shards: the adapters drawn, saved and loaded as the whole
    tree's.
"""
import copy
import itertools

import numpy as np
import pytest
import torch
import yaml

from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import gather_params, rank_layout, shard_params, slice_leaf
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint
from test_torch_comm import run_gloo
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_tp_checkpoint import PACKS, _main_worker, _recipe_files
from test_torch_training import S, _pack

CFG = tiny_test_config()
TIMEOUT = 120
MESH = MeshConfig(tp=2, tq=2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _recipe_files(tmp_path_factory.mktemp("tp2d_ckpt"))


def test_sliced_load_is_shard_params_of_the_whole_load(files):
    path = str(files / "ckpt")
    whole_stats = {}
    whole, cfg = load_long_vita_checkpoint(path, dtype=torch.float32, device="cpu",
                                           stats=whole_stats)
    text_whole = sum(p.nbytes for p in whole.text.parameters())

    def rank(comm):
        mesh = make_mesh(MESH, comm)
        stats = {}
        local, _ = load_long_vita_checkpoint(path, dtype=torch.float32, device="cpu", mesh=mesh,
                                             stats=stats)
        assert local.text.tp_comm is mesh.tp_comm and local.text.tq_comm is mesh.tq_comm
        want = dict(shard_params(whole, mesh, cfg, own=True).named_parameters())
        got = dict(local.named_parameters())
        assert got.keys() == want.keys()
        for n, p in got.items():
            assert p.dtype == want[n].dtype and torch.equal(p, want[n]), n
            assert p.untyped_storage().nbytes() == p.nbytes, n  # nothing whole behind it
        layout = rank_layout(local, cfg, mesh)
        wanted = {n: slice_leaf(t.detach(), layout[n]).nbytes
                  for n, t in whole.named_parameters() if n.startswith("text.")}
        back = dict(gather_params(local, mesh, cfg).named_parameters())
        for n, t in whole.named_parameters():
            assert torch.equal(back[n], t), n
        return stats["bytes_read"], wanted, layout

    named = dict(whole.named_parameters())
    for read, wanted, layout in run_thread_ranks(rank, MESH.size, timeout=TIMEOUT):
        assert read == whole_stats["bytes_read"] - text_whole + sum(wanted.values())
        for n, nbytes in wanted.items():
            leaf = layout[n]
            cut = (leaf.pieces if leaf.sharded else 1) * (leaf.tq if leaf.cut_tq else 1)
            assert nbytes * cut == named[n].nbytes, n
        # every decoder weight, the embedding and the head: a quarter
        assert all(layout[n].sharded and layout[n].cut_tq for n in wanted
                   if n.endswith((".weight", "embed")) and "norm" not in n)


def _trainer(params, mesh, comm, steps, save_dir):
    tcfg = TrainerConfig(
        seq_len=S, logit_budget=S, global_batch=2, steps=steps, remat=False, vision_chunk=2,
        mesh=mesh, save_dir=save_dir,
        optim=topt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6, freeze_vision=True))
    return Trainer(copy.deepcopy(params), CFG, tcfg, comm=comm)


def _whole_state(tr) -> dict:
    """The trainer's parameters and moments, whole (gathered over its mesh)."""
    from long_vita_tpu_torch.parallel.sharding import gather_named

    state = tr.state
    named = {n: p.detach() for n, p in state.params.named_parameters()}
    if tr.mesh is None:
        return {"params": named, "mu": state.opt_state.mu, "nu": state.opt_state.nu}
    layout, mesh = rank_layout(state.params, CFG, tr.mesh), tr.mesh
    return {k: gather_named(t, layout, mesh.tp_comm, tq_comm=mesh.tq_comm)
            for k, t in (("params", named), ("mu", state.opt_state.mu),
                         ("nu", state.opt_state.nu))}


def test_checkpoint_of_a_2d_run_reloads_at_tp1_and_tp2(tmp_path, one_torch_thread):
    """Two steps at tp 2 x tq 2 write a checkpoint (the tp-1 format); a
    Trainer at tp 1 and one at tp 2 x tq 1 resume from it, and their
    parameters and moments, gathered, are the 2-D run's bit for bit."""
    from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
    from test_torch_training import _jax_params

    params = long_vita_params_from_jax(_jax_params(0), device="cpu")
    batches = list(batch_iterator(iter([_pack(**p, pack_cls=tloss.Pack) for p in PACKS]),
                                  2, S))
    save = str(tmp_path / "save")

    def run_2d(comm):
        tr = _trainer(params, MESH, comm, 2, save)
        tr.train(iter(batches))
        return _whole_state(tr)

    want = run_thread_ranks(run_2d, MESH.size, timeout=TIMEOUT)[0]

    def resumed(mesh, comm):
        tr = _trainer(params, mesh, comm, 3, save)
        assert tr.start_step == 2
        return _whole_state(tr)

    got = {"tp1": resumed(MeshConfig(), None),
           "tp2": run_thread_ranks(lambda c: resumed(MeshConfig(tp=2), c), 2,
                                   timeout=TIMEOUT)[0]}
    for geom, state in got.items():
        for k in ("params", "mu", "nu"):
            assert state[k].keys() == want[k].keys(), (geom, k)
            for n, t in want[k].items():
                assert torch.equal(state[k][n], t), (geom, k, n)


def test_main_over_tp2_tq2_gloo_processes_matches_jax(files, tmp_path, monkeypatch):
    """``train.main(["--config", r.yaml], device="cpu")`` with mesh {tp: 2,
    tq: 2} in four gloo processes (each loads only its blocks of the *_HF
    directory) against JAX's Trainer on the same recipe (on one device): the
    3 losses within 1e-5 relative, every rank the same; the checkpoint the
    run writes holds the whole tree (the directory's tp-1 shapes)."""
    import long_vita_tpu.tokenizer as jax_tokenizer
    import long_vita_tpu.training.distributed as jax_distributed
    import long_vita_tpu.utils.compile_cache as jax_compile_cache
    from long_vita_tpu.training import train as jtrain
    from long_vita_tpu_torch.training.checkpoint import _read
    from test_torch_recipe import _recipe
    from test_torch_serving import tiny_tokenizer

    recipe = _recipe(files, mesh={"tp": 2, "tq": 2}, run={"save_dir": str(tmp_path / "save")})
    path = tmp_path / "recipe.yaml"
    path.write_text(yaml.safe_dump(recipe))
    got = run_gloo(_main_worker, MESH.size, str(path), join_timeout=TIMEOUT)
    assert sorted(got) == list(range(MESH.size)), got
    assert not any(isinstance(v, str) for v in got.values()), got
    assert all(got[r] == got[0] for r in got)

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


def test_lora_on_2d_shards_matches_the_whole_tree(tmp_path):
    """LoRA over tp 2 x tq 2: add_lora_params on a rank's shard draws the
    adapters of its tp index (replicated over tq), save_lora from the
    shards writes the whole tree's files, and load_lora into shards gives
    the same adapters as cutting the whole tree; merge_lora asks for a
    gathered tree. Bit for bit."""
    from long_vita_tpu_torch.training.lora import (
        ALL_TARGETS,
        LoraConfig,
        add_lora_params,
        load_lora,
        merge_lora,
        save_lora,
    )

    base = init_long_vita_params(torch.Generator().manual_seed(5), CFG)
    lcfg = LoraConfig(r=4, alpha=8, targets=ALL_TARGETS)
    whole, wcfg = add_lora_params(copy.deepcopy(base), CFG.text, lcfg,
                                  torch.Generator().manual_seed(6))
    with torch.no_grad():  # B = 0 at init: give it values
        for i, (n, p) in enumerate(p for p in whole.named_parameters() if ".lora.b" in p[0]):
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(i)) * 0.1)
    save_lora(str(tmp_path / "whole"), whole, wcfg, lcfg)

    def rank(comm):
        mesh = make_mesh(MESH, comm)
        drawn, _ = add_lora_params(shard_params(base, mesh, CFG, own=True), CFG.text, lcfg,
                                   torch.Generator().manual_seed(6))
        want = dict(shard_params(whole, mesh, CFG).named_parameters())
        got = dict(drawn.named_parameters())
        for n, p in want.items():
            if ".lora.a" in n:  # b starts at zeros
                assert torch.equal(got[n], p), n
        local = shard_params(whole, mesh, CFG, own=True)
        with pytest.raises(ValueError, match="2-D tp shard"):
            merge_lora(local, wcfg)
        save_lora(str(tmp_path / "shards"), local, wcfg, lcfg)
        comm.barrier()
        loaded, _ = load_lora(str(tmp_path / "whole"), shard_params(base, mesh, CFG, own=True),
                              CFG.text)
        got = dict(loaded.named_parameters())
        for n, p in want.items():
            assert torch.equal(got[n], p), n

    run_thread_ranks(rank, MESH.size, timeout=TIMEOUT)
    with np.load(tmp_path / "whole" / "lora_weights.npz") as a, \
            np.load(tmp_path / "shards" / "lora_weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
