"""PyTorch port: FSDP's slice loading, geometry-free checkpoints and the
recipe entry, on the CPU at the tiny configuration (f32):

  - ``load_long_vita_checkpoint(..., mesh=, fsdp=True)`` gives each rank
    only its (tp, dp) piece of every FSDP leaf: bit for bit
    shard_params(..., own=True, fsdp=True) of the whole load at dp 2, dp 2
    x tp 2 and dp 2 x tp 4 (a kv head on two tp ranks), the bytes it copies
    out of the files those of its pieces, every tensor with storage of its
    own, and gather_params puts the whole tree back;
  - a checkpoint written under FSDP 2 resumes without FSDP, one written
    without FSDP resumes at dp 2 x tp 2 with FSDP, and one written there
    resumes under FSDP 2: the moments and parameters the resumed run holds
    gathered back bit for bit the file's, the next step's loss and the
    parameters against an uninterrupted one-device run (1e-5 relative);
  - train.main(device="cpu") with mesh {dp: 2} and run.fsdp in two gloo
    processes (each reading its pieces of the directory) against JAX's
    Trainer on the same recipe, and the checkpoint it writes in the
    one-device format;
  - LoRA on FSDP shards: add_lora_params draws the whole tree's adapters,
    whole on every dp rank.
"""
import copy
import itertools

import numpy as np
import pytest
import torch
import yaml

from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import (
    gather_named,
    gather_params,
    rank_layout,
    shard_params,
    slice_leaf,
)
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training.checkpoint import _read
from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint
from test_torch_comm import run_gloo
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_tp_checkpoint import PACKS, _main_worker, _recipe_files
from test_torch_training import CFG, S, _pack

TIMEOUT = 120


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _recipe_files(tmp_path_factory.mktemp("fsdp_ckpt"))


@pytest.mark.parametrize("dp,tp", [(2, 1), (2, 2), (2, 4)])
def test_fsdp_sliced_load_is_shard_params_of_the_whole_load(files, dp, tp):
    path = str(files / "ckpt")
    whole_stats = {}
    whole, cfg = load_long_vita_checkpoint(path, dtype=torch.float32, device="cpu",
                                           stats=whole_stats)
    named_whole = dict(whole.named_parameters())
    text_whole = sum(p.nbytes for p in whole.text.parameters())

    def rank(comm):
        mesh = make_mesh(MeshConfig(dp=dp, tp=tp), comm)
        stats = {}
        local, _ = load_long_vita_checkpoint(path, dtype=torch.float32, device="cpu", mesh=mesh,
                                             stats=stats, fsdp=True)
        want = shard_params(whole, mesh, cfg, own=True, fsdp=True)
        assert local.text.fsdp is not None and local.text.fsdp.comm is mesh.dp_comm
        got, ref = dict(local.named_parameters()), dict(want.named_parameters())
        assert got.keys() == ref.keys()
        for n, p in got.items():
            assert p.dtype == ref[n].dtype and torch.equal(p, ref[n]), n
            assert p.untyped_storage().nbytes() == p.nbytes, n
        layout = rank_layout(local, cfg, mesh)
        wanted = {n: slice_leaf(t.detach(), layout[n]).nbytes
                  for n, t in named_whole.items() if n.startswith("text.")}
        back = gather_params(local, mesh, cfg)
        assert back.text.fsdp is None and back.text.tp_comm is None
        for n, t in back.named_parameters():
            assert torch.equal(t, named_whole[n]), n
        return stats["bytes_read"], wanted, layout

    for read, wanted, layout in run_thread_ranks(rank, dp * tp, timeout=TIMEOUT):
        assert read == whole_stats["bytes_read"] - text_whole + sum(wanted.values())
        for n, nbytes in wanted.items():
            leaf = layout[n]
            pieces = (leaf.pieces if leaf.sharded else 1) * (leaf.dp if leaf.fsdp else 1)
            assert nbytes * pieces == named_whole[n].nbytes, n
        # a rank reads about 1/(dp tp) of the decoder (whole kv heads, biases over tp only)
        assert sum(wanted.values()) < text_whole / (dp * tp) * 1.3


GEOMETRIES = {"fsdp2": (MeshConfig(dp=2), True), "one_device": (MeshConfig(), False),
              "dp2_tp2_fsdp": (MeshConfig(dp=2, tp=2), True)}


def _run(params, geom, steps, save_dir, batches):
    """Train to ``steps`` at ``geom`` (resuming from save_dir when it holds a
    checkpoint): -> (the start step, the losses of the steps run, the
    parameters and moments gathered right after the resume, the whole
    parameters at the end)."""
    m, fsdp = GEOMETRIES[geom]

    def rank(comm):
        tcfg = TrainerConfig(
            seq_len=S, logit_budget=S, global_batch=2, steps=steps, remat=False, vision_chunk=2,
            mesh=m, save_dir=save_dir, fsdp=fsdp,
            optim=topt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6,
                                       freeze_vision=True))
        tr = Trainer(copy.deepcopy(params), CFG, tcfg, comm=comm)
        layout = tr._layout()

        def gathered(named):
            if layout is None:
                return {n: t.detach().clone() for n, t in named.items()}
            return gather_named(named, layout, tr.mesh.tp_comm, dp_comm=tr.mesh.dp_comm)

        resumed = (gathered(dict(tr.state.params.named_parameters())),
                   gathered(tr.state.opt_state.mu), gathered(tr.state.opt_state.nu))
        losses = tr.train(iter(batches[tr.start_step:]))["losses"]
        end = gathered(dict(tr.state.params.named_parameters()))
        return tr.start_step, losses, resumed, end

    if m.size == 1:
        return rank(None)
    res = run_thread_ranks(rank, m.size, timeout=TIMEOUT)
    assert all(r[1] == res[0][1] for r in res)
    return res[0]


@pytest.mark.parametrize("first,then", [("fsdp2", "one_device"), ("one_device", "dp2_tp2_fsdp"),
                                        ("dp2_tp2_fsdp", "fsdp2")])
def test_checkpoint_resumes_across_fsdp_geometries(tmp_path, first, then, one_torch_thread):
    from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
    from test_torch_training import _jax_params

    params = long_vita_params_from_jax(_jax_params(0), device="cpu")
    batches = list(batch_iterator(iter([_pack(**p, pack_cls=tloss.Pack) for p in PACKS]),
                                  2, S))
    _, want, _, want_params = _run(params, "one_device", 3, None, batches)
    start, head, _, _ = _run(params, first, 2, str(tmp_path), batches)
    assert start == 0 and len(head) == 2
    saved = _read(str(tmp_path), 2)
    assert {n: tuple(t.shape) for n, t in saved["params"].items()} == {
        n: tuple(p.shape) for n, p in params.named_parameters()}  # the one-device format
    start, tail, (p2, mu2, nu2), got_params = _run(params, then, 3, str(tmp_path), batches)
    assert start == 2 and len(tail) == 1
    for got, key in ((p2, "params"), (mu2, "mu"), (nu2, "nu")):
        assert got.keys() == saved[key].keys(), key
        for n, t in got.items():
            assert torch.equal(t, saved[key][n]), (key, n)
    np.testing.assert_allclose(head + tail, want, rtol=1e-5)
    for n, p in got_params.items():
        np.testing.assert_allclose(p.numpy(), want_params[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_main_with_fsdp_over_dp2_gloo_processes_matches_jax(files, tmp_path, monkeypatch):
    """``train.main(["--config", r.yaml], device="cpu")`` with mesh {dp: 2}
    and run.fsdp in two gloo processes (each loads only its pieces of the
    *_HF directory, one row a rank) against JAX's Trainer on the same
    recipe (with fsdp; one device, where JAX's mesh is None): the 3 losses
    within 1e-5 relative, both ranks the same; the checkpoint the run
    writes holds the whole tree."""
    import long_vita_tpu.tokenizer as jax_tokenizer
    import long_vita_tpu.training.distributed as jax_distributed
    import long_vita_tpu.utils.compile_cache as jax_compile_cache
    from long_vita_tpu.training import train as jtrain
    from test_torch_recipe import _recipe
    from test_torch_serving import tiny_tokenizer

    root = files
    recipe = _recipe(root, mesh={"dp": 2},
                     run={"save_dir": str(tmp_path / "save"), "fsdp": True, "global_batch": 2})
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
    whole, _ = load_long_vita_checkpoint(str(root / "ckpt"), dtype=torch.float32, device="cpu")
    saved = _read(str(tmp_path / "save"), None)
    assert saved["step"] == 3
    assert {n: tuple(t.shape) for n, t in saved["params"].items()} == {
        n: tuple(p.shape) for n, p in whole.named_parameters()}


def test_lora_on_fsdp_shards_draws_the_whole_adapters():
    """add_lora_params on an FSDP shard (dp 2 x tp 2) draws the adapters of
    the whole tree (the same generator), whole over dp (JAX replicates
    them) and cut over tp as on a tp shard; merge_lora asks for a gather."""
    from long_vita_tpu_torch.training.lora import (
        ALL_TARGETS,
        LoraConfig,
        add_lora_params,
        merge_lora,
    )

    base = init_long_vita_params(torch.Generator().manual_seed(5), CFG)
    lcfg = LoraConfig(r=4, alpha=8, targets=ALL_TARGETS)
    whole, wcfg = add_lora_params(copy.deepcopy(base), CFG.text, lcfg,
                                  torch.Generator().manual_seed(6))

    def rank(comm):
        mesh = make_mesh(MeshConfig(dp=2, tp=2), comm)
        shard = shard_params(base, mesh, CFG, own=True, fsdp=True)
        drawn, _ = add_lora_params(shard, CFG.text, lcfg, torch.Generator().manual_seed(6))
        want = dict(shard_params(whole, mesh, CFG, fsdp=True).named_parameters())
        got = dict(drawn.named_parameters())
        for n, p in got.items():
            if ".lora." in n:
                assert torch.equal(p, want[n]), n
        with pytest.raises(ValueError, match="gather"):
            merge_lora(drawn, wcfg)

    run_thread_ranks(rank, 4, timeout=TIMEOUT)
