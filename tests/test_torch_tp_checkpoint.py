"""PyTorch port: per-rank slice loading and geometry-free checkpoints over
tensor parallelism, on the CPU at the tiny configuration (f32; 4/2 heads,
so tp 4 holds each kv head on two ranks):

  - ``load_long_vita_checkpoint(..., mesh=)`` gives each rank only its
    slices of the *_HF directory: bit for bit shard_params(own=True) of the
    whole load at tp 2 and 4, the bytes it copies out of the files those of
    the slices (1/tp of each sharded tensor, 2/tp of a kv head shared by two
    ranks), every tensor with storage of its own (nothing whole kept), and
    gather_params puts the whole tree back;
  - a checkpoint written over tp 2 resumes at tp 1, and one written at tp 1
    resumes over tp 2: the next step's loss and the parameters against an
    uninterrupted tp-1 run (1e-5 relative);
  - train.main(device="cpu") with mesh {tp: 2} in two gloo processes (each
    reading its slices of the directory) against JAX's Trainer on the same
    recipe, and the checkpoint it writes in the tp-1 format;
  - LoRA on shards at tp 2 and 4: the adapters drawn, merged, saved and
    loaded bit for bit as the whole tree's.
"""
import copy
import itertools
import os

import numpy as np
import pytest
import torch
import yaml

from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import gather_params, leaf_layout, shard_params, slice_leaf
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint
from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint
from test_torch_comm import run_gloo
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import S, _pack

CFG = tiny_test_config()
TIMEOUT = 120


def _recipe_files(root):
    """A tiny *_HF directory (random f32 weights) and test_torch_recipe's
    two-source text corpus, written under ``root``."""
    import json

    params = init_long_vita_params(torch.Generator().manual_seed(3), CFG)
    save_hf_checkpoint(params, CFG, str(root / "ckpt"))
    rng = np.random.default_rng(0)

    def text(n):
        return "".join(chr(c) for c in rng.integers(97, 123, n))

    for name, n in (("a", 14), ("b", 9)):
        rows = [{"messages": [{"role": "user", "content": text(10 + i % 13)},
                              {"role": "assistant", "content": text(8 + i % 17)}]}
                for i in range(n)]
        (root / f"{name}.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    (root / "corpus.yaml").write_text(yaml.safe_dump({"dataset": {
        "A": {"ratio": 1.5, "data_paths": [str(root / "a.jsonl")]},
        "B": {"ratio": 1, "num": 8, "data_paths": [str(root / "b.jsonl")]},
    }}))
    return root


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _recipe_files(tmp_path_factory.mktemp("tp_ckpt"))


@pytest.mark.parametrize("tp", [2, 4])
def test_sliced_load_is_shard_params_of_the_whole_load(files, tp):
    path = str(files / "ckpt")
    whole_stats = {}
    whole, cfg = load_long_vita_checkpoint(path, dtype=torch.float32, device="cpu",
                                           stats=whole_stats)
    text_whole = sum(p.nbytes for p in whole.text.parameters())

    def rank(comm):
        mesh = make_mesh(MeshConfig(tp=tp), comm)
        stats = {}
        local, _ = load_long_vita_checkpoint(path, dtype=torch.float32, device="cpu", mesh=mesh,
                                             stats=stats)
        want = shard_params(whole, mesh, cfg, own=True)
        assert local.text.tp_comm is mesh.tp_comm
        got, ref = dict(local.named_parameters()), dict(want.named_parameters())
        assert got.keys() == ref.keys()
        for n, p in got.items():
            assert p.dtype == ref[n].dtype and torch.equal(p, ref[n]), n
            # its own storage: nothing of a whole tensor is kept behind it
            assert p.untyped_storage().nbytes() == p.nbytes, n
        layout = leaf_layout(local, cfg, mesh.tp_index, tp)
        wanted = {n: slice_leaf(t.detach(), layout[n]).nbytes
                  for n, t in whole.named_parameters() if n.startswith("text.")}
        back = gather_params(local, mesh, cfg)
        for n, t in back.named_parameters():
            assert torch.equal(t, dict(whole.named_parameters())[n]), n
        return stats["bytes_read"], wanted, layout

    for read, wanted, layout in run_thread_ranks(rank, tp, timeout=TIMEOUT):
        # the tower and projector whole, the decoder's slices alone
        assert read == whole_stats["bytes_read"] - text_whole + sum(wanted.values())
        named = dict(whole.named_parameters())
        for n, nbytes in wanted.items():
            leaf = layout[n]
            assert nbytes * (leaf.pieces if leaf.sharded else 1) == named[n].nbytes, n
        kv = [n for n in wanted if ".k_proj." in n or ".v_proj." in n]
        assert all(layout[n].pieces == min(tp, CFG.text.num_key_value_heads) for n in kv)


PACKS = [dict(seed=1, n_img=2, cuts=(40,)), dict(seed=2, n_img=1, cuts=(20, 50)),
         dict(seed=3, n_img=0, cuts=(30,)), dict(seed=4, n_img=2, cuts=(12, 44)),
         dict(seed=5, n_img=1, cuts=(36,)), dict(seed=6, n_img=0, cuts=(16, 48))]


def _trainer(params, tp, comm, steps, save_dir):
    tcfg = TrainerConfig(
        seq_len=S, logit_budget=S, global_batch=2, steps=steps, remat=False, vision_chunk=2,
        mesh=MeshConfig(tp=tp), save_dir=save_dir,
        optim=topt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6, freeze_vision=True))
    return Trainer(copy.deepcopy(params), CFG, tcfg, comm=comm)


def _run(params, tp, steps, save_dir, batches):
    """Train to ``steps`` at ``tp`` (resuming from save_dir when it holds a
    checkpoint): -> (losses of the steps run, the whole parameters)."""

    def rank(comm):
        tr = _trainer(params, tp, comm, steps, save_dir)
        losses = tr.train(iter(batches[tr.start_step:]))["losses"]
        mesh = tr.mesh
        whole = tr.state.params if mesh is None else gather_params(tr.state.params, mesh, CFG)
        return tr.start_step, losses, {n: p.detach().clone() for n, p in whole.named_parameters()}

    if tp == 1:
        return rank(None)
    res = run_thread_ranks(rank, tp, timeout=TIMEOUT)
    assert all(r[1] == res[0][1] for r in res)
    return res[0]


@pytest.mark.parametrize("first,then", [(2, 1), (1, 2)])
def test_checkpoint_resumes_across_tp_geometries(tmp_path, first, then, one_torch_thread):
    from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
    from test_torch_training import _jax_params

    params = long_vita_params_from_jax(_jax_params(0), device="cpu")
    batches = list(batch_iterator(iter([_pack(**p, pack_cls=tloss.Pack) for p in PACKS]),
                                  2, S))
    _, want, want_params = _run(params, 1, 3, None, batches)
    start, head, _ = _run(params, first, 2, str(tmp_path), batches)
    assert start == 0 and len(head) == 2
    start, tail, got_params = _run(params, then, 3, str(tmp_path), batches)
    assert start == 2 and len(tail) == 1
    np.testing.assert_allclose(head + tail, want, rtol=1e-5)
    for n, p in got_params.items():
        np.testing.assert_allclose(p.numpy(), want_params[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
# ---- the recipe entry in two gloo processes ------------------------------------


def _main_worker(rank, world, init, recipe_path, out):
    torch.set_num_threads(1)
    try:
        import long_vita_tpu_torch.tokenizer as port_tokenizer
        from long_vita_tpu_torch.training import train as ttrain
        from test_torch_serving import tiny_tokenizer

        tok = tiny_tokenizer()
        port_tokenizer.load_tokenizer = lambda path, template="long_vita": tok
        os.environ.update(LVT_COORDINATOR=init.removeprefix("tcp://"), LVT_NUM_PROCESSES=str(world),
                          LVT_PROCESS_ID=str(rank))
        out.put((rank, ttrain.main(["--config", recipe_path], device="cpu")["losses"]))
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        out.put((rank, f"raised {type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"))


def test_main_over_tp2_gloo_processes_matches_jax(files, tmp_path, monkeypatch):
    """``train.main(["--config", r.yaml], device="cpu")`` with mesh {tp: 2}
    in two gloo processes (each loads only its slices of the *_HF
    directory) against JAX's Trainer on the same recipe (on one device): the
    3 losses within 1e-5 relative, both ranks the same; the checkpoint the
    run writes holds the whole tree (the directory's tp-1 shapes)."""
    _main_over_tp2(files, tmp_path, monkeypatch)


def test_main_over_tp2_gloo_processes_at_an_odd_seq_len_matches_jax(files, tmp_path,
                                                                    monkeypatch):
    """The same at seq_len 63: the data path packs rows of exactly 63
    tokens, as JAX's does, and each rank's slice of a row is 32 tokens,
    rank 1's ending in a pad row."""
    _main_over_tp2(files, tmp_path, monkeypatch, data={"seq_len": 63, "logit_budget": 63})


def _main_over_tp2(files, tmp_path, monkeypatch, **over):
    import long_vita_tpu.tokenizer as jax_tokenizer
    import long_vita_tpu.training.distributed as jax_distributed
    import long_vita_tpu.utils.compile_cache as jax_compile_cache
    from long_vita_tpu.training import train as jtrain
    from long_vita_tpu_torch.training.checkpoint import _read
    from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint
    from test_torch_recipe import _recipe
    from test_torch_serving import tiny_tokenizer

    root = files
    recipe = _recipe(root, mesh={"tp": 2}, run={"save_dir": str(tmp_path / "save")}, **over)
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
    # JAX's Trainer takes a mesh of every device it has, so it runs the
    # recipe on one: the mesh does not change the losses
    jrecipe = dict(recipe, mesh={}, run={k: v for k, v in recipe["run"].items()
                                         if k != "save_dir"})
    trainer, stream, _ = jtrain.build_from_recipe(jrecipe)
    want = trainer.train(itertools.islice(stream, 3), tokenizer=tok)["losses"]
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
    # the checkpoint: the whole tree (the tp-1 format), world rank 0 wrote it
    whole, _ = load_long_vita_checkpoint(str(root / "ckpt"), dtype=torch.float32, device="cpu")
    saved = _read(str(tmp_path / "save"), None)
    assert saved["step"] == 3
    assert {n: tuple(t.shape) for n, t in saved["params"].items()} == {
        n: tuple(p.shape) for n, p in whole.named_parameters()}



@pytest.mark.parametrize("tp", [2, 4])
def test_lora_on_shards_matches_the_whole_tree(tmp_path, tp):
    """LoRA over tp: add_lora_params on a rank's shard draws the whole
    adapters and keeps its slices (the same generator gives the shard of
    the whole tree's draw); merge_lora per shard is the shard of the whole
    merge; save_lora from the shards writes the whole tree's files; and
    load_lora into shards cuts them as shard_params would. Bit for bit."""
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
    with torch.no_grad():  # B = 0 at init: give it values, so merges differ
        for i, (n, p) in enumerate(p for p in whole.named_parameters() if ".lora.b" in p[0]):
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(i)) * 0.1)
    save_lora(str(tmp_path / "whole"), whole, wcfg, lcfg)
    merged = merge_lora(whole, wcfg)

    def rank(comm):
        mesh = make_mesh(MeshConfig(tp=tp), comm)
        shard = shard_params(base, mesh, CFG, own=True)
        drawn, _ = add_lora_params(shard, CFG.text, lcfg, torch.Generator().manual_seed(6))
        want = shard_params(whole, mesh, CFG)
        got = dict(drawn.named_parameters())
        for n, p in want.named_parameters():
            if ".lora.a" in n:  # b starts at zeros; a is the shard of the whole draw
                assert torch.equal(got[n], p), n
        local = shard_params(whole, mesh, CFG, own=True)
        merged_local = dict(merge_lora(local, wcfg).named_parameters())
        for n, p in shard_params(merged, mesh, CFG).named_parameters():
            assert torch.equal(merged_local[n], p), n
        save_lora(str(tmp_path / "shards"), local, wcfg, lcfg)
        comm.barrier()
        loaded, _ = load_lora(str(tmp_path / "whole"), shard_params(base, mesh, CFG, own=True),
                              CFG.text)
        got = dict(loaded.named_parameters())
        for n, p in want.named_parameters():
            assert torch.equal(got[n], p), n

    run_thread_ranks(rank, tp, timeout=TIMEOUT)
    with np.load(tmp_path / "whole" / "lora_weights.npz") as a, \
            np.load(tmp_path / "shards" / "lora_weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
