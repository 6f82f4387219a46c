"""PyTorch port: stage handoff between the two packages through their
training entry points and one checkpoint format, on a tiny *_HF directory
(f32) and a two-source text corpus, one byte-level tokenizer for both.

JAX's train.main trains stage A a step and saves it (an orbax store: OCDBT,
zstd); the port's train.main starts stage B from it (``model.load_stage``)
and saves; JAX's train.main starts stage C from B's store. B and C take
their single step at the warm-up's lr 0, so each stage's store must hold
the parameters it started from: A's, bit for bit, through JAX's own
restore_params_only of every store. The port's Trainer counts the stage
store's bytes in ``checkpoint_bytes``.
"""
import jax
import numpy as np
import torch
import yaml

import long_vita_tpu.tokenizer as jax_tokenizer
import long_vita_tpu.training.distributed as jax_distributed
import long_vita_tpu.utils.compile_cache as jax_compile_cache
import long_vita_tpu_torch.tokenizer as port_tokenizer
from long_vita_tpu.config import tiny_test_config as jax_tiny_config
from long_vita_tpu.models.long_vita import init_long_vita_params as jax_init
from long_vita_tpu.training import checkpoint as jck
from long_vita_tpu.training import train as jtrain
from long_vita_tpu_torch.training import checkpoint as ckpt
from long_vita_tpu_torch.training import train as ttrain
from long_vita_tpu_torch.utils.checkpoint_io import load_long_vita_checkpoint
from test_torch_recipe import _recipe
from test_torch_serving import tiny_tokenizer
from test_torch_tp_checkpoint import _recipe_files


def test_stage_handoff_between_the_packages(tmp_path, monkeypatch):
    tok = tiny_tokenizer()
    for module in (jax_tokenizer, port_tokenizer):
        monkeypatch.setattr(module, "load_tokenizer", lambda path, template="long_vita": tok)
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: None)
    monkeypatch.setattr(jax_distributed, "maybe_initialize", lambda *a, **k: None)
    files = _recipe_files(tmp_path)
    stages = {s: tmp_path / s for s in "abc"}

    def config(name, **over):
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(_recipe(files, **over)))
        return ["--config", str(path)]

    jtrain.main(config("a", optim={"warmup_steps": 0},
                       run={"steps": 1, "save_dir": str(stages["a"])}))
    assert (stages["a"] / "1" / "params" / "manifest.ocdbt").is_file()  # JAX's OCDBT store
    ttrain.main(config("b", model={"load_stage": str(stages["a"])},
                       run={"steps": 1, "save_dir": str(stages["b"])}), device="cpu")
    jtrain.main(config("c", model={"load_stage": str(stages["b"])},
                       run={"steps": 1, "save_dir": str(stages["c"])}))

    template = jax_init(jax.random.PRNGKey(9), jax_tiny_config())

    def leaves(stage):
        restored = jck.restore_params_only(str(stages[stage]), template)
        return [np.asarray(x) for x in jax.tree.leaves(restored)]

    a, b, c = leaves("a"), leaves("b"), leaves("c")
    for x, y, z in zip(a, b, c):
        assert x.dtype == y.dtype == z.dtype and np.array_equal(x, y) and np.array_equal(x, z)
    base_stats, stage_stats = {}, {}
    base, _ = load_long_vita_checkpoint(str(files / "ckpt"), dtype=torch.float32, device="cpu",
                                        stats=base_stats)
    trained = ckpt._read(str(stages["a"]), 1)["params"]
    assert any(not torch.equal(p, trained[n]) for n, p in base.named_parameters())  # A moved

    trainer, _, _ = ttrain.build_from_recipe(
        _recipe(files, model={"load_stage": str(stages["c"])}), device="cpu")
    ckpt.restore_params_only(str(stages["c"]), base, stats=stage_stats)
    assert trainer.checkpoint_bytes == base_stats["bytes_read"] + stage_stats["bytes_read"]
