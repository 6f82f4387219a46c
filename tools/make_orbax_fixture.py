#!/usr/bin/env python3
"""Write the JAX-written orbax fixture that the port's readers are held to.

    JAX_PLATFORMS=cpu python3 tools/make_orbax_fixture.py [--out tests/data/orbax_jax_tiny]

Runs with JAX, orbax and tensorstore (the JAX package's own
training/checkpoint.save_checkpoint), on the CPU: a TrainState of a
narrower tiny_test_config() (vocabulary 64, decoder width 32 with 2/1
heads, tower width 16 at 28 px, 2 layers each; f32 parameters, bfloat16
mu, f32 nu: moment_dtype "bfloat16"), every float leaf random from a numpy
seed, both optax counts and the step at STEP, saved in orbax's default
layout (OCDBT, zarr v2, zstd chunks) into ``<out>/store``. Beside it, ``<out>/leaves.npz``
holds every array leaf by its orbax name (``params.text.embed.embedding``,
``opt_state.1.mu.text.final_norm``, ...; bfloat16 as its uint16 bits,
listed in the entry ``bfloat16``). The port decodes the store without JAX
(tests/test_torch_orbax_readers.py, chip_smoke.phase_orbax) and must get
those arrays bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEP = 3
SEED = 20


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(ROOT / "tests" / "data" / "orbax_jax_tiny"))
    args = parser.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from long_vita_tpu.config import tiny_test_config
    from long_vita_tpu.models.long_vita import init_long_vita_params
    from long_vita_tpu.training import checkpoint as jck
    from long_vita_tpu.training.optimizer import OptimizerConfig, make_optimizer
    from long_vita_tpu.training.train_step import init_train_state

    base = tiny_test_config(vocab_size=64)
    cfg = dataclasses.replace(
        base,
        text=dataclasses.replace(base.text, hidden_size=32, intermediate_size=64,
                                 num_attention_heads=2, num_key_value_heads=1),
        vision=dataclasses.replace(base.vision, hidden_size=16, intermediate_size=32,
                                   num_attention_heads=1, image_size=28))
    params = init_long_vita_params(jax.random.PRNGKey(0), cfg)
    tx = make_optimizer(params, OptimizerConfig(moment_dtype="bfloat16"),
                        num_vit_layers=cfg.vision.num_hidden_layers)
    rng = np.random.default_rng(SEED)

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("count") or name == ".step":
            return jax.numpy.asarray(np.asarray(STEP, a.dtype))
        value = rng.standard_normal(a.shape).astype(np.float32)
        return jax.numpy.asarray((np.abs(value) if ".nu" in name else value).astype(a.dtype))

    state = jax.tree_util.tree_map_with_path(fill, init_train_state(params, tx))
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    jck.save_checkpoint(str(out / "store"), state)
    leaves, bf16 = {}, []
    for item, tree in (("params", state.params), ("opt_state", state.opt_state)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path]
            name = ".".join([item] + keys)
            a = np.asarray(leaf)
            if a.dtype.name == "bfloat16":
                a = a.view(np.uint16)
                bf16.append(name)
            leaves[name] = a
    np.savez(out / "leaves.npz", bfloat16=np.array(bf16), **leaves)
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"{len(leaves)} leaves, {size} bytes under {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
