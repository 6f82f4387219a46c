"""PyTorch port: the JAX package's orbax stores read by the port, at
tiny_test_config() with random parameters and random Adam moments (numpy
seeds) and both optax counts at the step.

long_vita_tpu.training.checkpoint.save_checkpoint writes each store (OCDBT,
zarr v2, zstd); the port's load_checkpoint and restore_params_only read it
without JAX, orbax or tensorstore. Bit for bit against params_from_jax of
the saved tree: the parameters, mu and nu of every leaf the port keeps
moments for, the counts and the step, in canonical layer order. The cases:
one device (f32); a state sharded over dp 2 x tp 2 with FSDP on the fake
CPU devices (multi-chunk arrays, the per-process OCDBT merged into the top
manifest), also read into tp-2 shards on thread-ranks; pp 2 x virtual_pp 2
(the stack chunk-major on disk); LoRA lora_only (the base weights' moments
dropped: the port keeps none); bf16 parameters with moment_dtype bfloat16
and a frozen tower (its moments zero, checked and dropped); weight_decay
(the chain's indices shift); MoE experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config as jax_tiny_config
from long_vita_tpu.models.long_vita import init_long_vita_params as jax_init
from long_vita_tpu.parallel import pipeline as jpl
from long_vita_tpu.parallel.mesh import MeshConfig as JaxMeshConfig, make_mesh as jax_make_mesh
from long_vita_tpu.training import checkpoint as jck
from long_vita_tpu.training.lora import LoraConfig as JaxLoraConfig
from long_vita_tpu.training.lora import add_lora_params as jax_add_lora
from long_vita_tpu.training.optimizer import OptimizerConfig as JaxOptimizerConfig
from long_vita_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from long_vita_tpu.training.train_step import init_train_state as jax_init_state
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import leaf_layout, shard_params, slice_leaf
from long_vita_tpu_torch.training import checkpoint as ckpt
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training.train_step import init_train_state
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax, set_requires_grad

STEP = 7
CASES = {
    "one_device": {},
    "dp2_tp2_fsdp": dict(mesh=dict(dp=2, tp=2), fsdp=True),
    "pp2_v2": dict(layers=4, mesh=dict(pp=2), virtual_pp=2),
    "lora_only": dict(lora=True, optim=dict(lora_only=True)),
    "bf16_moments": dict(dtype=jnp.bfloat16,
                         optim=dict(moment_dtype="bfloat16", freeze_vision=True)),
    "weight_decay": dict(optim=dict(weight_decay=0.1)),
    "moe": dict(experts=4),
}


def _randomised(state, seed: int, zero: tuple = ()):
    """Every float leaf of the state random (nu positive), the moments of
    paths holding a string of ``zero`` zero, both counts and the step at
    STEP; each leaf keeps its sharding."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("count") or name == ".step":
            value = np.asarray(STEP, a.dtype)
        else:
            value = rng.standard_normal(a.shape).astype(np.float32)
            if ".nu" in name:
                value = np.abs(value)
            if any(z in name for z in zero) and (".mu" in name or ".nu" in name):
                value = np.zeros_like(value)
            value = value.astype(a.dtype)
        return jax.device_put(value, a.sharding)

    return jax.tree_util.tree_map_with_path(fill, state)


def _canonical(tree, layout):
    """The host tree with its decoder stack back in canonical order."""
    tree = jax.tree.map(np.asarray, tree)
    if layout[1] > 1:
        tree["text"]["layers"] = jpl.permute_layer_stack(tree["text"]["layers"], *layout,
                                                         inverse=True)
    return tree


def _named(tree) -> dict:
    return {n: t.detach() for n, t in long_vita_params_from_jax(tree, device="cpu")
            .named_parameters()}


def _write_store(name, root):
    """A case's JAX store in ``root``: -> (case, directory, fresh JAX
    params, cfg, the saved parameters and moments by the port's names,
    canonical order)."""
    case = CASES[name]
    cfg = jax_tiny_config(num_experts=case.get("experts", 0))
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=case.get("layers", 2)))
    params = jax_init(jax.random.PRNGKey(0), cfg, case.get("dtype", jnp.float32))
    if case.get("lora"):
        params, text = jax_add_lora(params, cfg.text, JaxLoraConfig(r=4, alpha=8,
                                                                    targets=("q_proj", "v_proj")),
                                    jax.random.PRNGKey(1), case.get("dtype", jnp.float32))
        cfg = dataclasses.replace(cfg, text=text)
    ocfg = JaxOptimizerConfig(**case.get("optim", {}))
    mesh = None
    if "mesh" in case:
        m = JaxMeshConfig(**case["mesh"])
        mesh = jax_make_mesh(m, devices=jax.devices()[:m.dp * m.pp * m.tp])
    virtual = case.get("virtual_pp", 1)
    layout = (case["mesh"]["pp"], virtual) if virtual > 1 else (1, 1)
    tx = jax_make_optimizer(params, ocfg, num_vit_layers=cfg.vision.num_hidden_layers)
    state = jax_init_state(params, tx, mesh, fsdp=case.get("fsdp", False), virtual_pp=virtual)
    state = _randomised(state, 5, zero=("vision",) if ocfg.freeze_vision else ())
    jck.save_checkpoint(str(root), state, layer_layout=layout)
    adam = state.opt_state[1]
    want = {"params": _named(_canonical(state.params, layout)),
            "mu": _named(_canonical(adam.mu, layout)), "nu": _named(_canonical(adam.nu, layout))}
    fresh = jax.tree.map(np.asarray, params)
    return name, case, str(root), fresh, cfg, want


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """name -> its case's JAX store, written once per module."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = _write_store(name, tmp_path_factory.mktemp(name))
        return made[name]

    return get


def _port_state(fresh, case, cfg):
    """A port TrainState of the case's tree (other values) and optimizer."""
    params = long_vita_params_from_jax(jax.tree.map(lambda a: -a, fresh), device="cpu")
    ocfg = topt.OptimizerConfig(**case.get("optim", {}))
    set_requires_grad(params, freeze_vision=ocfg.freeze_vision,
                      freeze_text=ocfg.freeze_text and not ocfg.lora_only)
    tx = topt.make_optimizer(params, ocfg, num_vit_layers=cfg.vision.num_hidden_layers)
    return init_train_state(params, tx)


def _equal(got: dict, want: dict, what: str) -> None:
    for n, t in got.items():
        assert t.dtype == want[n].dtype and torch.equal(t, want[n]), (what, n)


@pytest.mark.parametrize("name", list(CASES))
def test_port_resumes_a_jax_store(stores, name):
    name, case, root, fresh, cfg, want = stores(name)
    assert ckpt.latest_step(root) == STEP
    state = ckpt.load_checkpoint(root, _port_state(fresh, case, cfg))
    assert state.step == STEP and state.opt_state.count == STEP
    _equal({n: p.detach() for n, p in state.params.named_parameters()}, want["params"], "params")
    mu, nu = state.opt_state.mu, state.opt_state.nu
    assert mu.keys() == nu.keys() and mu
    _equal(mu, want["mu"], "mu")
    _equal(nu, want["nu"], "nu")
    held = set(mu)
    if name == "lora_only":
        assert held == {n for n in want["params"] if ".lora." in n}
    elif name == "bf16_moments":
        assert not any(n.startswith("vision.") for n in held)
        assert all(t.dtype == torch.bfloat16 for t in mu.values())
    else:
        assert held == set(want["params"])
    # stage handoff: the parameters alone, canonical order
    other = _port_state(fresh, case, cfg).params
    stats = {}
    ckpt.restore_params_only(root, other, stats=stats)
    _equal({n: p.detach() for n, p in other.named_parameters()}, want["params"], "params only")
    assert stats["bytes_read"] > 0


def test_port_reads_a_sharded_jax_store_into_tp_shards(stores):
    """The dp 2 x tp 2 FSDP store (chunks per device shard) into tp-2
    shards: each rank's slices, read alone, bit for bit."""
    name, case, root, fresh, cfg, want = stores("dp2_tp2_fsdp")
    from long_vita_tpu_torch.config import tiny_test_config

    port_cfg = tiny_test_config()

    def rank(comm):
        mesh = make_mesh(MeshConfig(tp=2), comm)
        state = _port_state(fresh, case, cfg)
        shard = shard_params(state.params, mesh, port_cfg, own=True)
        layout = leaf_layout(shard, port_cfg, mesh.tp_index, 2)
        ckpt.restore_params_only(root, shard, layout=layout)
        return {n: (p.detach().clone(), slice_leaf(want["params"][n], layout[n]))
                for n, p in shard.named_parameters()}

    for got in run_thread_ranks(rank, 2, timeout=60):
        for n, (g, w) in got.items():
            assert torch.equal(g, w), n


def test_a_stop_gradient_leaf_with_moments_is_refused(stores):
    """JAX's moments of a leaf the port stops the gradient of must be zero."""
    name, case, root, fresh, cfg, want = stores("one_device")
    state = _port_state(fresh, case, cfg)
    for n, p in state.params.named_parameters():
        if n.startswith("vision."):
            p.requires_grad_(False)
            del state.opt_state.mu[n], state.opt_state.nu[n]
    with pytest.raises(ValueError, match="is not zero, but the run stops its gradient"):
        ckpt.load_checkpoint(root, state)
