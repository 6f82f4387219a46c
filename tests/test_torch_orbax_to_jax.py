"""PyTorch port: the port's checkpoints restored by the JAX package, at
tiny_test_config() (f32, and bf16 with bf16 moments) with random
parameters and random Adam moments (numpy seeds), the tower frozen (its
moments written as zeros: the port keeps none).

The port's save_checkpoint writes the store at one device and, on
thread-ranks, from tp-2 shards, from FSDP shards (dp 2), from the stages
of pp 2 x virtual_pp 2, from 2-D tp shards (tp 2 x tq 2) and from a MoE
tree's expert shards (expert parallelism over dp 2); and the stores of
LoRA adapters under lora_only (the base weights' moments written as
zeros: the port keeps none), of weight decay (the chain's slots shift)
and of f32 parameters with bf16 moments over tp 2. long_vita_tpu.training.checkpoint's
load_checkpoint (into init_train_state's template) and restore_params_only
get the same bits: parameters, mu and nu, both counts and the step. The
interleaved store records its (pp, virtual_pp) and keeps its stack
chunk-major: JAX resumes it at that layout and refuses it at another in its
own words; the port resumes it at one device.
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
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.parallel.sharding import rank_layout, shard_named, shard_params
from long_vita_tpu_torch.training import checkpoint as ckpt
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training.train_step import TrainState, init_train_state
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax, set_requires_grad
from long_vita_tpu_torch.utils.orbax_store import read_layout

STEP = 5
GEOMS = {
    "one_device": dict(mesh={}),
    "one_device_bf16": dict(mesh={}, dtype=torch.bfloat16),
    "tp2": dict(mesh=dict(tp=2)),
    "fsdp_dp2": dict(mesh=dict(dp=2), fsdp=True),
    "pp2_v2": dict(mesh=dict(pp=2), virtual_pp=2),
    "tp2_tq2": dict(mesh=dict(tp=2, tq=2)),
    "moe_ep_dp2": dict(mesh=dict(dp=2), experts=4),
    "lora_only": dict(mesh={}, lora=True, optim=dict(lora_only=True)),
    "weight_decay": dict(mesh={}, optim=dict(weight_decay=0.1)),
    "tp2_bf16_moments": dict(mesh=dict(tp=2), optim=dict(moment_dtype="bfloat16")),
}
LORA = dict(r=4, alpha=8, targets=("q_proj", "v_proj"))


def _cfgs(layers: int, experts: int = 0, lora: bool = False):
    port = tiny_test_config(num_experts=experts)
    port = dataclasses.replace(port, text=dataclasses.replace(
        port.text, num_hidden_layers=layers, lora_r=LORA["r"] if lora else 0,
        lora_alpha=LORA["alpha"] if lora else port.text.lora_alpha))
    jcfg = jax_tiny_config(num_experts=experts)
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text,
                                                              num_hidden_layers=layers))
    return port, jcfg


def _optim(geom, bf16: bool) -> dict:
    """The case's optimizer settings (both packages' OptimizerConfig)."""
    return dict(dict(freeze_vision=True, moment_dtype="bfloat16" if bf16 else "float32"),
                **geom.get("optim", {}))


def _whole_state(geom):
    """The whole random port state (parameters, moments of every leaf the
    optimizer keeps them for, count STEP) and its optimizer config."""
    dtype = geom.get("dtype", torch.float32)
    bf16 = dtype == torch.bfloat16
    ocfg = topt.OptimizerConfig(**_optim(geom, bf16))
    cfg, jcfg = _cfgs(4, geom.get("experts", 0), geom.get("lora", False))
    rng = np.random.default_rng(11)
    jtree = jax_init(jax.random.PRNGKey(0), jcfg)
    if geom.get("lora"):
        jtree, jtext = jax_add_lora(jtree, jcfg.text, JaxLoraConfig(**LORA), jax.random.PRNGKey(1))
        jcfg = dataclasses.replace(jcfg, text=jtext)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                        jax.tree.map(np.asarray, jtree))
    params = long_vita_params_from_jax(tree, device="cpu", dtype=dtype)
    set_requires_grad(params, freeze_vision=True)
    state = init_train_state(params, topt.make_optimizer(params, ocfg, 2))
    gen = torch.Generator().manual_seed(12)
    for moments, positive in ((state.opt_state.mu, False), (state.opt_state.nu, True)):
        for n, t in moments.items():
            r = torch.randn(t.shape, generator=gen)
            moments[n] = (r.abs() if positive else r).to(t.dtype)
    state.opt_state.count = state.step = STEP
    return state, ocfg, cfg, jcfg


def _save(state, geom, cfg, root):
    """save_checkpoint of ``state`` whole, or of each rank's shard of it."""
    if not geom["mesh"]:
        ckpt.save_checkpoint(root, state)
        return
    fsdp, virtual = geom.get("fsdp", False), geom.get("virtual_pp", 1)
    over_dp = fsdp or geom.get("experts", 0) > 0  # FSDP shards, or expert shards
    size = int(np.prod(list(geom["mesh"].values())))

    def rank(comm):
        mesh = make_mesh(MeshConfig(**geom["mesh"]), comm)
        shard = shard_params(state.params, mesh, cfg, own=True, fsdp=fsdp, virtual_pp=virtual)
        layout = rank_layout(shard, cfg, mesh)
        opt = state.opt_state
        moments = [{n: t.clone() for n, t in shard_named(m, layout).items()}
                   for m in (opt.mu, opt.nu)]
        local = TrainState(shard, topt.AdamState(*moments, opt.count, opt.config), state.step)
        ckpt.save_checkpoint(root, local, layout=layout, tp_comm=mesh.tp_comm,
                             dp_comm=mesh.dp_comm if over_dp else None, tq_comm=mesh.tq_comm,
                             write=comm.rank == 0)

    run_thread_ranks(rank, size, timeout=60)


def _jax_template(jcfg, layout, geom):
    bf16 = geom.get("dtype") == torch.bfloat16
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    params = jax_init(jax.random.PRNGKey(3), jcfg, dtype)
    if geom.get("lora"):
        params, _ = jax_add_lora(params, jcfg.text, JaxLoraConfig(**LORA), jax.random.PRNGKey(4),
                                 dtype)
    ocfg = JaxOptimizerConfig(**_optim(geom, bf16))
    tx = jax_make_optimizer(params, ocfg, num_vit_layers=jcfg.vision.num_hidden_layers)
    mesh = None
    if layout[1] > 1:
        mesh = jax_make_mesh(JaxMeshConfig(pp=layout[0]), devices=jax.devices()[:layout[0]])
    return params, jax_init_state(params, tx, mesh, virtual_pp=layout[1])


def _named(tree, layout) -> dict:
    tree = jax.tree.map(np.asarray, tree)
    if layout[1] > 1:
        tree["text"]["layers"] = jpl.permute_layer_stack(tree["text"]["layers"], *layout,
                                                         inverse=True)
    return {n: t.detach() for n, t in long_vita_params_from_jax(tree, device="cpu")
            .named_parameters()}


@pytest.mark.parametrize("name", list(GEOMS))
def test_jax_restores_the_port_store(tmp_path, name):
    geom = GEOMS[name]
    state, ocfg, cfg, jcfg = _whole_state(geom)
    root = str(tmp_path)
    _save(state, geom, cfg, root)
    layout = (2, 2) if geom.get("virtual_pp", 1) > 1 else (1, 1)
    assert read_layout(root) == layout and jck.latest_step(root) == STEP
    params, template = _jax_template(jcfg, layout, geom)
    restored = jck.load_checkpoint(root, template, layer_layout=layout)
    assert int(restored.step) == STEP
    adam, schedule = restored.opt_state[1], restored.opt_state[-1]
    assert int(adam.count) == int(schedule.count) == STEP
    want = {n: p.detach() for n, p in state.params.named_parameters()}
    for n, t in _named(restored.params, layout).items():
        assert t.dtype == want[n].dtype and torch.equal(t, want[n]), n
    for kind, held in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        got = _named(getattr(adam, kind), layout)
        assert {n for n in got if n.startswith("vision.")} == {
            n for n in want if n.startswith("vision.")}
        for n, t in got.items():
            expect = held[n] if n in held else torch.zeros_like(t)
            assert t.dtype == expect.dtype and torch.equal(t, expect), (kind, n)
    only = jck.restore_params_only(root, params)  # canonical whatever the layout
    for n, t in _named(only, (1, 1)).items():
        assert torch.equal(t, want[n]), n
    if layout != (1, 1):
        with pytest.raises(ValueError, match="resume requires the same geometry"):
            jck.load_checkpoint(root, _jax_template(jcfg, (1, 1), geom)[1])
        # the port resumes it at one device, canonical order
        fresh = _whole_state(geom)[0]
        back = ckpt.load_checkpoint(root, fresh)
        for n, p in back.params.named_parameters():
            assert torch.equal(p, want[n]), n
        for n, t in back.opt_state.mu.items():
            assert torch.equal(t, state.opt_state.mu[n]), n
