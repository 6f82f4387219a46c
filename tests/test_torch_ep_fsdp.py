"""PyTorch port: a MoE model under FSDP, its geometry-free checkpoints, and
the MoE meshes JAX rejects, on the CPU (tests/test_torch_ep_training.py's
configuration: 4 experts, top-2, capacity factor 0.5, copies dropped):

  - the Trainer with FSDP at dp 2 and dp 2 x tp 2 (the dense leaves
    streamed over dp, the expert stacks cut over dp for expert parallelism
    and never gathered) against JAX's make_train_step with fsdp on the same
    mesh, 3 steps: losses, grad_norm and the gathered parameters at 1e-5
    relative; each rank holds its E / dp experts' I / tp columns;
  - a checkpoint written under expert parallelism at dp 2 x tp 2 resumes at
    dp 1, and one written at dp 1 resumes there: the resumed run holds,
    gathered, the file's parameters and moments bit for bit, in the
    one-device format;
  - JAX's rejections: an expert count that dp does not divide, MoE over tq,
    and weight quantization of a MoE tree.
"""
import copy

import numpy as np
import pytest
import torch

from long_vita_tpu_torch.models.quantize import quantize_weights_int4, quantize_weights_int8
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.parallel.comm import ThreadComm, run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import make_mesh, validate_geometry
from long_vita_tpu_torch.parallel.sharding import gather_named, rank_layout, shard_params
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training.checkpoint import _read
from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_ep_training import (
    OPTIM,
    PORT_CFG,
    TIMEOUT,
    check,
    jax_params,
    jax_reference,
    packs,
    run_case,
)
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import S

FSDP = {"dp2_fsdp": MeshConfig(dp=2), "dp2_tp2_fsdp": MeshConfig(dp=2, tp=2)}


@pytest.mark.parametrize("case", list(FSDP))
def test_trainer_moe_with_fsdp_matches_jax(case, one_torch_thread):
    m = FSDP[case]
    want = jax_reference(m, fsdp=True)
    for got in run_case(m, fsdp=True):
        check(got, want)


def test_fsdp_shard_holds_its_experts_and_streams_the_rest():
    """Under FSDP at dp 2 x tp 2 a MoE layer's norms and attention weights
    are cut over dp (gathered when the layer runs), the router is whole and
    the experts are the rank's 2 of 4, I / 2 of their ffn, bound to the dp
    communicator for expert parallelism."""
    whole = long_vita_params_from_jax(jax_params(), device="cpu")
    h, i = PORT_CFG.text.hidden_size, PORT_CFG.text.intermediate_size

    def rank(comm):
        mesh = make_mesh(MeshConfig(dp=2, tp=2), comm)
        local = shard_params(whole, mesh, PORT_CFG, own=True, fsdp=True)
        layer = local.text.layers[0]
        assert local.text.ep_comm is mesh.dp_comm and local.text.fsdp is not None
        assert tuple(layer.experts.gate.shape) == (2, h, i // 2)
        assert tuple(layer.experts.down.shape) == (2, i // 2, h)
        assert tuple(layer.router.weight.shape) == (4, h)
        assert layer.input_norm.shape[0] == h // 2
        e = mesh.dp_index * 2
        t = slice(mesh.tp_index * i // 2, (mesh.tp_index + 1) * i // 2)
        want = whole.text.layers[0].experts.gate[e:e + 2, :, t]
        return bool(torch.equal(layer.experts.gate, want))

    assert all(run_thread_ranks(rank, 4, timeout=TIMEOUT))


GEOMETRIES = {"one_device": MeshConfig(), "ep_dp2_tp2": MeshConfig(dp=2, tp=2)}


def _run(params, geom, steps, save_dir, batches):
    """Train to ``steps`` at ``geom`` (resuming from save_dir when it holds a
    checkpoint): -> (the start step, the losses of the steps run, the
    parameters and moments gathered right after the resume)."""
    m = GEOMETRIES[geom]

    def rank(comm):
        tcfg = TrainerConfig(
            seq_len=S, logit_budget=S, global_batch=2, steps=steps, remat=False, vision_chunk=2,
            mesh=m, save_dir=save_dir, optim=topt.OptimizerConfig(**OPTIM, freeze_vision=True))
        tr = Trainer(copy.deepcopy(params), PORT_CFG, tcfg, comm=comm)
        layout = tr._layout()

        def gathered(named):
            if layout is None:
                return {n: t.detach().clone() for n, t in named.items()}
            return gather_named(named, layout, tr.mesh.tp_comm, dp_comm=tr.mesh.dp_comm)

        resumed = (gathered(dict(tr.state.params.named_parameters())),
                   gathered(tr.state.opt_state.mu), gathered(tr.state.opt_state.nu))
        losses = tr.train(iter(batches[tr.start_step:]))["losses"]
        return tr.start_step, losses, resumed

    if m.size == 1:
        return rank(None)
    res = run_thread_ranks(rank, m.size, timeout=TIMEOUT)
    assert all(r[1] == res[0][1] for r in res)
    return res[0]


@pytest.mark.parametrize("first,then", [("ep_dp2_tp2", "one_device"),
                                        ("one_device", "ep_dp2_tp2")])
def test_checkpoint_resumes_across_expert_parallelism(tmp_path, first, then, one_torch_thread):
    params = long_vita_params_from_jax(jax_params(), device="cpu")
    batches = list(batch_iterator(iter(packs(tloss.Pack, 6)), 2, S))
    start, head, _ = _run(params, first, 2, str(tmp_path), batches)
    assert start == 0 and len(head) == 2
    saved = _read(str(tmp_path), 2)
    assert {n: tuple(t.shape) for n, t in saved["params"].items()} == {
        n: tuple(p.shape) for n, p in params.named_parameters()}  # the one-device format
    start, tail, (p2, mu2, nu2) = _run(params, then, 3, str(tmp_path), batches)
    assert start == 2 and len(tail) == 1 and np.isfinite(tail[0])
    for got, key in ((p2, "params"), (mu2, "mu"), (nu2, "nu")):
        assert got.keys() == saved[key].keys(), key
        for n, t in got.items():
            assert torch.equal(t, saved[key][n]), (key, n)


def test_moe_meshes_that_jax_rejects_raise():
    """At dp > 1 the experts are cut over dp, so dp must divide them
    (validate_geometry, check_moe_mesh, shard_params); tq with MoE and a
    quantised MoE tree raise with JAX's words; dp, cp, tp, pp and FSDP are
    accepted."""
    cfg = PORT_CFG
    three = cfg.text.__class__(**{**cfg.text.__dict__, "num_experts": 3})
    with pytest.raises(ValueError, match="experts 3 % dp 2"):
        validate_geometry(three, MeshConfig(dp=2))
    with pytest.raises(ValueError, match="3 experts do not divide over dp 2"):
        tq.check_moe_mesh(three, dp=2)
    with pytest.raises(ValueError, match="does not compose with MoE"):
        tq.check_moe_mesh(cfg.text, tq=2)
    with pytest.raises(ValueError, match="does not compose with MoE"):
        validate_geometry(cfg.text, MeshConfig(tq=2))
    for kw in (dict(dp=2), dict(cp=2), dict(tp=2), dict(pp=2), dict(dp=4, cp=2, tp=2)):
        tq.check_moe_mesh(cfg.text, **kw)
    tq.check_moe_mesh(three, dp=1, cp=2, tp=2)
    text = tq.init_qwen2_params(torch.Generator().manual_seed(0), three)
    comms = ThreadComm.group(2)
    with pytest.raises(ValueError, match="3 experts do not divide over dp 2"):
        shard_params(text, make_mesh(MeshConfig(dp=2), comms[0]), three)
    with pytest.raises(ValueError, match="MoE"):
        quantize_weights_int8(text)
    with pytest.raises(ValueError, match="MoE"):
        quantize_weights_int4(text)


def test_trainer_rejects_an_expert_count_dp_does_not_divide():
    three = PORT_CFG.__class__(**{**PORT_CFG.__dict__, "text": PORT_CFG.text.__class__(
        **{**PORT_CFG.text.__dict__, "num_experts": 3})})
    params = long_vita_params_from_jax(jax_params(), device="cpu")
    with pytest.raises(ValueError, match="3 experts do not divide over dp 2|experts 3 % dp 2"):
        Trainer(params, three, TrainerConfig(seq_len=S, logit_budget=S, global_batch=2,
                                             mesh=MeshConfig(dp=2)),
                comm=ThreadComm.group(2)[0])


def test_rank_layout_of_an_ep_shard_names_its_expert_pieces():
    """rank_layout of an EP shard at dp 2 x tp 2: the experts' Leaf cut over
    dp (ep 2) and over tp along their ffn dim, the router replicated."""
    whole = long_vita_params_from_jax(jax_params(), device="cpu")

    def rank(comm):
        mesh = make_mesh(MeshConfig(dp=2, tp=2), comm)
        local = shard_params(whole, mesh, PORT_CFG, own=True)
        layout = rank_layout(local, PORT_CFG, mesh)
        gate, down = layout["text.layers.1.experts.gate"], layout["text.layers.1.experts.down"]
        router = layout["text.layers.1.router.weight"]
        return ((gate.ep, gate.ep_index, gate.dim, gate.index, down.dim) ==
                (2, mesh.dp_index, 2, mesh.tp_index, 1) and router.partial
                and not gate.partial and gate.expert)

    assert all(run_thread_ranks(rank, 4, timeout=TIMEOUT))
