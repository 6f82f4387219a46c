"""PyTorch port: training on one device against the JAX package.

  - loss and collation: cross_entropy, make_logit_positions and
    collate_packs against long_vita_tpu.training.loss and
    long_vita_tpu.data.dataset on packs with segments and images (exact,
    or 1e-6 for the f32 loss);
  - the optimizer against optax (make_optimizer's chain): identical gradient
    sequences through N steps with warmup, clipping that triggers and one
    that does not, weight decay, the ViT lr multiplier and layer decay, each
    freeze flag and bf16 first moments; parameters and schedule values at
    1e-6;
  - the slice: the tiny VLM (packs with images, segments and a logit budget)
    through make_train_step and make_grad_accum_steps in both packages, the
    port's parameters converted from the JAX ones, f32 on the CPU (JAX takes
    its XLA attention there, the port its plain attention). Loss and
    grad_norm agree to 1e-5 relative over 3 steps, the trainable gradients
    to 1e-4 relative + 1e-6 absolute and the parameters to 1e-5 (XLA and
    PyTorch sum in other orders; Adam divides by sqrt(v), which lifts those
    differences); frozen parameters stay bit-identical;
  - Trainer.train with a checkpoint and a resume that continues the same
    loss trajectory, and the training path with JAX, PIL and yaml absent.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.constants import IGNORE_INDEX
from long_vita_tpu.data import dataset as jdata
from long_vita_tpu.models import long_vita as jlv
from long_vita_tpu.training import loss as jloss
from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu_torch.config import tiny_test_config as port_tiny_config
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train as ttrain
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.training.checkpoint import restore_params_only
from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax, set_requires_grad
from test_torch_quantize import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = tiny_test_config()
S = 64


def _jax_params(seed=0, cfg=CFG):
    """Random tiny VLM with non-trivial norms and biases (f32)."""
    p = jlv.init_long_vita_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name or "ls1" in name or "ls2" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(jnp.asarray, jax.tree_util.tree_map_with_path(fill, p))


def _pack(seed, n_img=2, cuts=(40,), pack_cls=tloss.Pack, s=S):
    """A packed row of ``s`` tokens (S by default): segments restart their
    positions at each cut, n_img tiles sit in the first segment, and labels
    supervise a third of the text tokens."""
    rng = np.random.default_rng(seed)
    t = CFG.image_token_length
    tokens = rng.integers(0, CFG.text.vocab_size, s).astype(np.int32)
    seg = np.zeros(s, np.int32)
    for c in cuts:
        seg[c:] += 1
    starts = np.concatenate([[0], cuts])
    pos = (np.arange(s) - starts[seg]).astype(np.int32)
    labels = np.where(rng.random(s) < 0.35, tokens, IGNORE_INDEX).astype(np.int32)
    images = idx = None
    if n_img:
        img_pos = (3 + np.arange(n_img * t)).reshape(n_img, t)
        labels[img_pos.reshape(-1)] = IGNORE_INDEX
        images = rng.standard_normal((n_img, 56, 56, 3)).astype(np.float32)
        idx = np.stack([np.zeros((n_img, t), np.int64), img_pos])
    return pack_cls(tokens=tokens, labels=labels, position_ids=pos, segment_ids=seg,
                    images=images, image_indices=idx, actual_seq_len=[])


def _batch(seeds=(1,), budget=S):
    return tloss.collate_packs([_pack(s) for s in seeds], budget)


def _jnp(batch):
    return {k: (jnp.asarray(v) if v is not None else None) for k, v in batch.items()}


def _named(tree) -> dict:
    """A JAX tree (params or gradients) as the port's name -> tensor dict."""
    return {n: p.detach().clone() for n, p in long_vita_params_from_jax(tree, device="cpu").named_parameters()}


# ---------------------------------------------------------------------------
# loss and collation
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, [1, 4]] = IGNORE_INDEX
    labels[1, :] = IGNORE_INDEX
    want = jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tloss.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels))
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
    assert got[1].item() == float(want[1]) == 7.0


@pytest.mark.parametrize("budget", [3, 8, 40])
def test_make_logit_positions_matches_jax(budget):
    rng = np.random.default_rng(budget)
    labels = np.where(rng.random((3, 20)) < 0.4, rng.integers(0, 99, (3, 20)), IGNORE_INDEX)
    want = jloss.make_logit_positions(labels, budget)
    got = tloss.make_logit_positions(labels, budget)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_collate_packs_matches_jax():
    """Two packs, one with images and one without, segments in both."""
    specs = [dict(seed=1, n_img=2, cuts=(40,)), dict(seed=2, n_img=0, cuts=(20, 50))]
    want = jdata.collate_packs([_pack(**s, pack_cls=jdata.Pack) for s in specs], S)
    got = tloss.collate_packs([_pack(**s) for s in specs], S)
    assert set(got) == set(want)
    for key in want:
        if want[key] is None:
            assert got[key] is None, key
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for collate, cls in ((jdata.collate_packs, jdata.Pack), (tloss.collate_packs, tloss.Pack)):
        with pytest.raises(ValueError, match="dropped"):
            collate([_pack(1, pack_cls=cls)], 4)


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------

OPT_CASES = {
    "warmup_clip": dict(lr=1e-2, warmup_steps=3, total_steps=8, grad_clip=0.5),
    "decay_vit_mult": dict(lr=3e-3, weight_decay=0.1, vit_lr_mult=0.1,
                           vit_layer_decay=0.8, min_lr_ratio=0.1, total_steps=6),
    "freeze_vision": dict(lr=1e-2, freeze_vision=True, weight_decay=0.05),
    "freeze_projector": dict(lr=1e-2, freeze_projector=True),
    "freeze_text": dict(lr=1e-2, freeze_text=True, weight_decay=0.05),
    "freeze_embed": dict(lr=1e-2, freeze_embed=True),
    # gradients below the clip norm: a global norm summed in another order
    # moves every clipped gradient by an ulp, which can flip the bf16
    # rounding of m (clipping is covered in f32 by warmup_clip)
    "bf16_moments": dict(lr=1e-2, warmup_steps=2, moment_dtype="bfloat16"),
}
UNCLIPPED = {"bf16_moments"}
N_STEPS = 5


def _frozen_prefixes(ocfg) -> tuple:
    out = []
    if ocfg.freeze_vision:
        out.append("vision.")
    if ocfg.freeze_projector:
        out.append("projector.")
    if ocfg.freeze_text:
        out.append("text.")
    if ocfg.freeze_embed:
        out += ["text.embed", "text.lm_head."]
    return tuple(out)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    ocfg = jopt.OptimizerConfig(**OPT_CASES[case])
    tcfg = topt.OptimizerConfig(**OPT_CASES[case])
    jparams = _jax_params(3)
    tparams = long_vita_params_from_jax(jparams, device="cpu")
    set_requires_grad(tparams)  # every leaf takes a gradient: optax sees them all
    before = {n: p.detach().clone() for n, p in tparams.named_parameters()}
    jtx = jopt.make_optimizer(jparams, ocfg, num_vit_layers=CFG.vision.num_hidden_layers)
    ttx = topt.make_optimizer(tparams, tcfg, num_vit_layers=CFG.vision.num_hidden_layers)
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    rng = np.random.default_rng(7)
    for step in range(N_STEPS):
        # clipping triggers on odd steps only
        scale = 1.0 if step % 2 and case not in UNCLIPPED else 1e-4
        grads = jax.tree.map(
            lambda a: jnp.asarray(scale * rng.standard_normal(a.shape), jnp.float32), jparams
        )
        updates, jstate = jtx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttx.step(tparams, _named(grads), tstate)
    want = _named(jparams)
    frozen = _frozen_prefixes(tcfg)
    moved = False
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)
        if n.startswith(frozen):
            assert torch.equal(p.detach(), before[n]), f"{n} is frozen but moved"
        else:
            moved = moved or not torch.equal(p.detach(), before[n])
    assert moved
    if tcfg.moment_dtype == "bfloat16":
        assert all(m.dtype == torch.bfloat16 for m in tstate.mu.values())
        assert all(v.dtype == torch.float32 for v in tstate.nu.values())


@pytest.mark.parametrize("warmup,total,min_ratio", [(0, 10, 0.0), (3, 10, 0.1), (5, 5, 0.0)])
def test_schedule_matches_optax(warmup, total, min_ratio):
    """The decay steps include the warmup; past them the schedule holds its
    end value."""
    cfg = topt.OptimizerConfig(lr=2e-3, warmup_steps=warmup, total_steps=total,
                               min_lr_ratio=min_ratio)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0 if warmup else cfg.lr, peak_value=cfg.lr, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=cfg.lr * min_ratio,
    )
    got = topt.warmup_cosine_schedule(cfg)
    for t in range(total + 3):
        np.testing.assert_allclose(got(t), float(want(jnp.asarray(t, jnp.int32))),
                                   rtol=1e-6, atol=1e-12, err_msg=str(t))


# ---------------------------------------------------------------------------
# the training step against the JAX package
# ---------------------------------------------------------------------------

STEP_CASES = {
    # stage 1: decoder and tower frozen, the projector trains
    "stage1_remat": dict(remat=True, optim=dict(lr=1e-3, freeze_text=True, freeze_vision=True)),
    # a trainable tower beside a frozen decoder
    "tower_trainable": dict(remat=False, optim=dict(lr=1e-3, freeze_text=True, vit_lr_mult=0.1)),
    # everything trains; the projector frozen only by the optimizer's mask
    "all_remat_mask_frozen_projector": dict(
        remat=True, optim=dict(lr=1e-3, freeze_projector=True, weight_decay=0.01)),
}


def _step_flags(optim):
    return dict(freeze_vision=optim.get("freeze_vision", False),
                freeze_text=optim.get("freeze_text", False))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    spec = STEP_CASES[case]
    flags = _step_flags(spec["optim"])
    batch = _batch()
    jparams = _jax_params(0)
    tparams = long_vita_params_from_jax(jparams, device="cpu")
    set_requires_grad(tparams, **flags)
    before = {n: p.detach().clone() for n, p in tparams.named_parameters()}

    # the gradients of one step, before the steps donate jparams
    (jl, jcount), jg = jax.value_and_grad(jts.loss_fn, has_aux=True)(
        jparams, _jnp(batch), CFG, None, spec["remat"], 1, flags["freeze_vision"],
        flags["freeze_text"],
    )
    tg, tl, tcount, _ = tts._backward(
        tparams, tloss.to_device(batch, "cpu"), CFG, spec["remat"], 1,
        flags["freeze_vision"], flags["freeze_text"],
    )
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert tcount.item() == float(jcount) > 0
    jg = _named(jg)
    assert set(tg) == {n for n, p in tparams.named_parameters() if p.requires_grad}
    for n, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)
    for n in set(jg) - set(tg):  # stop_gradient'd in JAX: zero there
        assert not jg[n].any(), n

    ocfg = spec["optim"]
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**ocfg), 2)
    ttx = topt.make_optimizer(tparams, topt.OptimizerConfig(**ocfg), 2)
    jstep = jts.make_train_step(CFG, jtx, None, remat=spec["remat"], vision_chunk=1, **flags)
    tstep = tts.make_train_step(CFG, ttx, None, remat=spec["remat"], vision_chunk=1, **flags)
    jstate = jts.init_train_state(jparams, jtx)
    tstate = tts.init_train_state(tparams, ttx)
    tbatch = tloss.to_device(batch, "cpu")
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, _jnp(batch))
        tstate, tm = tstep(tstate, tbatch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        assert tm["tokens"].item() == float(jm["tokens"])
        losses.append(tm["loss"].item())
    assert losses[-1] < losses[0], losses
    assert tstate.step == int(jstate.step) == 3
    want = _named(jstate.params)
    frozen = _frozen_prefixes(topt.OptimizerConfig(**ocfg))
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
        if n.startswith(frozen):
            assert torch.equal(p.detach(), before[n]), f"{n} is frozen but moved"


def test_grad_accum_steps_match_jax():
    """Two micro-batches accumulated in f32, their mean applied once."""
    flags = dict(freeze_vision=False, freeze_text=True)
    ocfg = dict(lr=1e-3, freeze_text=True)
    micros = [_batch((1,)), _batch((2,))]
    jparams = _jax_params(0)
    tparams = long_vita_params_from_jax(jparams, device="cpu")
    set_requires_grad(tparams, **flags)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**ocfg), 2)
    ttx = topt.make_optimizer(tparams, topt.OptimizerConfig(**ocfg), 2)
    jfns = jts.make_grad_accum_steps(CFG, jtx, None, remat=True, vision_chunk=1, **flags)
    tfns = tts.make_grad_accum_steps(CFG, ttx, None, remat=True, vision_chunk=1, **flags)
    jstate = jts.init_train_state(jparams, jtx)
    tstate = tts.init_train_state(tparams, ttx)

    def run(fns, state, convert):
        grad_fn, accum_fn, apply_fn = fns
        acc = loss_sum = count_sum = None
        for mb in micros:
            g, loss, count = grad_fn(state.params, convert(mb))
            if acc is None:
                acc, loss_sum, count_sum = g, loss, count
            else:
                acc = accum_fn(acc, g)
                loss_sum, count_sum = loss_sum + loss, count_sum + count
        return apply_fn(state, acc, loss_sum, count_sum, 2.0)

    tstate, tm = run(tfns, tstate, lambda b: tloss.to_device(b, "cpu"))
    jstate, jm = run(jfns, jstate, _jnp)
    for key in ("loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    want = _named(jstate.params)
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_requires_grad_follows_the_jax_freezes():
    p = long_vita_params_from_jax(_jax_params(0), device="cpu")
    named = dict(p.named_parameters())
    assert not any(x.requires_grad for x in named.values())  # built frozen
    set_requires_grad(p, freeze_text=True, freeze_vision=True)
    on = {n for n, x in named.items() if x.requires_grad}
    assert on == {n for n in named if n.startswith("projector.")}
    set_requires_grad(p, freeze_vision=True)
    on = {n for n, x in named.items() if x.requires_grad}
    assert on == {n for n in named if not n.startswith("vision.")}


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


def _trainer(tmp, steps, **kw):
    params = long_vita_params_from_jax(_jax_params(0), device="cpu")
    tcfg = TrainerConfig(
        seq_len=S, logit_budget=S, steps=steps, remat=True, vision_chunk=1,
        save_dir=str(tmp) if tmp else None,
        optim=topt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6, freeze_text=True),
        **kw,
    )
    return Trainer(params, CFG, tcfg)


def test_trainer_resume_continues_the_loss_trajectory(tmp_path):
    batches = [_batch((1,)), _batch((2,))] * 2
    whole = _trainer(None, 4)
    want = whole.train(iter(batches))["losses"]
    assert len(want) == 4 and np.isfinite(want).all()

    first = _trainer(tmp_path, 2).train(iter(batches[:2]))["losses"]
    resumed = _trainer(tmp_path, 4)
    assert resumed.start_step == 2 and resumed.state.step == 2
    rest = resumed.train(iter(batches[2:]))["losses"]
    np.testing.assert_allclose(first + rest, want, rtol=1e-6)
    for (n, a), (_, b) in zip(whole.state.params.named_parameters(),
                              resumed.state.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    ev = resumed.evaluate(iter(batches[:2]))
    assert np.isfinite(ev["loss"]) and ev["tokens"] > 0
    # stage handoff: the parameters alone, into a fresh model
    fresh = long_vita_params_from_jax(_jax_params(1), device="cpu")
    restore_params_only(str(tmp_path), fresh)
    for (n, a), (_, b) in zip(fresh.named_parameters(), resumed.state.params.named_parameters()):
        assert torch.equal(a, b), n


def test_trainer_accumulates_micro_batches():
    """global_batch 2 at micro_batch 1: one optimizer step per two batches,
    the same update as make_grad_accum_steps."""
    tr = _trainer(None, 2, global_batch=2, micro_batch=1)
    assert tr.accum == 2 and tr.step_fn is None
    out = tr.train(iter([_batch((1,)), _batch((2,))] * 2))
    assert len(out["losses"]) == 2 and tr.state.step == 2


def test_unported_options_raise():
    """What does not compose raises: MoE over tq, as in JAX (MoE over dp,
    cp, tp and pp trains since the expert-parallel slice); FSDP inside
    pipeline stages binds its communicators since the pp x FSDP slice.
    (dp x cp meshes and zigzag batches train since
    the context-parallel slice, tests/test_torch_cp_training.py; tp since
    the tp training slice, tests/test_torch_tp_training.py: a tp mesh now
    gets as far as asking for its communicator; FSDP since the FSDP slice,
    tests/test_torch_fsdp.py: on one rank it is the plain step, as JAX's
    Trainer, whose mesh is None at size 1; pp and virtual pipeline stages
    since the pipeline slice, tests/test_torch_pp_training.py: a pp mesh
    asks for its communicator, and virtual_pp at pp 1 is the plain step,
    as in JAX; 2-D tp (tq) since the tq slice, tests/test_torch_tp2d.py:
    a tq mesh asks for its communicator, and its train step builds.)"""
    from long_vita_tpu_torch.parallel.comm import ThreadComm
    from long_vita_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="needs comm="):
        _trainer(None, 1, mesh=MeshConfig(dp=2, tp=2, tq=2))
    with pytest.raises(ValueError, match="needs comm="):
        _trainer(None, 1, mesh=MeshConfig(dp=2, tp=2))
    with pytest.raises(ValueError, match="needs comm="):
        _trainer(None, 1, mesh=MeshConfig(pp=2))
    plain, fsdp = _trainer(None, 1), _trainer(None, 1, fsdp=True)
    virtual = _trainer(None, 1, virtual_pp=2)
    assert fsdp.mesh is None and fsdp.state.params.text.fsdp is None
    assert virtual.mesh is None and virtual.state.params.text.pp is None
    batches = [_batch((1,))]
    losses = plain.train(iter(batches))["losses"]
    assert fsdp.train(iter(batches))["losses"] == losses
    assert virtual.train(iter(batches))["losses"] == losses
    for (n, a), (_, b), (_, c) in zip(plain.state.params.named_parameters(),
                                      fsdp.state.params.named_parameters(),
                                      virtual.state.params.named_parameters()):
        assert torch.equal(a, b) and torch.equal(a, c), n
    assert callable(tts.make_train_step(CFG, None,
                                        mesh=make_mesh(MeshConfig(tq=2), ThreadComm.group(2)[0])))
    # FSDP inside pipeline stages trains since the pp x FSDP slice
    # (tests/test_torch_pp_fsdp.py): the Trainer binds a stage's tree cut
    # over dp to the mesh's dp and pp communicators
    from long_vita_tpu_torch.parallel.comm import run_thread_ranks

    def staged(comm):
        tcfg = TrainerConfig(seq_len=S, logit_budget=S, steps=1, remat=True, vision_chunk=1,
                             mesh=MeshConfig(dp=2, pp=2), fsdp=True,
                             optim=topt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6))
        tr = Trainer(long_vita_params_from_jax(_jax_params(0), device="cpu"), CFG, tcfg,
                     comm=comm)
        text = tr.state.params.text
        return (text.fsdp is not None and text.fsdp.comm is tr.mesh.dp_comm
                and text.pp.comm is tr.mesh.pp_comm and len(text.layers) == 1
                and text.layers[0].q_proj.weight.shape[1] * 2 == CFG.text.hidden_size)

    assert all(run_thread_ranks(staged, 4, timeout=60))
    from long_vita_tpu_torch.models.long_vita import init_long_vita_params

    # MoE trains over a mesh as any model (tests/test_torch_ep_*.py), but
    # not over tq, as in JAX
    moe_cfg = port_tiny_config(num_experts=4)
    with pytest.raises(ValueError, match="needs comm="):
        Trainer(init_long_vita_params(torch.Generator(), moe_cfg), moe_cfg,
                TrainerConfig(seq_len=S, logit_budget=S, steps=1, mesh=MeshConfig(dp=2)))
    with pytest.raises(ValueError, match="does not compose with MoE"):
        Trainer(init_long_vita_params(torch.Generator(), moe_cfg), moe_cfg,
                TrainerConfig(seq_len=S, logit_budget=S, steps=1, mesh=MeshConfig(tq=2)))
    # the stage recipes' meshes (configs/stage*.yaml) are multi-device: dp
    # x cp x tp at the 14B's widths passes the port's checks and asks for
    # its ranks, and so does the same recipe over 2-D tp
    from long_vita_tpu_torch.config import long_vita_14b

    recipe = yaml.safe_load((ROOT / "configs" / "stage1_alignment.yaml").read_text())
    with pytest.raises(ValueError, match="needs comm="):
        Trainer(long_vita_params_from_jax(_jax_params(0), device="cpu"), long_vita_14b(),
                ttrain.trainer_config(recipe))
    recipe["mesh"] = {**recipe["mesh"], "tp": 4, "tq": 2}
    with pytest.raises(ValueError, match="needs comm="):
        Trainer(long_vita_params_from_jax(_jax_params(0), device="cpu"), CFG,
                ttrain.trainer_config(recipe))


_NO_JAX_TRAIN = """
import sys, tempfile
for mod in ("jax", "PIL", "yaml", "optax", "orbax", "tensorstore"):
    sys.modules[mod] = None  # any import of them now raises ImportError
import numpy as np, torch
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.training.loss import Pack
from long_vita_tpu_torch.training.optimizer import OptimizerConfig
from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig, batch_iterator

cfg = tiny_test_config()
rng = np.random.default_rng(0)
S, t = 48, cfg.image_token_length
tokens = rng.integers(0, cfg.text.vocab_size, S).astype(np.int32)
labels = np.where(np.arange(S) >= 20, tokens, -100).astype(np.int32)
pack = Pack(tokens, labels, np.arange(S, dtype=np.int32), np.zeros(S, np.int32),
            rng.standard_normal((1, 56, 56, 3)).astype(np.float32),
            np.stack([np.zeros((1, t), np.int64), 2 + np.arange(t)[None]]))
save_dir = tempfile.mkdtemp()

def trainer(steps):
    return Trainer(init_long_vita_params(torch.Generator().manual_seed(0), cfg), cfg,
                   TrainerConfig(seq_len=S, logit_budget=S, steps=steps, vision_chunk=1,
                                 save_dir=save_dir, optim=OptimizerConfig(
                                     lr=1e-3, freeze_text=True, freeze_vision=True)))

tr = trainer(2)
out = tr.train(batch_iterator(iter([pack, pack]), 1, S))
assert len(out["losses"]) == 2 and out["losses"][1] < out["losses"][0], out
# the orbax store it wrote resumes with neither orbax nor tensorstore
back = trainer(3)
assert back.start_step == 2 and back.state.opt_state.count == 2
for (n, p), (_, q) in zip(back.state.params.named_parameters(), tr.state.params.named_parameters()):
    assert torch.equal(p, q), n
for n, m in tr.state.opt_state.mu.items():
    assert torch.equal(back.state.opt_state.mu[n], m), n
loaded = [m for m, v in sys.modules.items() if v is not None]
assert not any(m == "jax" or m.startswith("jax.") for m in loaded)
assert not any(m.startswith(("PIL", "yaml", "long_vita_tpu.data")) for m in loaded)
print("OK", out["losses"])
"""


def test_training_runs_without_jax_pil_or_yaml():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _NO_JAX_TRAIN], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK ")
