"""PyTorch port: FSDP (ZeRO-3 weight streaming over dp) against the JAX
package, on the CPU at the tiny configuration (f32; 4/2 heads, so tp 4
holds each kv head on two ranks), over thread-ranks:

  - each rank's FSDP shard against the addressable shard of JAX's
    ``shard_params(params, mesh, fsdp=True)`` at the same mesh coordinates,
    bit for bit, at dp 2, dp 2 x cp 2 x tp 2, dp 4 x tp 2 and dp 2 x tp 4
    (a kv head shared by two tp ranks: the port holds the whole head, JAX
    half of it; the two JAX halves together are compared);
  - parallel/fsdp.py's unit: a decoder layer through the dp gather equals
    the whole-weight layer bit for bit, and each shard's gradient is the
    slice of the whole gradients summed over the ranks (a bias keeps the
    rank's own, summed by the train step); at most one unit's
    gathered weights are alive at any point of a forward and backward over
    4 layers and the head, with remat off, full and "flash", and none after
    the forward (without the saved-tensor hooks every layer's would be);
  - the Trainer with FSDP over 3 steps against JAX's FSDP train step on
    the same mesh (dp 2; dp 2 x cp 2 x tp 2) and against the one-device
    step (dp 4 x tp 2, dp 2 x tp 4, remat full and "flash", accumulation,
    a trainable tower, lora_only over dp 2 x tp 2, dp 2 x tp 2 on 63-token
    rows that do not split over tp): losses, grad_norm and
    the gathered parameters at the one-device step's tolerances (1e-5
    relative, +1e-5 absolute);
  - two planted faults must each fail that comparison: grad_norm without
    its dp sum of squares, and the reduce-scatter replaced by the rank's
    own slice of its own gradient;
  - ``long_vita_72b()`` equals JAX's, and the 72B recipes' geometry (tp 8
    x FSDP 8) and the 14B's at dp 4 x tp 2 pass validate_geometry.

Slice loading, resume across geometries and ``train.main`` are in
tests/test_torch_fsdp_checkpoint.py.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.data import dataset as jdata
from long_vita_tpu.parallel import sharding as jsharding
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu.training import trainer as jtrainer
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.parallel import fsdp as tfsdp
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import make_mesh, validate_geometry
from long_vita_tpu_torch.parallel.sharding import gather_named, rank_layout, shard_params, slice_leaf
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_tp_training import OPTIM, STEPS, _check, _packs, _reference
from test_torch_training import CFG, S, _jax_params, _jnp, _named

TIMEOUT = 120
GEOMS = {"dp2": MeshConfig(dp=2), "dp2_cp2_tp2": MeshConfig(dp=2, cp=2, tp=2),
         "dp4_tp2": MeshConfig(dp=4, tp=2), "dp2_tp4": MeshConfig(dp=2, tp=4)}


def _jmesh(m: MeshConfig):
    return j_make_mesh(JMeshConfig(dp=m.dp, cp=m.cp, tp=m.tp), devices=jax.devices()[:m.size])


# ---- the shards -------------------------------------------------------------------


@pytest.mark.parametrize("geom", list(GEOMS))
def test_fsdp_shards_match_jax_shard_params(geom):
    m = GEOMS[geom]
    jparams = _jax_params(0)
    jmesh = _jmesh(m)
    placed = jsharding.shard_params(jparams, jmesh, fsdp=True)
    whole = long_vita_params_from_jax(jparams, device="cpu")

    def local(d, c, t):
        dev = jmesh.devices[d, 0, c, t, 0]
        return _named(jax.tree.map(
            lambda a: next(s.data for s in a.addressable_shards if s.device == dev), placed))

    def rank(comm):
        mesh = make_mesh(m, comm)
        shard = shard_params(whole, mesh, CFG, own=True, fsdp=True)
        assert shard.text.fsdp is not None and shard.text.fsdp.comm is mesh.dp_comm
        return (mesh.dp_index, mesh.cp_index, mesh.tp_index), {
            n: p.detach().clone() for n, p in shard.named_parameters()}

    hkv = CFG.text.num_key_value_heads
    share = max(m.tp // hkv, 1)
    for (d, c, t), got in run_thread_ranks(rank, m.size, timeout=TIMEOUT):
        want = local(d, c, t)
        assert got.keys() == want.keys()
        for n, p in got.items():
            if share > 1 and (".k_proj." in n or ".v_proj." in n):
                # GSPMD cuts the kv head; the rank holds the whole head its q heads read
                j = t // share
                w = torch.cat([local(d, c, u)[n] for u in range(j * share, (j + 1) * share)], 0)
            else:
                w = want[n]
            assert p.shape == w.shape and torch.equal(p, w), (geom, (d, c, t), n)


# ---- the unit ---------------------------------------------------------------------


def _text_cfg(layers=2):
    return dataclasses.replace(CFG.text, num_hidden_layers=layers)


@pytest.mark.parametrize("dp", [2, 4])
def test_gathered_layer_equals_the_whole_layer(dp, one_torch_thread):
    """A decoder layer through fsdp.gathered_layer on each rank's own rows:
    the output bit for bit the whole layer's; each shard's gradient the
    slice of the whole gradients summed over the ranks (rank order)."""
    tcfg = _text_cfg(1)
    whole = tq.init_qwen2_params(torch.Generator().manual_seed(2), tcfg)
    with torch.no_grad():
        for n, p in whole.named_parameters():
            if "norm" in n:
                p.add_(0.3 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    s = 24
    xs = [torch.randn(1, s, tcfg.hidden_size, generator=torch.Generator().manual_seed(10 + r))
          for r in range(dp)]
    pos = torch.arange(s)[None]
    cos, sin = tq.rope_cos_sin(pos, tcfg.head_dim, tcfg.rope_theta)

    def run(layer, x):
        out, _ = tq.decoder_layer(layer, x, cos, sin, tcfg, None, None, pos, None, "xla")
        return out

    ref_out, ref_grads = [], []
    for x in xs:
        layer = copy.deepcopy(whole.layers[0])
        for p in layer.parameters():
            p.requires_grad_(True)
        out = run(layer, x)
        (out * out).sum().backward()
        ref_out.append(out.detach())
        ref_grads.append({n: p.grad for n, p in layer.named_parameters()})
    summed = {n: torch.stack([g[n] for g in ref_grads]).sum(0) for n in ref_grads[0]}

    def rank(comm):
        mesh = make_mesh(MeshConfig(dp=dp), comm)
        shard = shard_params(whole, mesh, tcfg, own=True, fsdp=True)
        layer = shard.layers[0]
        for p in layer.parameters():
            p.requires_grad_(True)
        x = xs[mesh.dp_index]
        out = run(tfsdp.gathered_layer(layer, shard.fsdp), x)
        (out * out).sum().backward()
        layout = {n[len("layers.0."):]: leaf for n, leaf in
                  rank_layout(shard, tcfg, mesh).items() if n.startswith("layers.0.")}
        return mesh.dp_index, out.detach(), {n: (p.grad, layout[n])
                                             for n, p in layer.named_parameters()}

    for d, out, grads in run_thread_ranks(rank, dp, timeout=TIMEOUT):
        assert torch.equal(out, ref_out[d])
        for n, (g, leaf) in grads.items():
            assert leaf.fsdp == ("norm" in n or n.endswith("weight")), n
            # a bias is no FSDP leaf: its gradient is the rank's own (the
            # train step sums it after the backward)
            want = slice_leaf(summed[n], leaf) if leaf.fsdp else ref_grads[d][n]
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-6, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("remat", [False, True, "flash", "unhooked"])
def test_one_unit_of_gathered_weights_alive(remat, monkeypatch, one_torch_thread):
    """A forward and backward of 4 layers and the head over dp 2: at most
    one unit's gathered tensors are alive at any gather (the peak over the
    run), none once the forward has ended; the whole weights are gathered
    again in the backward, once a unit (remat: by the recompute; else by
    the saved-tensor hooks). Without the hooks ("unhooked", the control)
    every layer's and the head's weights stay alive after the forward."""
    tcfg = _text_cfg(4)
    whole = tq.init_qwen2_params(torch.Generator().manual_seed(4), tcfg)
    if remat == "unhooked":
        import contextlib

        monkeypatch.setattr(tq, "streaming", lambda params: contextlib.nullcontext())
    s = 32

    def rank(comm):
        mesh = make_mesh(MeshConfig(dp=2), comm)
        shard = shard_params(whole, mesh, tcfg, own=True, fsdp=True)
        fs = shard.fsdp
        for p in shard.parameters():
            p.requires_grad_(True)
        ids = torch.randint(0, tcfg.vocab_size, (1, s),
                            generator=torch.Generator().manual_seed(mesh.dp_index))
        emb = tq.embed_tokens(shard, ids)
        hidden, _ = tq.qwen2_decoder(shard, emb, torch.arange(s)[None], tcfg,
                                     remat=remat if remat != "unhooked" else False,
                                     attn_impl="xla")
        logits = tq.lm_head(shard, hidden)
        after_forward = fs.live_units()
        logits.logsumexp(-1).sum().backward()
        stats = dict(fs.stats)
        return after_forward, fs.live_units(), stats

    for after_forward, after_backward, stats in run_thread_ranks(rank, 2, timeout=TIMEOUT):
        assert after_backward == 0
        assert stats["scatters"] == 4 + 2  # each layer, the embedding and the head
        if remat == "unhooked":
            assert after_forward == 4 + 1 and stats["peak_live"] == 5
            continue
        assert after_forward == 0 and stats["peak_live"] == 1
        if remat is False:  # gathered again from the hooks: each layer and the head
            assert stats["gathers"] == 6 and stats["regathers"] == 5
        else:  # the recompute gathers each layer; the head from the hooks
            assert stats["gathers"] == 6 + 4 and stats["regathers"] == 1


# ---- the Trainer --------------------------------------------------------------------


_FSDP_REFERENCE: dict = {}


def _jax_fsdp_reference(m: MeshConfig):
    """JAX's train step with fsdp=True on its own mesh of ``m``'s geometry
    (init_train_state(..., mesh, fsdp=True), the Trainer's own path; the
    tower frozen): -> (named params, [metrics]) after STEPS steps."""
    key = (m.dp, m.cp, m.tp)
    if key in _FSDP_REFERENCE:
        return _FSDP_REFERENCE[key]
    jparams = _jax_params(0)
    jmesh = _jmesh(m)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**OPTIM, freeze_vision=True), 2)
    state = jts.init_train_state(jparams, jtx, jmesh, fsdp=True)
    step = jts.make_train_step(CFG, jtx, jmesh, remat=False, vision_chunk=2, freeze_vision=True,
                               freeze_text=False, use_ring=m.cp > 1)
    metrics = []
    for b in jtrainer.batch_iterator(iter(_packs(jdata.Pack)), 2, S, m.cp):
        state, mt = step(state, _jnp(b))
        metrics.append({k: float(v) for k, v in mt.items()})
    _FSDP_REFERENCE[key] = (_named(state.params), metrics)
    return _FSDP_REFERENCE[key]


def _train_fsdp(params, m, comm, *, fv, remat=False, accum=False, cfg=CFG, lora_only=False,
                rows=2, seq=S):
    """One rank: a Trainer with FSDP over ``comm`` (the whole tree handed in;
    the Trainer cuts the rank's shard) on the zigzag stream of ``seq``-token
    rows -> (losses, grad norms, the parameters gathered over dp and tp),
    after checking that the rank's parameters and moments are its shards.
    rows: a step's rows (2 micro-batches of 2 with accum)."""
    rows = 4 if accum else rows
    tcfg = TrainerConfig(
        seq_len=seq, logit_budget=seq, global_batch=rows, micro_batch=2 if accum else 0,
        steps=STEPS, mesh=m, remat=remat, vision_chunk=2, fsdp=True,
        optim=topt.OptimizerConfig(**OPTIM, freeze_vision=fv, lora_only=lora_only))
    tr = Trainer(params, cfg, tcfg, comm=comm)
    norms = []
    name = "apply_fn" if accum else "step_fn"
    fn = getattr(tr, name)

    def logged(*a):
        state, mt = fn(*a)
        norms.append(float(mt["grad_norm"]))
        return state, mt

    setattr(tr, name, logged)
    packs = _packs(tloss.Pack, seq)
    losses = tr.train(batch_iterator(iter(packs * (rows // 2)), rows if not accum else 2, seq,
                                     m.cp))["losses"]
    layout = rank_layout(tr.state.params, cfg, tr.mesh)
    named = dict(tr.state.params.named_parameters())
    for n, p in named.items():  # the rank holds its shards, and moments of their shapes
        assert p.shape == slice_leaf(dict(params.named_parameters())[n], layout[n]).shape, n
        if n in tr.state.opt_state.mu:
            assert tr.state.opt_state.mu[n].shape == p.shape == tr.state.opt_state.nu[n].shape
    gathered = gather_named(named, layout, tr.mesh.tp_comm, dp_comm=tr.mesh.dp_comm)
    return losses, norms, gathered


def _rows4_reference():
    """JAX's one-device train step on 3 steps of 4 rows (the packs twice)."""
    if "rows4" in _FSDP_REFERENCE:
        return _FSDP_REFERENCE["rows4"]
    jparams = _jax_params(0)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**OPTIM, freeze_vision=True), 2)
    step = jts.make_train_step(CFG, jtx, None, remat=False, vision_chunk=2, freeze_vision=True,
                               freeze_text=False)
    state, metrics = jts.init_train_state(jparams, jtx), []
    packs = _packs(jdata.Pack)
    for b in jtrainer.batch_iterator(iter(packs + packs), 4, S, 1):
        state, mt = step(state, _jnp(b))
        metrics.append({k: float(v) for k, v in mt.items()})
    _FSDP_REFERENCE["rows4"] = (_named(state.params), metrics)
    return _FSDP_REFERENCE["rows4"]


def _accum_reference():
    """The one-device accumulation reference for 4-row steps of 2 micro
    batches (JAX's make_grad_accum_steps on the whole rows)."""
    key = "accum4"
    if key in _FSDP_REFERENCE:
        return _FSDP_REFERENCE[key]
    jparams = _jax_params(0)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**OPTIM, freeze_vision=True), 2)
    grad_fn, accum_fn, apply_fn = jts.make_grad_accum_steps(CFG, jtx, None, remat=False,
                                                            vision_chunk=2, freeze_vision=True,
                                                            freeze_text=False)
    packs = _packs(jdata.Pack)
    micro = list(jtrainer.batch_iterator(iter(packs + packs), 2, S, 1))
    state, metrics = jts.init_train_state(jparams, jtx), []
    for i in range(STEPS):
        acc = loss_sum = count_sum = None
        for mb in micro[2 * i:2 * i + 2]:
            g, loss, count = grad_fn(state.params, _jnp(mb))
            if acc is None:
                acc, loss_sum, count_sum = g, loss, count
            else:
                acc, loss_sum, count_sum = accum_fn(acc, g), loss_sum + loss, count_sum + count
        state, mt = apply_fn(state, acc, loss_sum, count_sum, jnp.asarray(2.0))
        metrics.append({k: float(v) for k, v in mt.items()})
    _FSDP_REFERENCE[key] = (_named(state.params), metrics)
    return _FSDP_REFERENCE[key]


CASES = {
    "dp2_vs_jax_fsdp": dict(mesh=MeshConfig(dp=2), fv=True, ref="jax_fsdp"),
    "dp2_cp2_tp2_vs_jax_fsdp": dict(mesh=MeshConfig(dp=2, cp=2, tp=2), fv=True, ref="jax_fsdp"),
    "dp4_tp2": dict(mesh=MeshConfig(dp=4, tp=2), fv=True, rows=4),
    "dp2_tp4_shared_kv_heads": dict(mesh=MeshConfig(dp=2, tp=4), fv=True),
    "dp2_remat_full": dict(mesh=MeshConfig(dp=2), fv=True, remat=True),
    "dp2_tp2_remat_flash": dict(mesh=MeshConfig(dp=2, tp=2), fv=True, remat="flash"),
    "dp2_grad_accum": dict(mesh=MeshConfig(dp=2), fv=True, accum=True),
    "dp2_cp2_trainable_tower": dict(mesh=MeshConfig(dp=2, cp=2), fv=False),
    # rows of 63 tokens, which do not split over tp (rank 1's slice ends in a pad row)
    "dp2_tp2_s63": dict(mesh=MeshConfig(dp=2, tp=2), fv=True, seq=63),
}


def _want(kw):
    if kw.get("ref") == "jax_fsdp":
        return _jax_fsdp_reference(kw["mesh"])
    if kw.get("accum"):
        return _accum_reference()
    if kw.get("rows") == 4:
        return _rows4_reference()
    seq = kw.get("seq", S)
    return _reference(kw["fv"], budget=seq, seq=seq)


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_with_fsdp_matches_jax(case, one_torch_thread):
    kw = dict(CASES[case])
    m = kw.pop("mesh")
    want = _want({**kw, "mesh": m})
    kw.pop("ref", None)
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    got = run_thread_ranks(lambda comm: _train_fsdp(whole, m, comm, **kw), m.size,
                           timeout=TIMEOUT)
    for g in got:
        assert g[0] == got[0][0]  # every rank the same loss bits
        _check(g, want)


def test_lora_only_with_fsdp_over_dp2_tp2_matches_jax(one_torch_thread):
    """lora_only over dp 2 x tp 2 with FSDP: the adapters replicated over dp
    (JAX's specs), the base weights cut over dp and tp, their mask-frozen
    gradients reduce-scattered, summed and folded into grad_norm in the
    decoder's hooks; against the JAX lora_only step."""
    from test_torch_lora import _adapted

    jparams, jcfg, params, cfg = _adapted(("q_proj", "v_proj", "o_proj", "down_proj"))
    optim = dict(**OPTIM, lora_only=True, freeze_vision=True)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**optim), 2)
    jstep = jts.make_train_step(jcfg, jtx, None, remat=False, vision_chunk=2,
                                freeze_vision=True, freeze_text=False)
    state, metrics = jts.init_train_state(jparams, jtx), []
    for b in jtrainer.batch_iterator(iter(_packs(jdata.Pack)), 2, S, 1):
        state, mt = jstep(state, _jnp(b))
        metrics.append({k: float(v) for k, v in mt.items()})
    m = MeshConfig(dp=2, tp=2)

    def rank(comm):
        got = _train_fsdp(params, m, comm, fv=True, cfg=cfg, lora_only=True)
        return got

    for got in run_thread_ranks(rank, 4, timeout=TIMEOUT):
        _check(got, (_named(state.params), metrics))


@pytest.mark.parametrize("fault", ["norm_unsummed_over_dp", "local_slice_not_scattered"])
def test_planted_faults_fail_the_comparison(fault, monkeypatch, one_torch_thread):
    """The dp 2 comparison with grad_norm counting each rank's own FSDP
    shards only (train_step._NORM_UNSUMMED_OVER_DP), or with the backward
    keeping the rank's slice of its own gradient instead of the
    reduce-scatter (fsdp._LOCAL_SLICE_NOT_SCATTERED): each must fail."""
    if fault == "norm_unsummed_over_dp":
        monkeypatch.setattr(tts, "_NORM_UNSUMMED_OVER_DP", True)
    else:
        monkeypatch.setattr(tfsdp, "_LOCAL_SLICE_NOT_SCATTERED", True)
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    got = run_thread_ranks(lambda comm: _train_fsdp(whole, MeshConfig(dp=2), comm, fv=True), 2,
                           timeout=TIMEOUT)
    with pytest.raises(AssertionError):
        _check(got[0], _reference(True))


# ---- the configuration --------------------------------------------------------------


def test_long_vita_72b_matches_jax_and_its_recipes_pass_the_geometry():
    """long_vita_72b() field for field JAX's; configs/stage{1,2}_72b_tp8fsdp8
    at their own mesh ({dp: 8, tp: 8}, FSDP) and the 14B at dp 4 x tp 2
    pass validate_geometry; a dim that does not split over dp raises,
    naming it; a MoE model whose experts dp does not divide raises (expert
    parallelism cuts them over dp)."""
    from pathlib import Path

    import yaml

    from long_vita_tpu import config as jconfig
    from long_vita_tpu_torch import config as tconfig
    from long_vita_tpu_torch.training import train as ttrain

    assert dataclasses.asdict(tconfig.long_vita_72b()) == dataclasses.asdict(
        jconfig.long_vita_72b())
    root = Path(__file__).resolve().parents[1]
    cfg72 = tconfig.long_vita_72b()
    for name in ("stage1_72b_tp8fsdp8.yaml", "stage2_72b_tp8fsdp8.yaml"):
        recipe = yaml.safe_load((root / "configs" / name).read_text())
        tcfg = ttrain.trainer_config(recipe)
        assert tcfg.fsdp and (tcfg.mesh.dp, tcfg.mesh.tp) == (8, 8)
        validate_geometry(cfg72.text, tcfg.mesh, seq_len=tcfg.seq_len, fsdp=True)
    validate_geometry(tconfig.long_vita_14b().text, MeshConfig(dp=4, tp=2), seq_len=16384,
                      fsdp=True)
    bad = dataclasses.replace(tiny_test_config().text, vocab_size=510)
    with pytest.raises(ValueError, match="vocab 510 % tp\\*dp 4"):
        validate_geometry(bad, MeshConfig(dp=2, tp=2), fsdp=True)
    validate_geometry(bad, MeshConfig(dp=2, tp=2))  # without FSDP the vocab splits over tp
    with pytest.raises(ValueError, match="hidden 64 % dp 3"):
        validate_geometry(tiny_test_config().text, MeshConfig(dp=3), fsdp=True)
    moe = tiny_test_config(num_experts=3)  # FSDP with MoE runs (tests/test_torch_ep_fsdp.py)
    with pytest.raises(ValueError, match="3 experts do not divide over dp 2"):
        Trainer(tq.init_qwen2_params(torch.Generator(), moe.text), moe,
                TrainerConfig(seq_len=S, logit_budget=S, steps=1, mesh=MeshConfig(dp=2),
                              fsdp=True))
