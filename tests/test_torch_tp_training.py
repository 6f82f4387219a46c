"""PyTorch port: training over tensor parallelism (Megatron's tensor and
sequence parallelism, the vocab-parallel lookup and CE) against the JAX
package, on the CPU at the tiny configuration (f32; 4/2 heads, so tp 4
replicates each kv head over two ranks):

  - vocab_parallel_ce against JAX's (loss.py:40) on a tp 2 and a cp 2 x
    tp 2 mesh, and against the plain head, with IGNORE_INDEX rows: loss
    rtol 1e-6, the head's and the rows' gradients atol 2e-5;
  - embed_tokens_vp against JAX's (qwen2.py:918), an id past the table
    included: exact; on a pp 2 x tp 2 stage and at S 15 over tp 2 (JAX's
    plain lookup there) the clamped rows, exact;
  - the gradients of the training loss over tp 2 and cp 2 x tp 2 (ring),
    the tower trainable and images in the rows, gathered leaf by leaf,
    against JAX's loss_fn on the same mesh (atol 2e-4, as JAX's own test);
  - the Trainer over thread-ranks, 3 steps, against JAX's make_train_step
    (make_grad_accum_steps) on the whole batches on one device: tp 2,
    dp 2 x tp 2, cp 2 x tp 2, tp 4, a trainable tower, remat "flash",
    gradient accumulation; losses, grad_norm and the gathered parameters
    at 1e-5 relative (the train step's tolerances); lora_only over dp 2 x
    tp 2 (grad_norm over the folded base gradients);
  - a planted fault: the norms' gradients not summed over tp must fail the
    same comparison;
  - sequences that do not split into cp x tp equal slices (the last tp
    slice padded with zero rows, as GSPMD pads): tp 4 at S 62 and cp 2 x
    tp 4 at S 52 (4 kv heads), tp 2 at S 63 and 61 (a logit budget, remat
    "dots", LoRA), the loss and grad_norm at 1e-5 and every gradient at
    atol 2e-4 against JAX's loss_fn on the same mesh and on one device;
    the Trainer with accumulation at S 63; an even sequence's step bit for
    bit that of the plain all-gather / reduce-scatter pair.

The recipe entry over tp and the checkpoints are in
tests/test_torch_tp_checkpoint.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from long_vita_tpu.data import dataset as jdata
from long_vita_tpu.models import qwen2 as jq
from long_vita_tpu.models.qwen2 import ParallelConfig as JParallel
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu.training import loss as jloss
from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu.training import trainer as jtrainer
from long_vita_tpu_torch.constants import IGNORE_INDEX
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import make_mesh
from long_vita_tpu_torch.parallel.sharding import gather_named, leaf_layout, shard_params
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig, batch_iterator
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import CFG, S, _jax_params, _jnp, _named, _pack

RTOL = 1e-5
TIMEOUT = 120
PACK_SPECS = [dict(seed=1, n_img=2, cuts=(40,)), dict(seed=2, n_img=1, cuts=(20, 50)),
              dict(seed=3, n_img=0, cuts=(30,)), dict(seed=4, n_img=2, cuts=(12, 44)),
              dict(seed=5, n_img=1, cuts=(36,)), dict(seed=6, n_img=0, cuts=(16, 48))]
OPTIM = dict(lr=1e-3, warmup_steps=1, total_steps=6)
STEPS = 3


def _packs(cls, s=S):
    return [_pack(**spec, pack_cls=cls, s=s) for spec in PACK_SPECS]


def _jmesh(cp, tp):
    return j_make_mesh(JMeshConfig(dp=1, cp=cp, tp=tp), devices=jax.devices()[:cp * tp])


# ---- vocab_parallel_ce and embed_tokens_vp ---------------------------------------


def _ce_inputs(seed=0, b=2, m=12):
    rng = np.random.default_rng(seed)
    h, v = CFG.text.hidden_size, CFG.text.vocab_size
    kernel = (0.3 * rng.standard_normal((h, v))).astype(np.float32)  # JAX [H, V]
    hidden = rng.standard_normal((b, m, h)).astype(np.float32)
    labels = rng.integers(0, v, (b, m)).astype(np.int32)
    labels[0, ::5] = IGNORE_INDEX
    labels[1, 3] = IGNORE_INDEX
    return kernel, hidden, labels


@pytest.mark.parametrize("cp", [1, 2])
def test_vocab_parallel_ce_matches_jax_and_the_plain_head(cp, one_torch_thread):
    """Each rank of a cp x tp 2 mesh holds its [V/2, H] head slice and its
    cp block of the budget rows (JAX's in_specs P(dp, cp, None)); the loss
    summed over cp and the gradients (the head gathered over tp and summed
    over cp, the rows concatenated over cp) against JAX's
    vocab_parallel_ce and against cross_entropy of the plain head."""
    tp = 2
    kernel, hidden, labels = _ce_inputs(cp)
    par = JParallel(_jmesh(cp, tp))
    jfn = jax.jit(jax.value_and_grad(
        lambda k, h: jloss.vocab_parallel_ce(k, h, jnp.asarray(labels), par)[0], (0, 1)))
    jl, (jgk, jgh) = jfn(jnp.asarray(kernel), jnp.asarray(hidden))
    w_whole = torch.as_tensor(kernel.T.copy())  # the port's [V, H]
    m = hidden.shape[1] // cp

    def rank(comm):
        mesh = make_mesh(MeshConfig(cp=cp, tp=tp), comm)
        v = w_whole.shape[0] // tp
        w = w_whole[mesh.tp_index * v:(mesh.tp_index + 1) * v].clone().requires_grad_()
        rows = slice(mesh.cp_index * m, (mesh.cp_index + 1) * m)
        h = torch.as_tensor(hidden[:, rows]).clone().requires_grad_()
        loss, count = tloss.vocab_parallel_ce(w, h, torch.as_tensor(labels[:, rows]),
                                              mesh.tp_comm)
        loss.backward()
        total = mesh.cp_comm.all_reduce_sum(torch.stack([loss.detach(), count]))
        gw = mesh.cp_comm.all_reduce_sum(w.grad)
        return total, mesh.tp_comm.all_gather(gw, 0), mesh.cp_comm.all_gather(h.grad, 1)

    got = run_thread_ranks(rank, cp * tp, timeout=TIMEOUT)
    # the plain head: the whole [B, M, V] logits, then cross_entropy
    w_plain = w_whole.clone().requires_grad_()
    h_plain = torch.as_tensor(hidden).clone().requires_grad_()
    pl, pc = tloss.cross_entropy(tq._f32_logits(h_plain, w_plain), torch.as_tensor(labels))
    pl.backward()
    for total, gw, gh in got:
        np.testing.assert_allclose(total[0].item(), float(jl), rtol=1e-6)
        np.testing.assert_allclose(total[0].item(), pl.item(), rtol=1e-6)
        assert total[1].item() == pc.item() == float((labels != IGNORE_INDEX).sum())
        np.testing.assert_allclose(gw.numpy(), np.asarray(jgk).T, rtol=0, atol=2e-5)
        np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=0, atol=2e-5)
        np.testing.assert_allclose(gw.numpy(), w_plain.grad.numpy(), rtol=0, atol=2e-5)
        np.testing.assert_allclose(gh.numpy(), h_plain.grad.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("cp", [1, 2])
def test_embed_tokens_vp_matches_jax(cp):
    """The vocab-parallel lookup reduce-scattered into the sequence-parallel
    layout: every rank's [B, S/(cp tp), H] slice, in (cp, tp) order, is
    JAX's [B@dp, S@(cp, tp), H] output bit for bit, zeros at an id past
    the table (JAX's vp path), where the plain lookup clamps."""
    tp = 2
    jparams = _jax_params(0)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, CFG.text.vocab_size, (2, 16)).astype(np.int32)
    ids[0, 3] = CFG.text.vocab_size + 5  # past the table
    ids[1, 9] = CFG.text.vocab_size - 1
    want = np.asarray(jax.jit(lambda p, i: jq.embed_tokens_vp(p, i, JParallel(_jmesh(cp, tp))))(
        jparams["text"], jnp.asarray(ids)))
    assert not want[0, 3].any()
    whole = long_vita_params_from_jax(jparams, device="cpu")

    def rank(comm):
        mesh = make_mesh(MeshConfig(cp=cp, tp=tp), comm)
        local = shard_params(whole, mesh, CFG)
        n = ids.shape[1] // cp
        return tq.embed_tokens_vp(local.text, torch.as_tensor(ids[:, mesh.cp_index * n:
                                                                   (mesh.cp_index + 1) * n]))

    got = torch.cat(run_thread_ranks(rank, cp * tp, timeout=TIMEOUT), 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dims,s", [(dict(pp=2, tp=2), 16), (dict(tp=2), 15)],
                         ids=["pp2_tp2", "tp2_s15"])
def test_embed_tokens_vp_clamps_where_jax_looks_up_plainly(dims, s):
    """On a pipeline stage, and at a sequence that does not split over tp,
    JAX's training lookup is the plain one (long_vita.py:293-301): an id
    past the table gets the table's last row, not zeros. Every rank's
    slice [B, ceil(S/tp), H] is JAX's plain rows bit for bit, in tp order,
    the last slice ending in zero rows past S."""
    from long_vita_tpu_torch.parallel.comm import seq_slice

    jparams = _jax_params(0)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, CFG.text.vocab_size, (2, s)).astype(np.int32)
    ids[0, 3] = CFG.text.vocab_size + 5  # past the table
    want = np.asarray(jax.jit(jq.embed_tokens)(jparams["text"], jnp.asarray(ids)))
    table = np.asarray(jparams["text"]["embed"]["embedding"])
    np.testing.assert_array_equal(want[0, 3], table[-1])
    whole = long_vita_params_from_jax(jparams, device="cpu")
    mc = MeshConfig(**dims)

    def rank(comm):
        mesh = make_mesh(mc, comm)
        local = shard_params(whole, mesh, CFG)
        return mesh.tp_index, tq.embed_tokens_vp(local.text, torch.as_tensor(ids))

    w = seq_slice(s, 2)
    padded = np.concatenate([want, np.zeros((2, 2 * w - s, want.shape[-1]), want.dtype)], 1)
    for t, got in run_thread_ranks(rank, mc.size, timeout=TIMEOUT):
        np.testing.assert_array_equal(got.numpy(), padded[:, t * w:(t + 1) * w])


# ---- the loss's gradients on a mesh -------------------------------------------


@pytest.mark.parametrize("cp", [1, 2])
def test_loss_gradients_over_tp_match_jax(cp, one_torch_thread):
    """tp 2 and cp 2 x tp 2 (ring): one step's gradients of every leaf,
    summed over the ranks as the step sums them and gathered over tp,
    against jax.grad of JAX's loss_fn on the same mesh (its vocab-parallel
    CE and lookup; the tower trains, two rows with images), atol 2e-4."""
    _check_loss_gradients(cp, S)


def test_budget_not_dividing_over_cp_matches_jax_plain_head(one_torch_thread):
    """cp 2 x tp 2 with a 31-row logit budget, which does not divide over
    cp: JAX takes its plain head and CE there (train_step.py:75-84), the
    port its vocab-parallel CE over each cp shard's rows, however many.
    The loss at rtol 1e-5 and every gradient at atol 2e-4 against JAX's
    loss_fn on the same mesh, as above."""
    _check_loss_gradients(2, 31)


def _seq_packs(cls, s):
    """Two packed rows of ``s`` tokens, images in both (the tower trains)."""
    return [_pack(1, 2, (s * 5 // 8,), cls, s), _pack(2, 1, (s // 3, s * 3 // 4), cls, s)]


def _check_loss_gradients(cp, budget, *, s=S, tp=2, cfg=CFG, remat=True, whole=False,
                          lora=False):
    """The port's loss, grad_norm and every gradient over cp x tp against
    JAX's loss_fn on the same mesh (and, ``whole``, on one device on the
    unpermuted rows too): the loss and grad_norm at rtol 1e-5, the
    gradients at atol 2e-4. lora: the tree with test_torch_lora's adapters
    on four projections."""
    if lora:
        from test_torch_lora import _adapted

        jparams, cfg, _, _ = _adapted(("q_proj", "v_proj", "o_proj", "down_proj"))
    else:
        jparams = _jax_params(0, cfg)
    packs = _packs(jdata.Pack)[:2] if s == S else _seq_packs(jdata.Pack, s)
    jbatch = next(jtrainer.batch_iterator(iter(packs), 2, budget, cp))
    assert (jbatch["logit_positions"].shape[1] % cp == 0) == (budget % cp == 0)
    refs = [(JParallel(_jmesh(cp, tp)), jbatch)]
    if whole:
        refs.append((None, next(jtrainer.batch_iterator(iter(packs), 2, budget, 1))))
    wants = []
    for jpar, b in refs:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, b: jts.loss_fn(p, b, cfg, jpar, remat, 2)[0]))(jparams, _jnp(b))
        wants.append((float(jl), float(optax.global_norm(jg)), _named(jg)))
    whole_tree = long_vita_params_from_jax(jparams, device="cpu")
    tpacks = _packs(tloss.Pack)[:2] if s == S else _seq_packs(tloss.Pack, s)
    batch = next(batch_iterator(iter(tpacks), 2, budget, cp))

    def rank(comm):
        from long_vita_tpu_torch.training.distributed import local_rows, make_global_batch

        mesh = make_mesh(MeshConfig(cp=cp, tp=tp), comm)
        local = shard_params(whole_tree, mesh, cfg, own=True)
        grads, loss, _, _ = tts._backward(
            local, make_global_batch(local_rows(batch, mesh, 2), mesh, "cpu"), cfg, remat, 2,
            False, False, mesh=mesh, parallel=tts.make_parallel_config(mesh))
        layout = leaf_layout(local, cfg, mesh.tp_index, tp)
        return loss, gather_named(grads, layout, mesh.tp_comm)

    for loss, grads in run_thread_ranks(rank, cp * tp, timeout=TIMEOUT):
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).item()
        for jl, jnorm, want in wants:
            np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
            np.testing.assert_allclose(norm, jnorm, rtol=1e-5)
            assert set(grads) == set(want)
            for n, g in grads.items():
                np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=0, atol=2e-4,
                                           err_msg=n)


# ---- the Trainer over thread-ranks ---------------------------------------------


_REFERENCE: dict = {}


def _reference(fv: bool, accum: bool = False, budget: int = S, seq: int = S):
    """JAX's train step (its gradient accumulation with ``accum``: 2
    micro-batches of one row) on the whole, unpermuted batches of ``seq``
    tokens on one device: -> (named params, [metrics]) after STEPS steps."""
    key = (fv, accum, budget, seq)
    if key in _REFERENCE:
        return _REFERENCE[key]
    flags = dict(freeze_vision=fv, freeze_text=False)
    jparams = _jax_params(0)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**OPTIM, freeze_vision=fv), 2)
    state, metrics = jts.init_train_state(jparams, jtx), []
    if accum:
        grad_fn, accum_fn, apply_fn = jts.make_grad_accum_steps(CFG, jtx, None, remat=False,
                                                                vision_chunk=2, **flags)
        micro = list(jtrainer.batch_iterator(iter(_packs(jdata.Pack, seq)), 1, budget, 1))
        for i in range(STEPS):
            acc = loss_sum = count_sum = None
            for mb in micro[2 * i:2 * i + 2]:
                g, loss, count = grad_fn(state.params, _jnp(mb))
                if acc is None:
                    acc, loss_sum, count_sum = g, loss, count
                else:
                    acc, loss_sum, count_sum = accum_fn(acc, g), loss_sum + loss, count_sum + count
            state, m = apply_fn(state, acc, loss_sum, count_sum, jnp.asarray(2.0))
            metrics.append({k: float(v) for k, v in m.items()})
    else:
        step = jts.make_train_step(CFG, jtx, None, remat=False, vision_chunk=2, **flags)
        for b in jtrainer.batch_iterator(iter(_packs(jdata.Pack, seq)), 2, budget, 1):
            state, m = step(state, _jnp(b))
            metrics.append({k: float(v) for k, v in m.items()})
    _REFERENCE[key] = (_named(state.params), metrics)
    return _REFERENCE[key]


def _train(params, mesh, comm, *, fv, remat=False, accum=False, cfg=CFG, lora_only=False,
           budget=S, seq=S):
    """One rank: a Trainer over ``comm`` (the whole tree handed in; the
    Trainer cuts the rank's shard) on the zigzag stream of ``seq``-token
    rows, -> (losses, grad norms, the parameters gathered over tp)."""
    tcfg = TrainerConfig(
        seq_len=seq, logit_budget=budget, global_batch=2, micro_batch=1 if accum else 0,
        steps=STEPS,
        mesh=mesh, remat=remat, vision_chunk=2,
        optim=topt.OptimizerConfig(**OPTIM, freeze_vision=fv, lora_only=lora_only))
    tr = Trainer(params, cfg, tcfg, comm=comm)
    norms = []
    if accum:
        apply_fn = tr.apply_fn

        def logged(*a):
            state, m = apply_fn(*a)
            norms.append(float(m["grad_norm"]))
            return state, m

        tr.apply_fn = logged
    else:
        step_fn = tr.step_fn

        def logged(state, batch):
            state, m = step_fn(state, batch)
            norms.append(float(m["grad_norm"]))
            return state, m

        tr.step_fn = logged
    it = batch_iterator(iter(_packs(tloss.Pack, seq)), 1 if accum else 2, budget, mesh.cp)
    losses = tr.train(it)["losses"]
    layout = leaf_layout(tr.state.params, cfg, tr.mesh.tp_index, mesh.tp)
    params = gather_named(dict(tr.state.params.named_parameters()), layout, tr.mesh.tp_comm)
    return losses, norms, params


def _check(got, want):
    losses, norms, params = got
    wparams, wmetrics = want
    np.testing.assert_allclose(losses, [m["loss"] for m in wmetrics], rtol=RTOL)
    np.testing.assert_allclose(norms, [m["grad_norm"] for m in wmetrics], rtol=RTOL)
    assert set(params) == set(wparams)
    for n, p in params.items():
        # rtol and atol 1e-5, as test_torch_training's train step: Adam's
        # 1 / sqrt(v) lifts the rounding of a tiny gradient (an embedding
        # row that one token reaches lands 3e-6 off after 3 steps)
        np.testing.assert_allclose(p.numpy(), wparams[n].numpy(), rtol=RTOL, atol=1e-5, err_msg=n)


CASES = {
    "tp2": dict(mesh=MeshConfig(tp=2), fv=True),
    "dp2_tp2": dict(mesh=MeshConfig(dp=2, tp=2), fv=True),
    "cp2_tp2_ring_trainable_tower": dict(mesh=MeshConfig(cp=2, tp=2), fv=False),
    "tp2_trainable_tower": dict(mesh=MeshConfig(tp=2), fv=False),
    "tp4_shared_kv_heads": dict(mesh=MeshConfig(tp=4), fv=True),
    "tp2_remat_flash": dict(mesh=MeshConfig(tp=2), fv=True, remat="flash"),
    "tp2_grad_accum": dict(mesh=MeshConfig(tp=2), fv=True, accum=True),
    # a logit budget that does not divide over cp (JAX: its plain head)
    "cp2_tp2_budget31": dict(mesh=MeshConfig(cp=2, tp=2), fv=False, budget=31),
    # a sequence that does not split over tp (the last slice ends in a pad row)
    "tp2_s63_grad_accum": dict(mesh=MeshConfig(tp=2), fv=True, accum=True, budget=63, seq=63),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_over_tp_thread_ranks_matches_jax(case, one_torch_thread):
    kw = dict(CASES[case])
    mesh = kw.pop("mesh")
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    want = _reference(kw["fv"], kw.get("accum", False), kw.get("budget", S), kw.get("seq", S))
    for got in run_thread_ranks(lambda comm: _train(whole, mesh, comm, **kw), mesh.size,
                                timeout=TIMEOUT):
        _check(got, want)


def test_planted_fault_in_the_norms_tp_sum_fails(monkeypatch, one_torch_thread):
    """The same comparison with the norms' gradients summed over dp x cp
    only (not over tp): each rank's norm gradient covers its slice of the
    sequence alone, and the gate must see it."""
    monkeypatch.setattr(tts, "_UNSUMMED_OVER_TP", ("norm",))
    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    got = run_thread_ranks(lambda comm: _train(whole, MeshConfig(tp=2), comm, fv=True), 2,
                           timeout=TIMEOUT)
    with pytest.raises(AssertionError):
        _check(got[0], _reference(True))


def test_lora_only_over_dp2_tp2_matches_jax(one_torch_thread):
    """lora_only over dp 2 x tp 2 (thread-ranks): the base weights'
    mask-frozen gradients are summed over their ranks (a sharded one over
    dp, a replicated one over the world) and folded into grad_norm in the
    decoder's hooks; losses, grad_norm and every parameter after 3 steps
    against the JAX lora_only step (the JAX adapters copied in)."""
    from test_torch_lora import _adapted

    jparams, jcfg, params, cfg = _adapted(("q_proj", "v_proj", "o_proj", "down_proj"))
    optim = dict(**OPTIM, lora_only=True, freeze_vision=True)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**optim), 2)
    jstep = jts.make_train_step(jcfg, jtx, None, remat=False, vision_chunk=2,
                                freeze_vision=True, freeze_text=False)
    state, metrics = jts.init_train_state(jparams, jtx), []
    for b in jtrainer.batch_iterator(iter(_packs(jdata.Pack)), 2, S, 1):
        state, m = jstep(state, _jnp(b))
        metrics.append({k: float(v) for k, v in m.items()})
    mesh = MeshConfig(dp=2, tp=2)
    for got in run_thread_ranks(
            lambda comm: _train(params, mesh, comm, fv=True, cfg=cfg, lora_only=True), 4,
            timeout=TIMEOUT):
        _check(got, (_named(state.params), metrics))


# ---- refusals beside JAX's ------------------------------------------------------


def _jax_seq_loss(cfg, s, cp, tp):
    """JAX's loss_fn on a cp x tp mesh for two rows of ``s`` tokens (no
    images): -> the loss, or the error's text."""
    from long_vita_tpu.models.long_vita import init_long_vita_params as j_init

    rng = np.random.default_rng(0)
    v = cfg.text.vocab_size
    batch = {"tokens": jnp.asarray(rng.integers(0, v, (2, s)), jnp.int32),
             "positions": jnp.tile(jnp.arange(s, dtype=jnp.int32), (2, 1)),
             "segment_ids": jnp.zeros((2, s), jnp.int32),
             "logit_positions": jnp.tile(jnp.arange(s, dtype=jnp.int32), (2, 1)),
             "labels": jnp.asarray(rng.integers(0, v, (2, s)), jnp.int32),
             "images": None, "image_indices": None}
    jpar = JParallel(_jmesh(cp, tp))
    try:
        return float(jax.jit(lambda p, b: jts.loss_fn(p, b, cfg, jpar, True, 2)[0])(
            j_init(jax.random.PRNGKey(0), cfg), batch))
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("s,cp", [(60, 1), (52, 2)], ids=["s60_tp4", "s52_cp2_tp4"])
def test_tp4_refusals_beside_jax(s, cp):
    """At tp 4 on the tiny configuration's 2 kv heads JAX's loss_fn raises
    shard_map's divisibility error for any sequence: its attention cuts the
    kv heads over tp (k_ [B, S, 2, D] over tp 4). The port shares each kv
    head between tp // 2 ranks and trains there (tp4_shared_kv_heads
    above), at S 52 over cp 2 x tp 4 too, whose cp shards of 26 tokens do
    not split over tp (the last slice ends in pad rows): validate_geometry
    passes both. With 4 kv heads JAX trains both sequences, and the port
    matches it (test_sequence_refusal_is_the_ports_own)."""
    from long_vita_tpu.config import tiny_test_config as j_tiny
    from long_vita_tpu_torch.parallel.mesh import MeshConfig as PMeshConfig, validate_geometry

    got = _jax_seq_loss(j_tiny(), s, cp, 4)
    assert isinstance(got, str) and "not evenly divisible" in got and "k_" in got, got
    assert bool(s % (cp * 4)) == (cp == 2)
    validate_geometry(CFG.text, PMeshConfig(cp=cp, tp=4), seq_len=s)


def _kv4(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_key_value_heads=4))


def test_sequence_refusal_is_the_ports_own():
    """With 4 kv heads JAX's loss_fn trains a 62-token sequence over tp 4
    and a 52-token one over cp 2 x tp 4, neither splitting into cp x tp
    equal slices (GSPMD pads its layout). The port once refused both by
    a rule of its own; its sequence-parallel layout now pads the last tp
    slices with zero rows, and trains both at JAX's numbers: the loss,
    grad_norm and every gradient against JAX's loss_fn on the same mesh
    and on one device (images in the rows, the tower trainable)."""
    for s, cp in ((62, 1), (52, 2)):
        assert s % (cp * 4) and not s % (2 * cp)
        _check_loss_gradients(cp, s, s=s, tp=4, cfg=_kv4(CFG), whole=True)


UNEVEN = {
    # S 63 over tp 2: rank 1's slice ends in one pad row
    "tp2_s63": dict(cp=1, budget=63, s=63),
    # and a logit budget of 21 rows
    "tp2_s63_budget21": dict(cp=1, budget=21, s=63),
    # the "dots" remat level over the padded slices
    "tp2_s61_remat_dots": dict(cp=1, budget=61, s=61, remat="dots"),
    # LoRA adapters on q, v, o and down
    "tp2_s63_lora": dict(cp=1, budget=63, s=63, lora=True),
}


@pytest.mark.parametrize("case", list(UNEVEN))
def test_uneven_sequence_over_tp_matches_jax(case, one_torch_thread):
    """A sequence that does not split over tp, images in the rows and the
    tower trainable: the port's loss, grad_norm and every gradient against
    JAX's loss_fn on the same mesh (GSPMD's padded layout, its plain
    lookup) and on one device, as test_sequence_refusal_is_the_ports_own."""
    kw = dict(UNEVEN[case])
    _check_loss_gradients(kw.pop("cp"), kw.pop("budget"), whole=True, **kw)


def test_even_sequence_keeps_its_bits(monkeypatch, one_torch_thread):
    """At S 64 over tp 2 (slices that split) the sequence-parallel
    collectives take no pad: the loss and every gradient of one step equal,
    bit for bit, those of the plain all-gather / reduce-scatter pair that
    the layout used before it padded uneven slices."""
    from long_vita_tpu_torch.parallel import comm as tcomm

    class Gather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, comm, dim):
            ctx.comm, ctx.dim = comm, dim
            return comm.all_gather(x, dim)

        @staticmethod
        def backward(ctx, g):
            return ctx.comm.reduce_scatter(g.contiguous(), ctx.dim), None, None

    class Scatter(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, comm, dim):
            ctx.comm, ctx.dim = comm, dim
            return comm.reduce_scatter(x, dim)

        @staticmethod
        def backward(ctx, g):
            return ctx.comm.all_gather(g.contiguous(), ctx.dim), None, None

    whole = long_vita_params_from_jax(_jax_params(0), device="cpu")
    batch = next(batch_iterator(iter(_packs(tloss.Pack)[:2]), 2, S, 1))

    def step(comm):
        from long_vita_tpu_torch.training.distributed import local_rows, make_global_batch

        mesh = make_mesh(MeshConfig(tp=2), comm)
        local = shard_params(whole, mesh, CFG, own=True)
        grads, loss, _, _ = tts._backward(
            local, make_global_batch(local_rows(batch, mesh, 2), mesh, "cpu"), CFG, True, 2,
            False, False, mesh=mesh, parallel=tts.make_parallel_config(mesh))
        return loss, grads

    now = run_thread_ranks(step, 2, timeout=TIMEOUT)
    monkeypatch.setattr(tq, "gather_seq", lambda x, comm, dim=1, n=None: Gather.apply(x, comm, dim))
    monkeypatch.setattr(tq, "scatter_seq", lambda x, comm, dim=1: Scatter.apply(x, comm, dim))
    before = run_thread_ranks(step, 2, timeout=TIMEOUT)
    assert tcomm.seq_slice(S, 2) * 2 == S
    for (loss, grads), (loss0, grads0) in zip(now, before):
        assert torch.equal(loss, loss0)
        assert grads.keys() == grads0.keys()
        for n in grads:
            assert torch.equal(grads[n], grads0[n]), n


def test_fsdp_refusal_beside_jax():
    """FSDP over dp 3: the tiny hidden dim 64 (as the 14B's 5120) does not
    split into 3 pieces. JAX's shard_params (device_put onto its FSDP
    specs) raises "should be divisible by"; the port's validate_geometry
    raises by name before anything is cut."""
    from long_vita_tpu.parallel.sharding import shard_params as j_shard_params
    from long_vita_tpu_torch.parallel.mesh import MeshConfig as PMeshConfig, validate_geometry

    jmesh = j_make_mesh(JMeshConfig(dp=3), devices=jax.devices()[:3])
    with pytest.raises(ValueError, match="divisible by 3"):
        j_shard_params(_jax_params(0), jmesh, fsdp=True)
    with pytest.raises(ValueError, match="hidden 64 % dp 3"):
        validate_geometry(CFG.text, PMeshConfig(dp=3), fsdp=True)
