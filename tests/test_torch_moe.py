"""PyTorch port: the local mixture of experts (ops/moe.py) against the JAX
package's, and a MoE decoder through the port's entry points.

The same numpy weights and inputs go through both packages (f32 on the
CPU):
  - moe_mlp with ample and with tight capacity (copies dropped), top-1 and
    top-2: output and aux loss to 1e-5 (f32 products summed in another
    order); the local halves of tests/test_moe.py (one expert is the dense
    SwiGLU, a row is the gate-weighted mix of its experts, over-capacity
    copies give 0), which the JAX file runs only as slow tests;
  - the decoder (forward and aux; decode with a cache, one token a call, so
    a capacity of one call's tokens) from converted JAX weights: 1e-5;
  - one step's loss and aux-carrying gradients, then a train step's loss,
    grad_norm and update: 1e-5 relative, the gradients 1e-4 relative + 1e-6
    (the training slice's tolerances, tests/test_torch_training.py);
  - the serving engine (chunked prefill with a padded last chunk, then
    decode): greedy tokens identical, logprobs to 1e-4;
  - what JAX rejects raises: an expert count that dp does not divide, MoE
    over tq, and weight quantization of a MoE tree (expert parallelism and
    MoE over the mesh are in tests/test_torch_ep_*.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models import long_vita as jlv
from long_vita_tpu.models import qwen2 as jq
from long_vita_tpu.ops import moe as jmoe
from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu_torch.config import tiny_test_config as port_tiny_config
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.models.quantize import quantize_weights_int8
from long_vita_tpu_torch.ops import moe as tmoe
from long_vita_tpu_torch.parallel.comm import ThreadComm
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.utils.convert import (
    long_vita_params_from_jax,
    params_from_jax,
    set_requires_grad,
)
from test_torch_engine import _MM
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import _batch, _jnp, _named

TOL = dict(rtol=1e-5, atol=1e-5)


def _moe_weights(e, h, i, seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"router": {"kernel": n(h, e, scale=1.0)},
            "experts": {"gate": n(e, h, i), "up": n(e, h, i), "down": n(e, i, h)}}


def _port(w):
    return tmoe.MoEParams(
        tq.Dense(torch.from_numpy(w["router"]["kernel"].T.copy())),
        tmoe.Experts(*(torch.from_numpy(w["experts"][k]) for k in ("gate", "up", "down"))))


def _jax(w):
    return jax.tree.map(jnp.asarray, w)


@pytest.mark.parametrize("e,top_k,cap", [(4, 2, 8.0), (4, 2, 1.0), (8, 2, 0.5), (4, 1, 1.25),
                                         (8, 1, 0.25)])
def test_moe_mlp_matches_jax(e, top_k, cap):
    w = _moe_weights(e, 32, 48, seed=e + top_k)
    x = np.random.default_rng(1).standard_normal((2, 16, 32)).astype(np.float32)
    want, want_aux = jmoe.moe_mlp(_jax(w), jnp.asarray(x), top_k=top_k, capacity_factor=cap)
    got, aux = tmoe.moe_mlp(_port(w), torch.from_numpy(x), top_k=top_k, capacity_factor=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **TOL)
    n_tok = 32
    assert tmoe.moe_capacity(n_tok, e, top_k, cap) == max(int(cap * n_tok * top_k / e), top_k)


def test_single_expert_equals_dense():
    """E = 1, k = 1, ample capacity: the expert's SwiGLU, and aux = 1."""
    w = _moe_weights(1, 32, 64, seed=3)
    p = _port(w)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 32)).astype(np.float32))
    out, aux = tmoe.moe_mlp(p, x, top_k=1, capacity_factor=4.0)
    want = tmoe._expert_mlp(p.experts, x.reshape(1, 32, 32)).reshape(2, 16, 32)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    assert abs(aux.item() - 1.0) <= 1e-5
    jout, _ = jmoe.moe_mlp(_jax(w), jnp.asarray(x.numpy()), top_k=1, capacity_factor=4.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_topk_rows_are_weighted_expert_mix():
    """With nothing dropped, each row is sum_k gate_k * expert_k(x)."""
    e, h = 4, 16
    p = _port(_moe_weights(e, h, 32, seed=5))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 8, h)).astype(np.float32))
    out, _ = tmoe.moe_mlp(p, x, top_k=2, capacity_factor=8.0)
    xe = x.reshape(-1, h)
    probs = torch.softmax(xe @ p.router.weight.t(), -1)
    gates, ids = probs.topk(2, -1)
    every = tmoe._expert_mlp(p.experts, xe[None].expand(e, -1, -1))  # [E, N, H]
    want = sum(gates[:, k, None] * every[ids[:, k], torch.arange(8)] for k in range(2))
    torch.testing.assert_close(out.reshape(-1, h), want, atol=1e-5, rtol=0)


def test_capacity_drops_fall_through_to_zero():
    """Every token routed to expert 0 at 2 slots: 2 of 16 rows are nonzero,
    the first two in token order, as in JAX."""
    w = _moe_weights(2, 8, 16, seed=7)
    w["router"]["kernel"][:] = 0.0
    w["router"]["kernel"][:, 1] = -100.0
    w["router"]["kernel"][0, 0] = 100.0
    x = np.ones((1, 16, 8), np.float32)
    got, _ = tmoe.moe_mlp(_port(w), torch.from_numpy(x), top_k=1, capacity_factor=0.25)
    nonzero = got.reshape(16, 8).abs().sum(-1) > 1e-9
    assert nonzero.tolist() == [True, True] + [False] * 14
    want, _ = jmoe.moe_mlp(_jax(w), jnp.asarray(x), top_k=1, capacity_factor=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_expert_axis_raises():
    """The expert axis is a communicator (expert parallelism runs over
    ThreadComm, gloo or NCCL ranks, tests/test_torch_ep_moe.py); a JAX axis
    name raises."""
    p = _port(_moe_weights(2, 8, 16))
    with pytest.raises(TypeError, match="expert communicator"):
        tmoe.moe_mlp(p, torch.zeros(1, 4, 8), axis_name="dp")


# ---------------------------------------------------------------------------
# the MoE decoder
# ---------------------------------------------------------------------------

CFG = tiny_test_config(num_experts=4)
CFG_TIGHT = dataclasses.replace(CFG, text=dataclasses.replace(CFG.text, moe_capacity_factor=0.5))


def _jax_text(cfg, seed=0):
    p = jq.init_qwen2_params(jax.random.PRNGKey(seed), cfg.text)
    rng = np.random.default_rng(seed)

    def fill(path, a):  # non-trivial norms, biases and routers
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "router" in name:
            return (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 4

    return jax.tree_util.tree_map_with_path(fill, p)


@pytest.mark.parametrize("cfg", [CFG, CFG_TIGHT], ids=["cap1.25", "cap0.5"])
def test_moe_decoder_forward_and_aux_match_jax(cfg):
    p = _jax_text(cfg)
    tp = params_from_jax(p, device="cpu")
    assert hasattr(tp.layers[0], "router") and not hasattr(tp.layers[0], "gate_proj")
    ids = np.random.default_rng(1).integers(0, 500, (2, 32))
    pos = np.broadcast_to(np.arange(32), (2, 32))
    emb = jq.embed_tokens(p, jnp.asarray(ids))
    want, _, want_aux = jq.qwen2_decoder(p, emb, jnp.asarray(pos), cfg.text, return_aux=True,
                                         attn_impl="xla")
    temb = tq.embed_tokens(tp, torch.from_numpy(ids))
    got, _, aux = tq.qwen2_decoder(tp, temb, torch.from_numpy(pos.copy()), cfg.text,
                                   return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **TOL)
    assert aux.item() > 0
    again, _ = tq.qwen2_decoder(tp, temb, torch.from_numpy(pos.copy()), cfg.text)
    assert torch.equal(again, got)  # the two-value return is the same forward


def test_moe_decode_with_cache_matches_jax():
    """One token a call through the cache (capacity of one token's copies):
    the port's steps equal JAX's steps, and both track the one-shot
    forward."""
    p = _jax_text(CFG)
    tp = params_from_jax(p, device="cpu")
    ids = np.random.default_rng(2).integers(0, 500, (1, 12))
    pos = np.broadcast_to(np.arange(12), (1, 12)).copy()
    jemb = jq.embed_tokens(p, jnp.asarray(ids))
    temb = tq.embed_tokens(tp, torch.from_numpy(ids))
    jcache = jq.KVCache.zeros(CFG.text, batch=1, max_len=16, dtype=jnp.float32)
    tcache = tq.KVCache.zeros(CFG.text, batch=1, max_len=16, dtype=torch.float32)
    for t in range(12):
        want, jcache = jq.qwen2_decoder(p, jemb[:, t:t + 1], jnp.asarray(pos[:, t:t + 1]),
                                        CFG.text, kv_cache=jcache, attn_impl="xla")
        got, tcache = tq.qwen2_decoder(tp, temb[:, t:t + 1], torch.from_numpy(pos[:, t:t + 1]),
                                       CFG.text, kv_cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_vlm(seed=0):
    p = jlv.init_long_vita_params(jax.random.PRNGKey(seed), CFG, jnp.float32)
    p = dict(p, text=_jax_text(CFG, seed))
    return jax.tree.map(jnp.asarray, p)


def test_moe_train_step_matches_jax():
    """The aux loss enters the loss with moe_aux_loss_coef: one step's loss
    and gradients (the routers' and experts' included), then a train step's
    loss, grad_norm and update, against JAX. Adam's first update is lr x
    sign(g) wherever |g| >> eps (1e-8), so only elements whose gradient sign
    rounding cannot flip (|g| > 1e-5) are held to 1e-5; a later step would
    inherit the flips of the near-zero ones (6e-5 relative on grad_norm at
    lr 1e-2 here), which are rounding, not routing."""
    flags = dict(freeze_vision=True, freeze_text=False)
    batch = _batch()
    jparams = _jax_vlm(0)
    tparams = long_vita_params_from_jax(jparams, device="cpu")
    set_requires_grad(tparams, **flags)
    before = {n: p.detach().clone() for n, p in tparams.named_parameters()}
    (jl, jcount), jg = jax.value_and_grad(jts.loss_fn, has_aux=True)(
        jparams, _jnp(batch), CFG, None, True, 1, flags["freeze_vision"], flags["freeze_text"])
    tg, tl, tcount, _ = tts._backward(tparams, tloss.to_device(batch, "cpu"), CFG, True, 1,
                                      flags["freeze_vision"], flags["freeze_text"])
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jg = _named(jg)
    assert any(".router." in n for n in tg) and any(".experts." in n for n in tg)
    for n, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)

    ocfg = dict(lr=1e-2, warmup_steps=0, total_steps=4, freeze_vision=True)
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**ocfg), 2)
    ttx = topt.make_optimizer(tparams, topt.OptimizerConfig(**ocfg), 2)
    jstep = jts.make_train_step(CFG, jtx, None, remat=True, vision_chunk=1, **flags)
    tstep = tts.make_train_step(CFG, ttx, None, remat=True, vision_chunk=1, **flags)
    jstate, jm = jstep(jts.init_train_state(jparams, jtx), _jnp(batch))
    tstate, tm = tstep(tts.init_train_state(tparams, ttx), tloss.to_device(batch, "cpu"))
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    want = _named(jstate.params)
    for n, p in tstate.params.named_parameters():
        sure = (jg[n].abs() > 1e-5) if n in tg else torch.ones_like(p, dtype=torch.bool)
        np.testing.assert_allclose(p.detach()[sure].numpy(), want[n][sure].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
        if n.startswith("text.layers.0.router"):
            assert not torch.equal(p.detach(), before[n])


@pytest.fixture(scope="module")
def engines():
    p = _jax_text(CFG_TIGHT)
    kw = dict(max_seq_len=512, chunk=64, decode_segment=8)
    jax_eng = JaxEngine({"text": p}, CFG_TIGHT, _MM(), cache_dtype=jnp.float32, **kw)
    port = InferenceEngine(params_from_jax(p, device="cpu"), CFG_TIGHT, _MM(),
                           cache_dtype=torch.float32, **kw)
    return jax_eng, port


def test_moe_engine_greedy_matches_jax(engines):
    """150 ids: two whole chunks and a padded third, each routed with its own
    capacity (copies drop at factor 0.5), then decode one token a call."""
    jax_eng, port = engines
    prompt = np.random.default_rng(8).integers(0, 480, 150).tolist()
    want = jax_eng.generate(input_ids=prompt, sampling=JaxSP(max_new_tokens=12,
                                                             return_logprobs=True))
    got = port.generate(input_ids=prompt, sampling=SamplingParams(max_new_tokens=12,
                                                                  return_logprobs=True))
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=0, atol=1e-4)


def test_moe_engine_batch_matches_jax(engines):
    jax_eng, port = engines
    rng = np.random.default_rng(9)
    reqs = [{"input_ids": rng.integers(0, 480, n).tolist()} for n in (40, 130)]
    want = jax_eng.generate_batch(reqs, sampling=JaxSP(max_new_tokens=8, return_logprobs=True))
    got = port.generate_batch(reqs, sampling=SamplingParams(max_new_tokens=8,
                                                            return_logprobs=True))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0, atol=1e-4)


def test_moe_over_a_mesh_and_quantized_moe_raise():
    """The MoE meshes JAX rejects raise, and only those: an expert count dp
    does not divide (expert parallelism), tq (2-D tp), and the serving
    engine over dp; dp, cp, tp and pp are accepted (tests/test_torch_ep_*.py
    run them against JAX). Weight quantization of a MoE tree raises."""
    cfg = port_tiny_config(num_experts=4)
    with pytest.raises(ValueError, match="4 experts do not divide over dp 3"):
        tq.check_moe_mesh(cfg.text, dp=3)
    with pytest.raises(ValueError, match="does not compose with MoE"):
        tq.check_moe_mesh(cfg.text, tq=2)
    tq.check_moe_mesh(cfg.text)  # one device: fine
    tq.check_moe_mesh(cfg.text, dp=2, cp=2, tp=2)
    tq.check_moe_mesh(cfg.text, dp=4, pp=2)
    tq.check_moe_mesh(port_tiny_config().text, dp=3, tq=2)  # dense: fine
    text = tq.init_qwen2_params(torch.Generator().manual_seed(0), cfg.text)
    comms = ThreadComm.group(2)
    with pytest.raises(NotImplementedError, match="serving a MoE model over dp 2"):
        InferenceEngine(text, cfg, _MM(), cache_dtype=torch.float32,
                        mesh=make_mesh(MeshConfig(dp=2), comms[0]))
    with pytest.raises(ValueError, match="MoE"):
        quantize_weights_int8(text)
