"""PyTorch port: training/lora.py and the adapted projections against the JAX
package, on the tiny VLM in f32 on the CPU, the JAX adapters carried across
by utils/convert (jax.random cannot be reproduced in torch):

  - the adapted decoder (adapters in all seven projections, B random so
    they count) matches to 1e-5 relative; at init (B = 0) the port's own
    adapters leave the model as it was, bit for bit;
  - 3 lora_only steps match the JAX step (trainer's rule: freeze_text off,
    the base weights masked): loss and grad_norm to 1e-5 relative, the step-0
    gradients of B (A's are exactly 0 at B = 0) to 1e-4 relative + 1e-6,
    the adapters and every parameter to 1e-5; every base weight keeps its
    bits and no mask-frozen leaf holds Adam moments;
  - merge_lora matches the JAX merge to 1e-6 and drops the adapters;
  - each package loads the other's save_lora files, bit for bit;
  - greedy tokens from the port's engine with adapters are identical to the
    JAX engine's, with bf16 weights and with int4 projections (logprobs
    1e-4 absolute in f32 as tests/test_torch_engine_quant.py; bf16 tokens
    only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config as jax_tiny
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models import long_vita as jlv
from long_vita_tpu.training import lora as jlora
from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models import long_vita as tlv
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.training import lora as tlora
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax, params_from_jax
from test_torch_engine import _MM
from test_torch_quantize import g128_config, jax_params, one_torch_thread  # noqa: F401
from test_torch_training import _batch, _jax_params, _jnp, _named

R, ALPHA = 4, 8
LCFG = dict(r=R, alpha=ALPHA)


def _adapted(targets=tlora.ALL_TARGETS, seed=0, b_scale=0.05):
    """The tiny JAX VLM with adapters (B random when b_scale) -> (JAX tree,
    JAX cfg, port params, port cfg)."""
    jcfg = jax_tiny()
    params = _jax_params(seed)
    params, jtext = jlora.add_lora_params(params, jcfg.text, jlora.LoraConfig(targets=targets, **LCFG),
                                          jax.random.PRNGKey(seed + 1))
    jcfg = dataclasses.replace(jcfg, text=jtext)
    if b_scale:
        rng = np.random.default_rng(seed + 2)
        for t in targets:
            b = params["text"]["layers"][t]["lora"]["b"]
            params["text"]["layers"][t]["lora"]["b"] = jnp.asarray(
                b_scale * rng.standard_normal(b.shape), jnp.float32)
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, lora_r=R, lora_alpha=ALPHA))
    return params, jcfg, long_vita_params_from_jax(params, device="cpu"), cfg


def _logits(forward, params, batch, cfg):
    return forward(params, batch["tokens"], batch["positions"], cfg, images=batch["images"],
                   image_indices=batch["image_indices"], segment_ids=batch["segment_ids"],
                   logit_positions=batch["logit_positions"])[0]


def test_adapted_forward_matches_jax():
    jparams, jcfg, params, cfg = _adapted()
    batch = _batch()
    want = np.asarray(jax.jit(lambda p, b: _logits(jlv.long_vita_forward, p, b, jcfg))(
        jparams, _jnp(batch)))
    with torch.no_grad():
        got = _logits(tlv.long_vita_forward, params, tloss.to_device(batch, "cpu"), cfg).numpy()
        base = _logits(tlv.long_vita_forward, params, tloss.to_device(batch, "cpu"),
                       tiny_test_config()).numpy()  # lora_r 0: adapters off
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.abs(got - base).max() > 1e-3  # the adapters count


def test_fresh_adapters_leave_the_model_as_it_was():
    params = long_vita_params_from_jax(_jax_params(0), device="cpu")
    batch = tloss.to_device(_batch(), "cpu")
    with torch.no_grad():
        before = _logits(tlv.long_vita_forward, params, batch, tiny_test_config())
        gen = torch.Generator().manual_seed(5)
        _, text_cfg = tlora.add_lora_params(params, tiny_test_config().text,
                                            tlora.LoraConfig(targets=tlora.ALL_TARGETS, **LCFG), gen)
        cfg = dataclasses.replace(tiny_test_config(), text=text_cfg)
        after = _logits(tlv.long_vita_forward, params, batch, cfg)
    assert text_cfg.lora_r == R and text_cfg.lora_alpha == ALPHA
    assert torch.equal(before, after)
    a = params.text.layers[1].down_proj.lora.a
    assert a.shape == (128, R) and 0.1 < a.std().item() * R < 10
    assert not params.text.layers[0].q_proj.lora.b.any()


@pytest.mark.parametrize("freeze_vision", [True, False], ids=["tower_frozen", "tower_in_norm"])
def test_lora_only_steps_match_jax(freeze_vision):
    targets = ("q_proj", "v_proj", "o_proj", "down_proj")
    jparams, jcfg, params, cfg = _adapted(targets, b_scale=0.0)
    flags = dict(freeze_vision=freeze_vision, freeze_text=False)  # the trainer's lora_only rule
    ocfg = dict(lr=1e-2, lora_only=True, freeze_vision=freeze_vision, weight_decay=0.01)
    batch = _batch()
    before = {n: p.detach().clone() for n, p in params.named_parameters()}

    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**ocfg), 2)
    ttx = topt.make_optimizer(params, topt.OptimizerConfig(**ocfg), 2)
    assert ttx.frozen == {n for n in before if ".lora." not in n}
    # step 0's gradients: B's (A's are exactly zero while B is)
    (_, _), jg = jax.value_and_grad(jts.loss_fn, has_aux=True)(
        jparams, _jnp(batch), jcfg, None, True, 1, freeze_vision, False)
    tg, _, _, folded = tts._backward(params, tloss.to_device(batch, "cpu"), cfg, True, 1,
                                     freeze_vision, False, fold=ttx.frozen)
    jg = _named(jg)
    assert set(tg) == {n for n in before if ".lora." in n}
    for n, g in tg.items():
        if n.endswith(".b"):
            np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)
        else:
            assert not g.any() and not jg[n].any(), n
    frozen_sq = sum(float(np.square(jg[n].numpy().astype(np.float64)).sum()) for n in ttx.frozen
                    if n in jg)
    np.testing.assert_allclose(folded.item(), frozen_sq, rtol=1e-5)

    jstep = jts.make_train_step(jcfg, jtx, None, remat=True, vision_chunk=1, **flags)
    tstep = tts.make_train_step(cfg, ttx, None, remat=True, vision_chunk=1, **flags)
    jstate = jts.init_train_state(jparams, jtx)
    tstate = tts.init_train_state(params, ttx)
    assert set(tstate.opt_state.mu) == set(tg)  # no moments for mask-frozen leaves
    tbatch = tloss.to_device(batch, "cpu")
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, _jnp(batch))
        tstate, tm = tstep(tstate, tbatch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        losses.append(tm["loss"].item())
    assert losses[-1] < losses[0], losses
    want = _named(jstate.params)
    for n, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
        if ".lora." in n:
            assert not torch.equal(p.detach(), before[n]), f"{n} did not move"
        else:
            assert torch.equal(p.detach(), before[n]), f"{n} is frozen but moved"
    assert set(tstate.opt_state.mu) == set(tg)


def test_merge_lora_matches_jax():
    jparams, jcfg, params, cfg = _adapted()
    want = long_vita_params_from_jax(jlora.merge_lora(jparams, jcfg.text), device="cpu")
    merged = tlora.merge_lora(params, cfg.text)
    assert tlora.lora_subtree(merged) == {} and len(tlora.lora_subtree(params)) == 7
    for (n, g), (m, w) in zip(merged.named_parameters(), want.named_parameters()):
        assert n == m
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    assert merged.text.embed.data_ptr() == params.text.embed.data_ptr()  # shared, not copied
    batch = tloss.to_device(_batch(), "cpu")
    with torch.no_grad():
        adapted = _logits(tlv.long_vita_forward, params, batch, cfg)
        folded = _logits(tlv.long_vita_forward, merged, batch, cfg)
    torch.testing.assert_close(folded, adapted, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_loads_the_others_lora_files(tmp_path, writer):
    targets = ("k_proj", "up_proj")
    jparams, jcfg, params, cfg = _adapted(targets)
    lcfg = dict(targets=targets, **LCFG)
    if writer == "port":
        tlora.save_lora(str(tmp_path), params, cfg.text, tlora.LoraConfig(**lcfg))
        loaded, loaded_cfg = jlora.load_lora(str(tmp_path), _jax_params(0), jax_tiny().text)
        got = {t: {k: np.asarray(v) for k, v in ab.items()} for t, ab in
               jlora.lora_subtree(loaded).items()}
    else:
        jlora.save_lora(str(tmp_path), jparams, jcfg.text, jlora.LoraConfig(**lcfg))
        fresh = long_vita_params_from_jax(_jax_params(0), device="cpu")
        loaded, loaded_cfg = tlora.load_lora(str(tmp_path), fresh, tiny_test_config().text)
        got = {t: {k: v.numpy() for k, v in ab.items()} for t, ab in
               tlora.lora_subtree(loaded).items()}
    want = jlora.lora_subtree(jparams)
    assert set(got) == set(targets) and (loaded_cfg.lora_r, loaded_cfg.lora_alpha) == (R, ALPHA)
    for t in targets:
        for k in ("a", "b"):
            np.testing.assert_array_equal(got[t][k], np.asarray(want[t][k]), err_msg=f"{t}.{k}")


@pytest.mark.parametrize("weights", ["bfloat16", "int4"])
def test_engine_with_adapters_gives_the_jax_tokens(weights):
    """bf16: the tiny decoder in bf16 with f32 adapters, a bf16 cache;
    int4: the 128-group geometry, every projection int4 with its adapter
    riding along (K6's plain version in the port)."""
    cfg = tiny_test_config() if weights == "bfloat16" else g128_config()
    p = jax_params(cfg, seed=0)
    targets = ("q_proj", "v_proj", "o_proj", "gate_proj", "down_proj")
    p, jtext = jlora.add_lora_params({"text": p}, cfg.text, jlora.LoraConfig(targets=targets, **LCFG),
                                     jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    for t in targets:
        b = p["text"]["layers"][t]["lora"]["b"]
        p["text"]["layers"][t]["lora"]["b"] = jnp.asarray(0.2 * rng.standard_normal(b.shape),
                                                          jnp.float32)
    p = jax.tree.map(np.asarray, p["text"])
    tcfg = dataclasses.replace(cfg, text=jtext)
    if weights == "bfloat16":  # weights and adapters in bf16, a bf16 cache
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
        tp = params_from_jax(p, device="cpu", dtype=torch.bfloat16)
        kw = dict(max_seq_len=512, chunk=64, decode_segment=8)
        jax_eng = JaxEngine({"text": jp}, tcfg, _MM(), cache_dtype=jnp.bfloat16, **kw)
    else:
        tp = params_from_jax(p, device="cpu")
        kw = dict(max_seq_len=512, chunk=64, decode_segment=8, weight_quant="int4")
        jax_eng = JaxEngine({"text": p}, tcfg, _MM(), cache_dtype=jnp.float32, **kw)
    cache = torch.bfloat16 if weights == "bfloat16" else torch.float32
    port = InferenceEngine(tp, tcfg, _MM(), cache_dtype=cache, **kw)
    if weights == "int4":
        assert isinstance(port.text.layers[0].q_proj, tq.QuantDense4)
        assert port.text.layers[0].q_proj.lora is not None
    prompt = rng.integers(0, cfg.text.vocab_size, 100).tolist()
    sp = dict(max_new_tokens=12, return_logprobs=True)
    want = jax_eng.generate(input_ids=prompt, sampling=JaxSP(**sp))
    got = port.generate(input_ids=prompt, sampling=SamplingParams(**sp))
    assert got.token_ids == want.token_ids
    assert len(set(got.token_ids)) > 3, got.token_ids
    if weights == "int4":
        np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=0, atol=1e-4)
    plain = InferenceEngine(tp, cfg, _MM(), cache_dtype=cache, **kw)  # lora_r 0: adapters off
    assert plain.generate(input_ids=prompt, sampling=SamplingParams(**sp)).token_ids != got.token_ids
