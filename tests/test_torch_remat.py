"""PyTorch port: the selective remat levels against the JAX package, on the
tiny VLM in f32 on the CPU.

  - a train step under remat "dots", "flash" and "vit" (trainable tower,
    one tile a chunk, so the chunk-level tower checkpoint runs) matches the
    JAX step under the same level over 3 steps: loss and grad_norm to 1e-5
    relative and the parameters to 1e-5, test_torch_training.py's
    tolerances;
  - the flash forward (lvt::flash_fwd, its plain version on the CPU, with
    attn_impl="flash") runs once per layer per step under "flash" and
    without remat, twice under True, with the same loss and gradients;
  - under "dots" no projection's product runs again: the aten.mm count of
    a forward and backward equals the count without remat, and True adds
    the decoder's forward products that the backward needs;
  - check_remat takes True, "full", "dots", "flash", "vit", False and None
    and refuses anything else.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from long_vita_tpu.training import optimizer as jopt
from long_vita_tpu.training import train_step as jts
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.ops import flash_attention as fa
from long_vita_tpu_torch.training import loss as tloss
from long_vita_tpu_torch.training import optimizer as topt
from long_vita_tpu_torch.training import train_step as tts
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_training import _batch, _jax_params, _jnp, _named

CFG = tiny_test_config()
# (step flags, optimizer): the decoder trains under "dots" and "flash"; the
# tower under "vit", with test_torch_training.py's tower_trainable optimizer
LEVELS = {
    "dots": (dict(freeze_vision=True, freeze_text=False), dict(lr=1e-3, weight_decay=0.01)),
    "flash": (dict(freeze_vision=True, freeze_text=False), dict(lr=1e-3, weight_decay=0.01)),
    "vit": (dict(freeze_vision=False, freeze_text=True), dict(lr=1e-3, vit_lr_mult=0.1)),
}


@pytest.mark.parametrize("level", list(LEVELS))
def test_train_step_under_the_level_matches_jax(level):
    flags, optim = LEVELS[level]
    ocfg = dict(optim, **flags)
    batch = _batch()
    jparams = _jax_params(0)
    params = long_vita_params_from_jax(jparams, device="cpu")
    jtx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**ocfg), 2)
    ttx = topt.make_optimizer(params, topt.OptimizerConfig(**ocfg), 2)
    jstep = jts.make_train_step(CFG, jtx, None, remat=level, vision_chunk=1, **flags)
    tstep = tts.make_train_step(CFG, ttx, None, remat=level, vision_chunk=1, **flags)
    jstate = jts.init_train_state(jparams, jtx)
    tstate = tts.init_train_state(params, ttx)
    tbatch = tloss.to_device(batch, "cpu")
    assert tbatch["images"].shape[0] == 2  # two chunks of one tile under "vit"
    for _ in range(3):
        jstate, jm = jstep(jstate, _jnp(batch))
        tstate, tm = tstep(tstate, tbatch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    want = _named(jstate.params)
    for n, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def _grads(params, batch, remat, attn_impl="auto"):
    grads, loss, _, _ = tts._backward(params, batch, CFG, remat, 1, True, False,
                                      attn_impl=attn_impl)
    return loss, grads


def test_flash_forward_runs_once_per_layer_under_flash(monkeypatch):
    params = long_vita_params_from_jax(_jax_params(0), device="cpu")
    batch = tloss.to_device(_batch(), "cpu")
    calls = []
    plain = fa.flash_attention_reference

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    runs, results = {}, {}
    for level in (True, "flash", False):
        calls.clear()
        results[level] = _grads(params, batch, level, attn_impl="flash")
        runs[level] = len(calls)
    layers = CFG.text.num_hidden_layers
    assert runs == {True: 2 * layers, "flash": layers, False: layers}, runs
    loss, grads = results[True]
    for level in ("flash", False):
        assert torch.equal(results[level][0], loss)
        for n, g in grads.items():
            torch.testing.assert_close(results[level][1][n], g, rtol=1e-6, atol=1e-7, msg=n)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_recomputes_no_projection():
    params = long_vita_params_from_jax(_jax_params(0), device="cpu")
    batch = tloss.to_device(_batch(), "cpu")
    counts, results = {}, {}
    for level in (False, "dots", True):
        with _CountMM() as mode:
            results[level] = _grads(params, batch, level)
        counts[level] = mode.n
    assert counts["dots"] == counts[False], counts
    # True runs each decoder layer's products again but down_proj's, whose
    # output the backward does not need (the recompute stops once it has
    # what the backward needs)
    assert counts[True] == counts[False] + 6 * CFG.text.num_hidden_layers, counts
    loss, grads = results[False]
    for level in ("dots", True):
        assert torch.equal(results[level][0], loss)
        for n, g in grads.items():
            torch.testing.assert_close(results[level][1][n], g, rtol=1e-6, atol=1e-7, msg=n)


def test_check_remat_levels():
    for level in (True, "full", "dots", "flash", "vit"):
        assert tq.check_remat(level) is True
    for level in (False, None):
        assert tq.check_remat(level) is False
    for bad in ("selective", 1, "Flash"):
        with pytest.raises(ValueError, match="remat level"):
            tq.check_remat(bad)
    assert tq.remat_ops(True) is None and tq.remat_ops("vit") is None
    assert tq.remat_ops("flash") == [torch.ops.lvt.flash_fwd.default]
