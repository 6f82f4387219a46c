"""PyTorch port: the generic vision towers (CLIP, SigLIP, EVA) and the ragged
head dims they bring to the flash kernels.

  - models/generic_vit.py against the JAX package's at tiny geometries (f32
    on the CPU, the JAX tree converted by utils/convert.generic_vit_from_jax,
    norms and biases randomised so that every switch shows): each switch
    (CLS token, layer scale, pre and final LN, EVA's post-norm, the three
    activations) and a trainable tower's gradients under remat; outputs to
    1e-5, gradients to 1e-4 relative + 1e-5 x the tensor's largest gradient
    absolute (f32 sums in another order, at the scale of the sums);
  - the presets' fields equal JAX's;
  - a head dim that is not a multiple of 64 (SigLIP's 72, EVA's 112): the
    flash wrapper pads it to 128 with the true dim's scale, and its output
    and gradients equal the plain attention at the unpadded dim (1e-5 on
    the CPU); the ``cuda`` cases hold K1, K4 and K5 at those dims to the
    plain attention on the card (the bf16 tolerances of
    tests/test_torch_flash_cuda.py).

JAX is imported inside a fixture, so the ``cuda`` cases also run on the
card's machine, which has no JAX:

    python -m pytest tests/test_torch_generic_vit.py --noconftest -q -m cuda
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from long_vita_tpu_torch.models import generic_vit as tgv
from long_vita_tpu_torch.ops import flash_attention as tfa
from long_vita_tpu_torch.utils.convert import generic_vit_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)

SWITCHES = {
    "clip": dict(add_class_token=True, pre_layernorm=True, hidden_act="quick_gelu",
                 layer_norm_eps=1e-5),
    "siglip": dict(add_class_token=False, final_layernorm=True, hidden_act="gelu_tanh"),
    "eva": dict(add_class_token=True, post_norm=True),
    "layer_scale": dict(add_class_token=True, use_layer_scale=True),
    "everything": dict(add_class_token=True, use_layer_scale=True, pre_layernorm=True,
                       final_layernorm=True, post_norm=True, hidden_act="quick_gelu"),
}


@pytest.fixture(scope="module")
def jgv():
    pytest.importorskip("jax")
    from long_vita_tpu.models import generic_vit

    return generic_vit


def _cfg(**kw):
    return tgv.GenericViTConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, image_size=56, patch_size=14, **kw)


def _jax_tree(jgv, cfg, seed=0):
    import jax

    tree = jgv.init_generic_vit_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name or "ls1" in name or "ls2" in name:
            return (1.0 + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 5

    return jax.tree_util.tree_map_with_path(fill, tree)


def _pixels(n=2, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 56, 56, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(SWITCHES))
def test_tower_matches_jax(jgv, name):
    import jax.numpy as jnp

    cfg = _cfg(**SWITCHES[name])
    jcfg = jgv.GenericViTConfig(**dataclasses.asdict(cfg))
    tree = _jax_tree(jgv, jcfg)
    want = np.asarray(jgv.generic_vit(tree, jnp.asarray(_pixels()), jcfg))
    params = generic_vit_from_jax(tree, cfg, device="cpu")
    got = tgv.generic_vit(params, torch.from_numpy(_pixels()), cfg)
    assert got.shape == (2, cfg.seq_len, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["siglip", "eva"])
def test_trainable_tower_gradients_match_jax(jgv, name):
    """d sum(out * g) / d params under remat, as a trainable tower's."""
    import jax
    import jax.numpy as jnp

    cfg = _cfg(**SWITCHES[name])
    jcfg = jgv.GenericViTConfig(**dataclasses.asdict(cfg))
    tree = _jax_tree(jgv, jcfg, seed=2)
    g = np.random.default_rng(3).standard_normal((2, cfg.seq_len, 32)).astype(np.float32)
    jgrad = jax.grad(lambda p: jnp.sum(
        jgv.generic_vit(p, jnp.asarray(_pixels()), jcfg, remat=True) * g))(tree)
    params = generic_vit_from_jax(tree, cfg, device="cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    out = tgv.generic_vit(params, torch.from_numpy(_pixels()), cfg, remat=True)
    (out * torch.from_numpy(g)).sum().backward()
    want = {n: p for n, p in generic_vit_from_jax(jgrad, cfg, device="cpu").named_parameters()}
    for n, p in params.named_parameters():
        w = want[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=n)


def test_presets_match_jax(jgv):
    for name in ("clip_vit_300m", "siglip_so400m", "eva_4b"):
        got, want = getattr(tgv, name)(), getattr(jgv, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert (got.seq_len, got.head_dim) == (want.seq_len, want.head_dim)
    assert tgv.clip_vit_300m().head_dim == 64 and tgv.clip_vit_300m().seq_len == 1025
    assert tgv.siglip_so400m().head_dim == 72 and tgv.siglip_so400m().seq_len == 729
    assert tgv.eva_4b().head_dim == 112 and tgv.eva_4b().num_hidden_layers == 63


def test_init_is_seeded_and_shaped():
    cfg = _cfg(**SWITCHES["everything"])
    a = tgv.init_generic_vit_params(torch.Generator().manual_seed(0), cfg)
    b = tgv.init_generic_vit_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert a.pos_embed.shape == (cfg.seq_len, 32) and a.cls_token.shape == (1, 1, 32)
    assert a.layers[1].qkv.weight.shape == (96, 32) and torch.all(a.layers[0].ls2 == 1)
    assert a.pre_norm is not None and a.final_norm is not None
    siglip = tgv.init_generic_vit_params(torch.Generator(), _cfg(**SWITCHES["siglip"]))
    assert siglip.cls_token is None and siglip.pre_norm is None and siglip.layers[0].ls1 is None


# ---------------------------------------------------------------------------
# ragged head dims: the flash wrapper pads D to 128
# ---------------------------------------------------------------------------


def _qkv(shape_q, hkv, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    b, s, hq, d = shape_q
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                 for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))


def _plain_with_grads(q, k, v, do, causal):
    """The plain attention at the true head dim, differentiated by autograd."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o, _ = tfa.flash_attention_reference(*leaves, causal=causal)
    return (o, *torch.autograd.grad(o, leaves, do))


@pytest.mark.parametrize("d", [72, 112])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_head_dim_pads_to_the_plain_attention(d, causal):
    q, k, v, do = _qkv((2, 100, 4, d), 2)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = tfa.flash_attention(*leaves, causal=causal, return_lse=True)
    assert o.shape == q.shape
    grads = torch.autograd.grad(o, leaves, do)
    want = _plain_with_grads(q, k, v, do, causal)
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, **TOL, msg=name)
    _, rlse = tfa.flash_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(lse, rlse, **TOL)
    assert tfa.pad_head_dim(q).shape[-1] == 128


def test_ragged_head_dim_tower_runs_through_auto_attention():
    """A tower with 2 heads of 24 (a ragged D) through dot_product_attention
    "auto" and through "xla" gives the same features on the CPU."""
    cfg = dataclasses.replace(_cfg(**SWITCHES["siglip"]), hidden_size=48, intermediate_size=96)
    params = tgv.init_generic_vit_params(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_pixels())
    torch.testing.assert_close(tgv.generic_vit(params, x, cfg),
                               tgv.generic_vit(params, x, cfg, attn_impl="xla"), **TOL)


# ---------------------------------------------------------------------------
# K1, K4 and K5 at the padded head dims, on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [72, 112])
@pytest.mark.parametrize("fused", [True, False], ids=["K4", "K5"])
def test_kernels_at_a_ragged_head_dim(cuda_dev, d, fused):
    """SigLIP's [N, 729, 16, 72] and EVA's D 112, cut to 2 tiles: K1 through
    the padding wrapper, then K4 or K5 on the padded operands with the true
    dim's scale, against the plain attention at the true dim."""
    q, k, v, do = _qkv((2, 729, 16, d), 16, torch.bfloat16, cuda_dev)
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_attention(q, k, v, causal=False, return_lse=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    ro, rlse = tfa.flash_attention_reference(q, k, v, causal=False)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    pad = tfa.pad_head_dim
    o_pad = pad(o)
    dq, dk, dv = tfa._flash_bwd_cuda(pad(q), pad(k), pad(v), o_pad, lse, pad(do), False, 0, 0,
                                     729, None, None, fused, scale=1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert not g[..., d:].float().any(), f"{name}: the padded columns must stay zero"
        w = w.float()
        tol = 1e-2 * w.abs().max().item()
        torch.testing.assert_close(g[..., :d].float(), w, atol=tol, rtol=1e-2, msg=name)


@pytest.mark.cuda
def test_ragged_head_dim_autograd_on_the_card(cuda_dev):
    """flash_attention's own backward at D 72 (K4 or K5 by JAX's rule) gives
    gradients at the true dim."""
    q, k, v, do = _qkv((1, 300, 4, 72), 4, torch.bfloat16, cuda_dev, seed=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    _, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    want = tfa.flash_attention_bwd_reference(q, k, v, o.detach(), lse, do, causal=True)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        w = w.float()
        torch.testing.assert_close(g.float(), w, atol=1e-2 * w.abs().max().item(), rtol=1e-2)
