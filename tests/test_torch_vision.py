"""PyTorch port: the vision side (models/intern_vit.py, projector.py,
long_vita.py) and utils/convert.long_vita_params_from_jax, against the JAX
package at tiny_test_config() sizes on the CPU in f32.

Weights come from the JAX initializer with norms, biases and layer scales
randomised in numpy (the initializer leaves them at 1, 0 and 1, which would
let a bias, norm or layer-scale bug pass) and cross to the port through the
converter. Tolerances: 1e-5 on single ops (f32, summation order only), 1e-4
on the tower, the encode and the VLM forward (a few layers of f32 GEMMs in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.models import intern_vit as jvit
from long_vita_tpu.models import long_vita as jlv
from long_vita_tpu.models import projector as jproj
from long_vita_tpu_torch.models import intern_vit as tvit
from long_vita_tpu_torch.models import long_vita as tlv
from long_vita_tpu_torch.models import projector as tproj
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax

OP = dict(rtol=1e-5, atol=1e-5)
DEEP = dict(rtol=0, atol=1e-4)


def _jax_params(cfg, seed=0, dtype=jnp.float32):
    p = jlv.init_long_vita_params(jax.random.PRNGKey(seed), cfg, dtype)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name or "ls1" in name or "ls2" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(jnp.asarray, jax.tree_util.tree_map_with_path(fill, p))


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    p = _jax_params(cfg)
    return cfg, p, long_vita_params_from_jax(p, device="cpu")


def _pixels(seed, n, cfg):
    s = cfg.vision.image_size
    return np.random.default_rng(seed).standard_normal((n, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_applies_scale_before_the_cast(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 32)) * 3 + 1).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(32)).astype(np.float32)
    want = jvit.layer_norm(*(jnp.asarray(a, dtype) for a in (x, w, bias)), 1e-6)
    dt = getattr(torch, dtype)
    got = tvit.layer_norm(*(torch.as_tensor(a).to(dt) for a in (x, w, bias)), 1e-6)
    assert got.dtype == dt
    # bf16: both round the same f32 result once
    tol = OP if dtype == "float32" else dict(rtol=2.0**-7, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_patch_embed_and_embeddings(model):
    cfg, p, tp = model
    px = _pixels(2, 3, cfg)
    want, grid = jvit.patch_embed(p["vision"]["embeddings"]["patch_embed"], jnp.asarray(px), cfg.vision)
    got, tgrid = tvit.patch_embed(tp.vision.embeddings.patch_embed, torch.as_tensor(px), cfg.vision)
    assert tuple(tgrid) == tuple(grid) == (cfg.vision.grid,) * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP)
    want = jvit.vit_embeddings(p["vision"]["embeddings"], jnp.asarray(px), cfg.vision)
    got = tvit.vit_embeddings(tp.vision.embeddings, torch.as_tensor(px), cfg.vision)
    assert got.shape == (3, cfg.vision.seq_len, cfg.vision.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP)


def test_pos_embed_resize_is_not_ported(model):
    """(Named when the resize raised.) Serving tiles have the configured
    grid, where the embedding is returned as it is; another grid is now
    resized as JAX's jax.image.resize(cubic) does (tests/
    test_torch_pos_embed.py holds the resize itself)."""
    cfg, p, tp = model
    pos = tp.vision.embeddings.pos_embed[1:]
    assert tvit._interp_pos_embed(pos, cfg.vision.grid, (cfg.vision.grid,) * 2) is pos
    px = np.random.default_rng(6).standard_normal((1, 42, 42, 3)).astype(np.float32)
    want = jvit.vit_embeddings(p["vision"]["embeddings"], jnp.asarray(px), cfg.vision)
    got = tvit.vit_embeddings(tp.vision.embeddings, torch.from_numpy(px), cfg.vision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP)


def test_vit_layer_matches(model):
    cfg, p, tp = model
    x = np.random.default_rng(3).standard_normal((2, cfg.vision.seq_len, 32)).astype(np.float32)
    layer0 = jax.tree.map(lambda a: a[0], p["vision"]["layers"])
    want = jvit.vit_layer(layer0, jnp.asarray(x), cfg.vision, "xla")
    got = tvit.vit_layer(tp.vision.layers[0], torch.as_tensor(x), cfg.vision, "xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP)


def test_intern_vit_matches(model):
    cfg, p, tp = model
    px = _pixels(4, 3, cfg)
    want = jvit.intern_vit(p["vision"], jnp.asarray(px), cfg.vision)
    got = tvit.intern_vit(tp.vision, torch.as_tensor(px), cfg.vision, attn_impl="short")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEEP)


def test_pixel_shuffle_channel_order():
    x = np.arange(2 * 4 * 4 * 6, dtype=np.float32).reshape(2, 4, 4, 6)
    want = np.asarray(jproj.pixel_shuffle(jnp.asarray(x), 0.5))
    got = tproj.pixel_shuffle(torch.as_tensor(x), 0.5).numpy()
    assert got.shape == (2, 2, 2, 24)
    np.testing.assert_array_equal(got, want)  # a permutation: exact


def test_project_features_matches(model):
    cfg, p, tp = model
    n, grid = 3, cfg.vision.grid
    feats = np.random.default_rng(5).standard_normal((n, grid * grid, 32)).astype(np.float32)
    want = jproj.project_features(p["projector"], jnp.asarray(feats), cfg)
    got = tproj.project_features(tp.projector, torch.as_tensor(feats), cfg)
    assert got.shape == (n, cfg.image_token_length, cfg.text.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP)


def test_encode_images_chunked_equals_one_shot(model):
    """5 tiles in batches of 2 (a last partial batch) equal one batch of 5
    and the JAX encode, which pads the last batch with zero tiles."""
    cfg, p, tp = model
    px = _pixels(6, 5, cfg)
    want = jlv.encode_images(p, jnp.asarray(px), cfg, chunk=2, attn_impl="short")
    one = tlv.encode_images(tp, torch.as_tensor(px), cfg)
    got = tlv.encode_images(tp, torch.as_tensor(px), cfg, chunk=2, attn_impl="short")
    assert got.shape == (5, cfg.image_token_length, cfg.text.hidden_size)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEEP)


def test_merge_image_embeddings(model):
    cfg, _, _ = model
    rng = np.random.default_rng(7)
    embeds = rng.standard_normal((2, 20, 8)).astype(np.float32)
    img = rng.standard_normal((3, 4, 8)).astype(np.float32)
    idx = np.stack([
        np.asarray([[0] * 4, [1] * 4, [1] * 4]),
        np.asarray([[2, 3, 4, 5], [0, 1, 2, 3], [16, 17, 18, 19]]),
    ])
    want = jlv.merge_image_embeddings(jnp.asarray(embeds), jnp.asarray(img), jnp.asarray(idx))
    got = tlv.merge_image_embeddings(torch.as_tensor(embeds), torch.as_tensor(img), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # rows past the sequence are dropped; the input is not written
    idx[1, 2] = [18, 19, 20, 21]
    before = embeds.copy()
    out = tlv.merge_image_embeddings(torch.as_tensor(embeds), torch.as_tensor(img), torch.as_tensor(idx))
    np.testing.assert_array_equal(out[1, 18:].numpy(), img[2, :2])
    np.testing.assert_array_equal(embeds, before)


def test_long_vita_forward_matches(model):
    """Two rows with tiles scattered into each; full logits, then the
    logits-masked head and head=False at chosen rows."""
    cfg, p, tp = model
    rng = np.random.default_rng(8)
    b, s, t = 2, 30, cfg.image_token_length
    ids = rng.integers(0, cfg.text.vocab_size, size=(b, s))
    px = _pixels(9, 3, cfg)
    idx = np.stack([
        np.asarray([[0] * t, [1] * t, [1] * t]),
        np.stack([3 + np.arange(t), 5 + np.arange(t), 20 + np.arange(t)]),
    ])
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    lp = np.asarray([[29, 7], [4, 22]])
    jkw = dict(images=jnp.asarray(px), image_indices=jnp.asarray(idx), vision_chunk=2)
    tkw = dict(images=torch.as_tensor(px), image_indices=torch.as_tensor(idx), vision_chunk=2)
    want, _ = jlv.long_vita_forward(p, jnp.asarray(ids), jnp.asarray(pos), cfg, **jkw)
    got, cache = tlv.long_vita_forward(tp, torch.as_tensor(ids), torch.as_tensor(pos), cfg, **tkw)
    assert cache is None and got.shape == (b, s, cfg.text.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEEP)
    want, _ = jlv.long_vita_forward(
        p, jnp.asarray(ids), jnp.asarray(pos), cfg, logit_positions=jnp.asarray(lp), **jkw
    )
    got, _ = tlv.long_vita_forward(
        tp, torch.as_tensor(ids), torch.as_tensor(pos), cfg,
        logit_positions=torch.as_tensor(lp), **tkw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEEP)
    hid, _ = tlv.long_vita_forward(
        tp, torch.as_tensor(ids), torch.as_tensor(pos), cfg,
        logit_positions=torch.as_tensor(lp), head=False, **tkw,
    )
    assert hid.shape == (b, 2, cfg.text.hidden_size)


def test_converter_layout_and_bf16_bits():
    cfg = tiny_test_config()
    p = _jax_params(cfg, seed=1, dtype=jnp.bfloat16)
    tp = long_vita_params_from_jax(p, device="cpu")
    assert len(tp.vision.layers) == cfg.vision.num_hidden_layers

    def bits(t):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)

    jl = p["vision"]["layers"]
    np.testing.assert_array_equal(
        bits(tp.vision.layers[1].qkv.weight), np.asarray(jl["qkv"]["kernel"][1]).T.view(np.uint16)
    )
    np.testing.assert_array_equal(
        bits(tp.vision.layers[0].ls2), np.asarray(jl["ls2"][0]).view(np.uint16)
    )
    np.testing.assert_array_equal(
        bits(tp.vision.embeddings.patch_embed.weight),
        np.asarray(p["vision"]["embeddings"]["patch_embed"]["kernel"]).T.view(np.uint16),
    )
    np.testing.assert_array_equal(
        bits(tp.projector.fc2.weight), np.asarray(p["projector"]["fc2"]["kernel"]).T.view(np.uint16)
    )
    assert tp.projector.fc1.bias is None and tp.text.embed.dtype == torch.bfloat16


def test_init_long_vita_params_is_seeded():
    cfg = tiny_test_config()
    a = tlv.init_long_vita_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    b = tlv.init_long_vita_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not any(x.requires_grad for x in a.parameters())
    h, v = cfg.vision.hidden_size, cfg.vision
    assert a.vision.layers[0].qkv.weight.shape == (3 * h, h)
    assert a.vision.embeddings.patch_embed.weight.shape == (h, v.patch_size**2 * 3)
    assert a.vision.embeddings.pos_embed.shape == (v.num_patches + 1, h)
    assert a.projector.fc1.weight.shape == (h, 4 * h)
    assert a.projector.fc2.weight.shape == (cfg.text.hidden_size, h)
    assert torch.all(a.vision.layers[1].ls1 == v.initializer_factor)
