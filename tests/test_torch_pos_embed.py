"""PyTorch port: the InternViT position-embedding resize against the JAX
package's.

models/intern_vit._interp_pos_embed resamples the learned 32 x 32 patch
embedding to another patch grid as the JAX package does with
jax.image.resize(method="cubic") (Keys' cubic, a = -0.5, half-pixel
centres, antialiased when shrinking, taps past the edge dropped and each
sample's weights renormalised), as one separable f32 weight matrix per axis.
Grids 32 -> (16, 16), (24, 40), (48, 48), (33, 31) and one axis kept, at
1e-5 (f32 products summed in another order); the weights against
jax.image.scale_and_translate's own; a tiny InternViT at tiles of another
size than its image_size against JAX (1e-4, the tower's tolerance in
tests/test_torch_vision.py). F.interpolate(mode="bicubic") is shown to be
another function.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.models import intern_vit as jvit
from long_vita_tpu_torch.models import intern_vit as tvit
from long_vita_tpu_torch.utils.convert import vision_params_from_jax
from test_torch_vision import _jax_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _pos(src=32, h=48, seed=0):
    return np.random.default_rng(seed).standard_normal((src * src, h)).astype(np.float32)


@pytest.mark.parametrize("dst", [(16, 16), (24, 40), (48, 48), (33, 31), (32, 20), (7, 32)])
def test_resize_matches_jax_image_resize(dst):
    pos = _pos()
    want = np.asarray(jvit._interp_pos_embed(jnp.asarray(pos), 32, dst))
    got = tvit._interp_pos_embed(torch.from_numpy(pos), 32, dst)
    assert got.shape == (dst[0] * dst[1], 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_resize_keeps_the_dtype_and_computes_in_f32():
    pos = _pos(seed=1)
    want = np.asarray(jvit._interp_pos_embed(jnp.asarray(pos, jnp.bfloat16), 32, (24, 24)))
    got = tvit._interp_pos_embed(torch.from_numpy(pos).to(torch.bfloat16), 32, (24, 24))
    assert got.dtype == torch.bfloat16
    # the same f32 values rounded once to bf16: at most a bf16 step apart
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=0,
                               atol=np.abs(want.astype(np.float32)).max() * 2**-7)


@pytest.mark.parametrize("n_in,n_out", [(32, 16), (32, 48), (32, 33), (32, 7), (5, 3)])
def test_weights_equal_jax_scale_and_translate(n_in, n_out):
    from jax._src.image.scale import _kernels, ResizeMethod, compute_weight_mat

    want = compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _kernels[ResizeMethod.CUBIC], True)
    got = tvit.cubic_resize_weights(n_in, n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got.sum(0), torch.ones(n_out), rtol=0, atol=1e-6)


def test_resize_is_not_torch_bicubic():
    pos = torch.from_numpy(_pos(seed=2))
    ours = tvit._interp_pos_embed(pos, 32, (16, 16))
    grid = pos.reshape(1, 32, 32, 48).permute(0, 3, 1, 2)
    theirs = F.interpolate(grid, size=(16, 16), mode="bicubic", align_corners=False)
    theirs = theirs.permute(0, 2, 3, 1).reshape(256, 48)
    assert (ours - theirs).abs().max() > 0.1


@pytest.mark.parametrize("size", [42, 70])
def test_tower_at_another_tile_size_matches_jax(size):
    """The tiny tower (image_size 56, a 4 x 4 grid) on tiles of 42 and 70
    pixels: grids 3 x 3 and 5 x 5."""
    cfg = tiny_test_config()
    p = _jax_params(cfg)
    tp = vision_params_from_jax(p["vision"], device="cpu")
    px = np.random.default_rng(3).standard_normal((2, size, size, 3)).astype(np.float32)
    want = jvit.intern_vit(p["vision"], jnp.asarray(px), cfg.vision, attn_impl="xla")
    got = tvit.intern_vit(tp, torch.from_numpy(px), cfg.vision)
    g = size // cfg.vision.patch_size
    assert got.shape == (2, 1 + g * g, cfg.vision.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
