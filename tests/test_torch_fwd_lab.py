"""PyTorch port: the forward-kernel lab (K7) against the JAX package's lab.

The JAX lab's `variant_flash` (benchmarks/fwd_kernel_lab.py, the Pallas
`_variant_kernel`) runs here in interpret mode, loaded by its file path; the
port's `variant_flash` takes its plain version on CPU tensors. The same
numpy inputs (f32, S 256, head-major) go through both; every switch
combination at two block shapes, then the GQA groups 4/2 and 8/2 at D 64 and
128. Tolerance 1e-5 (f32: the Pallas kernel's online softmax against the
plain one-pass softmax, summation order and exp only).

The `cuda` cases hold K7 itself to its plain version on the card (bf16: 1e-2
abs + 1e-2 rel on o, as every bf16 forward kernel; 1e-3 on the lse). JAX is
imported inside the fixture that loads its lab, so that the file also runs
on the card's machine, which has no JAX:

    python -m pytest tests/test_torch_fwd_lab.py --noconftest -q -m cuda
"""
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from long_vita_tpu_torch.benchmarks import fwd_kernel_lab as lab

TOL = 1e-5
SWITCHES = list(itertools.product((False, True), repeat=3))  # fastpath, cheap_mask, wide_ml


@pytest.fixture(scope="module")
def jlab():
    pytest.importorskip("jax")
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "fwd_kernel_lab.py"
    spec = importlib.util.spec_from_file_location("jax_fwd_kernel_lab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((1, hq, s, d), (1, hkv, s, d), (1, hkv, s, d)))


def _jax_variant(jlab, q, k, v, **kw):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        o = jlab.variant_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        return np.asarray(jax.block_until_ready(o))


def _check(jlab, hq, hkv, d, block_q, block_kv, fastpath, cheap_mask, wide_ml):
    q, k, v = _inputs(hq, hkv, 256, d)
    want = _jax_variant(jlab, q, k, v, block_q=block_q, block_kv=block_kv,
                        cheap_mask=cheap_mask, fastpath=fastpath, wide_ml=wide_ml)
    got = lab.variant_flash(*(torch.from_numpy(x) for x in (q, k, v)), block_kv=block_kv,
                            cheap_mask=cheap_mask, fastpath=fastpath, wide_ml=wide_ml)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("block_q,block_kv", [(128, 128), (128, 64)])
@pytest.mark.parametrize("fastpath,cheap_mask,wide_ml", SWITCHES)
def test_every_switch_matches_jax(jlab, block_q, block_kv, fastpath, cheap_mask, wide_ml):
    _check(jlab, 8, 2, 128, block_q, block_kv, fastpath, cheap_mask, wide_ml)


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (8, 2, 64), (4, 2, 128)])
def test_gqa_and_head_dims_match_jax(jlab, hq, hkv, d):
    _check(jlab, hq, hkv, d, 128, 128, True, True, False)


def test_reference_lse_is_the_softmax_normaliser():
    """lse = log sum exp of the scaled, causally masked logits, row by row."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 2, 96, 64, seed=1))
    _, lse = lab.variant_flash(q, k, v, return_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, 1)) / 8.0
    s = s.masked_fill(~torch.ones(96, 96, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=TOL, rtol=TOL)


def test_variants_cover_every_switch_at_both_kv_tiles():
    names = {lab.variant_name(kw) for kw in lab.variants()}
    assert len(names) == 16 and "K7 bk128 base" in names
    assert "K7 bk64 fastpath+cheap_mask+wide_ml" in names


# ---------------------------------------------------------------------------
# K7 on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _card_check(gen, shape_q, hkv, **kw):
    b, hq, s, d = shape_q
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    before = lab.variant_flash.launches
    o, lse = lab.variant_flash(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert lab.variant_flash.launches == before + 1
    ro, rlse = lab.variant_flash_reference(q, k, v)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("block_kv", [128, 64])
@pytest.mark.parametrize("fastpath,cheap_mask,wide_ml", SWITCHES)
def test_kernel_d128_matches_plain(gen, block_kv, fastpath, cheap_mask, wide_ml):
    """Two batch rows, GQA 8/2, a ragged 700 rows (a partial q block and kv
    tile)."""
    _card_check(gen, (2, 8, 700, 128), 2, block_kv=block_kv, fastpath=fastpath,
                cheap_mask=cheap_mask, wide_ml=wide_ml)


@pytest.mark.cuda
@pytest.mark.parametrize("fastpath,cheap_mask,wide_ml", SWITCHES)
def test_kernel_d64_matches_plain(gen, fastpath, cheap_mask, wide_ml):
    _card_check(gen, (1, 4, 449, 64), 2, block_kv=128, fastpath=fastpath,
                cheap_mask=cheap_mask, wide_ml=wide_ml)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(gen):
    x = torch.randn((1, 2, 128, 64), generator=gen, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="block_kv"):
        lab.variant_flash(x, x, x, block_kv=64)
    with pytest.raises(TypeError):
        lab.variant_flash(x.half(), x.half(), x.half())
