"""PyTorch port: ops/quant_matmul.py (K6's host packing, plain versions and
route) against long_vita_tpu/ops/quant_matmul.py, inputs made by numpy from
a seed.

Packing and quantization agree bit for bit. The kernel's plain version
agrees with the Pallas kernel in interpret mode, both variants, in f32 at
rtol = atol = 2e-5 (the JAX package's own tolerance between its kernel and
its dequantise route, tests/test_quant_matmul.py): both accumulate each
group's dot in f32 and add the scaled groups in one order, so they differ by
summation order only. The dequantise route agrees with w4_matmul_xla, one
f32 GEMM each, summed in other orders by XLA and by torch: at 600 rows and
in 512 (products up to ~4 in magnitude, sums up to ~40) two elements in
150K land 3e-5 apart near zero, so it gets 1e-4 absolute. The route (kernel or dequantise) is JAX's choice, read by
spying on which of its functions w4_matmul(interpret=True) calls.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from long_vita_tpu.ops import quant_matmul as jq
from long_vita_tpu_torch.ops import quant_matmul as tq
from test_torch_quantize import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
DEQUANT_TOL = dict(rtol=2e-5, atol=1e-4)
SHAPES_14B = [(5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120), (5120, 152064)]


def _weights(seed, n_in, n_out, lead=()):
    w = np.random.default_rng(seed).standard_normal((*lead, n_in, n_out)).astype(np.float32)
    return w, jq.quantize_int4_grouped(w)


@pytest.mark.parametrize("shape", [(512, 96), (64, 40), (2, 256, 128), (1024, 256)])
def test_packing_and_quantization_bit_for_bit(shape):
    *lead, n_in, n_out = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.integers(-8, 8, size=shape, dtype=np.int8)
    packed = tq.pack_int4(q)
    np.testing.assert_array_equal(packed, jq.pack_int4(q))
    assert packed.dtype == np.int8 and packed.shape == (*lead, n_in // 2, n_out)
    np.testing.assert_array_equal(tq.unpack_int4(packed), jq.unpack_int4(packed))
    np.testing.assert_array_equal(tq.unpack_int4(packed), q)
    np.testing.assert_array_equal(tq.unpack_int4_torch(torch.from_numpy(packed)).numpy(), q)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero column takes scale 1
    got, want = tq.quantize_int4_grouped(w), jq.quantize_int4_grouped(w)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("variant", ["u", "grid"])
@pytest.mark.parametrize("rows", [1, 5, 64])
def test_reference_matches_pallas_kernel(rows, variant, monkeypatch):
    """Both Pallas variants in interpret mode: LVT_W4_KERNEL is read at call
    time ("u": the whole-contraction variant, else the (j, k) grid)."""
    monkeypatch.setenv("LVT_W4_KERNEL", variant)
    _, (packed, scales) = _weights(3, 512, 512)
    x = np.random.default_rng(rows).standard_normal((rows, 512)).astype(np.float32)
    calls = []
    real = jq._w4_matmul_pallas_u if variant == "u" else jq._w4_matmul_pallas
    name = "_w4_matmul_pallas_u" if variant == "u" else "_w4_matmul_pallas"
    monkeypatch.setattr(jq, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    want = np.asarray(jq.w4_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                                   interpret=True))
    assert calls == [1]
    assert tq.w4_uses_kernel(rows, torch.from_numpy(packed), torch.from_numpy(scales))
    before = (tq.w4_matmul.launches, tq.w4_matmul_dequant.calls)
    got = tq.w4_matmul(torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(scales))
    assert (tq.w4_matmul.launches, tq.w4_matmul_dequant.calls) == before  # CPU: no launch
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = tq.w4_matmul_reference(torch.from_numpy(x), torch.from_numpy(packed),
                                 torch.from_numpy(scales), torch.float32)
    np.testing.assert_array_equal(ref.numpy(), got.numpy())


@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_dequant_route_matches_xla_at_600_rows(out_dtype):
    _, (packed, scales) = _weights(4, 512, 256)
    x = np.random.default_rng(5).standard_normal((600, 512)).astype(np.float32)
    want = np.asarray(jq.w4_matmul_xla(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                                       out_dtype and jnp.float32))
    assert not tq.w4_uses_kernel(600, torch.from_numpy(packed), torch.from_numpy(scales))
    before = tq.w4_matmul_dequant.calls
    got = tq.w4_matmul(torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(scales),
                       out_dtype and torch.float32)
    assert tq.w4_matmul_dequant.calls == before + 1
    np.testing.assert_allclose(got.numpy(), want, **DEQUANT_TOL)


def test_leading_dims_and_tiny_groups():
    """x [2, 3, in]; the tiny-shape fallback (one group per packed half)
    takes the dequantise route in both packages, which agree."""
    for n_in, n_out in ((64, 96), (256, 96)):
        _, (packed, scales) = _weights(6, n_in, n_out)
        x = np.random.default_rng(7).standard_normal((2, 3, n_in)).astype(np.float32)
        want = np.asarray(jq.w4_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales)))
        got = tq.w4_matmul(torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(scales))
        assert got.shape == (2, 3, n_out)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _shape_only(shape, dtype):
    """An array / tensor of this shape that holds one element (stride 0)."""
    return np.broadcast_to(np.zeros((), dtype), shape), torch.zeros((), dtype=getattr(
        torch, np.dtype(dtype).name)).expand(*shape)


@pytest.mark.parametrize(
    "n_in,n_out,rows",
    [(i, o, r) for i, o in SHAPES_14B for r in (1, 512, 513)]
    + [(64, 512, 1), (256, 96, 1), (256, 640, 4), (512, 1000, 2)],
)
def test_route_choice_matches_jax(n_in, n_out, rows, monkeypatch):
    """Which of JAX's functions w4_matmul(interpret=True) calls (spied, with
    nothing computed) against w4_uses_kernel: the five 14B shapes at rows
    1, 512 and 513, a tiny-group shape, and out dimensions that JAX's block
    does and does not divide."""
    taken = []

    def spy(route):
        def fn(x, packed, *a, **k):
            taken.append(route)
            return np.broadcast_to(np.zeros((), np.float32), (*x.shape[:-1], packed.shape[-1]))
        return fn

    monkeypatch.setattr(jq, "w4_matmul_xla", spy("xla"))
    monkeypatch.setattr(jq, "_w4_matmul_pallas_u", spy("pallas"))
    group = 128 if n_in % 256 == 0 else n_in // 2
    x_np, _ = _shape_only((rows, n_in), np.float32)
    p_np, p_t = _shape_only((n_in // 2, n_out), np.int8)
    s_np, s_t = _shape_only((n_in // group, n_out), np.float32)
    jq.w4_matmul(x_np, p_np, s_np, interpret=True)
    assert taken == [("pallas" if tq.w4_uses_kernel(rows, p_t, s_t) else "xla")]
    if (n_in, n_out) in SHAPES_14B:
        assert taken == ["pallas" if rows <= 512 else "xla"]
    # a packed weight with a leading dim never takes the kernel
    assert not tq.w4_uses_kernel(rows, p_t[None], s_t)
