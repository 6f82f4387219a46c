"""PyTorch port: ops/rope.py against the JAX package's RoPE (CPU).

Tolerances: the inverse-frequency table is bit-exact; cos/sin and the f32
rotation agree to 1e-5 relative (transcendental implementations differ by
an ulp or two); bf16 outputs agree to one bf16 ulp (2^-7 relative), since
both round the same f32 halves once.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from long_vita_tpu.ops import rope as jrope
from long_vita_tpu_torch.ops import rope as trope


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (64, 1e4), (128, 1e6)])
def test_inv_freq_bit_exact(head_dim, theta):
    want = np.asarray(jrope.rope_inv_freq(head_dim, theta))
    got = trope.rope_inv_freq(head_dim, theta).numpy()
    np.testing.assert_array_equal(got, want)


def test_cos_sin_match():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, size=(2, 37))
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 128, 1e6)
    tc, ts = trope.rope_cos_sin(torch.as_tensor(pos), 128, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table_rank", [2, 3])
def test_apply_rope_matches(dtype, table_rank):
    rng = np.random.default_rng(1)
    b, s, hq, hk, d = 2, 19, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    pos = rng.integers(0, 500, size=(b, s)) if table_rank == 3 else np.arange(s)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), d, 1e4)
    jq, jk = jrope.apply_rope(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jc, js
    )
    tdt = getattr(torch, dtype)
    tc, ts = trope.rope_cos_sin(torch.as_tensor(pos), d, 1e4)
    tq, tk = trope.apply_rope(
        torch.as_tensor(q).to(tdt), torch.as_tensor(k).to(tdt), tc, ts
    )
    assert tq.dtype == tdt and tk.dtype == tdt
    rtol = 1e-5 if dtype == "float32" else 2.0**-7
    for got, want in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=1e-5
        )
