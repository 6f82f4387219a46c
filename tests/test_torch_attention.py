"""PyTorch port: ops/attention.py against the JAX package (CPU, f32).

Tolerance 1e-5 relative / 1e-5 absolute: both compute f32 logits and an
f32 softmax; only summation order differs.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from long_vita_tpu.ops import attention as jatt
from long_vita_tpu_torch.ops import attention as tatt

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(rng, b, sq, skv, hq, hkv, d=16):
    return (
        rng.standard_normal((b, sq, hq, d)).astype(np.float32),
        rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
        rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
    )


def _both(q, k, v, **kw):
    want = jatt.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()},
    )
    got = tatt.xla_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        **{n: (torch.as_tensor(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()},
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_xla_attention_gqa(causal, hq, hkv):
    q, k, v = _qkv(np.random.default_rng(0), 2, 33, 33, hq, hkv)
    got, want = _both(q, k, v, causal=causal)
    np.testing.assert_allclose(got, want, **TOL)


def test_xla_attention_causal_offsets_and_valid_len():
    """A chunk at positions 40.. against a 96-slot cache, ragged valid lens."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 24, 96, 4, 2)
    qpos = np.stack([40 + np.arange(24), 50 + np.arange(24)])
    kpos = np.broadcast_to(np.arange(96), (2, 96)).copy()
    got, want = _both(
        q, k, v, causal=True, q_positions=qpos, kv_positions=kpos,
        kv_valid_len=np.asarray([64, 74]),
    )
    np.testing.assert_allclose(got, want, **TOL)


def test_xla_attention_segments():
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 40, 40, 4, 2)
    seg = np.zeros((2, 40), np.int32)
    seg[0, 13:] = 1
    seg[1, 5:] = 1
    seg[1, 31:] = 2
    got, want = _both(q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    np.testing.assert_allclose(got, want, **TOL)


def test_dot_product_attention_routes_cpu_to_xla():
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(x) for x in _qkv(rng, 1, 256, 256, 4, 2))
    assert tatt._pick_impl(q, k, True, None) == "xla"
    got = tatt.dot_product_attention(q, k, v, causal=True)
    np.testing.assert_allclose(
        got.numpy(), tatt.xla_attention(q, k, v, causal=True).numpy(), rtol=0, atol=0
    )
    # "short" (the ViT kernel K3) is for CUDA; the CPU routes it as "auto"
    np.testing.assert_allclose(
        tatt.dot_product_attention(q, k, v, causal=False, impl="short").numpy(),
        tatt.xla_attention(q, k, v, causal=False).numpy(), rtol=0, atol=0,
    )
    with pytest.raises(ValueError, match="unknown"):
        tatt.dot_product_attention(q, k, v, impl="bogus")
