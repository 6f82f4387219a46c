"""PyTorch port: K3, short_attention (the ViT's single-pass attention).

On the CPU the port's short_attention takes its plain version
(short_attention_reference); it is held against the JAX package's Pallas
kernel `_short_nc_kernel` run in interpret mode, o and lse, at the ragged
length and GQA cases of the JAX package's own test (S 260 and 130). f32
throughout and one softmax pass on both sides: 1e-5 relative and absolute.

The CUDA kernel itself is compared with its plain version on a GPU by
tests/test_torch_flash_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from long_vita_tpu.ops.flash_attention import _short_attention_impl as jax_short
from long_vita_tpu_torch.ops import attention as tatt
from long_vita_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, b, s, hq, hkv, d=64):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, s, hq, d)).astype(np.float32),
        rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        rng.standard_normal((b, s, hkv, d)).astype(np.float32),
    )


@pytest.mark.parametrize(
    "b,s,hq,hkv", [(2, 260, 4, 4), (1, 130, 4, 2), (3, 65, 2, 2)],
    ids=["ragged", "gqa", "one_past_a_tile"],
)
def test_short_attention_matches_jax(b, s, hq, hkv):
    q, k, v = _qkv(13 + s, b, s, hq, hkv)
    jo, jl = jax_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True)
    before = tfa.short_attention.launches
    to, tl = tfa.short_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), return_lse=True
    )
    assert tfa.short_attention.launches == before  # CPU: no kernel launch
    assert to.shape == q.shape and tl.shape == (b, hq, s)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # o alone, and the same as the plain non-causal attention
    o = tfa.short_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v))
    plain = tatt.xla_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), causal=False
    )
    np.testing.assert_allclose(o.numpy(), plain.numpy(), **TOL)


def test_short_attention_bf16_rounds_p_like_the_kernel():
    """In bf16 the plain version rounds p = exp(s - max) to bf16 before P.V
    and divides after it, as the kernel does: within bf16 rounding (2^-8
    relative, two roundings) of the f32 result."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(7, 2, 100, 4, 2))
    o32 = tfa.short_attention(q, k, v)
    o16, lse16 = tfa.short_attention(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), return_lse=True
    )
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    torch.testing.assert_close(o16.float(), o32, atol=2e-2, rtol=2e-2)


def test_impl_short_routes_by_device():
    """impl="short" reaches K3 only on CUDA; on the CPU it routes as "auto"
    does (the plain attention), as the JAX package off the TPU."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(8, 1, 200, 4, 2))
    before = tfa.short_attention.launches
    got = tatt.dot_product_attention(q, k, v, causal=False, impl="short")
    assert tfa.short_attention.launches == before
    want = tatt.xla_attention(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=0)
