"""PyTorch port: the hand-written CUDA kernels (K1 flash forward, K2 int8 flash
forward, K3 short ViT attention) against their plain versions.

Needs a CUDA GPU (the kernel has no CPU mode): every test carries the
``cuda`` marker and skips without one. This file imports no JAX, so it runs
on a machine without it; there, skip the JAX-importing conftest:

    python -m pytest tests/test_torch_flash_cuda.py --noconftest -q

Tolerances (as chip_smoke.py): bf16 output 1e-2 abs + 1e-2 rel (the kernel
and the plain version round p and o to bf16 at different points), lse 1e-3
abs; f32 1e-4 (summation order and exp only).
"""
import pytest
import torch

from long_vita_tpu_torch.models.qwen2 import quantize_kv
from long_vita_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _check(q, k, v, **kw):
    before = tfa.flash_attention.launches
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    ro, rlse = tfa.flash_attention_reference(q, k, v, **kw)
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=min(tol, 1e-3), rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunk_against_strided_cache(gen, dtype):
    """Two rows, a 300-row chunk at offset 350 against a view of a longer
    cache buffer (batch stride != Skv * Hkv * D), 600 valid slots."""
    q = _rand(gen, (2, 300, 8, 128), dtype)
    kbuf, vbuf = _rand(gen, (2, 1024, 2, 128), dtype), _rand(gen, (2, 1024, 2, 128), dtype)
    _check(q, kbuf[:, :700], vbuf[:, :700], causal=True, q_offset=350, kv_valid_len=600)


def test_segments_d64(gen):
    q, k, v = (_rand(gen, (2, 256, 4, 64), torch.bfloat16) for _ in range(3))
    seg = torch.zeros(2, 256, dtype=torch.int32, device="cuda")
    seg[0, 77:] = 1
    seg[1, 130:] = 1
    _check(q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q = _rand(gen, (1, 128, 4, 128), torch.bfloat16)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        x = _rand(gen, (1, 128, 4, 96), torch.bfloat16)
        tfa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="packed"):
        t = q.transpose(1, 2).contiguous().transpose(1, 2)  # [B, S, H, D] view of head-major
        tfa.flash_attention(t, t, t)


def _check_quant(q, k, ks, v, vs, **kw):
    before = tfa.flash_attention_quant.launches
    o, lse = tfa.flash_attention_quant(q, k, ks, v, vs, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_quant.launches == before + 1
    ro, rlse = tfa.flash_attention_quant_reference(q, k, ks, v, vs, **kw)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)
    return o, lse


def test_flash_quant_chunk_against_strided_int8_cache(gen):
    """K2: two rows, a 300-row chunk at offset 350 against views of a longer
    int8 cache and its scales, 600 valid slots; D 128 and 64."""
    for d in (128, 64):
        q = _rand(gen, (2, 300, 8, d), torch.bfloat16)
        k, ks = quantize_kv(_rand(gen, (2, 1024, 2, d), torch.bfloat16))
        v, vs = quantize_kv(_rand(gen, (2, 1024, 2, d), torch.bfloat16))
        _check_quant(q, k[:, :700], ks[:, :700], v[:, :700], vs[:, :700],
                     q_offset=350, kv_valid_len=600)


def test_flash_quant_empty_rows(gen):
    q = _rand(gen, (1, 256, 8, 128), torch.bfloat16)
    k, ks = quantize_kv(_rand(gen, (1, 512, 2, 128), torch.bfloat16))
    o, lse = _check_quant(q, k, ks, k, ks, q_offset=100, kv_valid_len=0)
    assert bool((o == 0).all()) and bool((lse == tfa.NEG_INF).all())


@pytest.mark.parametrize("shape", [(2, 1025, 16, 16), (3, 257, 16, 16), (2, 130, 4, 2), (1, 1, 2, 2)])
def test_short_attention_kernel(gen, shape):
    """K3: the ViT shape (1025 = 16 x 64 + 1), unaligned lengths, GQA, and a
    one-token sequence; q/k/v as the strided views of one qkv projection."""
    b, s, hq, hkv = shape
    qkv = _rand(gen, (b, s, hq + 2 * hkv, 64), torch.bfloat16)
    q, k, v = qkv.split([hq, hkv, hkv], dim=2)
    before = tfa.short_attention.launches
    o, lse = tfa.short_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert tfa.short_attention.launches == before + 1
    ro, rlse = tfa.short_attention_reference(q, k, v)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)


def test_new_wrappers_reject_what_their_kernels_do_not_take(gen):
    q = _rand(gen, (1, 128, 4, 128), torch.bfloat16)
    k, ks = quantize_kv(_rand(gen, (1, 128, 2, 128), torch.bfloat16))
    with pytest.raises(TypeError):
        tfa.flash_attention_quant(q.float(), k, ks, k, ks)
    with pytest.raises(ValueError, match="scales"):
        tfa.flash_attention_quant(q, k, ks[:, :64], k, ks)
    with pytest.raises(ValueError, match="head dim 64"):
        tfa.short_attention(q, q, q)
