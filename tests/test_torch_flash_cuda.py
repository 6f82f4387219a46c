"""PyTorch port: the hand-written CUDA kernels (K1 flash forward, K2 int8 flash
forward, K3 short ViT attention, K4 one-pass and K5 two-pass flash backward)
against their plain versions, and the f32-logit head's backward against an
f32 product.

Needs a CUDA GPU (the kernel has no CPU mode): every test carries the
``cuda`` marker and skips without one. This file imports no JAX, so it runs
on a machine without it; there, skip the JAX-importing conftest:

    python -m pytest tests/test_torch_flash_cuda.py --noconftest -q

Tolerances (as chip_smoke.py): bf16 output 1e-2 abs + 1e-2 rel (the kernel
and the plain version round p and o to bf16 at different points), lse 1e-3
abs; f32 1e-4 (summation order and exp only). Backward: bf16 gradients
within 1e-2 x max|ref| abs + 1e-2 rel (both round p and dS to bf16 at the
same points, but from f32 logits summed in another order, so a rounding can
flip; each gradient sums up to Sq products), f32 within 1e-5 x max|ref| +
1e-5 rel.
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


def _check_bwd(q, k, v, fused, *, causal, q_offset=0, kv_valid_len=None, seg=None):
    """K4 (fused) or K5 against the plain backward on the same (o, lse, do);
    the kernel is forced, whatever JAX's rule picks at the shape."""
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len,
              q_segment_ids=seg, kv_segment_ids=seg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    do = _rand(gen, q.shape, q.dtype)
    o, lse = tfa.flash_attention_reference(q, k, v, **kw)
    counts = (tfa.flash_bwd_fused.launches, tfa.flash_bwd_dkv.launches, tfa.flash_bwd_dq.launches)
    kv_len = k.shape[1] if kv_valid_len is None else kv_valid_len
    got = tfa._flash_bwd_cuda(q, k, v, o, lse, do, causal, q_offset, 0, kv_len, seg, seg, fused)
    torch.cuda.synchronize()
    rise = (1, 0, 0) if fused else (0, 1, 1)
    assert (tfa.flash_bwd_fused.launches, tfa.flash_bwd_dkv.launches,
            tfa.flash_bwd_dq.launches) == tuple(c + r for c, r in zip(counts, rise))
    ref = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    tol = 1e-2 if q.dtype == torch.bfloat16 else 1e-5
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == q.dtype and g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), rtol=tol,
                                   atol=tol * r.float().abs().max().item(), msg=name)


@pytest.mark.parametrize("fused", [True, False], ids=["K4", "K5"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_causal_gqa_segments(gen, fused, dtype):
    q = _rand(gen, (2, 300, 8, 128), dtype)
    k, v = _rand(gen, (2, 300, 2, 128), dtype), _rand(gen, (2, 300, 2, 128), dtype)
    seg = torch.zeros(2, 300, dtype=torch.int32, device="cuda")
    seg[0, 100:] = 1
    seg[1, 170:] = 1
    seg[1, 240:] = 2
    _check_bwd(q, k, v, fused, causal=True, seg=seg)


@pytest.mark.parametrize("fused", [True, False], ids=["K4", "K5"])
def test_backward_offsets_kv_valid_len_strided(gen, fused):
    """A chunk at q offset 350 against a strided cache view with 600 valid
    slots (dk, dv are 0 past them), D 64."""
    q = _rand(gen, (2, 300, 8, 64), torch.bfloat16)
    kbuf, vbuf = _rand(gen, (2, 1024, 2, 64), torch.bfloat16), _rand(gen, (2, 1024, 2, 64), torch.bfloat16)
    _check_bwd(q, kbuf[:, :700], vbuf[:, :700], fused, causal=True, q_offset=350, kv_valid_len=600)


@pytest.mark.parametrize("fused", [True, False], ids=["K4", "K5"])
def test_backward_vit_noncausal(gen, fused):
    """The ViT's attention: q/k/v as views of one qkv projection, 1025 tokens."""
    qkv = _rand(gen, (3, 1025, 3, 16, 64), torch.bfloat16)
    q, k, v = qkv.unbind(2)
    _check_bwd(q, k, v, fused, causal=False)


def test_autograd_through_the_kernels(gen):
    """flash_attention's and short_attention's gradients on CUDA tensors come
    from the kernels (JAX's choice: K4 at these shapes) and match autograd
    through the plain attention."""
    from long_vita_tpu_torch.ops.attention import xla_attention

    q = _rand(gen, (1, 256, 4, 64), torch.float32)
    k, v = _rand(gen, (1, 256, 2, 64), torch.float32), _rand(gen, (1, 256, 2, 64), torch.float32)
    w = _rand(gen, (1, 256, 4, 64), torch.float32)
    for causal in (True, False):
        args = [x.clone().requires_grad_() for x in (q, k, v)]
        before = tfa.flash_bwd_fused.launches
        (tfa.flash_attention(*args, causal=causal) * w).sum().backward()
        assert tfa.flash_bwd_fused.launches == before + 1
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        (xla_attention(*plain, causal=causal) * w).sum().backward()
        for a, b in zip(args, plain):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)
    args = [x.clone().bfloat16().requires_grad_() for x in (q, k, v)]
    before = (tfa.short_attention.launches, tfa.flash_bwd_fused.launches)
    (tfa.short_attention(*args).float() * w).sum().backward()
    assert (tfa.short_attention.launches, tfa.flash_bwd_fused.launches) == (before[0] + 1, before[1] + 1)
    assert all(bool(torch.isfinite(a.grad.float()).all()) for a in args)


def test_f32_head_backward_at_the_budget_shape(gen):
    """The f32-logit head's backward (models.qwen2._F32Logits) at the
    training shape, 4096 logit rows of the 14B head: d_flat and d_weight
    must be the f32 products rounded once to bf16, as JAX's transpose rule
    gives them. Held elementwise to one bf16 ulp (2^-7 relative) plus 1e-5 x
    max|ref| (f32 summation order where a sum cancels), and by the share of
    elements that differ from the f32 product's bf16 rounding: at most 1% of
    d_weight (measured on an H100: 0.32%; rounding the gradient to bf16
    first gives 38.5%) and 5% of d_flat (2.84%; 3.21% with the rounding
    first: each row's label term, -w[label] / N, is exact in bf16 and
    dominates)."""
    from long_vita_tpu_torch.models.qwen2 import _F32Logits

    n, h, vocab = 4096, 5120, 152064
    flat = _rand(gen, (n, h), torch.bfloat16).requires_grad_()
    w = (_rand(gen, (vocab, h), torch.bfloat16) * 0.02).requires_grad_()
    logits = _F32Logits.apply(flat, w)
    labels = torch.randint(0, vocab, (n,), generator=gen, device="cuda")
    # the cross-entropy gradient of the mean loss over the rows
    g = torch.softmax(logits.detach(), -1)
    g[torch.arange(n, device="cuda"), labels] -= 1.0
    g /= n
    logits.backward(g)
    with torch.no_grad():
        refs = (g @ w.float(), g.t() @ flat.float())
    for name, got, ref, share in (("d_flat", flat.grad, refs[0], 0.05),
                                  ("d_weight", w.grad, refs[1], 0.01)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        err = (got.float() - ref).abs()
        assert bool((err <= 2.0**-7 * ref.abs() + 1e-5 * ref.abs().max()).all()), name
        assert (got != ref.to(torch.bfloat16)).float().mean().item() <= share, name
