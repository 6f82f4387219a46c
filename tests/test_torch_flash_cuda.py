"""PyTorch port: the hand-written CUDA kernels (K1 flash forward, K2 int8 flash
forward, K3 short ViT attention, K4 one-pass and K5 two-pass flash backward,
K6 the w4a16 product) against their plain versions, and the f32-logit head's
backward against an f32 product.

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
1e-5 rel. K6: both sides take each int4 x bf16 product exactly and sum in
f32 in different orders, then round once: bf16 out within 1e-2 x max|ref|,
f32 out within 1e-4 x max|ref|; with f32 activations (products rounded in
f32) 1e-5 x max|ref|.
"""
import pytest
import torch

from long_vita_tpu_torch.models.qwen2 import quantize_kv
from long_vita_tpu_torch.models.quantize import quantize_kernel_int4
from long_vita_tpu_torch.ops import flash_attention as tfa
from long_vita_tpu_torch.ops import quant_matmul as tqm

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


# The Hopper forward (K1's bf16 body and K3): 128 query rows a block, K/V
# tiles of 128 rows through TMA, a 16-column product for a tile of which a
# warpgroup sees at most 16 columns, V's rows past kv_valid_len zeroed.


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("case", [
    # (Sq, Skv, Hq, Hkv, q_offset, kv_valid_len, causal)
    (300, 700, 8, 8, 350, 600, True),      # Sq and kv_len off the 128 grid, GQA 1
    (200, 1024, 40, 8, 100, 129, True),    # GQA 5; one key past a tile: a narrow tile
    (256, 640, 16, 2, 1000, 640, True),    # GQA 8; q_offset past the cache frontier
    (129, 512, 8, 1, 0, 300, False),       # non-causal, kv_len inside a tile
    (1, 2048, 8, 2, 2047, 2048, True),     # one decode-like row at the end
    (200, 300, 8, 2, 70, 300, True),       # D 64: warpgroup 0's narrow tile is not the block's last
])
def test_sm90_forward_shapes(gen, d, case):
    sq, skv, hq, hkv, q_off, kv_len, causal = case
    q = _rand(gen, (2, sq, hq, d), torch.bfloat16)
    k, v = _rand(gen, (2, skv, hkv, d), torch.bfloat16), _rand(gen, (2, skv, hkv, d), torch.bfloat16)
    _check(q, k, v, causal=causal, q_offset=q_off, kv_valid_len=kv_len)


@pytest.mark.parametrize("kv_len", [0, 1, 127, 128, 333])
def test_sm90_forward_nan_past_kv_valid_len(gen, kv_len):
    """Rows of the cache past kv_valid_len hold NaN (TMA loads them as they
    are): they must not reach o or lse; kv_len 0 gives empty rows."""
    q = _rand(gen, (1, 200, 8, 128), torch.bfloat16)
    k, v = _rand(gen, (1, 512, 2, 128), torch.bfloat16), _rand(gen, (1, 512, 2, 128), torch.bfloat16)
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    o, lse = tfa.flash_attention(q, k, v, causal=True, q_offset=400, kv_valid_len=kv_len,
                                 return_lse=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(lse).all())
    if kv_len == 0:
        assert bool((o == 0).all()) and bool((lse == tfa.NEG_INF).all())
    else:
        _check(q, k, v, causal=True, q_offset=400, kv_valid_len=kv_len)


@pytest.mark.parametrize("layout", ["packed", "interleaved"])
@pytest.mark.parametrize("d", [128, 64])
def test_sm90_forward_segments(gen, d, layout):
    """Segments (causal, GQA 5) with an odd Skv: the kv segment ids are
    padded to a multiple of 4 ids a row for their TMA map. Packed rows let
    whole kv tiles be skipped; interleaved ids (not sorted) must skip none
    that holds a match."""
    s = 1333
    q = _rand(gen, (2, s, 10, d), torch.bfloat16)
    k, v = _rand(gen, (2, s, 2, d), torch.bfloat16), _rand(gen, (2, s, 2, d), torch.bfloat16)
    if layout == "packed":
        seg = torch.zeros(2, s, dtype=torch.int32, device="cuda")
        seg[0, 130:] = 1
        seg[0, 700:] = 2
        seg[1, 5:] = 1
        seg[1, 1200:] = 2
    else:
        seg = ((torch.arange(s, device="cuda") // 50) % 3).to(torch.int32).expand(2, s)
    _check(q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)


@pytest.mark.parametrize("s", [1, 257, 1025, 2048])
def test_short_attention_sm90_lengths(gen, s):
    """K3 at the lengths it meets (1025 = 8 x 128 + 1: one narrow kv tile and
    a q block of one warpgroup), q/k/v as the strided views of one
    [N, S, 3, H, 64] qkv projection, never copied."""
    qkv = _rand(gen, (3, s, 3, 16, 64), torch.bfloat16)
    q, k, v = qkv.unbind(2)
    before = tfa.short_attention.launches
    o, lse = tfa.short_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert tfa.short_attention.launches == before + 1
    ro, rlse = tfa.short_attention_reference(q, k, v)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=0)


def test_sm90_wrappers_reject_what_the_tensor_maps_do_not_take(gen):
    q = _rand(gen, (1, 64, 4, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="batch rows"):
        x = q.expand(65536, 64, 4, 64)
        tfa.short_attention(x, x, x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        buf = _rand(gen, (64 * 4 * 64 + 4,), torch.bfloat16)
        t = buf[4:].view(1, 64, 4, 64)  # 8 bytes past an aligned base
        tfa.flash_attention(t, t, t)


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
    return got


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


# The Hopper backward (K4's and K5's bf16 bodies, csrc/flash_bwd_sm90.cuh):
# kv-major blocks of 128 kv rows walking 64-row q tiles, q-major dq blocks of
# 128 q rows walking 128-row kv tiles, tiles skipped by the causal frontier,
# kv_valid_len and segment-id range.


@pytest.mark.parametrize("fused", [True, False], ids=["K4", "K5"])
@pytest.mark.parametrize("case", [
    # (Sq, Skv, Hq, Hkv, q_offset, kv_valid_len, d)
    (300, 700, 8, 8, 350, 600, 128),     # ragged Sq and kv_len, GQA 1
    (200, 1024, 40, 8, 100, 129, 128),   # GQA 5; one key past a 128-row tile
    (256, 640, 16, 2, 1000, 640, 128),   # GQA 8; q_offset past the keys' frontier
    (333, 500, 10, 2, 170, 401, 64),     # D 64, GQA 5
    (1, 2048, 8, 2, 2047, 2048, 128),    # one row at the end
])
def test_sm90_backward_shapes_nan_past_kv_valid_len(gen, fused, case):
    """Ragged Sq and Skv, q offsets, GQA 1/5/8; the K and V rows past
    kv_valid_len hold NaN (TMA loads rows inside the tensor as they are):
    none may reach dq, and dk, dv are 0 there."""
    sq, skv, hq, hkv, q_off, kv_len, d = case
    q = _rand(gen, (2, sq, hq, d), torch.bfloat16)
    k, v = _rand(gen, (2, skv, hkv, d), torch.bfloat16), _rand(gen, (2, skv, hkv, d), torch.bfloat16)
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    got = _check_bwd(q, k, v, fused, causal=True, q_offset=q_off, kv_valid_len=kv_len)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)


@pytest.mark.parametrize("fused", [True, False], ids=["K4", "K5"])
@pytest.mark.parametrize("layout", ["packed", "interleaved"])
@pytest.mark.parametrize("d", [128, 64])
def test_sm90_backward_segments(gen, fused, layout, d):
    """Segments, causal, GQA 5, odd Skv (kv ids padded to rows of 4 for
    their TMA map): packed rows let whole tile pairs be skipped; interleaved
    ids must skip none that holds a match."""
    s = 1333
    q = _rand(gen, (2, s, 10, d), torch.bfloat16)
    k, v = _rand(gen, (2, s, 2, d), torch.bfloat16), _rand(gen, (2, s, 2, d), torch.bfloat16)
    if layout == "packed":
        seg = torch.zeros(2, s, dtype=torch.int32, device="cuda")
        seg[0, 130:] = 1
        seg[0, 700:] = 2
        seg[1, 5:] = 1
        seg[1, 1200:] = 2
    else:
        seg = ((torch.arange(s, device="cuda") // 50) % 3).to(torch.int32).expand(2, s).contiguous()
    _check_bwd(q, k, v, fused, causal=True, seg=seg)


@pytest.mark.parametrize("fused", [True, False], ids=["K4", "K5"])
def test_sm90_backward_vit_shape(gen, fused):
    """The trainable tower's [16, 1025, 16, 64] non-causal backward, q/k/v
    strided views of one qkv projection (never copied)."""
    qkv = _rand(gen, (16, 1025, 3, 16, 64), torch.bfloat16)
    q, k, v = qkv.unbind(2)
    _check_bwd(q, k, v, fused, causal=False)


@pytest.mark.parametrize("fused", [True, False], ids=["K4", "K5"])
def test_sm90_backward_empty_rows(gen, fused):
    """Rows with no unmasked key (lse = -2^30): the first 100 q rows sit
    before every key (q_offset - kv_offset < 0), and one segment's rows meet
    only other segments' keys. Their dq is 0 and nothing turns non-finite."""
    q = _rand(gen, (1, 300, 8, 128), torch.bfloat16)
    k, v = _rand(gen, (1, 300, 2, 128), torch.bfloat16), _rand(gen, (1, 300, 2, 128), torch.bfloat16)
    qseg = torch.zeros(1, 300, dtype=torch.int32, device="cuda")
    qseg[:, 200:] = 7  # no key carries id 7
    kseg = torch.zeros(1, 300, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, q_offset=0, kv_offset=100, q_segment_ids=qseg, kv_segment_ids=kseg)
    o, lse = tfa.flash_attention_reference(q, k, v, **kw)
    assert bool((lse[:, :, :100] == tfa.NEG_INF).all()) and bool((lse[:, :, 200:] == tfa.NEG_INF).all())
    do = _rand(gen, q.shape, q.dtype)
    got = tfa._flash_bwd_cuda(q, k, v, o, lse, do, True, 0, 100, 300, qseg, kseg, fused)
    ref = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.float(), r.float(), rtol=1e-2,
                                   atol=1e-2 * r.float().abs().max().item())
    assert bool((got[0][:, :100] == 0).all()) and bool((got[0][:, 200:] == 0).all())


@pytest.mark.parametrize("fused", [True, False], ids=["K4", "K5"])
def test_sm90_backward_dk_dv_reproducible(gen, fused):
    """dK and dV are bit-identical over two runs (each block owns its rows;
    only K4's dQ sums with atomics)."""
    q = _rand(gen, (1, 1000, 10, 128), torch.bfloat16)
    k, v = _rand(gen, (1, 1000, 2, 128), torch.bfloat16), _rand(gen, (1, 1000, 2, 128), torch.bfloat16)
    seg = torch.zeros(1, 1000, dtype=torch.int32, device="cuda")
    seg[:, 400:] = 1
    o, lse = tfa.flash_attention_reference(q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    do = _rand(gen, q.shape, q.dtype)
    runs = [tfa._flash_bwd_cuda(q, k, v, o, lse, do, True, 0, 0, 1000, seg, seg, fused)
            for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])
    if not fused:
        assert torch.equal(runs[0][0], runs[1][0])


def test_sm90_backward_rejects_what_the_tensor_maps_do_not_take(gen):
    q = _rand(gen, (1, 64, 4, 64), torch.bfloat16)
    x = q.expand(65536, 64, 4, 64)
    lse = torch.zeros(65536, 4, 64, device="cuda")
    with pytest.raises(ValueError, match="batch rows"):
        tfa._flash_bwd_cuda(x, x, x, x, lse, x, False, 0, 0, 64, None, None, True)


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


def _w4_case(gen, rows, n_in, n_out, x_dtype, out_dtype):
    w = _rand(gen, (n_out, n_in), torch.bfloat16) * 0.02  # nn.Linear orientation
    packed, scales = quantize_kernel_int4(w)
    x = _rand(gen, (rows, n_in), x_dtype)
    before = tqm.w4_matmul.launches
    got = tqm.w4_matmul(x, packed, scales, out_dtype)
    torch.cuda.synchronize()
    assert tqm.w4_matmul.launches == before + 1 and got.dtype == out_dtype
    ref = tqm.w4_matmul_reference(x, packed, scales, out_dtype)
    tol = 1e-5 if x_dtype == torch.float32 else (1e-2 if out_dtype == torch.bfloat16 else 1e-4)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=tol * ref.float().abs().max().item())
    again = tqm.w4_matmul(x, packed, scales, out_dtype)
    assert torch.equal(again, got)  # a fixed summation order: the same bits
    return got


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 512])
@pytest.mark.parametrize("n_in,n_out", [(5120, 1024), (5120, 152064)], ids=["k_proj", "head"])
def test_w4_matmul_kernel(gen, rows, n_in, n_out, out_dtype):
    """K6 at the 14B k_proj and head shapes, a decode row and the kernel
    route's 512-row limit (k_proj at one row splits its groups over blocks
    and adds the partials in a second pass)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _w4_case(gen, rows, n_in, n_out, torch.bfloat16, out_dtype)


def test_w4_matmul_f32_activations_and_rejects(gen):
    torch.backends.cuda.matmul.allow_tf32 = False
    _w4_case(gen, 5, 512, 640, torch.float32, torch.float32)
    packed, scales = quantize_kernel_int4(_rand(gen, (256, 512), torch.bfloat16))
    x = _rand(gen, (3, 512), torch.bfloat16)
    with pytest.raises(TypeError):
        tqm._w4_cuda(x.half(), packed, scales, torch.bfloat16)
    with pytest.raises(TypeError):
        tqm._w4_cuda(x, packed, scales.half(), torch.bfloat16)
    with pytest.raises(ValueError, match="shapes"):
        tqm._w4_cuda(x, packed, scales[:2], torch.bfloat16)


def test_w4_dequant_route_on_the_card(gen):
    """600 rows take JAX's dequantise route (no launch); its int8 nibble
    split (arithmetic shifts) gives the CPU's codes for every byte, and its
    f32-out product agrees with the plain version of the kernel route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    every_byte = torch.arange(-128, 128, dtype=torch.int8).reshape(256, 1)
    assert torch.equal(tqm.unpack_int4_torch(every_byte.cuda()).cpu(),
                       tqm.unpack_int4_torch(every_byte))
    packed, scales = quantize_kernel_int4(_rand(gen, (256, 512), torch.bfloat16) * 0.02)
    x = _rand(gen, (600, 512), torch.bfloat16)
    before = (tqm.w4_matmul.launches, tqm.w4_matmul_dequant.calls)
    got = tqm.w4_matmul(x, packed, scales, torch.float32)
    assert (tqm.w4_matmul.launches, tqm.w4_matmul_dequant.calls) == (before[0], before[1] + 1)
    ref = tqm.w4_matmul_reference(x, packed, scales, torch.float32)
    # the dequantised weight is rounded to bf16 once after its f32 scale
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-2 * ref.abs().max().item())
