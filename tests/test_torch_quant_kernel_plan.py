"""PyTorch port: how the Hopper kernels K6 (w4a16, csrc/w4_matmul.cu) and K2
(int8-cache flash forward, csrc/flash_fwd_quant.cu) are cut and launched,
on the CPU.

K6 cuts its (row tile, column tile, group pair) units into one contiguous
range a block and sums a tile that spans blocks in block order.
``w4_split_plan`` is that cut in Python; hypothesis draws shapes and SM
counts and holds it to its rules (exact, integer). The plain version in
the kernel's order (``w4_matmul_split_reference``) agrees with
``w4_matmul_reference`` and with the JAX Pallas kernel in interpret mode in
f32 within 1e-5 relative (the same products, partial sums added in another
order) and gives the same bits twice. Last, the launch arguments K2's
wrapper prepares for a strided cache slice, and what it rejects before
anything is allocated.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from long_vita_tpu.ops import quant_matmul as jq
from long_vita_tpu_torch.ops import flash_attention as tfa
from long_vita_tpu_torch.ops import quant_matmul as tq

REL = 1e-5


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 512), n_in=st.integers(1, 56).map(lambda g: 256 * g),
       n_out=st.integers(1, 160).map(lambda c: 128 * c), sms=st.integers(1, 200))
def test_w4_split_plan_covers_every_unit_once_in_block_order(rows, n_in, n_out, sms):
    shape, segments = tq.w4_split_plan(rows, n_in, n_out, sms)
    # the row tile: the fewest of 8..64 rows that hold them, else tiles of 128
    assert shape.n in tq.KERNEL_ROW_TILES and (shape.n >= rows or shape.n == 128)
    assert shape.n == 8 or rows > shape.n // 2
    assert shape.row_tiles == -(-rows // shape.n) and shape.col_tiles == n_out // 128
    assert shape.pairs == n_in // 256
    assert shape.blocks == max(1, min(sms, shape.units // tq.MIN_UNITS_A_BLOCK))
    covered = np.zeros((shape.tiles, shape.pairs), np.int32)
    by_block = {}
    for tile, segs in enumerate(segments):
        # the reduction order: blocks in increasing order, their pairs
        # contiguous from 0 to the last pair
        assert [b for b, *_ in segs] == sorted({b for b, *_ in segs})
        assert segs[0][2] == 0 and segs[-1][3] == shape.pairs
        for (_, _, _, p1), (_, _, p0, _) in zip(segs, segs[1:]):
            assert p1 == p0
        for b, slot, p0, p1 in segs:
            assert p0 < p1
            covered[tile, p0:p1] += 1
            by_block.setdefault(b, []).append((tile * shape.pairs + p0, tile * shape.pairs + p1,
                                               tile, slot))
    assert (covered == 1).all()
    assert sorted(by_block) == list(range(shape.blocks))
    for b, segs in by_block.items():
        # each block walks its own range in order, and only it
        u0, u1 = tq.w4_block_units(b, shape)
        assert u0 < u1 and [s[0] for s in segs] == sorted(s[0] for s in segs)
        assert segs[0][0] == u0 and segs[-1][1] == u1
        assert all(a[1] == c[0] for a, c in zip(segs, segs[1:]))
        # slot 0 for the block's first tile, 1 for the others: the partial
        # slots of the tiles it shares are distinct
        first = u0 // shape.pairs
        assert [slot for *_, tile, slot in segs] == [int(tile != first) for *_, tile, _ in segs]
        shared = [slot for u, e, tile, slot in segs if len(segments[tile]) > 1]
        assert len(shared) == len(set(shared))
    counters = -(-shape.tiles * 2 * 4 // 256) * 256
    assert tq.w4_workspace_bytes(shape) == counters + shape.blocks * 2 * 2 * 128 * shape.n * 2


@pytest.mark.parametrize("rows,n_in,n_out,sms", [
    (1, 2048, 512, 7), (5, 1536, 640, 4), (70, 2048, 384, 4), (200, 1024, 256, 3)])
def test_w4_split_reference_matches_plain_and_pallas(rows, n_in, n_out, sms):
    """f32: SM counts that split tiles over blocks, a ragged row tile and
    two row tiles of 128."""
    w = np.random.default_rng(rows).standard_normal((n_in, n_out)).astype(np.float32)
    packed, scales = jq.quantize_int4_grouped(w)
    x = np.random.default_rng(rows + 1).standard_normal((rows, n_in)).astype(np.float32)
    want = np.asarray(jq.w4_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                                   interpret=True))
    args = (torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(scales))
    shape, segments = tq.w4_split_plan(rows, n_in, n_out, sms)
    assert any(len(s) > 1 for s in segments)
    got = tq.w4_matmul_split_reference(*args, torch.float32, sms)
    plain = tq.w4_matmul_reference(*args, torch.float32)
    for ref in (plain.numpy(), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=REL, atol=REL * np.abs(ref).max())
    assert torch.equal(got, tq.w4_matmul_split_reference(*args, torch.float32, sms))


def test_flash_quant_args_strided_cache_slice():
    """K2's launch arguments for a 300-row chunk of two batch rows against a
    slice of a longer int8 cache and its scales: the caller's strides (no
    copy), the mask scalars on the device, q tiles of 128 rows."""
    b, sq, hq, hkv, d = 2, 300, 10, 2, 128
    q = torch.randn(b, sq, hq, d).to(torch.bfloat16)
    cache = torch.zeros(b, 1024, hkv, d, dtype=torch.int8)
    scales = torch.ones(b, 1024, hkv, 1)
    k, ks = cache[:, :700], scales[:, :700]
    o, lse, args = tfa.flash_quant_args(q, k, ks, k, ks, 350, 0, 600)
    assert o.shape == q.shape and o.dtype == torch.bfloat16 and lse.shape == (b, hq, sq)
    assert args[:8][1].data_ptr() == cache.data_ptr() and args[3].data_ptr() == scales.data_ptr()
    assert args[7].tolist() == [350, 0, 600] and args[7].dtype == torch.int32
    assert args[8:16] == (sq * hq * d, hq * d, 1024 * hkv * d, hkv * d, 1024 * hkv * d, hkv * d,
                          sq * hq * d, hq * d)
    assert args[16:22] == (1024 * hkv, hkv, 1) * 2
    assert args[22:28] == (b, sq, 700, hq, hkv, d) and args[28] == pytest.approx(d ** -0.5)
    assert len(args) + 1 == len(tfa._build.argtypes("lvt_flash_fwd_quant"))
    assert tfa.SM90_QUANT_BLOCK_Q == 128


def test_flash_quant_args_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 128, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 256, 2, 128, dtype=torch.int8)
    ks = torch.ones(1, 256, 2, 1)
    with pytest.raises(TypeError):
        tfa.flash_quant_args(q.float(), k, ks, k, ks, 0, 0, 256)
    with pytest.raises(TypeError, match="float32"):
        tfa.flash_quant_args(q, k, ks.half(), k, ks, 0, 0, 256)
    with pytest.raises(ValueError, match="scales"):
        tfa.flash_quant_args(q, k, ks[:, :64], k, ks, 0, 0, 256)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(1, 256, 2, 96, dtype=torch.int8)
        tfa.flash_quant_args(torch.zeros(1, 128, 4, 96, dtype=torch.bfloat16), x, ks, x, ks, 0, 0, 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kv = torch.zeros(1 * 256 * 2 * 128 + 8, dtype=torch.int8)[8:].view(1, 256, 2, 128)
        tfa.flash_quant_args(q, kv, ks, kv, ks, 0, 0, 256)
    # the causal grid (Hq, B, q tiles of 128): y and z at most 65535
    x = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    k1, s1 = torch.zeros(1, 64, 1, 64, dtype=torch.int8), torch.ones(1, 64, 1, 1)
    with pytest.raises(ValueError, match="batch rows"):
        qb = x.expand(65536, 8, 1, 64)
        tfa.flash_quant_args(qb, k1.expand(65536, 64, 1, 64), s1.expand(65536, 64, 1, 1),
                             k1.expand(65536, 64, 1, 64), s1.expand(65536, 64, 1, 1), 0, 0, 64)
    with pytest.raises(ValueError, match="tiles of 128"):
        tfa.flash_quant_args(x.expand(1, 65535 * 128 + 1, 1, 64), k1, s1, k1, s1, 0, 0, 64)
