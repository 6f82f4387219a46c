"""PyTorch port: ops/flash_attention.py.

On the CPU the port's flash_attention takes its plain version
(flash_attention_reference); it is held against the JAX package's Pallas
flash kernel run in interpret mode, o and lse both, in f32 at S <= 512 with
128-blocks. Tolerance 1e-5 relative and absolute: f32 throughout, only the
order of the softmax sums differs (online vs. one pass).

The CUDA kernel itself is compared with the plain version on a GPU by
tests/test_torch_flash_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from long_vita_tpu.ops.flash_attention import flash_attention as jax_flash
from long_vita_tpu_torch.ops import flash_attention as tfa
from long_vita_tpu_torch.ops._target import on_cuda

TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -(2.0**30)


def _qkv(seed, b, sq, skv, hq, hkv, d=64):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, hq, d)).astype(np.float32),
        rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
        rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
    )


def _compare(q, k, v, seg=None, **kw):
    jseg = {} if seg is None else dict(
        q_segment_ids=jnp.asarray(seg[0]), kv_segment_ids=jnp.asarray(seg[1])
    )
    tseg = {} if seg is None else dict(
        q_segment_ids=torch.as_tensor(seg[0]), kv_segment_ids=torch.as_tensor(seg[1])
    )
    jo, jl = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=128, block_kv=128, return_lse=True, **jseg, **kw,
    )
    before = tfa.flash_attention.launches
    to, tl = tfa.flash_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        return_lse=True, **tseg, **kw,
    )
    assert tfa.flash_attention.launches == before  # CPU: no kernel launch
    assert to.shape == q.shape and tl.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    return to.numpy(), tl.numpy()


def test_causal_self_attention_gqa():
    _compare(*_qkv(0, 2, 256, 256, 4, 2), causal=True)


def test_chunk_against_cache_offset_and_valid_len():
    """A 128-row prefill chunk at offset 256 against a 512-slot cache of
    which 384 slots are written (the serving shape, scaled down)."""
    _compare(*_qkv(1, 1, 128, 512, 4, 2), causal=True, q_offset=256, kv_valid_len=384)


def test_non_causal_ragged():
    _compare(*_qkv(2, 2, 200, 200, 2, 2), causal=False)


def test_segment_ids():
    q, k, v = _qkv(3, 2, 256, 256, 4, 2)
    seg = np.zeros((2, 256), np.int32)
    seg[0, 100:] = 1
    seg[1, 37:] = 1
    seg[1, 170:] = 2
    _compare(q, k, v, seg=(seg, seg), causal=True)


def test_empty_rows():
    """kv_valid_len = 0 empties every row; kv_offset 256 empties the first
    256 query rows (whole blocks the Pallas kernel skips): o = 0 and lse =
    -2^30 there, in both packages."""
    q, k, v = _qkv(4, 1, 256, 256, 4, 2)
    o, lse = _compare(q, k, v, causal=True, kv_valid_len=0)
    assert (o == 0).all() and (lse == NEG_INF).all()
    q, k, v = _qkv(5, 1, 384, 384, 4, 2)
    o, lse = _compare(q, k, v, causal=True, kv_offset=256)
    assert (o[:, :256] == 0).all() and (lse[:, :, :256] == NEG_INF).all()
    assert (lse[:, :, 256:] > NEG_INF).all()


def test_positions_and_vector_valid_len_follow_the_jax_contract():
    """Offsets come from element [0, 0] of the positions, kv_valid_len from
    element 0 of a [B] vector; return_lse=False returns o alone."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(6, 2, 64, 160, 4, 2))
    qpos = 70 + torch.arange(64)[None].expand(2, 64)
    kpos = torch.arange(160)[None].expand(2, 160)
    got = tfa.flash_attention(
        q, k, v, q_positions=qpos, kv_positions=kpos,
        kv_valid_len=torch.tensor([134, 9]),
    )
    want, _ = tfa.flash_attention_reference(q, k, v, q_offset=70, kv_valid_len=134)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="both"):
        tfa.flash_attention(q, k, v, q_segment_ids=torch.zeros(2, 64, dtype=torch.int32))


def test_dispatch_is_by_device():
    cpu = torch.zeros(1)
    assert on_cuda(cpu, None) is False
    with pytest.raises(ValueError, match="unsupported"):
        on_cuda(cpu, torch.zeros(1, device="meta"))



def test_tile_ranges_of_segment_ids():
    """The (min, max) segment id of each 128-row tile, which the Hopper
    forward uses to skip kv tiles: the last tile is padded with its last id."""
    seg = torch.tensor([[0] * 100 + [1] * 60 + [3] * 40, [5] * 130 + [2] * 70], dtype=torch.int32)
    got = tfa._tile_ranges(seg, 128)
    assert got.tolist() == [[[0, 1], [1, 3]], [[5, 5], [2, 5]]]
    assert tfa._tile_ranges(seg[:, :128], 128).tolist() == [[[0, 1]], [[5, 5]]]
