"""PyTorch port: the int8 KV cache against the JAX package (CPU, f32).

quantize_kv must give JAX's int8 codes bit for bit (same f32 division, round
half to even, clip to +-127) and its scales to 1e-7 relative. The attention
functions agree to 1e-5 relative and absolute: both compute f32 logits and
an f32 softmax and round to bf16 at the same points; only summation order
differs. K2's plain version (flash_attention_quant_reference, what the
port's flash_attention_quant runs on a CPU tensor) is held against the JAX
Pallas kernel run in interpret mode at the sizes of the JAX package's own
test (sq 128, skv 256, 128-blocks), o and lse, at 1e-5.

The CUDA kernel itself is compared with its plain version on a GPU by
tests/test_torch_flash_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.models import qwen2 as jq
from long_vita_tpu.ops import attention as jatt
from long_vita_tpu.ops.flash_attention import flash_attention_quant as jax_flash_quant
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.ops import attention as tatt
from long_vita_tpu_torch.ops import flash_attention as tfa
from long_vita_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -(2.0**30)


def _quantized(rng, b, s, h, d):
    """f32 values -> (JAX codes, JAX scales) as numpy."""
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    codes, scale = jq.quantize_kv(jnp.asarray(x))
    return np.array(codes), np.array(scale)


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]  # writable copies


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_codes_bit_identical(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 37, 4, 64)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # amax 0: the 1e-8 floor
    # a row with amax 127 has scale 1 exactly, so these are exact ties:
    # round half to even gives 2, -4, 0, 0 (not 3, -3, 1, -1)
    x[1, 0, 0, :5] = [127.0, 2.5, -3.5, 0.5, -0.5]
    x[1, 0, 0, 5:] = 0.0
    want_q, want_s = jq.quantize_kv(jnp.asarray(x, dtype))
    got_q, got_s = tq.quantize_kv(torch.as_tensor(x).to(getattr(torch, dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_s.shape == (2, 37, 4, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(got_q[1, 0, 0, :5].numpy(), [127, 2, -4, 0, 0])


def test_xla_attention_quant_matches():
    """A 24-row chunk at positions 40.. and 50.. against a 96-slot int8
    cache with ragged valid lengths; q in f32 is still cast to bf16."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    kq, ks = _quantized(rng, 2, 96, 2, 16)
    vq, vs = _quantized(rng, 2, 96, 2, 16)
    qpos = np.stack([40 + np.arange(24), 50 + np.arange(24)])
    kpos = np.broadcast_to(np.arange(96), (2, 96)).copy()
    valid = np.asarray([64, 74])
    want = jatt.xla_attention_quant(
        *_j(q, kq, ks, vq, vs), q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kpos), kv_valid_len=jnp.asarray(valid),
    )
    got = tatt.xla_attention_quant(
        *_t(q, kq, ks, vq, vs), q_positions=torch.as_tensor(qpos),
        kv_positions=torch.as_tensor(kpos), kv_valid_len=torch.as_tensor(valid),
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "quant,dtype", [(False, "float32"), (False, "bfloat16"), (True, "float32")],
    ids=["f32_cache", "bf16_cache", "int8"],
)
def test_decode_attention_matches(quant, dtype):
    """One decode row per batch row at its own position and frontier. The
    bf16 cache's products follow the cache dtype in both (f32 accumulation),
    and both round o to bf16 once: 1e-2."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    pos = np.asarray([[10], [47], [63]])
    valid = pos[:, 0] + 1
    if quant:
        kq, ks = _quantized(rng, 3, 64, 2, 16)
        vq, vs = _quantized(rng, 3, 64, 2, 16)
        jk, jv, tk, tv = jnp.asarray(kq), jnp.asarray(vq), torch.as_tensor(kq), torch.as_tensor(vq)
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=torch.as_tensor(ks), v_scale=torch.as_tensor(vs))
    else:
        k = rng.standard_normal((3, 64, 2, 16)).astype(np.float32)
        v = rng.standard_normal((3, 64, 2, 16)).astype(np.float32)
        jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
        tk, tv = (torch.as_tensor(x).to(getattr(torch, dtype)) for x in (k, v))
        jsc, tsc = {}, {}
    want = jatt.decode_attention(
        jnp.asarray(q, dtype), jk, jv, q_positions=jnp.asarray(pos),
        kv_valid_len=jnp.asarray(valid), **jsc,
    )
    got = tatt.decode_attention(
        torch.as_tensor(q).to(getattr(torch, dtype)), tk, tv, q_positions=torch.as_tensor(pos),
        kv_valid_len=torch.as_tensor(valid), **tsc,
    )
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    with pytest.raises(ValueError, match="Sq == 1"):
        tatt.decode_attention(
            torch.zeros(1, 2, 8, 16), tk[:1], tv[:1],
            q_positions=torch.zeros(1, 2, dtype=torch.long),
            kv_valid_len=torch.ones(1, dtype=torch.long),
        )


def test_quant_prefill_attention_cpu_path():
    """On the CPU (and for any chunk under 128 rows) the int8 prefill
    dequantises to q's dtype and takes xla_attention, as JAX off the TPU."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 40, 4, 16)).astype(np.float32)
    kq, ks = _quantized(rng, 1, 128, 2, 16)
    vq, vs = _quantized(rng, 1, 128, 2, 16)
    qpos = (60 + np.arange(40))[None]
    valid = np.asarray([100])
    want = jatt.quant_prefill_attention(
        *_j(q, kq, ks, vq, vs), q_positions=jnp.asarray(qpos), kv_valid_len=jnp.asarray(valid)
    )
    before = tfa.flash_attention_quant.launches
    got = tatt.quant_prefill_attention(
        *_t(q, kq, ks, vq, vs), q_positions=torch.as_tensor(qpos),
        kv_valid_len=torch.as_tensor(valid),
    )
    assert tfa.flash_attention_quant.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _compare_flash_quant(q, kq, ks, vq, vs, **kw):
    jo, jl = jax_flash_quant(
        *_j(q, kq, ks, vq, vs), block_q=128, block_kv=128, return_lse=True, **kw
    )
    before = tfa.flash_attention_quant.launches
    to, tl = tfa.flash_attention_quant(*_t(q, kq, ks, vq, vs), return_lse=True, **kw)
    assert tfa.flash_attention_quant.launches == before  # CPU: no kernel launch
    assert to.shape == q.shape and tl.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    return to.numpy(), tl.numpy()


@pytest.fixture(scope="module")
def quant_inputs():
    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 128, 4, 64)).astype(np.float32)
    kq, ks = _quantized(rng, 1, 256, 2, 64)
    vq, vs = _quantized(rng, 1, 256, 2, 64)
    return q, kq, ks, vq, vs


def test_flash_quant_reference_chunk_against_cache(quant_inputs):
    """A 128-row chunk at offset 128 against a 256-slot cache of which 200
    slots are valid (the serving shape, scaled down; GQA 4/2)."""
    _compare_flash_quant(*quant_inputs, q_offset=128, kv_valid_len=200)


def test_flash_quant_reference_empty_rows(quant_inputs):
    """kv_valid_len = 0, and a cache that starts after every query
    (kv_offset 1024): every row is empty, o = 0 and lse = -2^30 in both."""
    for kw in (dict(q_offset=128, kv_valid_len=0), dict(q_offset=128, kv_offset=1024)):
        o, lse = _compare_flash_quant(*quant_inputs, **kw)
        assert (o == 0).all() and (lse == NEG_INF).all()


def test_flash_quant_reference_follows_kernel_order(quant_inputs):
    """The plain version is K2's order (scale after the dot, p * v_scale cast
    to q's dtype before P.V), which for a bf16 q differs from dequantising
    the cache first only by bf16 rounding; a [B] kv_valid_len reads element
    0, and return_lse=False returns o alone."""
    q, kq, ks, vq, vs = _t(*quant_inputs)
    qb = q.to(torch.bfloat16)
    got = tfa.flash_attention_quant(
        qb, kq, ks, vq, vs, q_offset=128, kv_valid_len=torch.tensor([200, 3])
    )
    assert got.dtype == torch.bfloat16
    deq = tatt.quant_prefill_attention(
        qb, kq, ks, vq, vs, q_positions=128 + torch.arange(128)[None],
        kv_valid_len=torch.tensor([200]),
    )
    torch.testing.assert_close(got.float(), deq.float(), atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module")
def tiny_decoder():
    """The tiny JAX decoder with randomised norms and biases, and its port."""
    cfg = tiny_test_config()
    p = jq.init_qwen2_params(jax.random.PRNGKey(0), cfg.text)
    rng = np.random.default_rng(0)

    def fill(path, a):
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    p = jax.tree_util.tree_map_with_path(fill, p)
    return cfg, p, params_from_jax(p, device="cpu")


def test_decoder_with_int8_cache_matches(tiny_decoder):
    """Two 40-token chunks into an int8 cache, then one ragged decode row per
    batch row: hidden states match the JAX decoder, and the cache's codes
    and scales match the JAX cache's.

    Codes come from each framework's own k/v projections, which differ in
    the last f32 bits; a value within that of a rounding boundary may land
    one code apart, so codes may differ by at most 1 (and rarely), and the
    hidden states get 1e-4 (one code is 1/127 of a row's amax)."""
    cfg, p, tp = tiny_decoder
    rng = np.random.default_rng(4)
    b = 2
    ids = rng.integers(0, cfg.text.vocab_size, size=(b, 80))
    jc = jq.KVCache.zeros(cfg.text, b, 128, quantize=True)
    tc = tq.KVCache.zeros(cfg.text, b, 128, quantize=True)
    assert tc.quantized and tc.k.dtype == torch.int8 and tc.k_scale.shape == (2, b, 128, 2, 1)
    for start in (0, 40):
        piece = ids[:, start : start + 40]
        pos = np.broadcast_to(start + np.arange(40), (b, 40)).copy()
        jh, jc = jq.qwen2_decoder(
            p, jq.embed_tokens(p, jnp.asarray(piece)), jnp.asarray(pos), cfg.text, kv_cache=jc
        )
        th, tc = tq.qwen2_decoder(
            tp, tq.embed_tokens(tp, torch.as_tensor(piece)), torch.as_tensor(pos),
            cfg.text, kv_cache=tc,
        )
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    assert tc.length == 80 and tc.quantized
    # a ragged decode step: rows at frontiers 77 and 80
    lengths = np.asarray([77, 80])
    tok = rng.integers(0, cfg.text.vocab_size, size=(b, 1))
    jc = jq.KVCache(jc.k, jc.v, jnp.asarray(lengths), jc.k_scale, jc.v_scale)
    tc = tq.KVCache(tc.k, tc.v, torch.as_tensor(lengths), tc.k_scale, tc.v_scale)
    jh, jc = jq.qwen2_decoder(
        p, jq.embed_tokens(p, jnp.asarray(tok)), jnp.asarray(lengths[:, None]), cfg.text, kv_cache=jc
    )
    th, tc = tq.qwen2_decoder(
        tp, tq.embed_tokens(tp, torch.as_tensor(tok)), torch.as_tensor(lengths[:, None]),
        cfg.text, kv_cache=tc,
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tc.length.numpy(), lengths + 1)
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=1e-5, atol=0)
    np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale), rtol=1e-5, atol=0)
