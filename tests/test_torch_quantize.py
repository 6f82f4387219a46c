"""PyTorch port: weight-only quantization (models/quantize.py), the quantized
projections and head (models/qwen2.py) and quantized trees through
params_from_jax, against long_vita_tpu/models/quantize.py and the JAX decoder.

The port quantizes CPU tensors to the same codes and scales as the JAX
package's numpy host quantization, bit for bit. The decoder and the head
with int8 and int4 trees agree with JAX's on the same trees in f32 at 1e-4
absolute on hidden states and logits (two layers of f32 GEMMs summed in
another order, as tests/test_torch_qwen2.py), at two geometries:
tiny_test_config() (hidden 64: the int4 groups fall back to one per packed
half, and both packages take the dequantise route) and a 128-group one
(hidden 256, ffn 512, 4/2 heads, 2 layers, vocab 512), where every int4
product takes the kernel route: K6's plain version in the port, JAX's
dequantise route off the TPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.models import qwen2 as jq
from long_vita_tpu.models.quantize import (
    quantize_weights_int4_host,
    quantize_weights_int8_host,
)
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.models.quantize import (
    PROJ_NAMES,
    quantize_weights_int4,
    quantize_weights_int8,
)
from long_vita_tpu_torch.ops import quant_matmul as tqm
from long_vita_tpu_torch.utils.convert import params_from_jax

HID = dict(rtol=0, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU tests run many small torch ops. Under the suite's
    several pytest workers, torch's default of one intra-op thread per core
    oversubscribes the machine: the engine files ran about 3x slower. Each
    module that imports this fixture runs its torch ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def g128_config():
    """A geometry whose int4 projections all tile 128-row groups."""
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, hidden_size=256, intermediate_size=512, num_attention_heads=4,
        num_key_value_heads=2, num_hidden_layers=2, vocab_size=512,
    ))


GEOMETRIES = {"tiny": tiny_test_config, "g128": g128_config}


def jax_params(cfg, seed=0):
    """JAX init, f32, with randomised norms and biases and widened kernels
    (numpy arrays)."""
    p = jq.init_qwen2_params(jax.random.PRNGKey(seed), cfg.text, dtype=jnp.float32)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 4

    return jax.tree_util.tree_map_with_path(fill, p)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def trees(request):
    cfg = GEOMETRIES[request.param]()
    p = jax_params(cfg)
    return request.param, cfg, p, params_from_jax(p, device="cpu")


def _bits_equal(a: torch.Tensor, b) -> None:
    b = np.asarray(b)
    assert a.dtype == torch.from_numpy(b).dtype and tuple(a.shape) == b.shape
    np.testing.assert_array_equal(a.numpy(), b)


def _check_int8(tp_q, jp_q):
    for i, layer in enumerate(tp_q.layers):
        for name in PROJ_NAMES:
            e, je = getattr(layer, name), jp_q["layers"][name]
            assert isinstance(e, tq.QuantDense8)
            _bits_equal(e.weight_q, np.asarray(je["kernel_q"][i]).T)
            _bits_equal(e.scale, je["scale"][i])
    _bits_equal(tp_q.lm_head.weight_q, np.asarray(jp_q["lm_head"]["kernel_q"]).T)
    _bits_equal(tp_q.lm_head.scale, jp_q["lm_head"]["scale"])


def _check_int4(tp_q, jp_q):
    for i, layer in enumerate(tp_q.layers):
        for name in PROJ_NAMES:
            e, je = getattr(layer, name), jp_q["layers"][name]
            assert isinstance(e, tq.QuantDense4)
            _bits_equal(e.packed, je["kernel_p4"][i])
            _bits_equal(e.scales, je["scale4"][i])
    _bits_equal(tp_q.lm_head.packed, jp_q["lm_head"]["kernel_p4"])
    _bits_equal(tp_q.lm_head.scales, jp_q["lm_head"]["scale4"])


def test_quantization_bit_for_bit(trees):
    """Codes and scales of every projection and the head equal the JAX host
    quantization's; biases, norms and the embedding are the input's own
    tensors; the input tree keeps its bits."""
    _, _, p, tp = trees
    before = {n: t.clone() for n, t in tp.named_parameters()}
    q8, q4 = quantize_weights_int8(tp), quantize_weights_int4(tp)
    _check_int8(q8, quantize_weights_int8_host(p))
    _check_int4(q4, quantize_weights_int4_host(p))
    for q in (q8, q4):
        assert q.embed.data_ptr() == tp.embed.data_ptr()
        assert q.final_norm.data_ptr() == tp.final_norm.data_ptr()
        assert q.layers[1].q_proj.bias.data_ptr() == tp.layers[1].q_proj.bias.data_ptr()
        assert q.layers[0].input_norm.data_ptr() == tp.layers[0].input_norm.data_ptr()
    assert all(torch.equal(t, before[n]) for n, t in tp.named_parameters())
    assert all(isinstance(getattr(tp.layers[0], n), tq.Dense) for n in PROJ_NAMES)


def test_head_false_and_longvita_trees(trees):
    _, cfg, _, tp = trees
    for fn, kind in ((quantize_weights_int8, tq.QuantDense8), (quantize_weights_int4, tq.QuantDense4)):
        q = fn(tp, head=False)
        assert q.lm_head.weight.data_ptr() == tp.lm_head.weight.data_ptr()
        assert isinstance(q.layers[0].down_proj, kind)
    from long_vita_tpu_torch.models.long_vita import LongVITAParams

    lv = LongVITAParams(text=tp, vision=torch.nn.Module(), projector=torch.nn.Module())
    q = quantize_weights_int4(lv)
    assert isinstance(q, LongVITAParams) and q.vision is lv.vision and q.projector is lv.projector
    assert isinstance(q.text.lm_head, tq.QuantDense4) and lv.text is tp
    with pytest.raises(ValueError, match="quantized already"):
        quantize_weights_int8(q)


def test_moe_trees_raise(trees):
    _, _, p, tp = trees
    with pytest.raises(ValueError, match="MoE"):
        quantize_weights_int8_host(dict(p, layers=dict(p["layers"], router={})))
    tp.layers[0].router = torch.nn.Parameter(torch.zeros(2), requires_grad=False)
    try:
        for fn in (quantize_weights_int8, quantize_weights_int4):
            with pytest.raises(ValueError, match="MoE"):
                fn(tp)
    finally:
        del tp.layers[0].router


def test_params_from_jax_carries_quantized_trees(trees):
    """The JAX host-quantized trees (stacked [L, ...]) split per layer into
    QuantDense8 / QuantDense4 with the same bits; a LongVITA-style tree and
    dtype=bf16 keep codes int8 and scales f32."""
    _, _, p, _ = trees
    j8, j4 = quantize_weights_int8_host(p), quantize_weights_int4_host(p)
    _check_int8(params_from_jax(j8, device="cpu"), j8)
    _check_int4(params_from_jax({"text": j4}, device="cpu"), j4)
    bf = params_from_jax(j4, dtype=torch.bfloat16, device="cpu")
    assert bf.layers[0].q_proj.packed.dtype == torch.int8
    assert bf.layers[0].q_proj.scales.dtype == torch.float32
    assert bf.layers[0].q_proj.bias.dtype == torch.bfloat16


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_decoder_and_head_match_jax(trees, quant):
    """A 48-token chunk into a cache, then one decode row (the kernel
    route's row count), then the head on both: hidden states, caches and
    f32 logits against the JAX decoder on the JAX-quantized tree."""
    geometry, cfg, p, tp = trees
    jp = (quantize_weights_int8_host if quant == "int8" else quantize_weights_int4_host)(p)
    jp = jax.tree.map(jnp.asarray, jp)
    tpq = (quantize_weights_int8 if quant == "int8" else quantize_weights_int4)(tp)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, cfg.text.vocab_size, size=(1, 49))
    jcache = jq.KVCache.zeros(cfg.text, 1, 64, dtype=jnp.float32)
    tcache = tq.KVCache.zeros(cfg.text, 1, 64, dtype=torch.float32)
    before = (tqm.w4_matmul_dequant.calls,)
    for piece, start in ((ids[:, :48], 0), (ids[:, 48:], 48)):
        pos = start + np.arange(piece.shape[1])[None]
        jh, jcache = jq.qwen2_decoder(
            jp, jq.embed_tokens(jp, jnp.asarray(piece)), jnp.asarray(pos), cfg.text,
            kv_cache=jcache,
        )
        th, tcache = tq.qwen2_decoder(
            tpq, tq.embed_tokens(tpq, torch.as_tensor(piece)), torch.as_tensor(pos), cfg.text,
            kv_cache=tcache,
        )
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HID)
    np.testing.assert_allclose(tcache.k[:, :, :49].numpy(), np.asarray(jcache.k)[:, :, :49], **HID)
    logits = tq.lm_head(tpq, th[:, -1])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jq.lm_head(jp, jh[:, -1])), **HID)
    # the route: at 128-row groups every int4 product takes the kernel route
    # (its plain version here); the tiny geometry's fallback groups do not
    dequant = tqm.w4_matmul_dequant.calls - before[0]
    if quant == "int4":
        assert dequant == (0 if geometry == "g128" else 2 * 7 * cfg.text.num_hidden_layers + 1)
    # quantization moves the logits and keeps them correlated with the
    # dense tree's (int4 of random weights lands at cosine ~0.9 here)
    dense = tq.lm_head(tp, tq.qwen2_decoder(
        tp, tq.embed_tokens(tp, torch.as_tensor(ids)), torch.arange(49)[None], cfg.text,
    )[0][:, -1])
    cos = torch.nn.functional.cosine_similarity(logits, dense).item()
    assert 0.5 < cos < 1.0
