"""PyTorch port: models/qwen2.py and utils/convert.py against the JAX decoder.

Weights come from the JAX initializer, with biases and norm weights
randomised in numpy (the initializer leaves them at 0 and 1, which would let
a bias or norm bug pass), and cross to the port through params_from_jax.
Tolerances, f32 on the CPU: 1e-4 absolute on hidden states and KV caches
(two layers of f32 GEMMs in another summation order), 1e-5 relative on ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.models import qwen2 as jq
from long_vita_tpu_torch.models import qwen2 as tq
from long_vita_tpu_torch.utils.convert import params_from_jax

HID = dict(rtol=0, atol=1e-4)


def _jax_params(cfg, seed=0, dtype=jnp.float32):
    """JAX init with randomised biases and norms, as numpy arrays."""
    p = jq.init_qwen2_params(jax.random.PRNGKey(seed), cfg.text, dtype=dtype)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fill, p)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    p = _jax_params(cfg)
    return cfg, p, params_from_jax(p, device="cpu")


def test_params_from_jax_layout_and_bf16_bits():
    cfg = tiny_test_config()
    p = _jax_params(cfg, seed=1, dtype=jnp.bfloat16)
    tp = params_from_jax(p, device="cpu")
    assert len(tp.layers) == cfg.text.num_hidden_layers
    assert tp.embed.dtype == torch.bfloat16

    def bits(t):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)

    kernel = np.asarray(p["layers"]["q_proj"]["kernel"][1])  # [in, out]
    np.testing.assert_array_equal(bits(tp.layers[1].q_proj.weight), kernel.T.view(np.uint16))
    np.testing.assert_array_equal(
        bits(tp.layers[0].k_proj.bias), np.asarray(p["layers"]["k_proj"]["bias"][0]).view(np.uint16)
    )
    np.testing.assert_array_equal(
        bits(tp.lm_head.weight), np.asarray(p["lm_head"]["kernel"]).T.view(np.uint16)
    )
    # a LongVITA tree with a "text" entry converts the same way
    assert torch.equal(params_from_jax({"text": p}, device="cpu").final_norm, tp.final_norm)
    f32 = params_from_jax(p, dtype=torch.float32, device="cpu")
    assert f32.layers[0].up_proj.weight.dtype == torch.float32


def test_params_from_jax_refuses_quantized_entries():
    """Quantized serving trees now come across (tests/test_torch_quantize.py
    holds them bit for bit), and so do entries carrying LoRA adapters: a
    layer's slice of {"a": [L, in, r], "b": [L, r, out]} becomes the
    projection's LoraAdapter in the same layout (tests/test_torch_lora.py
    holds the adapted model to JAX's)."""
    cfg = tiny_test_config()
    p = _jax_params(cfg)
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 64, 4), np.float32), rng.standard_normal((2, 4, 64), np.float32)
    p["layers"]["q_proj"]["lora"] = {"a": a, "b": b}
    layers = params_from_jax(p, device="cpu").layers
    for i in range(2):
        assert torch.equal(layers[i].q_proj.lora.a, torch.from_numpy(a[i]))
        assert torch.equal(layers[i].q_proj.lora.b, torch.from_numpy(b[i]))
        assert layers[i].k_proj.lora is None
    p = _jax_params(cfg)
    entry = p["layers"]["q_proj"]
    kernel = np.asarray(entry.pop("kernel"))
    entry["kernel_q"] = np.zeros(kernel.shape, np.int8)
    entry["scale"] = np.ones(kernel.shape[::2], np.float32)  # [L, out]
    assert isinstance(params_from_jax(p, device="cpu").layers[0].q_proj, tq.QuantDense8)


@pytest.mark.parametrize("name", [
    "params_from_jax", "vision_params_from_jax", "projector_params_from_jax",
    "long_vita_params_from_jax",
])
def test_conversion_defaults_to_the_card(monkeypatch, name):
    """Without device=, the weights go to the card; with no card that
    raises instead of quietly building host tensors."""
    from long_vita_tpu_torch.utils import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"text": {}, "vision": {}, "projector": {}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(convert, name)(tree)


def test_conversion_to_the_cpu_keeps_every_bit():
    """device="cpu" gives host tensors equal bit for bit to the JAX arrays."""
    cfg = tiny_test_config()
    p = _jax_params(cfg, seed=3, dtype=jnp.bfloat16)
    tp = params_from_jax(p, device="cpu")
    assert all(t.device.type == "cpu" for t in tp.parameters())

    def bits(t):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)

    layers = p["layers"]
    for i, layer in enumerate(tp.layers):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
            kernel = np.asarray(layers[name]["kernel"][i]).T
            np.testing.assert_array_equal(bits(getattr(layer, name).weight), kernel.view(np.uint16))
        for name in ("input_norm", "post_attn_norm"):
            np.testing.assert_array_equal(
                bits(getattr(layer, name)), np.asarray(layers[name][i]).view(np.uint16)
            )
    np.testing.assert_array_equal(
        bits(tp.embed), np.asarray(p["embed"]["embedding"]).view(np.uint16)
    )
    np.testing.assert_array_equal(bits(tp.final_norm), np.asarray(p["final_norm"]).view(np.uint16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    want = jq.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype), 1e-6)
    dt = getattr(torch, dtype)
    got = tq.rms_norm(torch.as_tensor(x).to(dt), torch.as_tensor(w).to(dt), 1e-6)
    assert got.dtype == dt
    # bf16: both round the same f32 normalisation once, then multiply in bf16
    rtol = 1e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_decoder_packed_segments_match(model, attn_impl):
    """Packed batch: positions restart in each segment; the port runs its
    plain attention ("xla") or the flash kernel's plain version ("flash")."""
    cfg, p, tp = model
    rng = np.random.default_rng(3)
    b, s, h = 2, 48, cfg.text.hidden_size
    embeds = rng.standard_normal((b, s, h)).astype(np.float32)
    seg = np.zeros((b, s), np.int32)
    seg[0, 20:] = 1
    seg[1, 7:] = 1
    seg[1, 30:] = 2
    pos = np.zeros((b, s), np.int64)
    for r in range(b):
        for sid in np.unique(seg[r]):
            idx = np.nonzero(seg[r] == sid)[0]
            pos[r, idx] = np.arange(len(idx))
    want, _ = jq.qwen2_decoder(
        p, jnp.asarray(embeds), jnp.asarray(pos), cfg.text,
        segment_ids=jnp.asarray(seg), attn_impl="xla",
    )
    got, cache = tq.qwen2_decoder(
        tp, torch.as_tensor(embeds), torch.as_tensor(pos), cfg.text,
        segment_ids=torch.as_tensor(seg), attn_impl=attn_impl,
    )
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HID)


def test_chunked_cached_prefill_matches(model):
    """Two 40-token chunks into a 128-slot cache: hidden states and cache
    contents match JAX chunk by chunk, and the chunked hidden states match
    the no-cache forward of the whole 80 tokens."""
    cfg, p, tp = model
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.text.vocab_size, size=(1, 80))
    jcache = jq.KVCache.zeros(cfg.text, 1, 128, dtype=jnp.float32)
    tcache = tq.KVCache.zeros(cfg.text, 1, 128, dtype=torch.float32)
    chunks = []
    for start in (0, 40):
        piece = ids[:, start : start + 40]
        pos = start + np.arange(40)[None]
        jh, jcache = jq.qwen2_decoder(
            p, jq.embed_tokens(p, jnp.asarray(piece)), jnp.asarray(pos),
            cfg.text, kv_cache=jcache,
        )
        th, tcache = tq.qwen2_decoder(
            tp, tq.embed_tokens(tp, torch.as_tensor(piece)), torch.as_tensor(pos),
            cfg.text, kv_cache=tcache,
        )
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HID)
        chunks.append(th)
    assert tcache.length == 80 and int(jcache.length) == 80
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **HID)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), **HID)
    full, _ = tq.qwen2_decoder(
        tp, tq.embed_tokens(tp, torch.as_tensor(ids)),
        torch.arange(80)[None], cfg.text,
    )
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(), full.numpy(), **HID)


@pytest.mark.parametrize("s", [1, 2])
def test_ragged_cache_write_drops_out_of_range(model, s):
    """A [B] cache length: each row writes at its own frontier; the row at
    capacity (16 of 16 slots) and the second token of the row at 15 fall
    past the buffer and are dropped, as JAX's mode="drop" scatter does."""
    cfg, p, tp = model
    rng = np.random.default_rng(5)
    lengths = np.asarray([3, 15, 16])
    shape = (cfg.text.num_hidden_layers, 3, 16, cfg.text.num_key_value_heads, cfg.text.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(0, cfg.text.vocab_size, size=(3, s))
    pos = lengths[:, None] + np.arange(s)[None]
    jh, jc = jq.qwen2_decoder(
        p, jq.embed_tokens(p, jnp.asarray(ids)), jnp.asarray(pos), cfg.text,
        kv_cache=jq.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(lengths)),
    )
    tk, tv = torch.as_tensor(k0.copy()), torch.as_tensor(v0.copy())
    th, tc = tq.qwen2_decoder(
        tp, tq.embed_tokens(tp, torch.as_tensor(ids)), torch.as_tensor(pos), cfg.text,
        kv_cache=tq.KVCache(tk, tv, torch.as_tensor(lengths)),
    )
    assert tc.k is tk  # written in place
    np.testing.assert_array_equal(tc.length.numpy(), lengths + s)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HID)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jc.k), **HID)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jc.v), **HID)
    np.testing.assert_array_equal(tk[:, 2].numpy(), k0[:, 2])  # row at capacity untouched


def test_lm_head_gives_f32_logits(model):
    """bf16 hidden and head -> f32 logits, as the JAX head's
    preferred_element_type=f32 (no bf16 rounding of the logits)."""
    cfg, _, _ = model
    p = _jax_params(cfg, seed=6, dtype=jnp.bfloat16)
    tp = params_from_jax(p, device="cpu")
    rng = np.random.default_rng(6)
    hid = rng.standard_normal((2, 3, cfg.text.hidden_size)).astype(np.float32)
    want = jq.lm_head(p, jnp.asarray(hid, jnp.bfloat16))
    got = tq.lm_head(tp, torch.as_tensor(hid).to(torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_init_qwen2_params_is_seeded():
    cfg = tiny_test_config()
    a = tq.init_qwen2_params(torch.Generator().manual_seed(0), cfg.text, dtype=torch.bfloat16)
    b = tq.init_qwen2_params(torch.Generator().manual_seed(0), cfg.text, dtype=torch.bfloat16)
    h, v = cfg.text.hidden_size, cfg.text.vocab_size
    assert a.embed.shape == (v, h) and a.lm_head.weight.shape == (v, h)
    assert a.layers[0].q_proj.weight.shape == (cfg.text.num_attention_heads * cfg.text.head_dim, h)
    assert a.layers[1].down_proj.weight.shape == (h, cfg.text.intermediate_size)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not any(x.requires_grad for x in a.parameters())
    assert torch.count_nonzero(a.layers[0].v_proj.bias) == 0
    assert torch.all(a.final_norm == 1)
    # a MoE layer carries a router and its experts in place of the dense MLP
    moe = tq.init_qwen2_params(torch.Generator().manual_seed(0),
                               tiny_test_config(num_experts=4).text)
    i = cfg.text.intermediate_size
    assert moe.layers[0].router.weight.shape == (4, h)
    assert moe.layers[1].experts.gate.shape == (4, h, i)
    assert moe.layers[1].experts.down.shape == (4, i, h)
    assert not hasattr(moe.layers[0], "gate_proj")
