"""PyTorch port: the serving slice as a whole, inference/engine.py against the
JAX InferenceEngine (f32 on the CPU, max_seq_len 512, chunk 64).

Greedy tokens must be identical. Last-row hidden states agree to 1e-4
absolute and logprobs to 1e-4 absolute (f32 GEMMs summed in another order
through two layers, then a log-softmax over 512 logits). With the int8 cache
the codes come from each framework's own k/v, which differ in the last f32
bits, so a value on a rounding boundary may land one code apart: logprobs
there get 1e-3.

Media: a stub multimodal tokenizer lays out image and video blocks as
long_vita_tpu/data/multimodal.py does, on pre-made 56-pixel tiles. The JAX
engine's per-chunk scatter (`_embed_chunk_impl`) wraps a negative chunk
offset into the chunk (JAX normalises negative indices before mode="drop"),
so a feature row one chunk back lands on the current chunk's token at the
same offset. The port drops it. The parity prompts keep every media row
within one chunk of the prompt's end (_check_no_wrap), where the two agree;
test_chunk_scatter_drops_other_chunks_rows shows the difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.data.multimodal import ExpandedInputs
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models.long_vita import init_long_vita_params, long_vita_forward
from long_vita_tpu.models.qwen2 import init_qwen2_params
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.parallel.comm import LocalComm
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax, params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401

TOL = dict(rtol=0, atol=1e-4)
QUANT_TOL = dict(rtol=0, atol=1e-3)


class _Tok:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in ids)


# token ids of the stub tokenizer's special tokens: the expansion's lie in
# the tiny vocabulary (media prompts draw text ids below 480); the tags are
# replaced by the expansion and lie past it, so no text prompt holds one
IMG_START, IMG_CTX, IMG_END, VID_START, VID_CTX, VID_END = range(480, 486)
PATCH_START, PATCH_CTX, PATCH_END, NL = range(486, 490)
IMG_TAG, VID_TAG = 1000, 1001


class _MM:
    """The duck-typed multimodal tokenizer of tests/test_quant_quality.py,
    with the tag expansion laid out as long_vita_tpu/data/multimodal.py
    does it, on pre-made tiles: an image is (tiles [1 + rows * cols, s, s,
    3], (rows, cols)), the thumbnail first; a video is frames [F, s, s, 3].
    One pass in prompt order (the parity prompts put images before videos,
    where it equals the tokenizer's two passes)."""

    tokenizer = _Tok()

    def __init__(self, t: int = 4):
        self.t = t

    def encode_chat(self, messages):  # a "tokenizer" of space-separated ids
        return [int(t) for m in messages for t in m["content"].split()]

    def _block(self, ids, start, ctx, end, indices):
        ids.append(start)
        seq = np.arange(len(ids), len(ids) + self.t, dtype=np.int64)
        indices.append(np.stack([np.zeros(self.t, np.int64), seq]))
        ids.extend([ctx] * self.t)
        ids.append(end)

    def expand(self, input_ids, images=(), videos=(), labels=None, max_num_frame=None):
        images, videos = list(images), list(videos)
        ids, stacks, indices = [], [], []
        for tok in input_ids:
            if tok == IMG_TAG:
                tiles, (rows, cols) = images.pop(0)
                stacks.append(tiles)
                self._block(ids, IMG_START, IMG_CTX, IMG_END, indices)
                if len(tiles) > 1:
                    for _ in range(rows):
                        ids.append(NL)
                        for _ in range(cols):
                            self._block(ids, PATCH_START, PATCH_CTX, PATCH_END, indices)
            elif tok == VID_TAG:
                frames = videos.pop(0)
                stacks.append(frames)
                for _ in range(len(frames)):
                    self._block(ids, VID_START, VID_CTX, VID_END, indices)
            else:
                ids.append(int(tok))
        if not stacks:
            return ExpandedInputs(ids, None, None)
        return ExpandedInputs(ids, np.concatenate(stacks), np.stack(indices, axis=1))



@pytest.fixture(scope="module")
def engines():
    cfg = tiny_test_config()
    p = init_qwen2_params(jax.random.PRNGKey(0), cfg.text)
    rng = np.random.default_rng(0)

    def fill(path, a):  # randomise norms and biases; widen the kernels
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 4

    p = jax.tree_util.tree_map_with_path(fill, p)
    kw = dict(max_seq_len=512, chunk=64, decode_segment=8)
    jax_eng = JaxEngine({"text": p}, cfg, _MM(), cache_dtype=jnp.float32, **kw)
    port = InferenceEngine(params_from_jax(p, device="cpu"), cfg, _MM(), cache_dtype=torch.float32, **kw)
    return jax_eng, port, cfg


def test_generate_greedy_tokens_identical(engines):
    jax_eng, port, cfg = engines
    prompt = np.random.default_rng(1).integers(0, cfg.text.vocab_size, 150).tolist()
    want = jax_eng.generate(input_ids=prompt, sampling=JaxSP(max_new_tokens=20, return_logprobs=True))
    got = port.generate(input_ids=prompt, sampling=SamplingParams(max_new_tokens=20, return_logprobs=True))
    assert got.token_ids == want.token_ids
    assert len(set(got.token_ids)) > 3, got.token_ids  # not a degenerate loop
    assert got.prompt_tokens == want.prompt_tokens == 150
    assert got.text == want.text
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)


def test_prefill_last_row_matches(engines):
    """150 ids: three chunks, then the last-row recompute (150 is not a
    chunk multiple); the incremental API gives the same as prefill()."""
    jax_eng, port, cfg = engines
    prompt = np.random.default_rng(2).integers(0, cfg.text.vocab_size, 150).tolist()
    _, want, _ = jax_eng.prefill(prompt)
    cache, got, n = port.prefill(prompt)
    assert n == 150 and cache.length == 150
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    job = port.start_prefill(prompt)
    steps = 0
    while not port.prefill_step(job):
        steps += 1
    assert steps + 1 == 3
    _, inc, _ = port.finish_prefill(job)
    np.testing.assert_allclose(inc.numpy(), got.numpy(), rtol=0, atol=0)


def test_generate_batch_ragged_identical(engines):
    jax_eng, port, cfg = engines
    rng = np.random.default_rng(3)
    reqs = [{"input_ids": rng.integers(0, cfg.text.vocab_size, n).tolist()} for n in (40, 150, 100)]
    want = jax_eng.generate_batch(reqs, sampling=JaxSP(max_new_tokens=12, return_logprobs=True))
    got = port.generate_batch(reqs, sampling=SamplingParams(max_new_tokens=12, return_logprobs=True))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.prompt_tokens for r in got] == [40, 150, 100]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, **TOL)
    # a stop token cuts each row where it first appears, in both engines
    stop = got[0].token_ids[4]
    want = jax_eng.generate_batch(reqs, sampling=JaxSP(max_new_tokens=12, stop_token_ids=(stop,)))
    got = port.generate_batch(reqs, sampling=SamplingParams(max_new_tokens=12, stop_token_ids=(stop,)))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert len(got[0].token_ids) <= 4


def test_messages_go_through_the_tokenizer(engines):
    _, port, _ = engines
    msgs = [{"role": "user", "content": " ".join(map(str, range(3, 90)))}]
    sp = SamplingParams(max_new_tokens=6)
    want = port.generate(input_ids=list(range(3, 90)), sampling=sp).token_ids
    assert port.generate(msgs, sampling=sp).token_ids == want
    assert port.generate_batch([{"messages": msgs}], sampling=sp)[0].token_ids == want


def test_sampled_generate_is_seeded(engines):
    _, port, cfg = engines
    prompt = list(range(70))
    sp = SamplingParams(greedy=False, temperature=0.7, top_p=0.9, max_new_tokens=10)
    a = port.generate(input_ids=prompt, sampling=sp, seed=5)
    b = port.generate(input_ids=prompt, sampling=sp, seed=5)
    assert a.token_ids == b.token_ids and len(a.token_ids) == 10
    assert all(0 <= t < cfg.text.vocab_size for t in a.token_ids)


@pytest.mark.parametrize("kw,item", [(dict(mesh_cfg=MeshConfig(pp=2)), "training only")])
def test_later_slices_raise(engines, kw, item):
    """cp and tp meshes serve (tests/test_torch_cp_engine.py,
    test_torch_tp_engine.py); a pipeline one raises: pp runs in training
    only, as in the JAX package, whose engine takes a tp x cp mesh."""
    from long_vita_tpu_torch.parallel.comm import ThreadComm

    _, port, cfg = engines
    with pytest.raises(NotImplementedError, match=item):
        InferenceEngine(port.params, cfg, _MM(),
                        mesh=make_mesh(kw["mesh_cfg"], ThreadComm.group(2)[0]))


@pytest.mark.parametrize(
    "kw,attr,value",
    [
        (dict(interleave_encode=True), "interleave_encode", True),
        (dict(weight_quant="int8"), "weight_quant", "int8"),
        (dict(prefix_cache_entries=4), "prefix_cache", 4),
        (dict(speculative_k=4), "speculative_k", 4),
    ],
)
def test_engine_options_of_later_slices_are_accepted(engines, kw, attr, value):
    """The options that raised before their slices were ported: the engine
    takes them (their behaviour is held against the JAX engine in
    test_torch_engine_quant, test_torch_speculative and
    test_torch_prefix_cache)."""
    _, port, cfg = engines
    eng = InferenceEngine(port.params, cfg, _MM(), **kw)
    got = getattr(eng, attr)
    assert (got.max_entries if attr == "prefix_cache" else got) == value


# ---- media and the int8 cache ----------------------------------------------

def _check_no_wrap(mm, input_ids, images=(), videos=(), chunk=64):
    """Every feature row sits within one chunk of the prompt's end, so the
    JAX engine's wrapped scatter (see the module docstring) lands past it."""
    e = mm.expand(input_ids, images=images, videos=videos)
    assert (e.image_indices[1] + chunk >= len(e.input_ids)).all()
    return e


@pytest.fixture(scope="module")
def media_engines():
    """JAX and port engines, bf16-layout cache in f32 and int8 cache, over
    one LongVITA tree. vision_chunk 3 and transfer_chunk 4 make a stack of 5
    or 7 tiles encode in padded pieces and partial ViT batches."""
    cfg = tiny_test_config()
    p = init_long_vita_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(1)

    def fill(path, a):  # randomise norms, biases, layer scales; widen kernels
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name or "ls1" in name or "ls2" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 4

    p = jax.tree.map(jnp.asarray, jax.tree_util.tree_map_with_path(fill, p))
    mm = _MM(cfg.image_token_length)
    kw = dict(max_seq_len=512, chunk=64, decode_segment=8, vision_chunk=3, transfer_chunk=4)
    tp = long_vita_params_from_jax(p, device="cpu")
    out = {"cfg": cfg, "mm": mm, "jax_params": p}
    for quant in (False, True):
        out["jax", quant] = JaxEngine(p, cfg, mm, cache_dtype=jnp.float32, kv_quant=quant, **kw)
        out["port", quant] = InferenceEngine(tp, cfg, mm, cache_dtype=torch.float32, kv_quant=quant, **kw)
    return out


def _tiles(seed, n, size=56):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("quant", [False, True], ids=["cache_f32", "kv_quant"])
def test_generate_with_media_identical(media_engines, quant):
    """130 text ids, an image (thumbnail and a 2 x 1 grid), a 2-frame video
    and 10 text ids: 172 tokens, 5 tiles (not a multiple of vision_chunk 3,
    two padded transfer pieces of 4)."""
    e = media_engines
    rng = np.random.default_rng(10)
    ids = [*rng.integers(0, 480, 130), IMG_TAG, VID_TAG, *rng.integers(0, 480, 10)]
    media = dict(images=[(_tiles(11, 3), (2, 1))], videos=[_tiles(12, 2)])
    expanded = _check_no_wrap(e["mm"], ids, **media)
    assert len(expanded.input_ids) == 172 and expanded.images.shape[0] == 5
    sp = dict(max_new_tokens=12, return_logprobs=True)
    want = e["jax", quant].generate(input_ids=ids, sampling=JaxSP(**sp), **media)
    got = e["port", quant].generate(input_ids=ids, sampling=SamplingParams(**sp), **media)
    assert got.token_ids == want.token_ids
    assert len(set(got.token_ids)) > 3, got.token_ids
    assert got.prompt_tokens == want.prompt_tokens == 172
    np.testing.assert_allclose(got.logprobs, want.logprobs, **(QUANT_TOL if quant else TOL))
    # the features reach the prompt: without them the last row moves
    _, with_media, _ = e["port", quant].prefill(
        expanded.input_ids, expanded.images, expanded.image_indices
    )
    _, text_only, _ = e["port", quant].prefill(expanded.input_ids)
    assert (with_media - text_only).abs().max() > 1e-2


def test_tile_straddles_a_chunk_boundary(media_engines):
    """A video frame's context rows at 125..128 straddle the chunk boundary
    at 128; the incremental API lands them token by token in chunks 1 and
    2 and matches the JAX engine's prefill, the cache included."""
    e = media_engines
    rng = np.random.default_rng(13)
    ids = [*rng.integers(0, 480, 124), VID_TAG, *rng.integers(0, 480, 10)]
    videos = [_tiles(14, 2)]
    x = _check_no_wrap(e["mm"], ids, videos=videos)
    assert x.image_indices[1, 0].tolist() == [125, 126, 127, 128]
    jcache, jhid, jn = e["jax", False].prefill(x.input_ids, x.images, x.image_indices)
    port = e["port", False]
    job = port.start_prefill(x.input_ids, x.images, x.image_indices)
    steps = 1
    while not port.prefill_step(job):
        steps += 1
    cache, hid, n = port.finish_prefill(job)
    assert steps == 3 and n == jn == len(x.input_ids) == 146
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), **TOL)
    np.testing.assert_allclose(cache.k[:, :, :n].numpy(), np.asarray(jcache.k)[:, :, :n], **TOL)
    sp = dict(max_new_tokens=8)
    want = e["jax", False].generate(input_ids=ids, videos=videos, sampling=JaxSP(**sp))
    got = port.generate(input_ids=ids, videos=videos, sampling=SamplingParams(**sp))
    assert got.token_ids == want.token_ids


def test_generate_batch_ragged_media_kv_quant(media_engines):
    """A text row, a row with a 3-tile image and a row with a 3-frame video,
    40 / 124 / 172 tokens, into one int8 cache: the rows' tile stacks merge
    with each row's batch index, and every row matches the JAX engine."""
    e = media_engines
    rng = np.random.default_rng(15)
    reqs = [
        {"input_ids": rng.integers(0, 480, 40).tolist()},
        {"input_ids": [*rng.integers(0, 480, 100), IMG_TAG, *rng.integers(0, 480, 5)],
         "images": [(_tiles(16, 3), (1, 2))]},
        {"input_ids": [*rng.integers(0, 480, 150), VID_TAG, *rng.integers(0, 480, 4)],
         "videos": [_tiles(17, 3)]},
    ]
    for r in reqs[1:]:
        _check_no_wrap(e["mm"], r["input_ids"], r.get("images", ()), r.get("videos", ()))
    sp = dict(max_new_tokens=10, return_logprobs=True)
    want = e["jax", True].generate_batch(reqs, sampling=JaxSP(**sp))
    got = e["port", True].generate_batch(reqs, sampling=SamplingParams(**sp))
    assert [r.prompt_tokens for r in got] == [r.prompt_tokens for r in want] == [40, 124, 172]
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, **QUANT_TOL)
    # each media row equals its solo run
    solo = e["port", True].generate(
        input_ids=reqs[2]["input_ids"], videos=reqs[2]["videos"], sampling=SamplingParams(**sp)
    )
    assert solo.token_ids == got[2].token_ids


def test_chunk_scatter_drops_other_chunks_rows(media_engines):
    """Media in chunk 0 and text at the same offsets in chunk 1: the port's
    chunked prefill equals the one-shot JAX forward (whose single scatter is
    right), while the JAX engine's wrapped per-chunk scatter overwrites
    chunk 1's text with chunk 0's features and moves the last row."""
    e = media_engines
    cfg, p = e["cfg"], e["jax_params"]
    rng = np.random.default_rng(18)
    ids = [*rng.integers(0, 480, 5), IMG_TAG, *rng.integers(0, 480, 100)]
    images = [(_tiles(19, 3), (1, 2))]
    x = e["mm"].expand(ids, images=images)
    n = len(x.input_ids)
    logits, _ = long_vita_forward(
        p, jnp.asarray([x.input_ids]), jnp.arange(n)[None], cfg,
        images=jnp.asarray(x.images), image_indices=jnp.asarray(x.image_indices), head=False,
    )
    want = np.asarray(logits)[:, -1]
    _, got, _ = e["port", False].prefill(x.input_ids, x.images, x.image_indices)
    _, jax_engine, _ = e["jax", False].prefill(x.input_ids, x.images, x.image_indices)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(np.asarray(jax_engine) - want).max() > 1e-2


def test_text_only_params_refuse_media(engines):
    _, port, cfg = engines
    mm = _MM(cfg.image_token_length)
    eng = InferenceEngine(port.params, cfg, mm, max_seq_len=512, chunk=64)
    with pytest.raises(ValueError, match="LongVITAParams"):
        eng.generate(input_ids=[1, 2, VID_TAG, 3], videos=[_tiles(20, 1)])
