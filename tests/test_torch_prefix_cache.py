"""PyTorch port: the cross-request prefix cache (inference/prefix_cache.py, the
engine's prefix_cache_entries) and interleaved encode (interleave_encode),
mirroring tests/test_prefix_cache.py, against the JAX package.

The store's decisions (resume points, hits, misses, evictions) equal JAX's
PrefixCache on the same sequence of operations. An engine with the cache
gives the tokens of an engine without it, and the JAX engine's, for
multi-turn chat, an exact repeat and image prompts keyed by their pixels;
an engine with interleave_encode gives the up-front encode's tokens. f32 on
the CPU, greedy tokens identical. At the 128-group geometry the engines
serve int4 weights. Media stay within one chunk of the prompt's end, where
the JAX engine's per-chunk scatter does not wrap (tests/test_torch_engine.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.prefix_cache import PrefixCache as JaxPrefixCache
from long_vita_tpu.inference.prefix_cache import media_fingerprint as jax_fingerprint
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models.long_vita import init_long_vita_params
from long_vita_tpu.models.qwen2 import KVCache as JaxKVCache
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.prefix_cache import (
    PrefixCache,
    copy_cache,
    media_fingerprint,
)
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models.qwen2 import KVCache
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_engine import IMG_TAG, VID_TAG, _MM, _check_no_wrap, _tiles
from test_torch_quantize import GEOMETRIES, one_torch_thread  # noqa: F401

CHUNK = 16


def _cache(fill: int = 0, slots: int = 96, quantize: bool = False) -> KVCache:
    cfg = GEOMETRIES["tiny"]().text
    c = KVCache.zeros(cfg, 1, slots, torch.float32, quantize=quantize)
    c.k.add_(fill)
    return c


# ---- the store ---------------------------------------------------------------


def test_match_alignment_and_final_row_cap():
    pc = PrefixCache(max_entries=2, chunk=CHUNK)
    ids = np.arange(100, dtype=np.int32)
    pc.put(ids, _cache(1, 128), frontier=100)
    cache, start = pc.match(ids)  # exact repeat: capped at 99, aligned to 96
    assert start == 96 and cache.length == 96
    assert pc.hits == 1 and pc.tokens_saved == 96
    q = np.concatenate([ids[:50], 400 + np.arange(60, dtype=np.int32)])
    assert pc.match(q)[1] == 48
    assert pc.match(np.concatenate([ids[:10], [999] * 50]).astype(np.int32)) is None
    assert pc.misses == 1


def test_match_and_put_copy_and_keep_scales():
    pc = PrefixCache(max_entries=1, chunk=CHUNK)
    ids = np.arange(64, dtype=np.int32)
    live = _cache(2, quantize=True)
    live.k_scale.add_(0.5)
    pc.put(ids, live, frontier=64)
    live.k.add_(1)  # the engine writes its caches in place
    c1, _ = pc.match(ids)
    c2, _ = pc.match(ids)
    for buf in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(c1, buf), getattr(c2, buf)
        assert a.data_ptr() != b.data_ptr() != getattr(live, buf).data_ptr()
        assert torch.equal(a, b)
    assert int(c1.k.max()) == 2 and float(c1.k_scale.max()) == 0.5
    snap = copy_cache(live)
    assert snap.v_scale.data_ptr() != live.v_scale.data_ptr()
    assert torch.equal(snap.k, live.k) and snap.length == live.length


def test_store_decisions_match_jax():
    """The same puts and matches on both stores: resume points, hits,
    misses, tokens saved, replacement of a shorter snapshot of one session
    and LRU eviction."""
    jcfg = GEOMETRIES["tiny"]().text
    ops = []
    a = np.arange(80, dtype=np.int32)
    b, c = 1000 + a[:32], 2000 + a[:32]
    ops += [("put", a[:48], 48, ""), ("put", a, 80, ""), ("match", a, ""),
            ("put", a[:48], 48, ""), ("match", a, ""), ("put", b, 32, "m"),
            ("match", b, ""), ("match", b, "m"), ("put", c, 32, ""), ("match", a, ""),
            ("match", c, ""), ("match", b, "m"), ("match", a[:20], "")]
    port, jpc = PrefixCache(2, CHUNK), JaxPrefixCache(2, CHUNK)
    for op, ids, *rest in ops:
        if op == "put":
            frontier, key = rest
            port.put(ids, _cache(), frontier, key)
            jpc.put(ids, JaxKVCache.zeros(jcfg, 1, 96, jnp.float32), frontier, key)
        else:
            got, want = port.match(ids, rest[0]), jpc.match(ids, rest[0])
            assert (got is None) == (want is None), (op, ids[:3], rest)
            if got is not None:
                assert got[1] == want[1] and got[0].length == int(want[0].length)
        assert len(port) == len(jpc)
    assert (port.hits, port.misses, port.tokens_saved) == (jpc.hits, jpc.misses, jpc.tokens_saved)


def test_media_fingerprint_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 3, 8, 8)).astype(np.float32)
    b = a.copy()
    b[39, 0, 4, 4] += 1.0
    assert media_fingerprint(a) == jax_fingerprint(a) != media_fingerprint(b)
    assert media_fingerprint(None) == "" == media_fingerprint(a[:0])


# ---- engines -----------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def media(request):
    """A LongVITA tree (JAX init, norms and biases randomised, kernels
    widened) and, over it, the JAX engine and port engines without and with
    the prefix cache and with interleaved encode (transfer pieces of 2
    tiles, ViT batches of 3)."""
    base = GEOMETRIES[request.param]()
    cfg = dataclasses.replace(base, vision=GEOMETRIES["tiny"]().vision)
    p = init_long_vita_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)

    def fill(path, a):
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name or "ls1" in name or "ls2" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 4

    p = jax.tree.map(jnp.asarray, jax.tree_util.tree_map_with_path(fill, p))
    quant = "int4" if request.param == "g128" else None
    mm = _MM(cfg.image_token_length)
    kw = dict(max_seq_len=512, chunk=CHUNK * 4, decode_segment=8, vision_chunk=3,
              transfer_chunk=2, weight_quant=quant)
    tp = long_vita_params_from_jax(p, device="cpu")
    return {
        "cfg": cfg, "mm": mm,
        "jax": JaxEngine(p, cfg, mm, cache_dtype=jnp.float32, **kw),
        "plain": InferenceEngine(tp, cfg, mm, cache_dtype=torch.float32, **kw),
        "cached": InferenceEngine(tp, cfg, mm, cache_dtype=torch.float32,
                                  prefix_cache_entries=2, **kw),
        "interleaved": InferenceEngine(tp, cfg, mm, cache_dtype=torch.float32,
                                       interleave_encode=True, **kw),
        "both": InferenceEngine(tp, cfg, mm, cache_dtype=torch.float32,
                                interleave_encode=True, prefix_cache_entries=2, **kw),
    }


def _same(e, ids, n=8, **media_kw):
    """Tokens of the JAX engine, checked against the plain port engine."""
    want = e["jax"].generate(input_ids=ids, sampling=JaxSP(max_new_tokens=n), **media_kw)
    plain = e["plain"].generate(input_ids=ids, sampling=SamplingParams(max_new_tokens=n), **media_kw)
    assert plain.token_ids == want.token_ids
    return want.token_ids


def test_multiturn_reuse_matches_no_cache_engine(media):
    e = media
    rng = np.random.default_rng(7)
    turn1 = rng.integers(0, 480, 90).tolist()
    sp = SamplingParams(max_new_tokens=8)
    r1 = e["cached"].generate(input_ids=turn1, sampling=sp)
    assert r1.token_ids == _same(e, turn1)
    assert len(e["cached"].prefix_cache) >= 1
    turn2 = turn1 + r1.token_ids + rng.integers(0, 480, 30).tolist()
    assert e["cached"].start_prefill(turn2).resumed_from == 64
    saved = e["cached"].prefix_cache.tokens_saved
    r2 = e["cached"].generate(input_ids=turn2, sampling=sp)
    assert r2.token_ids == _same(e, turn2)
    assert e["cached"].prefix_cache.tokens_saved - saved == 64


def test_exact_repeat_hits_and_matches(media):
    e = media
    ids = np.random.default_rng(8).integers(0, 480, 140).tolist()
    sp = SamplingParams(max_new_tokens=8)
    first = e["cached"].generate(input_ids=ids, sampling=sp)
    hits = e["cached"].prefix_cache.hits
    again = e["cached"].generate(input_ids=ids, sampling=sp)
    assert again.token_ids == first.token_ids == _same(e, ids)
    assert e["cached"].prefix_cache.hits == hits + 1


def test_image_prompts_keyed_by_pixels(media):
    """Same ids and a different image: no resume; the same image again:
    resume, and the tokens stay those of the no-cache engine."""
    e = media
    rng = np.random.default_rng(9)
    ids = [*rng.integers(0, 480, 100), IMG_TAG, *rng.integers(0, 480, 6)]
    img_a, img_b = [(_tiles(10, 3), (1, 2))], [(_tiles(11, 3), (1, 2))]
    _check_no_wrap(e["mm"], ids, images=img_a)
    sp = SamplingParams(max_new_tokens=8)
    r_a = e["cached"].generate(input_ids=ids, images=img_a, sampling=sp)
    assert r_a.token_ids == _same(e, ids, images=img_a)
    x_b = e["mm"].expand(ids, images=img_b)
    assert e["cached"].start_prefill(x_b.input_ids, x_b.images, x_b.image_indices).resumed_from == 0
    x_a = e["mm"].expand(ids, images=img_a)
    assert e["cached"].start_prefill(x_a.input_ids, x_a.images, x_a.image_indices).resumed_from == 64
    assert e["cached"].generate(input_ids=ids, images=img_a, sampling=sp).token_ids == r_a.token_ids
    r_b = e["cached"].generate(input_ids=ids, images=img_b, sampling=sp)
    assert r_b.token_ids == _same(e, ids, images=img_b)


def test_lru_keeps_two_sessions(media):
    e = media
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 480, 70).tolist() for _ in range(3)]
    eng = InferenceEngine(e["plain"].params, e["cfg"], e["mm"], cache_dtype=torch.float32,
                          prefix_cache_entries=2, max_seq_len=512, chunk=64, decode_segment=8)
    sp = SamplingParams(max_new_tokens=4)
    for ids in prompts:
        eng.generate(input_ids=ids, sampling=sp)
    assert len(eng.prefix_cache) == 2
    assert eng.start_prefill(prompts[0]).resumed_from == 0  # evicted
    assert eng.start_prefill(prompts[2]).resumed_from == 64


def test_interleaved_encode_matches_upfront(media):
    """A 5-frame video at rows 87..116 of a 121-token prompt (chunks of 64):
    the leading text chunk runs before any encode, the frames of chunk 1 and
    chunk 2 are encoded just before them, and the tokens equal the up-front
    encode's and the JAX engine's. With the prefix cache, an exact repeat
    resumes at 64 and skips the encodes of the frames wholly before it."""
    e = media
    rng = np.random.default_rng(13)
    ids = [*rng.integers(0, 480, 86), VID_TAG, *rng.integers(0, 480, 5)]
    videos = [_tiles(14, 5)]
    x = _check_no_wrap(e["mm"], ids, videos=videos)
    assert len(x.input_ids) == 121 and x.image_indices[1].min() == 87
    want = _same(e, ids, videos=videos)
    eng = e["interleaved"]
    job = eng.start_prefill(x.input_ids, x.images, x.image_indices)
    assert job.feats is None and job.tiles_done == 0
    eng.prefill_step(job)
    assert job.feats is None  # chunk 0 holds no frame row
    eng.prefill_step(job)
    assert job.tiles_done == 5 and job.feats.shape[0] == 6  # padded to the piece
    assert eng.generate(input_ids=ids, videos=videos,
                        sampling=SamplingParams(max_new_tokens=8)).token_ids == want
    both = e["both"]
    assert both.generate(input_ids=ids, videos=videos,
                         sampling=SamplingParams(max_new_tokens=8)).token_ids == want
    job = both.start_prefill(x.input_ids, x.images, x.image_indices)
    last_rows = x.image_indices[1].max(axis=1)
    assert job.resumed_from == 64 and job.tiles_done == int((last_rows < 64).sum())
    assert both.generate(input_ids=ids, videos=videos,
                         sampling=SamplingParams(max_new_tokens=8)).token_ids == want


def test_engine_rejects_mesh(media):
    """Serving over 2-D tp (a tq mesh) with the prefix cache and
    interleaved encode, since the tq serving slice (the engine over tq:
    tests/test_torch_tq_serving.py): on a tq 2 mesh of thread-ranks (at
    g128 its int4 weights cut over tq by their output dim) the engine gives
    the JAX engine's tokens for the interleaved video prompt, and an exact
    repeat resumes after the first chunk, on every rank. (The name is kept
    from when a tq mesh raised here.)"""
    from long_vita_tpu_torch.parallel.comm import run_thread_ranks
    from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    e = media
    rng = np.random.default_rng(13)
    ids = [*rng.integers(0, 480, 86), VID_TAG, *rng.integers(0, 480, 5)]
    videos = [_tiles(14, 5)]
    x = _check_no_wrap(e["mm"], ids, videos=videos)
    want = _same(e, ids, videos=videos)
    sp = SamplingParams(max_new_tokens=8)
    kw = dict(max_seq_len=512, chunk=CHUNK * 4, decode_segment=8, vision_chunk=3,
              transfer_chunk=2, interleave_encode=True, prefix_cache_entries=2)

    def rank(comm):
        # the plain engine's tree, quantised already at g128: the engine cuts it
        eng = InferenceEngine(e["plain"].params, e["cfg"], e["mm"], cache_dtype=torch.float32,
                              mesh=make_mesh(MeshConfig(tq=2), comm), **kw)
        first = eng.generate(input_ids=ids, videos=videos, sampling=sp).token_ids
        resumed = eng.start_prefill(x.input_ids, x.images, x.image_indices).resumed_from
        again = eng.generate(input_ids=ids, videos=videos, sampling=sp).token_ids
        return first, resumed, again

    for first, resumed, again in run_thread_ranks(rank, 2, timeout=120):
        assert first == want and again == want and resumed == 64