"""PyTorch port: serving from a cp group — the slot pool, speculative
decoding, beam search and the prefix cache over a cp-sharded cache, and the
server on cp rank 0 with the other ranks replaying its actions
(inference/server.py's lockstep over inference/multihost.py), at
tiny_test_config() in f32 on the CPU, on cp 2 and 4 thread-ranks.

References: the JAX engine on a CPU mesh of cp 2 (built and compiled once
for the module: the function does not depend on the port's cp), and for the
server the one-process JAX server (test_torch_serving's make_engines and
_serve). Greedy tokens and texts must be identical, logprobs and beam
scores within 1e-4 (f32 summed in other orders, as test_torch_serving
holds them); what a follower rank replays must equal rank 0's answers
exactly (every rank makes the same calls on the same operands). Every wait
is bounded: thread-ranks by their communicator's timeout, HTTP calls by
TIMEOUT.
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.data.image_processor import ImageProcessor as JaxIP
from long_vita_tpu.data.multimodal import MultimodalTokenizer as JaxMM
from long_vita_tpu.inference import server as jax_server
from long_vita_tpu.inference.beam_search import beam_search as jax_beam
from long_vita_tpu.inference.continuous import ContinuousEngine as JaxCE
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models.long_vita import init_long_vita_params
from long_vita_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as j_make_mesh
from long_vita_tpu_torch.data.image_processor import ImageProcessor
from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
from long_vita_tpu_torch.inference import server as port_server
from long_vita_tpu_torch.inference.beam_search import beam_search
from long_vita_tpu_torch.inference.continuous import ContinuousEngine
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.models.qwen2 import KVCache
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_serving import TIMEOUT, _b64_png, _fill, _put, _serve, _stop, tiny_tokenizer

TOL = dict(rtol=0, atol=1e-4)
KW = dict(max_seq_len=512, chunk=64)
RANK_TIMEOUT = 120.0  # seconds any one wait of a thread-rank may take


@pytest.fixture(scope="module")
def model():
    """The weights of test_torch_serving.make_engines (seed 0), the JAX
    engine on a cp-2 CPU mesh over them, and the port's tree."""
    cfg = tiny_test_config()
    p = _fill(init_long_vita_params(jax.random.PRNGKey(0), cfg), 0)
    tok = tiny_tokenizer()
    jmesh = j_make_mesh(JMeshConfig(cp=2), devices=jax.devices()[:2])
    jeng = JaxEngine(jax.tree.map(jnp.asarray, p), cfg,
                     JaxMM(tok, image_processor=JaxIP(image_size=56), image_token_length=4),
                     cache_dtype=jnp.float32, mesh=jmesh, **KW)
    return jeng, long_vita_params_from_jax(p, device="cpu"), cfg, tok


def _port_engine(model, comm, cp, **kw):
    _, params, cfg, tok = model
    mm = MultimodalTokenizer(tok, image_processor=ImageProcessor(image_size=56),
                             image_token_length=4)
    return InferenceEngine(params, cfg, mm, cache_dtype=torch.float32,
                           mesh=make_mesh(MeshConfig(cp=cp), comm), **{**KW, **kw})


def _on_ranks(cp, fn):
    return run_thread_ranks(fn, cp, timeout=RANK_TIMEOUT, join_timeout=4 * RANK_TIMEOUT)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lengths]


def _drive(ce, schedule):
    """("add", prompt) / ("step",) actions, then run_to_completion."""
    done, rids = {}, []
    for action in schedule:
        if action[0] == "add":
            rids.append(ce.add_request(action[1]))
        else:
            done.update(ce.step())
    done.update(ce.run_to_completion())
    return [done[r] for r in rids]


def _same_results(got, want):
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, **TOL)
    assert all(len(set(r.token_ids)) > 2 for r in got), [r.token_ids for r in got]


# ---- the slot pool ----------------------------------------------------------

@pytest.mark.parametrize("cp", [2, 4])
def test_pool_matches_jax_on_a_cp_mesh(model, cp, one_torch_thread):
    """The port of tests/test_continuous.py::test_continuous_on_cp_mesh: a
    row joins mid-flight; the rows span several ranks' shards (a 300-id
    prompt ends in rank 1's shard at cp 2, rank 2's at cp 4)."""
    jeng = model[0]
    prompts = _prompts(0, (300, 55))
    sp = dict(max_new_tokens=8, return_logprobs=True)
    schedule = [("add", prompts[0]), ("step",), ("add", prompts[1])]
    want = _drive(JaxCE(jeng, JaxSP(**sp), max_slots=2, tick=3), schedule)

    def rank(comm):
        eng = _port_engine(model, comm, cp)
        return _drive(ContinuousEngine(eng, SamplingParams(**sp), max_slots=2, tick=3),
                      schedule)

    for got in _on_ranks(cp, rank):
        _same_results(got, want)


@pytest.mark.parametrize("cp", [2, 4])
def test_pool_speculative_matches_jax_on_a_cp_mesh(model, cp, one_torch_thread):
    """speculative_k = 4 in the pool: one batched verify step a tick (its 4
    rows shard over cp as a prefill chunk does, each row at its own
    frontier), the same tokens as JAX's pool on the cp mesh. The first row's
    frontier lies in rank 1's shard (cp 2) or rank 2's (cp 4)."""
    jeng = model[0]
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, 12).tolist()
    prompts = [base * 25, rng.integers(0, 256, 49).tolist()]  # the first repeats itself
    sp = dict(max_new_tokens=8, return_logprobs=True)
    schedule = [("add", prompts[0]), ("step",), ("add", prompts[1])]
    jeng.speculative_k = 4
    try:
        want = _drive(JaxCE(jeng, JaxSP(**sp), max_slots=2, tick=3), schedule)
    finally:
        jeng.speculative_k = 0

    def rank(comm):
        eng = _port_engine(model, comm, cp, speculative_k=4)
        got = _drive(ContinuousEngine(eng, SamplingParams(**sp), max_slots=2, tick=3), schedule)
        return got, eng._spec_steps

    for got, steps in _on_ranks(cp, rank):
        _same_results(got, want)
        assert steps > 0


@pytest.mark.parametrize("cp,kv_quant", [(2, False), (2, True), (4, False)])
def test_insert_copies_this_ranks_shard_of_the_row(model, cp, kv_quant):
    """_insert on a row of 300 tokens (it ends inside rank 1's shard at cp
    2, rank 2's at cp 4): each rank copies its valid prefix, clamp(300 -
    rank * C, 0, C) positions, and leaves the rest of the slot (and every
    other slot) as it was, here a NaN sentinel (int8: -128)."""
    true_len = 300

    def rank(comm):
        eng = _port_engine(model, comm, cp, kv_quant=kv_quant)
        ce = ContinuousEngine(eng, SamplingParams(), max_slots=2, tick=2)
        c = ce.cache.k.shape[2]
        gen = torch.Generator().manual_seed(comm.rank)
        staged = eng._make_cache(batch=1, max_len=512)
        bufs = [b for b in (staged.k, staged.v, staged.k_scale, staged.v_scale) if b is not None]
        pool = [b for b in (ce.cache.k, ce.cache.v, ce.cache.k_scale, ce.cache.v_scale)
                if b is not None]
        for s, big in zip(bufs, pool):
            if s.is_floating_point():
                s.copy_(torch.randn(s.shape, generator=gen))
                big.fill_(float("nan"))
            else:
                s.copy_(torch.randint(-127, 128, s.shape, generator=gen, dtype=s.dtype))
                big.fill_(-128)
        ce._insert(KVCache(staged.k, staged.v, true_len, k_scale=staged.k_scale,
                           v_scale=staged.v_scale), 1, true_len)
        n = min(max(true_len - comm.rank * c, 0), c)
        for s, big in zip(bufs, pool):
            assert torch.equal(big[:, 1, :n], s[:, 0, :n])
            untouched = big[:, 1, n:], big[:, 0]
            for u in untouched:
                assert (u.isnan().all() if u.is_floating_point() else (u == -128).all())
        return n

    c = 512 // cp
    assert _on_ranks(cp, rank) == [min(max(true_len - r * c, 0), c) for r in range(cp)]


# ---- beam search and the prefix cache ------------------------------------

@pytest.mark.parametrize("cp,width,n", [(2, 3, 6), (4, 2, 5)])
def test_beam_search_matches_jax_on_a_cp_mesh(model, cp, width, n, one_torch_thread):
    jeng = model[0]
    prompt = _prompts(6, (150,))[0]
    want = jax_beam(jeng, prompt, beam_size=width, max_new_tokens=n, num_return=width)

    def rank(comm):
        return beam_search(_port_engine(model, comm, cp), prompt, beam_size=width,
                           max_new_tokens=n, num_return=width)

    for got in _on_ranks(cp, rank):
        assert [h.token_ids for h in got] == [h.token_ids for h in want]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], **TOL)


def test_prefix_cache_hit_over_cp(model, one_torch_thread):
    """A 150-id prompt served twice through the pool of a cp-2 engine with a
    prefix cache: the finished row's shard is snapshotted on every rank, the
    second admission resumes after two chunks, and both answers equal the
    JAX engine's on the cp mesh."""
    jeng = model[0]
    prompt = _prompts(5, (150,))[0]
    sp = dict(max_new_tokens=6, return_logprobs=True)
    want = jeng.generate(input_ids=prompt, sampling=JaxSP(**sp))

    def rank(comm):
        eng = _port_engine(model, comm, 2, prefix_cache_entries=2)
        ce = ContinuousEngine(eng, SamplingParams(**sp), max_slots=2, tick=3)
        first = _drive(ce, [("add", prompt)])[0]
        entry = eng.prefix_cache._entries[0]
        shard = entry.cache.k.shape[2]
        resumed = eng.start_prefill(prompt).resumed_from
        again = _drive(ce, [("add", prompt)])[0]
        return first, again, resumed, shard, eng.prefix_cache.hits

    for first, again, resumed, shard, hits in _on_ranks(2, rank):
        assert resumed == 128 and shard == 256 and hits == 2
        _same_results([first, again], [want, want])


# ---- the server over cp: rank 0 serves, the others replay ----------------

CONTINUOUS = [
    {"prompts": ["hello there"], "tokens_to_generate": 6},
    {"prompts": ["two prompts", "in one request"], "tokens_to_generate": 5},
    {"prompts": ["<image>\nwhat color?"], "image_list": [_b64_png((10, 200, 30))],
     "tokens_to_generate": 4},
    {"prompts": ["log my probabilities"], "tokens_to_generate": 5, "logprobs": True},
    {"prompts": ["beam me up"], "tokens_to_generate": 5, "beam_width": 2},
]
SAMPLED = {"prompts": ["sample me"], "tokens_to_generate": 5, "top_k": 5, "random_seed": 3}
WINDOW = CONTINUOUS[:2] + [
    {"prompts": ["<image>\nwhat is shown?"], "image_list": [_b64_png((200, 30, 40))],
     "tokens_to_generate": 3, "beam_width": 2},
    CONTINUOUS[3],
]
MODES = {"continuous": dict(continuous=True, max_batch=4, tick=4),
         "window": dict(batch_window_s=0.05, max_batch=4)}


def cp_server_run(model, cp, mode, payloads):
    """Serve ``payloads`` (one at a time, over HTTP) from cp rank 0 of cp
    thread-ranks, the others in follower_serve. -> (rank 0's answers, its
    batcher's finished rows or None, the followers' replayers)."""
    kw = MODES[mode]

    def rank(comm):
        eng = _port_engine(model, comm, cp)
        if comm.rank:
            return port_server.follower_serve(eng, continuous=kw.get("continuous", False),
                                              max_batch=kw["max_batch"], tick=kw.get("tick", 16))
        server, thread, url = _serve(port_server, eng, **kw)
        try:
            answers = [_put(url, p) for p in payloads]
        finally:
            server.shutdown()
            thread.join(timeout=TIMEOUT)
            port_server.close_server(server, timeout=TIMEOUT)
        return answers, getattr(server.batcher, "finished", None)

    res = _on_ranks(cp, rank)
    return res[0][0], res[0][1], res[1:]


@pytest.fixture(scope="module")
def jax_answers():
    """The one-process JAX server's answers, by mode (computed once)."""
    from test_torch_serving import make_engines

    jax_eng, _ = make_engines()
    out = {}
    for mode, payloads in (("continuous", CONTINUOUS), ("window", WINDOW)):
        server, thread, url = _serve(jax_server, jax_eng, **MODES[mode])
        try:
            out[mode] = [_put(url, p) for p in payloads]
        finally:
            _stop(server, thread)
    return out


def _same_json(got, want):
    (code, body), (jcode, jbody) = got, want
    assert code == jcode == 200, (body, jbody)
    g, w = json.loads(body), json.loads(jbody)
    for key in ("logprobs", "scores"):
        if key in w:
            np.testing.assert_allclose(np.asarray(g.pop(key), float), np.asarray(w.pop(key), float),
                                       **TOL)
    assert g == w


@pytest.mark.parametrize("cp,mode", [(2, "continuous"), (4, "continuous"), (2, "window")])
def test_cp_server_matches_the_jax_server_and_followers_replay(model, jax_answers, cp, mode,
                                                               one_torch_thread):
    payloads = CONTINUOUS + [SAMPLED] if mode == "continuous" else WINDOW
    answers, finished, followers = cp_server_run(model, cp, mode, payloads)
    for got, want in zip(answers, jax_answers[mode]):
        _same_json(got, want)
    assert answers[-1][0] == 200  # the sampled request (a sampling switch on the admit)
    for fol in followers:
        if mode == "continuous":
            assert fol.finished.keys() == finished.keys() and len(finished) == 6
            for rid, res in finished.items():
                assert fol.finished[rid].token_ids == res.token_ids
                assert fol.finished[rid].logprobs == res.logprobs
            assert fol.trace.count("admit") == 6 and "tick" in fol.trace
            # the beam request took the serial path: one replayed request
            assert [json.loads(json.dumps(p)) for p in fol.payloads] == [json.loads(answers[4][1])]
        else:
            want = [json.loads(b) for _, b in answers]
            assert [json.loads(json.dumps(p)) for p in fol.payloads] == want
            assert fol.trace == ["batch", "batch", "request", "batch"]


def test_make_server_refuses_a_follower_rank(model):
    def rank(comm):
        eng = _port_engine(model, comm, 2)
        if comm.rank == 1:
            with pytest.raises(ValueError, match="follower_serve"):
                port_server.make_server(eng, "127.0.0.1", 0)
        comm.barrier()

    _on_ranks(2, rank)
