"""PyTorch port: serving over a tensor-parallel mesh, over cp x tp and over
2-D tp (tp 2 x tq 2: the weights cut over tp and tq) — the slot pool (a row
joining mid-flight), the speculative pool, beam search, a prefix-cache hit,
and the lockstep server on world rank 0 with the other ranks replaying its
actions — at tiny_test_config() in f32 on the CPU, on 2 (tp 2) and 4 (cp 2
x tp 2, tp 2 x tq 2) thread-ranks.

References: the JAX engine on a CPU mesh of the same geometry
(MeshConfig(tp=2), MeshConfig(cp=2, tp=2) and MeshConfig(tp=2, tq=2), the
first two the geometry of JAX's tests/test_continuous.py:96 and
tests/test_speculative.py:201; each built once for the module), and for
the server the one-process JAX server
(test_torch_cp_serving's answers). Greedy tokens and texts identical,
logprobs and beam scores within 1e-4; what a follower rank replays equals
rank 0's answers exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.data.image_processor import ImageProcessor as JaxIP
from long_vita_tpu.data.multimodal import MultimodalTokenizer as JaxMM
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
from long_vita_tpu_torch.parallel.comm import run_thread_ranks
from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_cp_serving import (  # noqa: F401 (jax_answers: a fixture)
    CONTINUOUS,
    MODES,
    SAMPLED,
    TOL,
    _drive,
    _prompts,
    _same_json,
    _same_results,
    jax_answers,
)
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_serving import TIMEOUT, _fill, _put, _serve, tiny_tokenizer

KW = dict(max_seq_len=512, chunk=64)
RANK_TIMEOUT = 120.0
MESHES = {"tp2": dict(tp=2), "cp2xtp2": dict(cp=2, tp=2), "tp2xtq2": dict(tp=2, tq=2)}


@pytest.fixture(scope="module")
def model():
    """The weights of test_torch_serving.make_engines (seed 0), the JAX
    engine on each mesh over them (made on first use), and the port's
    tree."""
    cfg = tiny_test_config()
    p = _fill(init_long_vita_params(jax.random.PRNGKey(0), cfg), 0)
    return p, {}, long_vita_params_from_jax(p, device="cpu"), cfg, tiny_tokenizer()


def _jax_engine(model, mesh: str):
    p, engines, _, cfg, tok = model
    if mesh not in engines:
        dims = MESHES[mesh]
        jmesh = j_make_mesh(JMeshConfig(**dims), devices=jax.devices()[:np.prod(
            list(dims.values()))])
        engines[mesh] = JaxEngine(
            jax.tree.map(jnp.asarray, p), cfg,
            JaxMM(tok, image_processor=JaxIP(image_size=56), image_token_length=4),
            cache_dtype=jnp.float32, mesh=jmesh, **KW)
    return engines[mesh]


def _port_engine(model, comm, mesh: str, **kw):
    _, _, params, cfg, tok = model
    mm = MultimodalTokenizer(tok, image_processor=ImageProcessor(image_size=56),
                             image_token_length=4)
    return InferenceEngine(params, cfg, mm, cache_dtype=torch.float32,
                           mesh=make_mesh(MeshConfig(**MESHES[mesh]), comm), **{**KW, **kw})


def _on_ranks(mesh: str, fn):
    n = int(np.prod(list(MESHES[mesh].values())))
    return run_thread_ranks(fn, n, timeout=RANK_TIMEOUT, join_timeout=4 * RANK_TIMEOUT)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pool_matches_jax_on_the_mesh(model, mesh, one_torch_thread):
    """A row joins mid-flight; at cp 2 the 300-id prompt ends in cp rank
    1's shard."""
    prompts = _prompts(0, (300, 55))
    sp = dict(max_new_tokens=8, return_logprobs=True)
    schedule = [("add", prompts[0]), ("step",), ("add", prompts[1])]
    want = _drive(JaxCE(_jax_engine(model, mesh), JaxSP(**sp), max_slots=2, tick=3), schedule)

    def rank(comm):
        eng = _port_engine(model, comm, mesh)
        return _drive(ContinuousEngine(eng, SamplingParams(**sp), max_slots=2, tick=3),
                      schedule)

    res = _on_ranks(mesh, rank)
    for got in res:
        _same_results(got, want)
        assert [(r.token_ids, r.logprobs) for r in got] == [
            (r.token_ids, r.logprobs) for r in res[0]]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pool_speculative_matches_jax_on_the_mesh(model, mesh, one_torch_thread):
    """speculative_k = 4 in the pool: one batched verify step a tick."""
    jeng = _jax_engine(model, mesh)
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
        eng = _port_engine(model, comm, mesh, speculative_k=4)
        got = _drive(ContinuousEngine(eng, SamplingParams(**sp), max_slots=2, tick=3), schedule)
        return got, eng._spec_steps

    for got, steps in _on_ranks(mesh, rank):
        _same_results(got, want)
        assert steps > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_beam_search_matches_jax_on_the_mesh(model, mesh, one_torch_thread):
    """The prompt's cache of this rank's kv heads (and slots) repeated over
    3 beams."""
    prompt = _prompts(6, (150,))[0]
    want = jax_beam(_jax_engine(model, mesh), prompt, beam_size=3, max_new_tokens=6,
                    num_return=3)

    def rank(comm):
        return beam_search(_port_engine(model, comm, mesh), prompt, beam_size=3,
                           max_new_tokens=6, num_return=3)

    for got in _on_ranks(mesh, rank):
        assert [h.token_ids for h in got] == [h.token_ids for h in want]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], **TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefix_cache_hit_on_the_mesh(model, mesh, one_torch_thread):
    """A 150-id prompt served twice through the pool with a prefix cache:
    each rank snapshots its shard (its kv heads; at cp 2 its slots), the
    second admission resumes after two chunks, and both answers equal the
    JAX engine's on the mesh."""
    prompt = _prompts(5, (150,))[0]
    sp = dict(max_new_tokens=6, return_logprobs=True)
    want = _jax_engine(model, mesh).generate(input_ids=prompt, sampling=JaxSP(**sp))

    def rank(comm):
        eng = _port_engine(model, comm, mesh, prefix_cache_entries=2)
        ce = ContinuousEngine(eng, SamplingParams(**sp), max_slots=2, tick=3)
        first = _drive(ce, [("add", prompt)])[0]
        snap = eng.prefix_cache._entries[0].cache.k.shape
        resumed = eng.start_prefill(prompt).resumed_from
        again = _drive(ce, [("add", prompt)])[0]
        return first, again, resumed, snap, eng.prefix_cache.hits

    cp = MESHES[mesh].get("cp", 1)
    for first, again, resumed, snap, hits in _on_ranks(mesh, rank):
        assert resumed == 128 and hits == 2
        assert snap[2] == 512 // cp and snap[3] == 1  # this rank's slots and kv head
        _same_results([first, again], [want, want])


# ---- the server over tp: rank 0 serves, the other replays ------------------

@pytest.mark.parametrize("mesh,mode", [("tp2", "continuous"), ("tp2", "window"),
                                       ("cp2xtp2", "continuous"), ("tp2xtq2", "continuous"),
                                       ("tp2xtq2", "window")])
def test_tp_server_matches_the_jax_server_and_followers_replay(model, jax_answers, mesh, mode,
                                                               one_torch_thread):
    from test_torch_cp_serving import WINDOW

    payloads = CONTINUOUS + [SAMPLED] if mode == "continuous" else WINDOW
    kw = MODES[mode]

    def rank(comm):
        eng = _port_engine(model, comm, mesh)
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

    res = _on_ranks(mesh, rank)
    (answers, finished), followers = res[0], res[1:]
    for got, want in zip(answers, jax_answers[mode]):
        _same_json(got, want)
    for fol in followers:
        if mode == "continuous":
            assert fol.finished.keys() == finished.keys() and len(finished) == 6
            for rid, r in finished.items():
                assert (fol.finished[rid].token_ids, fol.finished[rid].logprobs) == (
                    r.token_ids, r.logprobs)
        else:
            assert [json.loads(json.dumps(p)) for p in fol.payloads] == [
                json.loads(b) for _, b in answers]
