"""PyTorch port: the serving entry points — inference/continuous.py,
beam_search.py and server.py — against the JAX package's, f32 on the CPU at
tiny_test_config() (max_seq_len 512, chunk 64).

Both packages' engines run the same weights (utils/convert, device="cpu")
and one shared tokenizer object: the port's byte-level ByteTokenizer with
its special tokens inside the tiny vocabulary, wrapped by each package's
own MultimodalTokenizer and ImageProcessor (56-pixel tiles, 4 tokens a
tile).

Greedy tokens and texts must be identical. Logprobs and beam scores agree
to 1e-4 absolute (f32 GEMMs summed in another order through two layers,
then a log-softmax over 512 logits; a beam score is a sum of such
logprobs). Sampled tokens are not compared: the port draws from a
torch.Generator, JAX from its PRNG. Every server runs on a thread that the
fixture shuts down, and every HTTP call has a timeout.
"""
import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from long_vita_tpu.config import tiny_test_config
from long_vita_tpu.data.image_processor import ImageProcessor as JaxIP
from long_vita_tpu.data.multimodal import MultimodalTokenizer as JaxMM
from long_vita_tpu.inference import server as jax_server
from long_vita_tpu.inference.beam_search import beam_search as jax_beam
from long_vita_tpu.inference.continuous import ContinuousEngine as JaxCE
from long_vita_tpu.inference.engine import InferenceEngine as JaxEngine
from long_vita_tpu.inference.sampler import SamplingParams as JaxSP
from long_vita_tpu.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.data.image_processor import ImageProcessor
from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
from long_vita_tpu_torch.inference import server as port_server
from long_vita_tpu_torch.inference.beam_search import beam_search
from long_vita_tpu_torch.inference.client import generate as client_generate
from long_vita_tpu_torch.inference.client import generate_stream
from long_vita_tpu_torch.inference.continuous import ContinuousEngine
from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.tokenizer import ByteTokenizer
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax
from test_torch_quantize import one_torch_thread  # noqa: F401

TOL = dict(rtol=0, atol=1e-4)
TIMEOUT = 120  # seconds, every HTTP call


def tiny_tokenizer():
    """The shared stub: bytes 0-255, the chat tokens at 256-258 and the 17
    multimodal tokens from 259, all inside the tiny 512-id vocabulary."""
    return ByteTokenizer(endoftext=256, im_start=257, im_end=258, first_added=259)


def _fill(p, seed):
    """Randomise norms, biases and layer scales; widen the kernels 8x (at
    4x, greedy decoding of this tree falls into one- and two-token loops)."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "norm" in name or "ls1" in name or "ls2" in name:
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "bias" in name:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 8

    return jax.tree_util.tree_map_with_path(fill, p)


def make_engines(weight_quant=None, kv_quant=False, speculative_k=0, seed=0):
    cfg = tiny_test_config()
    p = _fill(init_long_vita_params(jax.random.PRNGKey(seed), cfg), seed)
    tok = tiny_tokenizer()
    kw = dict(max_seq_len=512, chunk=64, kv_quant=kv_quant, weight_quant=weight_quant,
              speculative_k=speculative_k)
    jax_eng = JaxEngine(
        jax.tree.map(jnp.asarray, p), cfg,
        JaxMM(tok, image_processor=JaxIP(image_size=56), image_token_length=4),
        cache_dtype=jnp.float32, **kw,
    )
    port = InferenceEngine(
        long_vita_params_from_jax(p, device="cpu"), cfg,
        MultimodalTokenizer(tok, image_processor=ImageProcessor(image_size=56),
                            image_token_length=4),
        cache_dtype=torch.float32, **kw,
    )
    return jax_eng, port


@pytest.fixture(scope="module")
def engines():
    return make_engines()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lengths]


# ---- continuous batching ---------------------------------------------------

def _drive(ce, schedule):
    """schedule: a list of ("add", prompt) and ("step",) actions, then
    run_to_completion. -> {rid: result} and the rids in add order."""
    done, rids = {}, []
    for action in schedule:
        if action[0] == "add":
            rids.append(ce.add_request(action[1]))
        else:
            done.update(ce.step())
    done.update(ce.run_to_completion())
    return done, rids


def test_mid_flight_join_matches_solo_and_jax(engines):
    """Requests joining at different ticks reproduce their solo outputs, and
    the JAX ContinuousEngine's tokens."""
    jax_eng, port = engines
    prompts = _prompts(0, (30, 55, 41))
    schedule = [("add", prompts[0]), ("add", prompts[1]), ("step",), ("add", prompts[2])]
    got, rids = _drive(ContinuousEngine(port, SamplingParams(max_new_tokens=10),
                                        max_slots=4, tick=3), schedule)
    want, jrids = _drive(JaxCE(jax_eng, JaxSP(max_new_tokens=10), max_slots=4, tick=3),
                         schedule)
    solo = [port.generate(input_ids=p, sampling=SamplingParams(max_new_tokens=10))
            for p in prompts]
    assert rids == jrids == [0, 1, 2]
    for rid, s in zip(rids, solo):
        assert got[rid].token_ids == s.token_ids == want[rid].token_ids, rid
        assert got[rid].text == want[rid].text
        assert got[rid].prompt_tokens == want[rid].prompt_tokens
    assert len(set(solo[0].token_ids)) > 3, solo[0].token_ids


def test_slot_reuse_more_requests_than_slots(engines):
    jax_eng, port = engines
    prompts = _prompts(1, [20 + i for i in range(5)])
    results = {}
    for name, ce in (
        ("port", ContinuousEngine(port, SamplingParams(max_new_tokens=6), max_slots=2, tick=4)),
        ("jax", JaxCE(jax_eng, JaxSP(max_new_tokens=6), max_slots=2, tick=4)),
    ):
        out, queue, rid_to_idx = {}, list(enumerate(prompts)), {}
        while queue or ce.active:
            while queue and ce.free_slots:
                idx, p = queue.pop(0)
                rid_to_idx[ce.add_request(p)] = idx
            for rid, res in ce.step():
                out[rid_to_idx[rid]] = res.token_ids
        results[name] = out
    solo = {i: port.generate(input_ids=p, sampling=SamplingParams(max_new_tokens=6)).token_ids
            for i, p in enumerate(prompts)}
    assert results["port"] == results["jax"] == solo


def test_logprobs_and_stop_tokens_match_jax(engines):
    """return_logprobs and an extra stop token through the pool: the same
    kept tokens as JAX, logprobs within 1e-4."""
    jax_eng, port = engines
    prompts = _prompts(2, (33, 47))
    stop = port.generate(input_ids=prompts[0], sampling=SamplingParams(max_new_tokens=8)).token_ids[3]
    sp = dict(max_new_tokens=8, return_logprobs=True, stop_token_ids=(stop,))
    schedule = [("add", prompts[0]), ("step",), ("add", prompts[1])]
    got, _ = _drive(ContinuousEngine(port, SamplingParams(**sp), max_slots=2, tick=2), schedule)
    want, _ = _drive(JaxCE(jax_eng, JaxSP(**sp), max_slots=2, tick=2), schedule)
    assert len(got[0].token_ids) == 3
    for rid in (0, 1):
        assert got[rid].token_ids == want[rid].token_ids
        np.testing.assert_allclose(got[rid].logprobs, want[rid].logprobs, **TOL)


def test_set_sampling_requires_drained_pool(engines):
    _, port = engines
    ce = ContinuousEngine(port, SamplingParams(max_new_tokens=4), max_slots=2, tick=2)
    ce.add_request(list(range(1, 20)))
    with pytest.raises(RuntimeError, match="in flight"):
        ce.set_sampling(SamplingParams(max_new_tokens=8))
    ce.run_to_completion()
    ce.set_sampling(SamplingParams(max_new_tokens=8))
    assert ce.sampling.max_new_tokens == 8


def test_on_tokens_stream_concatenates(engines):
    """The streaming hook reports each slot's kept tokens in order: the
    reports concatenate to the result, for the port as for JAX."""
    jax_eng, port = engines
    prompts = _prompts(3, (25, 38))
    streams = {}
    for name, cls, sp in (("port", ContinuousEngine, SamplingParams),
                          ("jax", JaxCE, JaxSP)):
        fed = {0: [], 1: []}
        ce = cls(port if name == "port" else jax_eng, sp(max_new_tokens=9), max_slots=2,
                 tick=4, on_tokens=lambda rid, toks, fed=fed: fed[rid].append(list(toks)))
        done, _ = _drive(ce, [("add", prompts[0]), ("step",), ("add", prompts[1])])
        for rid in (0, 1):
            assert sum(fed[rid], []) == done[rid].token_ids
        streams[name] = fed
    assert streams["port"] == streams["jax"]


@pytest.mark.parametrize("kind", ["int4", "kv_quant", "speculative"])
def test_continuous_variants_match_solo_and_jax(kind):
    """int4 weights, an int8 cache, and prompt-lookup speculation (one
    batched verify step a tick) through the pool: each row equals its solo
    generate and the JAX ContinuousEngine's tokens."""
    kw = {"int4": dict(weight_quant="int4"), "kv_quant": dict(kv_quant=True),
          "speculative": dict(speculative_k=4)}[kind]
    jax_eng, port = make_engines(seed=4, **kw)
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, 12).tolist()
    prompts = [base * 3, rng.integers(0, 256, 49).tolist()]  # the first repeats itself
    schedule = [("add", prompts[0]), ("step",), ("add", prompts[1])]
    got, _ = _drive(ContinuousEngine(port, SamplingParams(max_new_tokens=8), max_slots=2, tick=3),
                    schedule)
    want, _ = _drive(JaxCE(jax_eng, JaxSP(max_new_tokens=8), max_slots=2, tick=3), schedule)
    for rid, p in enumerate(prompts):
        solo = port.generate(input_ids=p, sampling=SamplingParams(max_new_tokens=8))
        assert got[rid].token_ids == solo.token_ids == want[rid].token_ids, rid
    if kind == "speculative":
        assert port._spec_steps > 0


def test_continuous_prefix_cache_put_back(engines):
    """With a prefix cache, a finished slot's row is snapshotted; the same
    prompt again resumes from it and gives the same tokens."""
    _, plain = engines
    port = InferenceEngine(plain.params, plain.cfg, plain.mm, max_seq_len=512, chunk=64,
                           cache_dtype=torch.float32, prefix_cache_entries=2)
    prompt = _prompts(5, (150,))[0]
    ce = ContinuousEngine(port, SamplingParams(max_new_tokens=6), max_slots=2, tick=3)
    first, _ = _drive(ce, [("add", prompt)])
    assert len(port.prefix_cache._entries) == 1
    job = port.start_prefill(prompt)
    assert job.resumed_from == 128
    again, _ = _drive(ce, [("add", prompt)])
    assert first[0].token_ids == again[1].token_ids


# ---- beam search -----------------------------------------------------------

@pytest.mark.parametrize("kv_quant,width,n", [(False, 3, 6), (True, 2, 5), (False, 1, 4)])
def test_beam_search_matches_jax(kv_quant, width, n, engines):
    jax_eng, port = engines if not kv_quant else make_engines(kv_quant=True)
    prompt = _prompts(6, (70,))[0]
    want = jax_beam(jax_eng, prompt, beam_size=width, max_new_tokens=n, num_return=width)
    got = beam_search(port, prompt, beam_size=width, max_new_tokens=n, num_return=width)
    assert [h.token_ids for h in got] == [h.token_ids for h in want]
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want], **TOL)
    assert [h.score for h in got] == sorted((h.score for h in got), reverse=True)


def test_beam_search_stops_on_eos(engines):
    """A beam that emits the engine's stop token is frozen without it."""
    jax_eng, port = engines
    prompt = _prompts(7, (40,))[0]
    free = beam_search(port, prompt, beam_size=2, max_new_tokens=4, num_return=2)
    eos = free[0].token_ids[1]
    for eng in (jax_eng, port):
        eng.eos_id = eos
    try:
        want = jax_beam(jax_eng, prompt, beam_size=2, max_new_tokens=4, num_return=2)
        got = beam_search(port, prompt, beam_size=2, max_new_tokens=4, num_return=2)
    finally:
        for eng in (jax_eng, port):
            eng.eos_id = eng.cfg.text.eos_token_id
    assert [h.token_ids for h in got] == [h.token_ids for h in want]
    assert all(eos not in h.token_ids for h in got)
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want], **TOL)


# ---- the server ------------------------------------------------------------

def _put(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="PUT",
    )
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serve(module, engine, **kw):
    server = module.make_server(engine, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}/api"


def _stop(server, thread):
    server.shutdown()
    thread.join(timeout=TIMEOUT)
    if server.batcher is not None:
        server.batcher.stop(timeout=TIMEOUT)
    server.server_close()


@pytest.fixture(scope="module", params=["window", "continuous"])
def servers(request, engines):
    """The JAX and the port server over the same weights, in window mode
    (generous 0.5 s window: a burst groups on a loaded machine) or in
    continuous mode (4 slots, tick 4)."""
    kw = (dict(batch_window_s=0.5, max_batch=4) if request.param == "window"
          else dict(continuous=True, max_batch=4, tick=4))
    jax_eng, port = engines
    running = [_serve(jax_server, jax_eng, **kw), _serve(port_server, port, **kw)]
    yield request.param, [r[0] for r in running], [r[2] for r in running]
    for server, thread, _ in running:
        _stop(server, thread)


def _both(urls, payload):
    return [_put(u, payload) for u in urls]


def _b64_png(color):
    buf = io.BytesIO()
    Image.new("RGB", (64, 64), color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("payload", [
    {"prompts": ["hello there"], "tokens_to_generate": 6},
    {"prompts": ["two prompts", "in one request"], "tokens_to_generate": 5},
    {"prompts": ["<image>\nwhat color?"], "image_list": [_b64_png((10, 200, 30))],
     "tokens_to_generate": 4},
    {"prompts": ["stop at a newline"], "tokens_to_generate": 6, "stop_on_eol": True},
    {"prompts": ["zero tokens asks for one"], "tokens_to_generate": 0},
], ids=["text", "two_prompts", "base64_image", "stop_on_eol", "zero_tokens"])
def test_server_payloads_identical(servers, payload):
    _, _, urls = servers
    (jcode, jbody), (code, body) = _both(urls, payload)
    assert code == jcode == 200, (body, jbody)
    assert json.loads(body) == json.loads(jbody)
    assert len(json.loads(body)["text"]) == len(payload["prompts"])


def test_server_logprobs_within_tolerance(servers):
    _, _, urls = servers
    (_, jbody), (code, body) = _both(urls, {
        "prompts": ["log my probabilities"], "tokens_to_generate": 5, "logprobs": True,
    })
    assert code == 200
    got, want = json.loads(body), json.loads(jbody)
    assert got["text"] == want["text"]
    np.testing.assert_allclose(got["logprobs"][0], want["logprobs"][0], **TOL)


def test_server_concurrent_requests(servers):
    """Four concurrent requests with the same sampling settings: both
    batchers group them (rows per dispatch, or rows in flight per tick: 16
    tokens keep a row in the pool for four ticks, while the next is
    admitted) and every answer equals the JAX server's."""
    mode, srvs, urls = servers
    bodies = {}
    for name, url, srv in zip(("jax", "port"), urls, srvs):
        srv.batcher.batch_sizes.clear()
        out = {}

        def worker(i, url=url, out=out):
            out[i] = _put(url, {"prompts": [f"concurrent prompt number {i}"],
                                "tokens_to_generate": 16})

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert all(code == 200 for code, _ in out.values()), out
        bodies[name] = {i: json.loads(b) for i, (_, b) in out.items()}
        assert max(srv.batcher.batch_sizes) >= 2, (mode, srv.batcher.batch_sizes)
    assert bodies["port"] == bodies["jax"]


def test_server_beam(servers):
    _, _, urls = servers
    for payload in (
        {"prompts": ["beam me up"], "tokens_to_generate": 5, "beam_width": 3},
        {"prompts": ["<image>\nwhat is shown?"], "image_list": [_b64_png((200, 30, 40))],
         "tokens_to_generate": 3, "beam_width": 2},
    ):
        (jcode, jbody), (code, body) = _both(urls, payload)
        assert code == jcode == 200, body
        got, want = json.loads(body), json.loads(jbody)
        assert set(got) == {"text", "segments", "scores"}
        assert got["text"] == want["text"] and got["segments"] == want["segments"]
        np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
        assert got["scores"] == sorted(got["scores"], reverse=True)


@pytest.mark.parametrize("payload", [
    {"tokens_to_generate": 4},
    {"prompts": ["x"], "max_len": 5},
    {"prompts": ["x"], "sentences": ["y"]},
    {"prompts": "x"},
    {"prompts": ["x"] * 129},
    {"prompts": ["x"], "tokens_to_generate": -1},
    {"prompts": ["x"], "temperature": -1},
    {"prompts": ["x"], "top_k": 1001},
    {"prompts": ["x"], "top_p": 1.5},
    {"prompts": ["x"], "top_k": 5, "top_p": 0.5},
    {"prompts": ["x"], "beam_width": "3"},
    {"prompts": ["x"], "beam_width": 0},
    {"prompts": ["x", "y"], "beam_width": 2},
    {"prompts": ["a", "b"], "tokens_to_generate": 4, "stream": True},
], ids=lambda p: "-".join(sorted(p)))
def test_server_validation_errors(servers, payload):
    """Each malformed request gets the same 400 and message from both."""
    mode, _, urls = servers
    (jcode, jbody), (code, body) = _both(urls, payload)
    assert code == jcode == 400
    assert body == jbody and body
    assert port_server._validate(payload) in (body, None)


def test_server_invalid_json_and_path(servers):
    _, _, urls = servers
    for url in urls:
        req = urllib.request.Request(url, data=b"{not json", method="PUT",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert e.value.code == 400 and e.value.read() == b"invalid json"
    codes = [_put(u.replace("/api", "/other"), {"prompts": ["x"]})[0] for u in urls]
    assert codes == [404, 404]


def _stream(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps({**payload, "stream": True}).encode(),
        headers={"Content-Type": "application/json"}, method="PUT",
    )
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in resp]


def test_server_streaming_ndjson(servers):
    """"stream": true: in continuous mode NDJSON deltas that concatenate to
    the final text, which equals the non-streamed answer; the same events
    from both servers. In window mode both refuse it."""
    mode, _, urls = servers
    payload = {"prompts": ["stream over http"], "tokens_to_generate": 12}
    if mode == "window":
        (jcode, jbody), (code, body) = _both(urls, {**payload, "stream": True})
        assert code == jcode == 400 and body == jbody and "continuous" in body
        return
    jev, ev = (_stream(u, payload) for u in urls)
    assert ev == jev
    assert ev[-1].get("done") is True
    deltas = [e["delta"] for e in ev[:-1]]
    assert len(deltas) > 1
    assert "".join(deltas) == ev[-1]["text"][0]
    assert _put(urls[1], payload) == (200, json.dumps({"text": ev[-1]["text"]}))


def test_client_over_the_port_server(servers):
    """The urllib client's generate and generate_stream against the port's
    server, and its error on a 400."""
    mode, _, urls = servers
    url = urls[1]
    text = client_generate("the client asks", url=url, tokens_to_generate=6, timeout=TIMEOUT)
    assert text == json.loads(_put(url, {"prompts": ["the client asks"], "image_path_list": None,
                                         "video_path_list": None, "tokens_to_generate": 6})[1])["text"][0]
    if mode == "continuous":
        deltas = list(generate_stream("the client asks", url=url, tokens_to_generate=6,
                                      timeout=TIMEOUT))
        assert "".join(deltas) == text
    with pytest.raises(RuntimeError, match="server error 400"):
        client_generate("x", url=url, top_k=5, top_p=0.5, timeout=TIMEOUT)


def test_admission_interleaves_with_decode(engines):
    """While a long prompt is admitted, the in-flight request keeps
    decoding: every admission chunk is followed by a decode tick. The
    threadless batchers of both packages take the same actions and give
    the solo answers."""
    jax_eng, port = engines
    short_req = {"prompts": ["hi"], "tokens_to_generate": 24}
    long_text = " ".join(["test"] * 50)  # ~4 chunks of 64 byte tokens
    long_req = {"prompts": [long_text], "tokens_to_generate": 24}
    runs = {}
    for name, module, eng in (("jax", jax_server, jax_eng), ("port", port_server, port)):
        batcher = module.ContinuousBatcher(eng, max_slots=2, tick=2, start_thread=False)
        box_a = batcher.submit_async(short_req)
        for _ in range(3):
            batcher.iteration()
        assert batcher.ce.active == 1
        box_b = batcher.submit_async(long_req)
        guard = 0
        while not (box_a["event"].is_set() and box_b["event"].is_set()):
            assert batcher.iteration(), "scheduler idle with work pending"
            guard += 1
            assert guard < 200
        assert "error" not in box_a and "error" not in box_b
        trace = batcher.trace
        assert trace.count("chunk") >= 3, trace
        for i, action in enumerate(trace[:-1]):
            if action == "chunk":
                assert trace[i + 1] == "tick", (i, trace)
        runs[name] = (trace, [box_a["rows"][0].text, box_b["rows"][0].text])
    assert runs["port"] == runs["jax"]
    sp = SamplingParams(max_new_tokens=24)
    assert runs["port"][1] == [
        port.generate([{"role": "user", "content": p}], sampling=sp).text
        for p in ("hi", long_text)
    ]


def test_continuous_batcher_isolates_a_bad_row(engines):
    """A row whose prompt is too long fails its own request with the
    engine's message; its poolmate is answered."""
    _, port = engines
    batcher = port_server.ContinuousBatcher(port, max_slots=2, tick=4)
    try:
        good = batcher.submit_async({"prompts": ["fine"], "tokens_to_generate": 4})
        bad = batcher.submit_async({"prompts": ["x" * 600], "tokens_to_generate": 4})
        assert good["event"].wait(TIMEOUT) and bad["event"].wait(TIMEOUT)
        assert "error" not in good and good["rows"][0] is not None
        assert "exceeds max_seq_len" in str(bad["error"])
    finally:
        batcher.stop(timeout=TIMEOUT)


def test_request_batcher_groups_by_sampling_key(engines):
    """Requests with different sampling settings never share a dispatch."""
    _, port = engines
    batcher = port_server.RequestBatcher(port, max_batch=8, window_s=1.0)
    try:
        out = {}
        reqs = [{"prompts": [f"p{i}"], "tokens_to_generate": 3 + (i % 2)} for i in range(4)]

        def worker(i):
            out[i] = batcher.submit(reqs[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.01)
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert sorted(batcher.batch_sizes) == [2, 2], batcher.batch_sizes
        for i, r in enumerate(reqs):
            assert out[i] == port_server.execute_request(port, r)
    finally:
        batcher.stop(timeout=TIMEOUT)
