"""Inference REST server — wire-compatible with the reference Flask server.

Counterpart of long_vita_tpu/inference/server.py (reference
long_vita_megatron/inference/text_generation_server.py:34-281 + client
inference_long_vita.py:27-65), on the standard library's http.server:

    PUT /api
    {"prompts": [str],
     "image_path_list": [str] | null,
     "video_path_list": [str] | null,
     "image_list": [base64 str] | null, # base64-encoded images
     "tokens_to_generate": int,         # default 64
     "temperature": float, "top_k": int, "top_p": float,
     "beam_width": int | null,          # beam search (batch must be 1)
     "length_penalty": float,
     "max_num_frame": int, "random_seed": int, "logprobs": bool,
     "stream": bool, ...}
    -> 200 {"text": [generated_text]}            (greedy/sampling)
    -> 200 {"text": [...], "segments": [...], "scores": [...]}  (beam)
    -> 200 NDJSON {"delta": str} lines, then the payload with "done": true
       ("stream": true, continuous mode)
    -> 400 plain-text error message (same strings where practical)

Concurrent requests with the same sampling settings decode together: in
window mode (RequestBatcher) as one engine.generate_batch, in continuous
mode (ContinuousBatcher) as rows of one slot pool that requests join at any
tick.

An engine over a mesh of more than one rank (cp, tp or cp x tp; every rank
builds it) serves in lockstep (inference/multihost.py): world rank 0 runs
this server and
publishes every action it takes against the engine BEFORE the engine call
— a whole request ({"op": "request"}: beam requests, and every request
without a batcher), a window batch ({"op": "batch"}), or a pool action
({"op": "admit"} with the expanded ids and the tiles cast to the cache
dtype, the sampling switch riding on it; {"op": "chunk"}; {"op": "tick"})
— and the other ranks run ``follower_serve``, whose ``FollowerReplayer``
issues the same call, so every rank reaches the same collectives with the
same operands. ``run_server`` sends each rank to its side; a server made
with ``make_server`` is stopped with ``close_server``, which publishes
SHUTDOWN last.
"""
from __future__ import annotations

import base64
import collections
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from long_vita_tpu_torch.inference import multihost
from long_vita_tpu_torch.inference.engine import (
    InferenceEngine,
    _host_cast_pixels,
    _tile_stack,
)
from long_vita_tpu_torch.inference.sampler import SamplingParams
from long_vita_tpu_torch.parallel.comm import Comm

logger = logging.getLogger(__name__)
_KEEP = 256  # results a batcher or a follower keeps for inspection


def _keep(log: dict, key, value) -> None:
    """log[key] = value, dropping the oldest entries past _KEEP."""
    log[key] = value
    while len(log) > _KEEP:
        log.pop(next(iter(log)))


def lockstep_comm(engine: InferenceEngine) -> Optional[Comm]:
    """The lockstep channel of an engine over a mesh of more than one rank:
    the host side of the mesh's world communicator (a gloo group beside
    NCCL, made on the first call: every rank calls this at the same point);
    None for one rank."""
    if engine.parallel is None:
        return None
    return engine.parallel.mesh.world.host_comm()


def _validate(req: dict) -> Optional[str]:
    if "prompts" not in req:
        return "prompts argument required"
    if "max_len" in req:
        return "max_len is no longer used.  Replace with tokens_to_generate"
    if "sentences" in req:
        return "sentences is no longer used.  Replace with prompts"
    prompts = req["prompts"]
    if not isinstance(prompts, list) or not prompts:
        return "prompts is not a list of strings"
    if len(prompts) > 128:
        return "Maximum number of prompts is 128"
    tok = req.get("tokens_to_generate", 64)
    if not isinstance(tok, int) or tok < 0:
        return "tokens_to_generate must be an integer greater than 0"
    temperature = req.get("temperature", 1.0)
    if not isinstance(temperature, (int, float)) or not 0.0 < temperature <= 100.0:
        return "temperature must be a positive number less than or equal to 100.0"
    top_k = req.get("top_k", 0)
    if not isinstance(top_k, int) or not 0 <= top_k <= 1000:
        return (
            "top_k must be equal to or greater than 0 and less than or "
            "equal to 1000"
        )
    top_p = req.get("top_p", 0.0)
    if isinstance(top_p, int):
        top_p = float(top_p)
    if not isinstance(top_p, float) or not 0.0 <= top_p <= 1.0:
        return "top_p must be less than or equal to 1.0"
    if top_p > 0.0 and top_k > 0:
        return "cannot set both top-k and top-p samplings."
    if "beam_width" in req and req["beam_width"] is not None:
        beam_width = req["beam_width"]
        if not isinstance(beam_width, int):
            return "beam_width must be integer"
        if beam_width < 1:
            # the reference's own check/message mismatch (< 1 vs "> 1",
            # text_generation_server.py:188-191) is preserved for wire
            # parity: beam_width=1 is accepted and runs a width-1 beam
            return "beam_width must be an integer > 1"
        if len(prompts) > 1:
            return "When doing beam_search, batch size must be 1"
    return None


class LongVITARequestHandler(BaseHTTPRequestHandler):
    engine: InferenceEngine = None  # set by make_server
    protocol_version = "HTTP/1.1"  # chunked transfer for "stream": true

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, code: int, body: str, content_type="application/json"):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_PUT(self):
        if self.path not in ("/api", "/api/"):
            self._reply(404, "not found", "text/plain")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._reply(400, "invalid json", "text/plain")
            return

        err = _validate(req)
        if err:
            self._reply(400, err, "text/plain")
            return

        if req.get("stream"):
            self._do_stream(req)
            return

        try:
            batcher = getattr(self.server, "batcher", None)
            if batcher is not None and not req.get("beam_width"):
                # micro-batching path: concurrent requests with the same
                # sampling settings decode together
                payload = batcher.submit(req)
            else:
                with self.server.generate_lock:
                    if self.server.channel is not None:
                        # every rank runs the same generate (reference
                        # text_generation_server.py:25-32)
                        self.server.channel.publish({"op": "request", "req": req})
                    payload = execute_request(self.engine, req)
        except Exception as e:  # noqa: BLE001 — surface as 400 like reference
            self._reply(400, str(e), "text/plain")
            return
        self._reply(200, json.dumps(payload))

    def _do_stream(self, req: dict):
        """"stream": true — chunked NDJSON token deltas, then the final
        payload with "done": true. Streams ride the continuous batcher's
        slot pool alongside non-streaming requests (the reference server
        has no streaming at all, text_generation_server.py:225)."""
        batcher = getattr(self.server, "batcher", None)
        if not isinstance(batcher, ContinuousBatcher):
            self._reply(
                400, "stream requires the continuous batching server "
                "(--continuous)", "text/plain")
            return
        if len(req["prompts"]) != 1 or req.get("beam_width"):
            self._reply(
                400, "stream requires a single prompt without beam_width",
                "text/plain")
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        try:
            for ev in batcher.submit_stream(req):
                if isinstance(ev, str):
                    chunk({"delta": ev})
                else:  # ("done", payload)
                    payload = ev[1]
                    payload["done"] = True
                    chunk(payload)
        except Exception as e:  # noqa: BLE001
            chunk({"error": str(e), "done": True})
        self.wfile.write(b"0\r\n\r\n")


def _request_media(req: dict) -> tuple[list, list]:
    images = list(req.get("image_path_list") or [])
    if req.get("image_list"):
        from PIL import Image

        for image_str in req["image_list"]:
            raw = base64.b64decode(image_str)
            images.append(Image.open(io.BytesIO(raw)).convert("RGB"))
    videos = list(req.get("video_path_list") or [])
    return images, videos


def _max_num_frame(req: dict) -> Optional[int]:
    return int(req["max_num_frame"]) if req.get("max_num_frame") else None


def _parse_sampling(req: dict, engine: InferenceEngine) -> tuple[SamplingParams, int]:
    top_k = req.get("top_k", 0)
    top_p = float(req.get("top_p", 0.0))
    stop_ids = ()
    if req.get("stop_on_eol") or req.get("stop_on_double_eol"):
        nl = engine.mm.tokenizer("\n", add_special_tokens=False).input_ids
        stop_ids = tuple(nl)
    sampling = SamplingParams(
        temperature=float(req.get("temperature", 1.0)),
        top_k=top_k,
        top_p=top_p,
        greedy=(top_k == 0 and top_p == 0.0),
        max_new_tokens=int(req.get("tokens_to_generate", 64)) or 1,
        stop_token_ids=stop_ids,
        return_logprobs=bool(req.get("logprobs", False)),
    )
    return sampling, max(int(req.get("random_seed", 0)), 0)


def _payload(results, sampling: SamplingParams) -> dict:
    payload = {"text": [r.text for r in results]}
    if sampling.return_logprobs:
        payload["logprobs"] = [r.logprobs for r in results]
    return payload


def execute_request(engine: InferenceEngine, req: dict) -> dict:
    """Run one validated /api request dict -> response payload dict."""
    images, videos = _request_media(req)
    max_num_frame = _max_num_frame(req)
    sampling, seed = _parse_sampling(req, engine)

    if req.get("beam_width"):
        return _execute_beam(engine, req, images, videos, max_num_frame, sampling)

    results = [
        engine.generate(
            [{"role": "user", "content": prompt}],
            images=images, videos=videos, sampling=sampling, seed=seed,
            max_num_frame=max_num_frame,
        )
        for prompt in req["prompts"]
    ]
    return _payload(results, sampling)


def _execute_beam(engine, req, images, videos, max_num_frame, sampling) -> dict:
    """Beam-search branch (reference text_generation_server.py:236-250 —
    num_return_gen = beam_width, response carries segments + scores)."""
    from long_vita_tpu_torch.inference.beam_search import beam_search

    beam_width = int(req["beam_width"])
    input_ids = engine.mm.encode_chat([{"role": "user", "content": req["prompts"][0]}])
    expanded = engine.mm.expand(
        input_ids, images=images, videos=videos, max_num_frame=max_num_frame,
    )
    hyps = beam_search(
        engine,
        expanded.input_ids,
        images=expanded.images,
        image_indices=expanded.image_indices,
        beam_size=beam_width,
        max_new_tokens=sampling.max_new_tokens,
        length_penalty=float(req.get("length_penalty", 1.0)),
        num_return=beam_width,
    )
    tok = engine.mm.tokenizer
    return {
        "text": [tok.decode(h.token_ids, skip_special_tokens=True) for h in hyps],
        "segments": [
            [tok.decode([t], skip_special_tokens=False) for t in h.token_ids]
            for h in hyps
        ],
        "scores": [h.score for h in hyps],
    }


_SAMPLING_FIELDS = (
    "tokens_to_generate", "temperature", "top_k", "top_p", "random_seed",
    "logprobs", "stop_on_eol", "stop_on_double_eol",
)


def _sampling_fields(req: dict) -> dict:
    """The sampling-relevant subset of a request: what a follower needs to
    rebuild SamplingParams with _parse_sampling (media fields dropped)."""
    return {k: req[k] for k in _SAMPLING_FIELDS if k in req}


def _sampling_key(req: dict) -> tuple:
    """Requests agreeing on this key may decode as one batch."""
    return (
        req.get("tokens_to_generate", 64),
        req.get("temperature", 1.0),
        req.get("top_k", 0),
        req.get("top_p", 0.0),
        req.get("random_seed", 0),
        bool(req.get("logprobs")),
        bool(req.get("stop_on_eol")),
        bool(req.get("stop_on_double_eol")),
    )


def execute_batch(engine: InferenceEngine, reqs: list[dict]) -> list[dict]:
    """Run several same-sampling /api requests as one engine batch."""
    sampling, seed = _parse_sampling(reqs[0], engine)
    rows, spans = [], []
    for req in reqs:
        images, videos = _request_media(req)
        max_num_frame = _max_num_frame(req)
        start = len(rows)
        for prompt in req["prompts"]:
            rows.append({
                "messages": [{"role": "user", "content": prompt}],
                "images": images,
                "videos": videos,
                "max_num_frame": max_num_frame,
            })
        spans.append((start, len(rows)))
    results = engine.generate_batch(rows, sampling=sampling, seed=seed)
    return [_payload(results[start:end], sampling) for start, end in spans]


class RequestBatcher:
    """Micro-batching scheduler: a short accumulation window groups
    concurrent requests by sampling key, then one generate_batch serves the
    whole group (weight reads amortize across rows)."""

    def __init__(
        self, engine: InferenceEngine, max_batch: int = 8,
        window_s: float = 0.02, generate_lock: Optional[threading.Lock] = None,
        publish=None,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.window_s = window_s
        # the lockstep channel to the follower ranks (publish(msg)); None on
        # one rank
        self._publish = publish
        # shared with the beam path: device work stays one generation at a
        # time (two concurrent full-size KV caches would not fit under load)
        self.generate_lock = generate_lock or threading.Lock()
        self._cv = threading.Condition()
        self._queue: list[tuple] = []  # (key, req, box)
        self.batch_sizes: list[int] = []  # observability: rows per dispatch
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, req: dict) -> dict:
        box: dict = {"event": threading.Event()}
        with self._cv:
            self._queue.append((_sampling_key(req), req, box))
            self._cv.notify()
        box["event"].wait()
        if "error" in box:
            raise box["error"]
        return box["payload"]

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the scheduler thread (joins it)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
            time.sleep(self.window_s)  # let a burst accumulate
            with self._cv:
                key = self._queue[0][0]
                group, n_rows = [], 0
                for entry in list(self._queue):
                    if entry[0] != key:
                        continue
                    rows = len(entry[1]["prompts"])
                    if group and n_rows + rows > self.max_batch:
                        break
                    group.append(entry)
                    n_rows += rows
                for entry in group:
                    self._queue.remove(entry)
            try:
                with self.generate_lock:
                    if self._publish is not None:
                        # the followers run the same execute_batch
                        self._publish({"op": "batch", "reqs": [e[1] for e in group]})
                    payloads = execute_batch(self.engine, [e[1] for e in group])
                self.batch_sizes.append(n_rows)
                for (_, _, box), payload in zip(group, payloads):
                    box["payload"] = payload
            except Exception:  # noqa: BLE001
                # one bad request (corrupt image, over-long prompt) must not
                # 400 its batchmates: retry each request alone
                for _, req, box in group:
                    try:
                        with self.generate_lock:
                            if self._publish is not None:
                                self._publish({"op": "request", "req": req})
                            box["payload"] = execute_request(self.engine, req)
                    except Exception as exc:  # noqa: BLE001
                        box["error"] = exc
            for _, _, box in group:
                box["event"].set()


class ContinuousBatcher:
    """Iteration-level scheduler: requests join a slot-pool decode at any
    tick boundary (inference/continuous.py) — no accumulation window, so a
    late arrival rides the pool immediately instead of waiting for the
    current group to finish. Same submit() contract as RequestBatcher.

    Admission is CHUNKED: each scheduler iteration runs at most ONE prompt
    chunk of the pending admission before the next decode tick, so a long
    prompt joining the pool bounds every in-flight request's inter-token
    gap at ~one chunk of prefill."""

    def __init__(
        self, engine: InferenceEngine, max_slots: int = 8, tick: int = 16,
        generate_lock: Optional[threading.Lock] = None,
        start_thread: bool = True, publish=None,
    ):
        from long_vita_tpu_torch.inference.continuous import ContinuousEngine

        self.engine = engine
        # the lockstep channel to the follower ranks (publish(msg, arrays)):
        # every scheduler action that touches the engine (admit, prefill
        # chunk, decode tick, the sampling switch) is published BEFORE the
        # engine call, and the followers replay it (FollowerReplayer)
        self._publish = publish
        self.generate_lock = generate_lock or threading.Lock()
        self._cv = threading.Condition()
        # one entry per ROW: (key, box, row_index, prompt, req)
        self._queue: list[tuple] = []
        self._inflight: dict[int, tuple] = {}  # rid -> (box, row_index)
        self.ce = ContinuousEngine(
            engine, SamplingParams(), max_slots=max_slots, tick=tick,
            on_tokens=self._on_tokens,
        )
        self._key = None
        self.batch_sizes: list[int] = []  # rows in flight per tick
        self.trace: list[str] = []  # scheduler actions: admit/chunk/tick
        self.finished: dict = {}  # rid -> GenerationResult, the last _KEEP
        self._stop = False
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the scheduler thread (joins it; finishes the in-flight
        iteration first)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def submit(self, req: dict) -> dict:
        box = self.submit_async(req)
        box["event"].wait()
        if "error" in box:
            raise box["error"]
        sampling, _ = _parse_sampling(req, self.engine)
        return _payload(box["rows"], sampling)

    def _on_tokens(self, rid: int, token_ids: list):
        """ContinuousEngine streaming hook: forward a slot's fresh kept
        tokens to its request's stream queue (if it asked to stream)."""
        entry = self._inflight.get(rid)
        if entry is None:
            return
        box, _row = entry
        q = box.get("stream_q")
        if q is not None:
            q.put(("tokens", token_ids))

    def submit_stream(self, req: dict):
        """Streaming submit: yields text deltas as the pool decodes, then
        ("done", payload). Single-prompt requests only — the stream is one
        slot's token feed. Streams ride the SAME slot pool as non-streaming
        requests."""
        box = self.submit_async(req, stream=True)
        ids: list = []
        emitted = ""
        tok = self.engine.mm.tokenizer
        while True:
            if box["event"].is_set() and box["stream_q"].empty():
                break
            try:
                kind, data = box["stream_q"].get(timeout=0.05)
            except queue.Empty:
                continue
            if kind == "tokens":
                ids += data
                text = tok.decode(ids, skip_special_tokens=True)
                # suffix-delta decode: re-decoding the full id list handles
                # BPE merge boundaries; hold back while a partial UTF-8
                # sequence decodes to a replacement char
                if text.startswith(emitted) and not text.endswith("�"):
                    delta, emitted = text[len(emitted):], text
                    if delta:
                        yield delta
        if "error" in box:
            raise box["error"]
        sampling, _ = _parse_sampling(req, self.engine)
        payload = _payload(box["rows"], sampling)
        # any tail the delta stream held back (final text is authoritative)
        full = payload["text"][0]
        if full.startswith(emitted) and len(full) > len(emitted):
            yield full[len(emitted):]
        yield ("done", payload)

    def submit_async(self, req: dict, stream: bool = False) -> dict:
        """Enqueue a request's rows; returns the result box (event-gated)."""
        box: dict = {
            "event": threading.Event(),
            "rows": [None] * len(req["prompts"]),
            "pending": len(req["prompts"]),
            "req": req,
        }
        if stream:
            box["stream_q"] = queue.Queue()
        key = _sampling_key(req)
        with self._cv:
            for row, prompt in enumerate(req["prompts"]):
                self._queue.append((key, box, row, prompt, req))
            self._cv.notify()
        return box

    def _start_next_locked(self) -> bool:
        """Begin the chunked admission of the next queued row, if any."""
        while self._queue:
            key, box, row, prompt, req = self._queue[0]
            switch_req = None
            if self.ce.active or self.ce.admission_pending:
                if key != self._key:
                    return False  # drain before switching sampling configs
            elif key != self._key:
                switch_req = req
            if self.ce.free_slots <= 0:
                return False
            self._queue.pop(0)
            try:
                images, videos = _request_media(req)
                ids = self.engine.mm.encode_chat([{"role": "user", "content": prompt}])
                exp = self.engine.mm.expand(
                    ids, images=images, videos=videos, max_num_frame=_max_num_frame(req),
                )
                imgs = _tile_stack(exp.images)
                idx = None
                if imgs is not None:
                    # cast the tiles to the cache dtype ONCE on the host: the
                    # bytes published and the bytes admitted are the same, so
                    # every rank's operands agree bit for bit
                    imgs = _host_cast_pixels(imgs, self.engine.cache_dtype)
                    idx = np.asarray(exp.image_indices, np.int32)
                if self._publish is not None:
                    # the EXPANDED arrays, not the request: followers skip
                    # the file IO and the video decode
                    arrs = [np.asarray(exp.input_ids, np.int32)]
                    if imgs is not None:
                        arrs += [imgs, idx]
                    self._publish({
                        "op": "admit",
                        "sampling": (_sampling_fields(req)
                                     if switch_req is not None else None),
                        "has_images": imgs is not None,
                    }, arrs)
                if switch_req is not None:
                    # the sampling switch rides a successful expand (a failed
                    # one leaves every rank's pool as it was)
                    sampling, _ = _parse_sampling(switch_req, self.engine)
                    self.ce.set_sampling(sampling)
                    self._key = key
                rid = self.ce.start_admission(exp.input_ids, imgs, idx)
                self._inflight[rid] = (box, row)
                self.trace.append("admit")
                return True
            except Exception as exc:  # noqa: BLE001
                # a bad row (corrupt image, over-long prompt) fails its own
                # request, never its poolmates
                box["error"] = exc
                box["event"].set()
                self._queue = [e for e in self._queue if e[1] is not box]
        return False

    def iteration(self) -> bool:
        """One scheduler pass: at most one admission chunk, then one decode
        tick. Returns whether any work was done (the loop's idle signal);
        public for deterministic (threadless) tests."""
        with self.generate_lock:
            did = False
            if self.ce.admission_pending:
                if self._publish is not None:
                    self._publish({"op": "chunk"})
                self.ce.admission_step()  # ONE chunk
                self.trace.append("chunk")
                did = True
            elif self._start_next_locked():
                did = True
            if self.ce.active:
                if self._publish is not None:
                    self._publish({"op": "tick"})
                finished = self.ce.step()
                self.trace.append("tick")
                self.batch_sizes.append(self.ce.active + len(finished))
                did = True
            else:
                finished = []
        for rid, result in finished:
            _keep(self.finished, rid, result)
            entry = self._inflight.pop(rid, None)
            if entry is None:
                continue
            box, row = entry
            box["rows"][row] = result
            box["pending"] -= 1
            if box["pending"] == 0 and "error" not in box:
                box["event"].set()
        return did

    def _loop(self):
        while True:
            with self._cv:
                while (
                    not self._queue
                    and not self.ce.active
                    and not self.ce.admission_pending
                    and not self._stop
                ):
                    self._cv.wait()
                if self._stop:
                    return
            self.iteration()


class FollowerReplayer:
    """Replays rank 0's published actions on a follower rank.

    Every action the primary's batcher or handler takes against the engine
    is published before the engine call; this issues the same call here, so
    every rank runs the same collectives in the same order. The scheduler
    state (queues, slots, generator) is deterministic and built alike on
    every rank, so replaying the actions reproduces it. ``finished`` (rid
    -> result of the pool) and ``payloads`` (what each replayed request or
    batch answered) keep the last _KEEP results, for inspection."""

    def __init__(
        self, engine: InferenceEngine, *, continuous: bool = False,
        max_slots: int = 8, tick: int = 16,
    ):
        self.engine = engine
        self.ce = None
        if continuous:
            from long_vita_tpu_torch.inference.continuous import ContinuousEngine

            # the primary's ContinuousBatcher's geometry and seed: the same
            # pool, the same generator
            self.ce = ContinuousEngine(engine, SamplingParams(), max_slots=max_slots, tick=tick)
        self.finished: dict = {}
        self.payloads: collections.deque = collections.deque(maxlen=_KEEP)
        self.trace: list[str] = []

    def handle(self, msg: dict, arrays=()) -> None:
        op = msg.get("op") if isinstance(msg, dict) else None
        if op in ("admit", "chunk", "tick") and self.ce is None:
            raise ValueError(f"lockstep op {op!r} from a continuous server; this follower "
                             "replays a window server")
        if op == "request":
            self.payloads.append(execute_request(self.engine, msg["req"]))
        elif op == "batch":
            self.payloads.extend(execute_batch(self.engine, msg["reqs"]))
        elif op == "admit":
            if msg.get("sampling") is not None:
                sp, _ = _parse_sampling(msg["sampling"], self.engine)
                self.ce.set_sampling(sp)
            ids = [int(t) for t in arrays[0].tolist()]
            images = indices = None
            if msg.get("has_images"):
                images, indices = arrays[1], arrays[2].numpy()
            self.ce.start_admission(ids, images, indices)
        elif op == "chunk":
            self.ce.admission_step()
        elif op == "tick":
            for rid, res in self.ce.step():
                _keep(self.finished, rid, res)
        else:
            raise ValueError(f"unknown lockstep op: {msg!r}")
        self.trace.append(op)


def follower_serve(
    engine: InferenceEngine, *, continuous: bool = False,
    max_batch: int = 8, tick: int = 16,
) -> FollowerReplayer:
    """Run on every rank of the mesh but 0: replay the primary's actions until it
    publishes SHUTDOWN (IDLE beats are skipped). An action that fails is
    logged and the loop goes on (the primary fails the same request alone
    and serves on; a follower that left would stall the next collective).
    A channel that fails (a rank died, or the primary stopped beating)
    raises. -> the replayer, with what it answered."""
    comm = lockstep_comm(engine)
    if comm is None or multihost.is_primary(comm):
        raise ValueError("follower_serve runs on ranks 1.. of an engine over a mesh of more "
                         "than one rank")
    replayer = FollowerReplayer(engine, continuous=continuous, max_slots=max_batch, tick=tick)
    while True:
        msg, arrays = multihost.publish_blob(comm)
        if msg == multihost.SHUTDOWN:
            return replayer
        if msg == multihost.IDLE:
            continue
        try:
            replayer.handle(msg, arrays)
        except Exception:
            logger.exception("follower action replay failed; staying in lockstep")


class _Channel:
    """The primary's end of the lockstep channel: publish_blob over ``comm``
    under the server's generate_lock, an idle heartbeat (a quarter of the
    comm's timeout), and the SHUTDOWN that ends it. A publish that fails
    (a follower died) shuts the HTTP server down through ``on_error``."""

    def __init__(self, comm: Comm, lock: threading.Lock, on_error):
        self.comm, self.lock = comm, lock
        self.error: Optional[BaseException] = None
        self._on_error = on_error
        self.heartbeat = multihost.Heartbeat(self.publish, lock, comm.timeout / 4,
                                             on_error=self._failed)

    def _failed(self, exc: BaseException) -> None:
        if self.error is None:
            self.error = exc
            self._on_error(exc)

    def publish(self, msg, arrays=()):
        if self.error is not None:
            raise RuntimeError("the lockstep channel failed") from self.error
        try:
            out = multihost.publish_blob(self.comm, msg, arrays)
        except multihost.PayloadTooLarge:
            raise  # refused before any collective: the request fails alone
        except BaseException as exc:
            self._failed(exc)
            raise
        self.heartbeat.touch()
        return out

    def close(self) -> None:
        """Publish SHUTDOWN, the channel's last message (the batcher is
        stopped first). Raises if the channel had failed."""
        self.heartbeat.stop()
        with self.lock:
            if self.error is not None:
                raise RuntimeError("the lockstep channel failed") from self.error
            multihost.shutdown(self.comm)


def make_server(
    engine: InferenceEngine, host: str = "0.0.0.0", port: int = 5001,
    *, max_batch: int = 8, batch_window_s: float = 0.02,
    continuous: bool = False, tick: int = 16,
) -> ThreadingHTTPServer:
    """The HTTP server (not started: serve_forever). On an engine over a
    mesh of more than one rank this is rank 0's side, and it publishes to
    the followers;
    stop it with close_server once serve_forever has returned."""
    comm = lockstep_comm(engine)
    if comm is not None and not multihost.is_primary(comm):
        raise ValueError(f"rank {comm.rank} follows the primary: run follower_serve on it "
                         "(rank 0 serves)")
    handler = type("BoundHandler", (LongVITARequestHandler,), {"engine": engine})
    server = ThreadingHTTPServer((host, port), handler)
    server.generate_lock = threading.Lock()  # the beam / serial path
    server.batcher = None
    server.channel = None
    publish = None
    if comm is not None:
        server.channel = _Channel(
            comm, server.generate_lock,
            on_error=lambda exc: threading.Thread(target=server.shutdown, daemon=True).start())
        publish = server.channel.publish
    if max_batch > 1:
        if continuous:
            server.batcher = ContinuousBatcher(
                engine, max_slots=max_batch, tick=tick, generate_lock=server.generate_lock,
                publish=publish,
            )
        else:
            server.batcher = RequestBatcher(
                engine, max_batch=max_batch, window_s=batch_window_s,
                generate_lock=server.generate_lock, publish=publish,
            )
    return server


def close_server(server: ThreadingHTTPServer, timeout: float = 60.0) -> None:
    """Stop a server made by make_server after serve_forever has returned.
    The order matters on the lockstep channel: stop (and join) the batcher
    first, then publish SHUTDOWN under generate_lock, so that no admit,
    chunk or tick can follow it."""
    try:
        if server.batcher is not None:
            server.batcher.stop(timeout=timeout)
        if server.channel is not None:
            server.channel.close()
    finally:
        server.server_close()


def run_server(engine: InferenceEngine, host="0.0.0.0", port=5001,
               continuous: bool = False, max_batch: int = 8, tick: int = 16):
    """Serve PUT /api until interrupted; on an engine over a mesh of more
    than one rank, rank 0 serves and every other rank replays
    (follower_serve) until rank 0 stops."""
    comm = lockstep_comm(engine)
    if comm is not None and not multihost.is_primary(comm):
        print(f"rank {comm.rank}: replaying rank 0's actions")
        follower_serve(engine, continuous=continuous, max_batch=max_batch, tick=tick)
        return
    server = make_server(
        engine, host, port, continuous=continuous, max_batch=max_batch, tick=tick,
    )
    print(f"long-vita-tpu-torch server listening on {host}:{port} (PUT /api)")
    try:
        server.serve_forever()
    finally:
        close_server(server)
