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
tick. One process serves one device: the JAX package's multi-host lockstep
(FollowerReplayer, follower_serve) is not ported.
"""
from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from long_vita_tpu_torch.inference.engine import InferenceEngine
from long_vita_tpu_torch.inference.sampler import SamplingParams


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
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.window_s = window_s
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
        start_thread: bool = True,
    ):
        from long_vita_tpu_torch.inference.continuous import ContinuousEngine

        self.engine = engine
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
                imgs = exp.images
                if imgs is None or np.asarray(imgs).shape[0] == 0:
                    imgs = idx = None
                else:
                    idx = np.asarray(exp.image_indices, np.int64)
                if switch_req is not None:
                    # the sampling switch rides a successful expand
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
                self.ce.admission_step()  # ONE chunk
                self.trace.append("chunk")
                did = True
            elif self._start_next_locked():
                did = True
            if self.ce.active:
                finished = self.ce.step()
                self.trace.append("tick")
                self.batch_sizes.append(self.ce.active + len(finished))
                did = True
            else:
                finished = []
        for rid, result in finished:
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


def make_server(
    engine: InferenceEngine, host: str = "0.0.0.0", port: int = 5001,
    *, max_batch: int = 8, batch_window_s: float = 0.02,
    continuous: bool = False, tick: int = 16,
) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (LongVITARequestHandler,), {"engine": engine})
    server = ThreadingHTTPServer((host, port), handler)
    server.generate_lock = threading.Lock()  # the beam / serial path
    server.batcher = None
    if max_batch > 1:
        if continuous:
            server.batcher = ContinuousBatcher(
                engine, max_slots=max_batch, tick=tick, generate_lock=server.generate_lock,
            )
        else:
            server.batcher = RequestBatcher(
                engine, max_batch=max_batch, window_s=batch_window_s,
                generate_lock=server.generate_lock,
            )
    return server


def run_server(engine: InferenceEngine, host="0.0.0.0", port=5001,
               continuous: bool = False, max_batch: int = 8, tick: int = 16):
    server = make_server(
        engine, host, port, continuous=continuous, max_batch=max_batch, tick=tick,
    )
    print(f"long-vita-tpu-torch server listening on {host}:{port} (PUT /api)")
    try:
        server.serve_forever()
    finally:
        if server.batcher is not None:
            server.batcher.stop()
        server.server_close()
