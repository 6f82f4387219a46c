"""Serving cells: the port's continuous scheduler driven in process.

The requests are the server's own request dicts (inference/server.py's
``PUT /api`` body) handed to ``ContinuousBatcher.submit_async``, and this
loop calls ``iteration()`` as the server's scheduler thread would, stamping
each one on the host clock. A closed loop keeps ``clients`` requests
outstanding; an open loop sends each request when it is due.

The window opens when its first request is sent. A closed loop's window
closes at the first answer after ``--seconds``; its rate counts the prompt
tokens of every request answered up to then. An open loop sends the
requests due in ``--seconds`` and waits up to ``grace_s`` past the close for
each; its latency is first-token time minus due time, and a request never
answered counts at the wait it was given.

Set-up warms up every shape the cell's traffic takes through the same
scheduler: one request of each frame count (or of the shortest and longest
prompt), and one decode tick at the traffic's own sampling settings. Once the window has closed and the peak memory has been read,
the program's state is freed and a sample of the answered requests (the
longest among them) is judged against the plain reference.
"""
from __future__ import annotations

import gc
import os
import sys
import time
import types

import torch

from portbench import harness, system, vocab
from portbench.reference import serving as ref_serving
from portbench.trace import Trace, note
from portbench.traffic import rng_of
from portbench.weights import dims


def expected_tokens(ids, req: dict, n: dict) -> int:
    """The prompt's length after the front end's expansion: the chat
    template, the text, and each frame's block of context ids between its
    <vid> and </vid>."""
    base = len(ids.chat(req["content_ids"]))
    if req["frames"] is None:
        return base
    return base - 1 + len(req["frames"]) * (n["tokens"] + 2)


def _warm(batcher, gen, plan) -> None:
    """The warm-up: each warm-up request (the traffic's shapes: every frame
    count, or the shortest and longest prompt) admitted with a one-token
    answer, which needs no decode tick, then the last of them again as the
    traffic sends it, which runs the ticks."""
    reqs = [{**gen.server_request(plan, r), "tokens_to_generate": 1} for r in plan["warmup"]]
    reqs.append(gen.server_request(plan, plan["warmup"][-1]))
    for req in reqs:
        box = batcher.submit_async(req)
        while not box["event"].is_set():
            batcher.iteration()
        if "error" in box:
            raise RuntimeError(f"warm-up request failed: {box['error']!r}")


class Window:
    """The measured window of one run and what it recorded."""

    def __init__(self, env, batcher, gen, plan, ids, n):
        self.env, self.batcher, self.gen, self.plan, self.ids, self.n = env, batcher, gen, plan, \
            ids, n
        self.recs: list = []
        self.live: list = []
        self.iterations: list = []
        self.unadmitted: list = []
        self.admitting = None
        self.trace = None
        self.traced = None  # (first, last + 1) iteration indices inside the trace
        self.t_open = self.close = None

    def submit(self, req: dict, due: float) -> None:
        box = self.batcher.submit_async(self.gen.server_request(self.plan, req), stream=True)
        rec = {"req": req, "box": box, "due": due, "sent": time.perf_counter(), "first": None,
               "done": None, "admit": None, "chunks": 0,
               "tokens": expected_tokens(self.ids, req, self.n)}
        self.recs.append(rec)
        self.live.append(rec)
        self.unadmitted.append(rec)

    def step(self) -> float:
        """One scheduler iteration, recorded. -> its end time."""
        b = self.batcher
        t = self.env.cell.get("trace", {})
        if self.env.trace and self.trace is None and self.traced is None and \
                time.perf_counter() >= self.t_open + t.get("start_frac", 0.3) * self.env.seconds:
            self.trace = Trace()
            self.trace.start()
            self.trace_from = len(self.iterations)
        n0 = len(b.trace)
        with note("iteration"):
            t0 = time.perf_counter()
            b.iteration()
            t1 = time.perf_counter()
        acts = b.trace[n0:]
        it = {"t0": t0, "t1": t1, "acts": acts, "admit": None, "chunk": None}
        if "admit" in acts:
            self.admitting = self.unadmitted.pop(0)
            self.admitting["admit"] = t0
            it["admit"] = self.admitting
        elif "chunk" in acts:
            it["chunk"] = (self.admitting, self.admitting["chunks"])
            self.admitting["chunks"] += 1
        self.iterations.append(it)
        if self.trace is not None and t1 >= self.trace.t0 + t.get("seconds", 6.0):
            self.stop_trace()
        for rec in list(self.live):
            box = rec["box"]
            if rec["first"] is None and (not box["stream_q"].empty() or box["event"].is_set()):
                rec["first"] = t1
            if box["event"].is_set():
                rec["done"] = t1
                self.live.remove(rec)
                if rec in self.unadmitted:
                    self.unadmitted.remove(rec)
                if "error" in box:
                    rec["error"] = repr(box["error"])
                else:
                    rec["result"] = box["rows"][0]
                self.on_done(rec, t1)
        return t1

    def stop_trace(self) -> None:
        if self.trace is not None:
            self.trace.stop()
            self.traced = (self.trace_from, len(self.iterations))
            self.trace_obj, self.trace = self.trace, None

    def on_done(self, rec, t1) -> None:
        pass


class Closed(Window):
    def run(self) -> None:
        load, reqs = self.env.cell["load"], self.plan["requests"]
        self.next = 0

        def nxt():
            req = reqs[self.next % len(reqs)]
            self.next += 1
            return req

        self.nxt = nxt
        self.t_open = time.perf_counter()
        for _ in range(load["clients"]):
            self.submit(nxt(), time.perf_counter())
        while self.close is None:
            self.step()
        self.stop_trace()

    def on_done(self, rec, t1) -> None:
        if self.close is None and t1 >= self.t_open + self.env.seconds:
            self.close = t1
        elif self.close is None:
            self.submit(self.nxt(), t1)


class Open(Window):
    def run(self) -> None:
        reqs = [r for r in self.plan["requests"] if r["due"] < self.env.seconds]
        grace = self.env.cell["load"].get("grace_s", 60.0)
        self.t_open = time.perf_counter()
        self.close = self.t_open + self.env.seconds
        k = 0
        while True:
            now = time.perf_counter()
            while k < len(reqs) and self.t_open + reqs[k]["due"] <= now:
                self.submit(reqs[k], self.t_open + reqs[k]["due"])
                k += 1
            if not self.live:
                if k == len(reqs):
                    break
                time.sleep(max(0.0, self.t_open + reqs[k]["due"] - time.perf_counter()))
                continue
            if now > self.close + grace:
                break
            self.step()
        self.stop_trace()
        self.waited = time.perf_counter()


def build(env):
    """The traffic's plan, the program with the seed's weights, and its
    scheduler warmed up."""
    dev = torch.device("cuda", 0) if env.device == "cuda" else torch.device(env.device)
    cfg = env.cfg
    n = dims(cfg)
    ids = vocab.Ids(cfg["vocab_size"])
    gen = harness.module("traffic", env.mix["generator"])
    plan = gen.generate(env.mix, env.seed, ids, n["image"])
    tree = system.params(cfg, env.seed, dev)
    tokdir = vocab.tokenizer_dir(os.path.join(harness.WORK, f"tokenizer-{ids.base}"),
                                 cfg["vocab_size"])
    engine, batcher = system.serving(tree, cfg, system.multimodal(tokdir, cfg),
                                     env.cell["server"])
    _warm(batcher, gen, plan)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dev, n, ids, gen, plan, tree, engine, batcher


def run(env):
    cfg, cell = env.cfg, env.cell
    dev, n, ids, gen, plan, tree, engine, batcher = build(env)
    launches0 = system.kernel_launches()
    setup_s = time.perf_counter() - env.t0
    win = (Closed if cell["load"]["loop"] == "closed" else Open)(env, batcher, gen, plan, ids, n)
    win.run()
    launches = {k: v - launches0[k] for k, v in system.kernel_launches().items()}
    device = harness.device_record(torch, 1) if dev.type == "cuda" else {"platform": "cpu"}

    # ---- end-to-end metrics ---------------------------------------------
    recs = win.recs
    failed = [r for r in recs if "error" in r]
    if cell["load"]["loop"] == "closed":
        answered = [r for r in recs if r["done"] is not None and r["done"] <= win.close
                    and "error" not in r]
        window_s = win.close - win.t_open
        attempted = [r for r in recs if r["sent"] <= win.close]
        e2e = {"prompt_tokens_per_s": sum(r["tokens"] for r in answered) / window_s}
    else:
        answered = [r for r in recs if r["first"] is not None and "error" not in r]
        failed += [r for r in recs if r["first"] is None and "error" not in r]
        window_s = env.seconds
        attempted = recs
        lat = [(r["first"] if r["first"] is not None else win.waited) - r["due"] for r in recs]
        e2e = {"ttft_p90_ms": harness.quantile(lat, 0.9) * 1e3}
    e2e["setup_s"] = setup_s
    kinds: dict = {}
    for it in win.iterations:
        k = "+".join(it["acts"]) or "idle"
        c, t = kinds.get(k, (0, 0.0))
        kinds[k] = (c + 1, t + it["t1"] - it["t0"])
    print("[serve] iterations: " + ", ".join(f"{k} {c} x {1e3 * t / c:.1f} ms"
                                             for k, (c, t) in sorted(kinds.items())),
          file=sys.stderr)
    print(f"[serve] setup {setup_s:.2f} s; window {window_s:.2f} s, {len(attempted)} sent, "
          f"{len(answered)} answered, {len(failed)} failed; {e2e}; launches {launches}",
          file=sys.stderr)
    ctx = types.SimpleNamespace(
        cell=env.cell_name, n=n, recs=recs, answered=answered, iterations=win.iterations,
        trace=getattr(win, "trace_obj", None), traced=win.traced, t_open=win.t_open,
        close=win.close, window_s=window_s, chunk=cell["server"]["chunk"],
        vision_chunk=cell["server"]["vision_chunk"])
    metrics = env.report(e2e, ctx)

    # ---- correctness: the answered requests against the plain reference ----
    pick = sorted(answered, key=lambda r: (-r["tokens"], r["req"]["index"]))
    rng = rng_of(env.seed, "judge")
    rest = pick[1:]
    k = min(cell["check"]["requests"], len(pick))
    chosen = pick[:1] + [rest[i] for i in sorted(rng.choice(len(rest), k - 1, replace=False))] \
        if k else []
    items = [{"content_ids": r["req"]["content_ids"],
              "frames": None if r["req"]["frames"] is None else plan["pool"][r["req"]["frames"]],
              "served": r["result"].token_ids} for r in chosen]
    got_tokens = [r["result"].prompt_tokens for r in chosen]
    del batcher, engine, tree, win
    ctx.recs = ctx.answered = ctx.iterations = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    judged = [it for it in items if it["served"]]
    lower = getattr(env, "control", False)
    out = ref_serving.judge(cfg, env.seed, judged, ids, dev, lower=lower) if judged else {
        "gaps": [], "prompt_tokens": [], "logprobs": [], "control_gaps": [],
        "control_logprobs": []}
    gaps = [g for per in out["gaps"] for g in per]
    served_lp = [r["result"].logprobs for r in chosen if r["result"].token_ids]
    lp_gaps = [abs(a - b) for got, ref in zip(served_lp, out["logprobs"])
               for a, b in zip(got, ref)]
    want = [expected_tokens(ids, r["req"], n) for r in chosen]
    ref_len = dict(zip([id(i) for i in judged], out["prompt_tokens"]))
    mismatched = sum(a != b for a, b in zip(got_tokens, want)) + sum(
        ref_len[id(i)] != w for i, w in zip(items, want) if id(i) in ref_len)
    print(f"[check] judged {len(judged)} requests, {len(gaps)} served tokens in "
          f"{time.perf_counter() - t:.1f} s; widest gap per request "
          f"{[round(max(p), 5) if p else None for p in out['gaps']]}; widest log-probability "
          f"distance {max(lp_gaps) if lp_gaps else None}", file=sys.stderr)
    limit = cell["check"]["max_gap"]
    lp_limit = cell["check"]["logprob_gap"]
    checks = {
        "max_gap": {"value": max(gaps) if gaps else 0.0, "limit": limit},
        "logprob_gap": {"value": max(lp_gaps) if lp_gaps else 0.0, "limit": lp_limit},
        "prompt_len_mismatch": {"value": mismatched, "limit": 0},
        # served tokens judged fewer than the cell's least
        "tokens_short": {"value": max(0, cell["check"]["min_tokens"] - len(gaps)), "limit": 0},
    }
    errored = sum("error" in r for r in recs)
    checks["errored"] = {"value": errored, "limit": 0}
    correct = harness.within(checks)
    result = {"correct": correct, "attempted": len(attempted), "failed": len(failed),
              "metrics": metrics, "device": device}
    if lower:
        # the control in the program's place, judged by the same predicate
        # at the same limits: only its gaps differ from the program's
        control = [g for per in out["control_gaps"] for g in per]
        clp = [abs(a - b) for low, ref in zip(out["control_logprobs"], out["logprobs"])
               for a, b in zip(low, ref)]
        low = {**checks, "max_gap": {"value": max(control) if control else 0.0, "limit": limit},
               "logprob_gap": {"value": max(clp) if clp else 0.0, "limit": lp_limit}}
        result["control_correct"] = harness.within(low)
        checks["control_max_gap"] = low["max_gap"]
        checks["control_logprob_gap"] = low["logprob_gap"]
        print(f"[control] widest gap per request "
              f"{[round(max(p), 5) if p else None for p in out['control_gaps']]}", file=sys.stderr)
    if env.trace and ctx.trace is not None:
        ctx.trace.add_to(result)
    return result, checks
