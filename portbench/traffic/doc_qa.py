"""Multiple-choice questions over long documents: text prompts of an exact
number of ids (one-id words inside the chat template), a one-token greedy
answer, and open-loop arrivals. Parameters (``traffic/<mix>.json``):
prompt_ids [lo, hi] (log-uniform, counted with the template), block,
requests, rate (requests a second, Poisson: the gaps are the quantiles of an
exponential, drawn in another order per block).

Every seed sends the same lengths and gaps in another order, and its own
words. An open loop's tail follows the order in which long prompts arrive:
on one H100 at 1.2 requests a second over a 45 s window (~54 requests), the
90th percentile of first-token times read 1.9-3.6 s over six seeds, where
one seed run twice agreed within 1-4%; a cell of this mix needs more
requests in its window than that."""
from __future__ import annotations

import numpy as np

from portbench.traffic import blocks, quantiles, rng_of, words


def _requests(p: dict, rng, ids, lengths) -> list[dict]:
    frame = len(ids.chat([]))
    out = []
    for k, n in enumerate(lengths):
        text, qids = words(rng, ids, int(n) - frame)
        out.append({"index": k, "content": text, "content_ids": qids, "frames": None,
                    "answer": 1})
    return out


def generate(p: dict, seed: int, ids, image_size: int) -> dict:
    order = rng_of(seed, "doc_qa_schedule")
    lo, hi = p["prompt_ids"]
    n = p["block"]
    lengths = blocks(order, quantiles(n, lo, hi, log=True), p["requests"])
    q = (np.arange(n) + 0.5) / n
    gaps = blocks(order, -np.log1p(-q) / p["rate"], p["requests"])
    reqs = _requests(p, rng_of(seed, "doc_qa"), ids, lengths)
    due = 0.0
    for r, g in zip(reqs, gaps):
        r["due"] = due
        due += float(g)
    return {"pool": None, "requests": reqs,
            "warmup": _requests(p, rng_of(seed, "warmup"), ids, [lo, hi])}


def server_request(plan: dict, req: dict) -> dict:
    return {"prompts": [req["content"]], "tokens_to_generate": req["answer"], "logprobs": True}

