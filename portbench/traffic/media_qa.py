"""Questions about videos: each request one video of pre-extracted uint8
frames (drawn from a pool made from the seed), a question of one-id words
and a greedy answer under one cap on new tokens that every request sends, as
an evaluation run does. Parameters (``traffic/<mix>.json``): frames (the
frame counts, drawn equally often in complementary pairs; see
``paired_frames``), question_ids [lo, hi] (log-uniform), max_new_tokens,
block (requests per block of quantiles), requests (planned; a closed loop
wraps around), pool (distinct frames)."""
from __future__ import annotations

import numpy as np

from portbench.traffic import blocks, frame_pool, quantiles, rng_of, words


def _requests(p: dict, rng, ids, count: int, frame_counts) -> list[dict]:
    qlo, qhi = p["question_ids"]
    n = p["block"]
    questions = blocks(rng, quantiles(n, qlo, qhi, log=True), count)
    out = []
    for k in range(count):
        text, qids = words(rng, ids, int(questions[k]))
        f = int(frame_counts[k])
        out.append({
            "index": k,
            "content": "<video>" + text,
            "content_ids": [ids.special["<video>"]] + qids,
            "frames": rng.integers(0, p["pool"], f),
            "answer": int(p["max_new_tokens"]),
        })
    return out


def paired_frames(rng, frames, count: int) -> np.ndarray:
    """Frame counts drawn equally often, in pairs that hold the same
    frames: the smallest count with the largest, and so on inward, the
    pairs and the order inside each drawn from the seed. Any even run of
    requests then holds the same frames whatever the seed (a closed loop's
    window answers ~10 requests, and a part-block would change its work)."""
    f = sorted(frames)
    pairs = [(f[i], f[-1 - i]) for i in range(-(-len(f) // 2))]
    out = []
    while len(out) < count:
        for k in rng.permutation(len(pairs)):
            out += list(rng.permutation(pairs[k]))
    return np.asarray(out[:count])


def generate(p: dict, seed: int, ids, image_size: int) -> dict:
    rng = rng_of(seed, "media_qa")
    counts = paired_frames(rng, p["frames"], p["requests"])
    return {
        "pool": frame_pool(rng_of(seed, "frames"), p["pool"], image_size),
        "requests": _requests(p, rng, ids, p["requests"], counts),
        "warmup": _requests(p, rng_of(seed, "warmup"), ids, len(p["frames"]),
                            np.asarray(sorted(p["frames"]))),
    }


def server_request(plan: dict, req: dict) -> dict:
    """The server's request dict (inference/server.py's PUT /api body)."""
    return {
        "prompts": [req["content"]],
        "video_path_list": [plan["pool"][req["frames"]]],
        "tokens_to_generate": req["answer"],
        "logprobs": True,
    }
