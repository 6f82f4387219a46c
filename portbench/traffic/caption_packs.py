"""Stage-1 alignment samples: a single-tile image (from a pool of uint8
images made from the seed) and a caption of one-id words, as ChatML
conversations with the image in the user's turn. Parameters
(``traffic/<mix>.json``): caption_ids [lo, hi] (log-uniform), block,
samples (planned, enough for the set-up's steps and the window's), pool
(distinct images)."""
from __future__ import annotations

from portbench.traffic import blocks, frame_pool, quantiles, rng_of, words


def generate(p: dict, seed: int, ids, image_size: int) -> dict:
    rng = rng_of(seed, "caption_packs")
    lo, hi = p["caption_ids"]
    lengths = blocks(rng, quantiles(p["block"], lo, hi, log=True), p["samples"])
    pool = frame_pool(rng_of(seed, "images"), p["pool"], image_size)
    samples = []
    for k, n in enumerate(lengths):
        text, cids = words(rng, ids, int(n))
        samples.append({"index": k, "image": int(rng.integers(0, p["pool"])),
                        "caption": text, "caption_ids": cids})
    return {"pool": pool, "samples": samples}


def conversation(plan: dict, s: dict) -> dict:
    """The sample as the port's data path takes it (data/dataset.py)."""
    return {"messages": [{"role": "user", "content": "<image>"},
                         {"role": "assistant", "content": s["caption"]}],
            "images": [plan["pool"][s["image"]]]}
