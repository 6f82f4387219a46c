"""Local evaluation runner: jsonl QA sets without VLMEvalKit.

Counterpart of long_vita_tpu/eval/simple_eval.py. Each line: {"prompt":
"...<image>...", "images": [...], "videos": [...], "answer": "...", "id":
optional}. Scoring: exact match after normalisation, and a contains match,
after the reference evals' "Answer:" post-processing (postprocess_answer).
Host code only: the model runs in the engine or behind the server.

Usage:
    python -m long_vita_tpu_torch.eval.simple_eval --model /path/ckpt --data qa.jsonl
    python -m long_vita_tpu_torch.eval.simple_eval --url http://host:5001/api --data qa.jsonl
"""
from __future__ import annotations

import argparse
import json
import re
from typing import Optional

from long_vita_tpu_torch.eval.vlmeval_adapter import postprocess_answer


def _normalize(s: str) -> str:
    return re.sub(r"[^a-z0-9 ]", "", s.lower()).strip()


def score(prediction: str, answer: str) -> dict:
    p, a = _normalize(postprocess_answer(prediction)), _normalize(answer)
    return {"exact": p == a, "contains": a in p if a else False}


def run_eval(
    data_path: str,
    *,
    engine=None,
    url: Optional[str] = None,
    max_new_tokens: int = 64,
    out_path: Optional[str] = None,
) -> dict:
    """Greedy answers to every line of ``data_path`` from ``engine`` (an
    InferenceEngine) or the server at ``url``. -> {"summary": {n, exact,
    contains}, "results": the lines with their prediction and scores}."""
    with open(data_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    results = []
    for row in rows:
        prompt = row["prompt"]
        images = row.get("images", [])
        videos = row.get("videos", [])
        if engine is not None:
            from long_vita_tpu_torch.inference.sampler import SamplingParams

            res = engine.generate(
                [{"role": "user", "content": prompt}], images=images, videos=videos,
                sampling=SamplingParams(greedy=True, max_new_tokens=max_new_tokens),
            )
            pred = res.text
        else:
            from long_vita_tpu_torch.inference import client

            pred = client.generate(
                prompt, url=url, image_path_list=images, video_path_list=videos,
                tokens_to_generate=max_new_tokens,
            )
        results.append({**row, "prediction": pred, **score(pred, row.get("answer", ""))})

    n = max(len(results), 1)
    summary = {
        "n": len(results),
        "exact": sum(r["exact"] for r in results) / n,
        "contains": sum(r["contains"] for r in results) / n,
    }
    if out_path:
        with open(out_path, "w") as f:
            for r in results:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
            f.write(json.dumps({"summary": summary}) + "\n")
    return {"summary": summary, "results": results}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--url", default=None)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    engine = None
    if args.model:
        from long_vita_tpu_torch.inference.cli import build_engine

        engine = build_engine(args.model)
    out = run_eval(args.data, engine=engine, url=args.url,
                   max_new_tokens=args.max_new_tokens, out_path=args.out)
    print(json.dumps(out["summary"]))


if __name__ == "__main__":
    main()
