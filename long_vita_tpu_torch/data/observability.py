"""Data-pipeline observability: what the run fed the model, in its output dir.

Counterpart of long_vita_tpu/data/observability.py (the reference's xlsx
sample workbook and print_batch dumps, long_vita/data/utils.py:51 draw_data,
pretrain_long_vita.py:699-774): per-source statistics in data_report.json,
the first decoded samples in data_samples.json, skipped samples in
data_error.log and the first batch decoded in print_batch.log, each with the
JAX package's keys and layout.
"""
from __future__ import annotations

import collections
import json
import os

import numpy as np

from long_vita_tpu_torch.constants import IGNORE_INDEX


class DataReport:
    """Accumulates per-source sample stats; writes data_report.json + a
    sample sheet of decoded examples."""

    def __init__(self, output_dir: str, tokenizer=None, sample_limit: int = 5):
        self.output_dir = output_dir
        self.tokenizer = tokenizer
        self.sample_limit = sample_limit
        self.stats = collections.defaultdict(
            lambda: {"samples": 0, "tokens": 0, "supervised_tokens": 0,
                     "images": 0}
        )
        self.samples: list[dict] = []
        os.makedirs(output_dir, exist_ok=True)

    def record(self, source: str, input_ids, labels, num_images: int = 0):
        s = self.stats[source]
        s["samples"] += 1
        s["tokens"] += len(input_ids)
        s["supervised_tokens"] += int(
            np.sum(np.asarray(labels) != IGNORE_INDEX)
        )
        s["images"] += num_images
        if len(self.samples) < self.sample_limit and self.tokenizer:
            sup = [t for t, l in zip(input_ids, labels) if l != IGNORE_INDEX]
            self.samples.append({
                "source": source,
                "num_tokens": len(input_ids),
                "num_images": num_images,
                "text": self.tokenizer.decode(input_ids[:2048]),
                "supervised_text": self.tokenizer.decode(sup[:512]),
            })

    def record_error(self, source: str, error: str, sample=None):
        """data_error.log semantics (reference dataset_base.py:292-303)."""
        with open(os.path.join(self.output_dir, "data_error.log"), "a") as f:
            print("-" * 100, file=f)
            print(f"source={source}: {error}", file=f)
            if sample is not None:
                print(json.dumps(sample, default=str)[:2000], file=f)

    def flush(self):
        with open(os.path.join(self.output_dir, "data_report.json"), "w") as f:
            json.dump(
                {k: dict(v) for k, v in sorted(self.stats.items())},
                f, indent=2,
            )
        if self.samples:
            with open(
                os.path.join(self.output_dir, "data_samples.json"), "w"
            ) as f:
                json.dump(self.samples, f, indent=2, ensure_ascii=False)


def dump_first_batch(output_dir: str, batch: dict, tokenizer) -> None:
    """print_batch_{rank}.log semantics: decode the first batch to text so a
    human can eyeball the supervision (reference pretrain_long_vita.py:699)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "print_batch.log"), "w") as f:
        tokens = np.asarray(batch["tokens"])
        for b in range(min(tokens.shape[0], 2)):
            print(f"=== batch row {b} ===", file=f)
            print(tokenizer.decode(tokens[b].tolist()[:4096]), file=f)
            labels = np.asarray(batch["labels"])[b]
            keep = labels != IGNORE_INDEX
            print("--- supervised ---", file=f)
            print(tokenizer.decode(labels[keep].tolist()[:1024]), file=f)
