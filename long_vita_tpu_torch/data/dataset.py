"""Training dataset: YAML corpus config, ChatML supervision, greedy packing.

Counterpart of long_vita_tpu/data/dataset.py (reference dataset_base.py,
dataset_qwen2.py), host-side Python and numpy with the same results:

  - corpus config: YAML ``dataset: {name: {ratio, num, data_paths}}`` over
    json/jsonl files of samples {"conversations"|"messages": [{role,
    content}], "images": [...], "videos": [...]}: ratio subsamples or
    repeats, num caps, then one shuffle by seed. The walk draws from one
    ``random.Random(seed)`` in the JAX package's order, so both give the same
    sample order;
  - supervision: ChatML ``<|im_start|>{role}\\n{content}<|im_end|>\\n``;
    user and system turns masked; assistant content + <|im_end|> + "\\n"
    supervised, its role header masked (reference dataset_qwen2.py:489-527);
  - greedy packing to exactly ``max_len`` with per-source accumulators
    (reference maybe_init_ret/add_ret/process_ret :92-255): when the
    smallest open pack cannot take the next sample, the largest is emitted
    (padded with pad/IGNORE) and the sample starts a new one; segment ids
    per sample, positions restarting per segment.

``Pack`` and ``collate_packs`` live in training/loss.py (one copy, which the
Trainer uses without this module). yaml is imported inside ``load_corpus``,
so that the training path that is handed packs needs neither yaml nor PIL.
"""
from __future__ import annotations

import json
import logging
import os
import random
from typing import Iterator, Optional, Sequence

import numpy as np

from long_vita_tpu_torch.constants import IGNORE_INDEX
from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
from long_vita_tpu_torch.training.loss import Pack, collate_packs

__all__ = ["load_corpus", "ChatMLSupervision", "PackedDataset", "Pack", "collate_packs"]

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Corpus loading
# ---------------------------------------------------------------------------


def _load_json_file(path: str) -> list[dict]:
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        data = json.load(f)
        return data if isinstance(data, list) else [data]


def load_corpus(cfg_path: str, seed: int = 42) -> list[dict]:
    """YAML corpus -> shuffled list of samples tagged with their source."""
    import yaml

    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)

    rng = random.Random(seed)
    out: list[dict] = []
    for name, info in cfg.get("dataset", {}).items():
        ratio = info.get("ratio", 1)
        cap = info.get("num", None)
        if not ratio or cap == 0:
            continue
        rows: list[dict] = []
        for path in info.get("data_paths", []):
            if not os.path.exists(path):
                logger.warning("data file not found: %s", path)
                continue
            rows.extend(_load_json_file(path))
        if not rows:
            continue
        if ratio < 1:
            rows = rng.sample(rows, max(int(len(rows) * ratio), 1))
        elif ratio > 1:
            whole, frac = int(ratio), ratio - int(ratio)
            extra = rng.sample(rows, int(len(rows) * frac)) if frac else []
            rows = rows * whole + extra
        if cap is not None:
            rows = rows[:cap]
        for row in rows:
            row.setdefault("source", name)
        out.extend(rows)
    rng.shuffle(out)
    return out


# ---------------------------------------------------------------------------
# ChatML supervision
# ---------------------------------------------------------------------------

_HUMAN = {"user", "human"}
_GPT = {"assistant", "gpt"}
_SYSTEM = {"system"}


class ChatMLSupervision:
    """Render a conversation into (input_ids, labels) with assistant-only
    supervision, then expand its media tags."""

    def __init__(self, mm: MultimodalTokenizer, default_system_message: Optional[str] = None):
        self.mm = mm
        tok = mm.tokenizer
        self.nl = tok("\n", add_special_tokens=False).input_ids
        self.im_start = tok("<|im_start|>", add_special_tokens=False).input_ids
        self.im_end = tok("<|im_end|>", add_special_tokens=False).input_ids
        self.roles = {
            role: tok(role, add_special_tokens=False).input_ids
            for role in ("user", "assistant", "system")
        }
        self.default_system_message = default_system_message

    def render(self, sample: dict, is_begin: bool = True):
        """-> ExpandedInputs with labels (media expanded)."""
        messages = sample.get("conversations") or sample.get("messages") or []
        if is_begin and self.default_system_message and (
            not messages or messages[0]["role"] not in _SYSTEM
        ):
            messages = [{"role": "system", "content": self.default_system_message}] + list(
                messages
            )

        tok = self.mm.tokenizer
        ids: list[int] = []
        labels: list[int] = []
        for message in messages:
            role, content = message["role"], message["content"]
            body = tok(content, add_special_tokens=False).input_ids
            if role in _GPT:
                head = self.im_start + self.roles["assistant"] + self.nl
                tail = body + self.im_end + self.nl
                ids += head + tail
                labels += [IGNORE_INDEX] * len(head) + tail
            elif role in _HUMAN or role in _SYSTEM:
                name = "system" if role in _SYSTEM else "user"
                part = self.im_start + self.roles[name] + self.nl + body + self.im_end + self.nl
                ids += part
                labels += [IGNORE_INDEX] * len(part)
            else:
                raise ValueError(f"unknown role {role}")

        return self.mm.expand(
            ids,
            images=sample.get("images", []) or [],
            videos=sample.get("videos", []) or [],
            labels=labels,
        )


# ---------------------------------------------------------------------------
# Greedy packing
# ---------------------------------------------------------------------------


class _Accumulator:
    def __init__(self):
        self.tokens: list[int] = []
        self.labels: list[int] = []
        self.position_ids: list[int] = []
        self.segment_ids: list[int] = []
        self.images: list[np.ndarray] = []
        self.image_indices: list[np.ndarray] = []
        self.actual_seq_len: list[int] = []
        self.num_segments = 0

    def __len__(self):
        return len(self.tokens)

    def add(self, ex):
        n = len(ex.input_ids)
        offset = len(self.tokens)
        if ex.images is not None:
            idx = ex.image_indices.copy()
            idx[1] += offset  # reference add_ret:147 index shift
            self.images.append(ex.images)
            self.image_indices.append(idx)
        self.tokens += list(ex.input_ids)
        self.labels += list(ex.labels)
        self.position_ids += list(range(n))
        self.segment_ids += [self.num_segments] * n
        self.actual_seq_len.append(offset + n)
        self.num_segments += 1


class PackedDataset:
    """Greedy packer over a sample stream (iterable; yields full packs).
    ``report`` (data.observability.DataReport) records every sample packed
    and every one skipped, and is flushed when the stream ends."""

    def __init__(
        self,
        samples: Sequence[dict],
        supervision: ChatMLSupervision,
        max_len: int,
        pad_token_id: int = 151643,
        cross_dataset_joint: bool = False,
        num_joint_buffers: int = 2,
        report=None,
    ):
        self.samples = samples
        self.supervision = supervision
        self.max_len = max_len
        self.pad_token_id = pad_token_id
        self.cross_dataset_joint = cross_dataset_joint
        self.num_joint_buffers = num_joint_buffers
        self.report = report

    def _finalize(self, acc: _Accumulator) -> Pack:
        pad = self.max_len - len(acc)
        tokens = acc.tokens + [self.pad_token_id] * pad
        labels = acc.labels + [IGNORE_INDEX] * pad
        last_pos = acc.position_ids[-1] if acc.position_ids else -1
        positions = acc.position_ids + list(range(last_pos + 1, last_pos + 1 + pad))
        segments = acc.segment_ids + [acc.num_segments] * pad
        asl = list(acc.actual_seq_len)
        if asl:
            asl[-1] = self.max_len if pad == 0 else asl[-1]
        if pad:
            asl.append(self.max_len)
        return Pack(
            tokens=np.asarray(tokens[: self.max_len], np.int32),
            labels=np.asarray(labels[: self.max_len], np.int32),
            position_ids=np.asarray(positions[: self.max_len], np.int32),
            segment_ids=np.asarray(segments[: self.max_len], np.int32),
            images=np.concatenate(acc.images, axis=0) if acc.images else None,
            image_indices=(
                np.concatenate(acc.image_indices, axis=1) if acc.image_indices else None
            ),
            actual_seq_len=asl,
        )

    def __iter__(self) -> Iterator[Pack]:
        accs: dict[str, _Accumulator] = {}
        if self.cross_dataset_joint:
            for i in range(self.num_joint_buffers):
                accs[f"joint_{i}"] = _Accumulator()

        for sample in self.samples:
            source = sample.get("source", "default")
            try:
                ex = self.supervision.render(sample)
            except Exception as err:  # noqa: BLE001 — the reference logs and skips (:349-357)
                logger.exception("bad sample skipped (source=%s)", source)
                if self.report:
                    self.report.record_error(source, str(err), sample)
                continue
            n = len(ex.input_ids)
            if n > self.max_len:
                continue  # the reference drops over-long samples (:322-323)
            if self.report:
                self.report.record(
                    source, ex.input_ids, ex.labels,
                    num_images=0 if ex.images is None else ex.images.shape[0],
                )

            if self.cross_dataset_joint:
                smallest = min(accs, key=lambda k: len(accs[k]))
                largest = max(accs, key=lambda k: len(accs[k]))
            else:
                accs.setdefault(source, _Accumulator())
                smallest = largest = source

            if len(accs[smallest]) + n > self.max_len:
                full = accs.pop(largest)
                accs[largest] = _Accumulator()
                accs[largest].add(ex)
                yield self._finalize(full)
            else:
                accs[smallest].add(ex)

        for acc in accs.values():  # drain the non-empty buffers
            if len(acc):
                yield self._finalize(acc)
        if self.report:
            self.report.flush()
