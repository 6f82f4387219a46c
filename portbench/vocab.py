"""The tokenizer the benchmark serves with, and the ids its traffic is made of.

``assets/tokenizer`` is a frozen copy of the repository's Qwen2 tokenizer
fixture (a 4096-id byte-level BPE with Qwen2.5's 22 added tokens).
``tokenizer_dir`` writes it with its vocabulary padded so that the added
tokens take Qwen2.5's ids (151643..), and the 17 multimodal tokens that the
port adds follow them. ``assets/vocab.json`` lists the fixture's one-id
words (a space and letters, which the BPE's split keeps apart) and the ids
of the chat template around a user's message; the traffic generators build
text from those words, so both the text and its ids are known without a
tokenizer, and the plain reference builds the prompt ids from them.
"""
from __future__ import annotations

import functools
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "assets")


@functools.lru_cache(maxsize=1)
def assets() -> dict:
    with open(os.path.join(ASSETS, "vocab.json"), encoding="utf-8") as f:
        return json.load(f)


def first_special(vocab_size: int) -> int:
    """The first added token's id for a model of ``vocab_size`` rows:
    Qwen2.5's 151643 for its 152064 rows; at a smaller (test) vocabulary, the
    fixture's own 4096 (its BPE unpadded)."""
    return 151643 if vocab_size >= 152064 else assets()["bpe_size"]


class Ids:
    """The special and template ids at one vocabulary's padding."""

    def __init__(self, vocab_size: int):
        a = assets()
        self.base = first_special(vocab_size)
        self.special = {k: self.base + v for k, v in a["special"].items()}
        self.words = [w[0] for w in a["words"]]
        self.texts = [w[1] for w in a["words"]]

    def of(self, piece) -> list[int]:
        return [self.special[p] if isinstance(p, str) else int(p) for p in piece]

    def piece(self, key: str) -> list[int]:
        return self.of(assets()[key])

    def chat(self, content: list[int]) -> list[int]:
        """The served prompt: a user turn holding ``content`` and the
        assistant's head (the long_vita template, no system turn)."""
        return self.piece("user_head") + content + self.piece("turn_end") + self.piece(
            "assistant_head")


def tokenizer_dir(dst: str, vocab_size: int) -> str:
    """Write the fixture into ``dst`` padded (or left) to the model's first
    added id; the padding entries are unreachable (no merge makes them).
    -> dst."""
    base = first_special(vocab_size)
    src = os.path.join(ASSETS, "tokenizer")
    with open(os.path.join(src, "tokenizer.json"), encoding="utf-8") as f:
        tj = json.load(f)
    with open(os.path.join(src, "tokenizer_config.json"), encoding="utf-8") as f:
        config = json.load(f)
    model = tj["model"]
    vocab = {t: i for t, i in model["vocab"].items() if i < base}
    model["merges"] = [m for m in model["merges"] if "".join(m) in vocab]
    vocab.update((f"<|pad_{i}|>", i) for i in range(len(vocab), base))
    model["vocab"] = vocab
    for k, t in enumerate(sorted(tj["added_tokens"], key=lambda t: t["id"])):
        t["id"] = base + k
    config["added_tokens_decoder"] = {
        str(base + k): d for k, (_, d) in enumerate(
            sorted(config["added_tokens_decoder"].items(), key=lambda kv: int(kv[0])))}
    os.makedirs(dst, exist_ok=True)
    for name, obj in (("tokenizer.json", tj), ("tokenizer_config.json", config)):
        path = os.path.join(dst, name)
        text = json.dumps(obj, ensure_ascii=False)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                if f.read() == text:
                    continue
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    return dst
