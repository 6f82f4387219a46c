#!/usr/bin/env python3
"""Write the Qwen2-style tokenizer fixture that the port's tokenizer is held to.

    python3 tools/make_tokenizer_fixture.py [--out tests/data/qwen2_tokenizer_tiny]

Runs with the Hugging Face ``tokenizers`` package (not needed by the port):
trains a byte-level BPE of VOCAB entries (GPT-2's 256 byte characters and
its merges) on the repository's own text (the JAX package's Python
sources, English docstrings and code) with Qwen2's pipeline (the NFC normalizer, Qwen2's
Split pattern, the ByteLevel pre-tokenizer, post-processor and decoder),
then adds Qwen2.5's 22 added tokens in Qwen2.5's order with its flags
(<|endoftext|> .. <|video_pad|> special, <tool_call> .. <|file_sep|>
not; all unnormalized), so they take ids VOCAB .. VOCAB + 21. Writes
``tokenizer.json`` and a ``tokenizer_config.json`` with Qwen2.5-Instruct's
settings (Qwen2Tokenizer, eos <|im_end|>, pad <|endoftext|>, no unk or bos,
clean_up_tokenization_spaces false) and a chat template in Qwen2.5's
layout without its tool-call branches.

chip_smoke.tokenizer_dir cuts or pads the vocabulary so that the added
tokens sit at any id (151643 for Qwen2.5's), without this package.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 4096
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
               r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# Qwen2.5's added tokens 151643..151664, and whether each is special
ADDED = [
    ("<|endoftext|>", True), ("<|im_start|>", True), ("<|im_end|>", True),
    ("<|object_ref_start|>", True), ("<|object_ref_end|>", True), ("<|box_start|>", True),
    ("<|box_end|>", True), ("<|quad_start|>", True), ("<|quad_end|>", True),
    ("<|vision_start|>", True), ("<|vision_end|>", True), ("<|vision_pad|>", True),
    ("<|image_pad|>", True), ("<|video_pad|>", True), ("<tool_call>", False),
    ("</tool_call>", False), ("<|fim_prefix|>", False), ("<|fim_middle|>", False),
    ("<|fim_suffix|>", False), ("<|fim_pad|>", False), ("<|repo_name|>", False),
    ("<|file_sep|>", False),
]
CHAT_TEMPLATE = """{%- if messages[0]['role'] == 'system' %}
    {{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}
{%- else %}
    {{- '<|im_start|>system\\nYou are Qwen, created by Alibaba Cloud. You are a helpful assistant.<|im_end|>\\n' }}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant") %}
        {{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
{%- endif %}
"""


def corpus() -> list:
    files = sorted((ROOT / "long_vita_tpu").rglob("*.py"))
    return [str(p) for p in files]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(ROOT / "tests" / "data" / "qwen2_tokenizer_tiny"))
    args = parser.parse_args(argv)
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors, trainers)

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.post_processor = processors.ByteLevel(add_prefix_space=False, trim_offsets=False,
                                              use_regex=False)
    tok.decoder = decoders.ByteLevel(add_prefix_space=False, trim_offsets=False,
                                     use_regex=False)
    trainer = trainers.BpeTrainer(vocab_size=VOCAB, min_frequency=2, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train(corpus(), trainer)
    assert tok.get_vocab_size() == VOCAB, tok.get_vocab_size()
    for content, special in ADDED:
        added = AddedToken(content, special=special, normalized=False)
        (tok.add_special_tokens if special else tok.add_tokens)([added])
    os.makedirs(args.out, exist_ok=True)
    tok.save(os.path.join(args.out, "tokenizer.json"))
    config = {
        "add_bos_token": False,
        "add_prefix_space": False,
        "added_tokens_decoder": {
            str(VOCAB + i): {"content": c, "lstrip": False, "normalized": False,
                             "rstrip": False, "single_word": False, "special": s}
            for i, (c, s) in enumerate(ADDED)},
        "additional_special_tokens": [c for c, s in ADDED[1:] if s],
        "bos_token": None,
        "chat_template": CHAT_TEMPLATE,
        "clean_up_tokenization_spaces": False,
        "eos_token": "<|im_end|>",
        "errors": "replace",
        "model_max_length": 131072,
        "pad_token": "<|endoftext|>",
        "split_special_tokens": False,
        "tokenizer_class": "Qwen2Tokenizer",
        "unk_token": None,
    }
    with open(os.path.join(args.out, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2, ensure_ascii=False)
    print(f"wrote {args.out}: {VOCAB} BPE entries, added tokens at {VOCAB}..{VOCAB + 21}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
