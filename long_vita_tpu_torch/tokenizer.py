"""Tokenizer extension: register the multimodal special tokens.

Counterpart of long_vita_tpu/tokenizer.py (reference long_vita/tokenizer.py:
22-31): the same 17 tokens, added as special tokens, so token ids line up
with the released checkpoints' resized embedding tables; the same chat
templates, string for string. ``load_tokenizer`` imports ``transformers``
only when it is called.

``ByteTokenizer`` is the port's own: a byte-level tokenizer with the part of
the Hugging Face interface that the front end and the server use, for runs
without tokenizer files (the CPU tests and chip_smoke.py).
"""
from __future__ import annotations

import types

from long_vita_tpu_torch.constants import (
    BOX_END_TOKEN,
    BOX_START_TOKEN,
    IMG_CONTEXT_TOKEN,
    IMG_END_TOKEN,
    IMG_START_TOKEN,
    IMG_TAG_TOKEN,
    PATCH_CONTEXT_TOKEN,
    PATCH_END_TOKEN,
    PATCH_START_TOKEN,
    QUAD_END_TOKEN,
    QUAD_START_TOKEN,
    REF_END_TOKEN,
    REF_START_TOKEN,
    VID_CONTEXT_TOKEN,
    VID_END_TOKEN,
    VID_START_TOKEN,
    VID_TAG_TOKEN,
)

SPECIAL_TOKENS = [
    IMG_START_TOKEN, IMG_END_TOKEN, IMG_CONTEXT_TOKEN,
    VID_START_TOKEN, VID_END_TOKEN, VID_CONTEXT_TOKEN,
    PATCH_START_TOKEN, PATCH_END_TOKEN, PATCH_CONTEXT_TOKEN,
    QUAD_START_TOKEN, QUAD_END_TOKEN, REF_START_TOKEN, REF_END_TOKEN,
    BOX_START_TOKEN, BOX_END_TOKEN, IMG_TAG_TOKEN, VID_TAG_TOKEN,
]


def update_tokenizer(tokenizer):
    """Add the 17 multimodal special tokens (idempotent)."""
    tokenizer.add_tokens(SPECIAL_TOKENS, special_tokens=True)
    return tokenizer


# Qwen2.5 ChatML (the released checkpoints' tokenizer_config carries the
# full tool-aware template; this is the no-tools core, same rendering).
QWEN_CHATML_TEMPLATE = (
    "{%- if messages[0]['role'] != 'system' %}"
    "{{- '<|im_start|>system\\nYou are Qwen, created by Alibaba Cloud. "
    "You are a helpful assistant.<|im_end|>\\n' }}{%- endif %}"
    "{%- for message in messages %}"
    "{{- '<|im_start|>' + message['role'] + '\\n' + message['content'] "
    "+ '<|im_end|>' + '\\n' }}{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<|im_start|>assistant\\n' }}"
    "{%- endif %}"
)

# The reference SERVER renders with the "long_vita" template
# (configs/finetune/templates.json via --prompt-type long_vita,
# inference_..._server.sh:174): plain ChatML with NO default system message,
# stop word <|im_end|>. Serving/eval must use this for answer parity.
LONG_VITA_CHAT_TEMPLATE = (
    "{%- for message in messages %}"
    "{{- '<|im_start|>' + message['role'] + '\\n' + message['content'] "
    "+ '<|im_end|>' + '\\n' }}{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<|im_start|>assistant\\n' }}"
    "{%- endif %}"
)


def load_tokenizer(path: str, template: str = "long_vita"):
    """Load an HF tokenizer dir, add special tokens, set the chat template.

    template "long_vita" (default) matches the reference server's rendering
    (no default system message); "checkpoint" keeps the tokenizer_config's
    own template (Qwen default-system behavior); "qwen" forces ChatML with
    the Qwen system default.
    """
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(path, trust_remote_code=False)
    tokenizer = update_tokenizer(tokenizer)
    if template == "long_vita":
        tokenizer.chat_template = LONG_VITA_CHAT_TEMPLATE
    elif template == "qwen" or tokenizer.chat_template is None:
        tokenizer.chat_template = QWEN_CHATML_TEMPLATE
    return tokenizer


class ByteTokenizer:
    """Text as its UTF-8 bytes (ids 0-255), plus ``<|endoftext|>``,
    ``<|im_start|>``, ``<|im_end|>`` at fixed ids and each token given to
    ``add_tokens`` at the next id from ``first_added`` on. The defaults are
    Qwen2.5's ids (151643-151645; its added tokens end at 151664), so the
    multimodal tokens land where the released tokenizer puts them.

    Decoding joins the pieces: a run of byte ids decodes as UTF-8 with
    replacement characters (as a byte-level BPE does), a special token as
    its string (dropped with ``skip_special_tokens``), and any other id as
    ``<|id|>``. Chat rendering is ``LONG_VITA_CHAT_TEMPLATE``'s."""

    def __init__(self, endoftext: int = 151643, im_start: int = 151644,
                 im_end: int = 151645, first_added: int = 151665):
        self._ids = {"<|endoftext|>": endoftext, "<|im_start|>": im_start,
                     "<|im_end|>": im_end}
        self._next = first_added
        self.pad_token_id = endoftext  # Qwen2.5 pads with <|endoftext|>

    def add_tokens(self, tokens, special_tokens: bool = False) -> int:
        new = [t for t in tokens if t not in self._ids]
        for t in new:
            self._ids[t] = self._next
            self._next += 1
        return len(new)

    def __len__(self) -> int:
        return max(256, max(self._ids.values()) + 1)

    def encode(self, text: str) -> list[int]:
        ids, i = [], 0
        specials = sorted(self._ids, key=len, reverse=True)
        while i < len(text):
            hit = next((s for s in specials if text.startswith(s, i)), None)
            if hit is not None:
                ids.append(self._ids[hit])
                i += len(hit)
            else:
                ids.extend(text[i].encode())
                i += 1
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True):
        return types.SimpleNamespace(input_ids=self.encode(text))

    def apply_chat_template(self, messages, add_generation_prompt: bool = True,
                            tokenize: bool = True):
        text = "".join(
            f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages
        )
        if add_generation_prompt:
            text += "<|im_start|>assistant\n"
        return self.encode(text) if tokenize else text

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        names = {v: k for k, v in self._ids.items()}
        out, run = [], bytearray()
        for t in (int(x) for x in ids):
            if t < 256:
                run.append(t)
                continue
            out.append(run.decode("utf-8", errors="replace"))
            run = bytearray()
            if t in names:
                if not skip_special_tokens:
                    out.append(names[t])
            else:
                out.append(f"<|{t}|>")
        out.append(run.decode("utf-8", errors="replace"))
        return "".join(out)
