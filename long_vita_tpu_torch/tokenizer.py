"""Tokenizer extension: register the multimodal special tokens.

Counterpart of long_vita_tpu/tokenizer.py (reference long_vita/tokenizer.py:
22-31): the same 17 tokens, added as special tokens, so token ids line up
with the released checkpoints' resized embedding tables; the same chat
templates, string for string.

``load_tokenizer`` reads a Qwen2 tokenizer directory into the port's own
byte-level BPE (``Qwen2Tokenizer``), which imports neither ``transformers``
nor ``tokenizers`` nor ``regex``: the same ids, strings and decoded text as
``AutoTokenizer.from_pretrained`` on the same directory
(tests/test_torch_tokenizer.py).

``ByteTokenizer`` is a byte-level stand-in with the part of the interface
that the front end and the server use, for runs without tokenizer files
(the CPU tests and the multi-rank serving phases of chip_smoke.py).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import types
import unicodedata

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
    """Load a Qwen2 tokenizer dir, add special tokens, set the chat template.

    template "long_vita" (default) matches the reference server's rendering
    (no default system message); "checkpoint" keeps the tokenizer_config's
    own template (Qwen default-system behavior); "qwen" forces ChatML with
    the Qwen system default.
    """
    tokenizer = update_tokenizer(Qwen2Tokenizer.from_pretrained(path))
    if template == "long_vita":
        tokenizer.chat_template = LONG_VITA_CHAT_TEMPLATE
    elif template == "qwen" or tokenizer.chat_template is None:
        tokenizer.chat_template = QWEN_CHATML_TEMPLATE
    return tokenizer


# ---- Qwen2's byte-level BPE --------------------------------------------------

# Qwen2's pre-tokenizer split (its tokenizer.json), written for the Rust
# library's Oniguruma engine. ``_split_pattern`` spells it for ``re``.
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
               r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

# Oniguruma's \s is Unicode's White_Space; Python's also takes U+001C-U+001F.
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(map(chr, range(0x2000, 0x200B)))
                + "\u2028\u2029\u202f\u205f\u3000")


# Letters and numbers of Unicode 15.1 and 16.0, which the tables of the
# reference engine (Oniguruma in tokenizers 0.22) hold and Python 3.12's
# unicodedata (Unicode 15.0.0) leaves unassigned: 4,924 letters and 80
# numbers, found by comparing the two splits over every code point. Every
# other code point splits alike.
_NEWER = {
    "L": ((0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
          (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389),
          (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
          (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
          (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
          (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D)),
    "N": ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
          (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA)),
}


def _letter_number_classes() -> tuple:
    """The code points whose general category is L* (letters) and N*
    (numbers) in this interpreter's unicodedata, with _NEWER's, each as
    the ranges of a character class. No letter or number lies past plane
    3, so the scan stops there."""
    out = {"L": [], "N": []}
    for kind, ranges in _NEWER.items():
        out[kind] = [list(r) for r in ranges]
    for cp in range(0x40000):
        kind = unicodedata.category(chr(cp))[0]
        if kind in out:
            ranges = out[kind]
            if ranges and ranges[-1][1] == cp - 1:
                ranges[-1][1] = cp
            else:
                ranges.append([cp, cp])
    return tuple("".join(f"\\U{a:08x}-\\U{b:08x}" for a, b in out[kind]) for kind in "LN")


@functools.cache
def _split_pattern() -> re.Pattern:
    """QWEN2_SPLIT for ``re``: \\p{L} and \\p{N} from unicodedata's
    categories, \\s and \\S as White_Space and its complement."""
    letters, numbers = _letter_number_classes()
    ws = _WHITE_SPACE
    return re.compile(
        rf"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n{letters}{numbers}]?[{letters}]+|[{numbers}]|"
        rf" ?[^{ws}{letters}{numbers}]+[\r\n]*|[{ws}]*[\r\n]+|[{ws}]+(?![^{ws}])|[{ws}]+")


@functools.cache
def _byte_chars() -> tuple:
    """GPT-2's byte-to-unicode map: -> (256 chars by byte, char -> byte)."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    chars, n = {}, 0
    for b in range(256):
        if b in keep:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + n)
            n += 1
    by_byte = tuple(chars[b] for b in range(256))
    return by_byte, {c: b for b, c in chars.items()}


@dataclasses.dataclass
class AddedToken:
    """A token matched in the text before the BPE (tokenizers' AddedToken)."""
    content: str
    special: bool = False
    lstrip: bool = False
    rstrip: bool = False
    single_word: bool = False
    normalized: bool = True

    def as_json(self, id_: int) -> dict:
        return {"id": id_, "content": self.content, "single_word": self.single_word,
                "lstrip": self.lstrip, "rstrip": self.rstrip,
                "normalized": self.normalized, "special": self.special}


# The reference's NFC (Rust's unicode-normalization) lacks one composition
# that unicodedata makes: U+11935 U+11930 -> U+11938 (Dives Akuru). Both
# are starters, so NFC around the pair is NFC without that composition.
_UNCOMPOSED = "\U00011935\U00011930"


def _nfc(text: str) -> str:
    return _UNCOMPOSED.join(unicodedata.normalize("NFC", p) for p in text.split(_UNCOMPOSED))


def _added_token(d: dict) -> AddedToken:
    """An added token from its JSON (tokenizer.json or added_tokens_decoder)."""
    return AddedToken(d["content"], special=d.get("special", False),
                      lstrip=d.get("lstrip", False), rstrip=d.get("rstrip", False),
                      single_word=d.get("single_word", False),
                      normalized=d.get("normalized", not d.get("special", False)))


def _word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def _clean_up_tokenization(text: str) -> str:
    """transformers' clean_up_tokenization."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


_PIPELINE = {  # Qwen2's tokenizer.json around its model and added tokens
    "normalizer": {"type": "NFC"},
    "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": QWEN2_SPLIT}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
         "use_regex": False}]},
    "post_processor": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                       "use_regex": False},
    "decoder": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                "use_regex": False},
}
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "pad_token")
_CACHE_WORDS = 1 << 16


def _content(token):
    return token["content"] if isinstance(token, dict) else token


def _read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _check_pipeline(tj: dict) -> None:
    """Refuse a tokenizer.json whose pipeline is not Qwen2's by name."""
    model = tj["model"]
    bad = [f"model {model.get('type')}"] if model.get("type") != "BPE" else []
    for key, want in (("dropout", None), ("continuing_subword_prefix", ""),
                      ("end_of_word_suffix", ""), ("byte_fallback", False),
                      ("ignore_merges", False)):
        if model.get(key) not in (want, None):
            bad.append(f"BPE {key} {model.get(key)!r}")
    if tj.get("normalizer") not in (None, _PIPELINE["normalizer"]):
        bad.append(f"normalizer {tj['normalizer']}")
    pre = tj.get("pre_tokenizer") or {}
    steps = pre.get("pretokenizers", [])
    split_ok = (len(steps) == 2 and steps[0].get("type") == "Split"
                and steps[0].get("pattern") == {"Regex": QWEN2_SPLIT}
                and steps[0].get("behavior") == "Isolated" and not steps[0].get("invert")
                and steps[1].get("type") == "ByteLevel" and not steps[1].get("add_prefix_space")
                and not steps[1].get("use_regex"))
    if pre.get("type") != "Sequence" or not split_ok:
        bad.append("pre_tokenizer (Qwen2's Split then ByteLevel)")
    if (tj.get("decoder") or {}).get("type") != "ByteLevel":
        bad.append(f"decoder {tj.get('decoder')}")
    if (tj.get("post_processor") or {"type": "ByteLevel"}).get("type") != "ByteLevel":
        bad.append(f"post_processor {tj['post_processor'].get('type')}")
    if bad:
        raise ValueError(f"not a Qwen2 byte-level BPE tokenizer.json: {'; '.join(bad)}")


class Qwen2Tokenizer:
    """Qwen2's byte-level BPE with added tokens, as a Hugging Face fast
    tokenizer runs it (tokenizers' AddedVocabulary, NFC, the Split and
    ByteLevel pre-tokenizers, BPE, the ByteLevel decoder), with the part
    of transformers' interface that the port calls: ``__call__(text)``
    -> ``.input_ids``, ``add_tokens``, ``apply_chat_template`` (jinja2, as
    transformers renders it), ``decode``, ``convert_tokens_to_ids``,
    ``pad_token_id``, ``chat_template``, ``len()`` and ``save_pretrained``.

    Encoding: the tokens added unnormalized are cut out of the raw text
    first (leftmost, the longest at a place, with their lstrip, rstrip
    and single_word rules), the rest is NFC-normalized and cut by the
    normalized added tokens, then split by QWEN2_SPLIT; each piece's UTF-8
    bytes become GPT-2's byte characters and merge by rank (a word's ids
    cached)."""

    def __init__(self, vocab: dict, merges: list, added: list, *, normalize: bool = True,
                 config: dict | None = None, chat_template: str | None = None):
        self._vocab = dict(vocab)
        self._merges = [tuple(m) for m in merges]
        self._ranks = {m: i for i, m in enumerate(self._merges)}
        self._normalize = normalize
        self._config = dict(config or {})
        self.chat_template = chat_template
        self.clean_up_tokenization_spaces = bool(
            self._config.get("clean_up_tokenization_spaces", False))
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        # tokenizers' AddedVocabulary: each id's token (its flags rule the
        # match), the id of each content, the special contents, and the
        # tokens as added, which make up the matchers
        self._added: dict[int, AddedToken] = {}
        self._added_ids: dict[str, int] = {}
        self._special: set[str] = set()
        self._matched: list[AddedToken] = []
        self._matchers = None
        self._cache: dict[str, list] = {}
        self._add(added)
        pad = self._config.get("pad_token")
        self.pad_token = _content(pad) if pad else None

    # -- construction ----------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str) -> "Qwen2Tokenizer":
        """Read a tokenizer directory as AutoTokenizer.from_pretrained does
        for Qwen2: tokenizer.json if present (model, pipeline, added
        tokens), else vocab.json + merges.txt with Qwen2's pipeline; then
        tokenizer_config.json's added_tokens_decoder entries that differ
        from those, by id, and the special tokens it names that are not
        added yet (special_tokens_map.json's where the config names none;
        Qwen2's tokenizer class defaults <|endoftext|> as unk, eos and pad)."""
        def opt(name):
            p = os.path.join(path, name)
            return _read_json(p) if os.path.exists(p) else {}

        config, specials_map = opt("tokenizer_config.json"), opt("special_tokens_map.json")
        for key in (*_SPECIAL_KEYS, "additional_special_tokens"):
            if key not in config and key in specials_map:
                config[key] = specials_map[key]
        if str(config.get("tokenizer_class", "Qwen2Tokenizer")).startswith("Qwen2Tokenizer"):
            for key in ("unk_token", "eos_token", "pad_token"):
                config.setdefault(key, "<|endoftext|>")
        tj_path = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj_path):
            tj = _read_json(tj_path)
            _check_pipeline(tj)
            model = tj["model"]
            vocab, merges = model["vocab"], model["merges"]
            normalize = tj.get("normalizer") is not None
            added = sorted(tj.get("added_tokens", []), key=lambda t: t["id"])
        else:
            vocab = _read_json(os.path.join(path, "vocab.json"))
            with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
                merges = [line.rstrip("\n") for line in f]
            merges = [m for i, m in enumerate(merges)
                      if m and not (i == 0 and m.startswith("#version"))]
            normalize, added = True, []
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in merges]
        tokens = [_added_token(t) for t in added]
        ids = {t["id"]: _added_token(t) for t in added}
        tokens += [_added_token(d) for i, d in sorted(
            config.get("added_tokens_decoder", {}).items(), key=lambda kv: int(kv[0]))
            if ids.get(int(i)) != _added_token(d)]
        named = [_content(config[k]) for k in _SPECIAL_KEYS if config.get(k)]
        named += [_content(t) for t in config.get("additional_special_tokens", [])]
        contents = {t.content for t in tokens}
        tokens += [AddedToken(c, special=True, normalized=False)
                   for c in dict.fromkeys(named) if c not in contents]
        template = config.get("chat_template")
        jinja = os.path.join(path, "chat_template.jinja")
        if template is None and os.path.exists(jinja):
            with open(jinja, encoding="utf-8") as f:
                template = f.read()
        return cls(vocab, merges, tokens, normalize=normalize, config=config,
                   chat_template=template)

    def _add(self, tokens: list) -> int:
        """tokenizers' AddedVocabulary.add_tokens: a token equal to an added
        one (content and flags) is skipped; any other keeps the id of its
        content (an added token's, whose flags it takes, or the
        vocabulary's) or takes the next id past the model's vocabulary and
        every added token. -> the number not skipped."""
        for tok in tokens:
            if tok.special and tok.content and tok.content not in self._special:
                self._special.add(tok.content)
                self._matched.append(tok)
        n = 0
        for tok in tokens:
            if not tok.content or tok in self._added.values():
                continue
            id_ = self._added_ids.get(tok.content, self._vocab.get(tok.content))
            if id_ is None:
                top = max(self._added, default=-1)
                id_ = top + 1 if top >= len(self._vocab) else len(self._vocab)
            self._added[id_] = tok
            self._added_ids[tok.content] = id_
            if tok.content not in self._special:
                self._matched.append(tok)
            n += 1
        self._matchers = None  # rebuilt at the next encode
        return n

    def add_tokens(self, tokens, special_tokens: bool = False) -> int:
        """transformers' add_tokens: strings become added tokens, special
        ones unnormalized; -> the number not added before as they are."""
        if isinstance(tokens, (str, AddedToken)):
            tokens = [tokens]
        return self._add([t if isinstance(t, AddedToken) else
                          AddedToken(t, special=special_tokens, normalized=not special_tokens)
                          for t in tokens])

    def __len__(self) -> int:
        return len(set(self._vocab.values()) | set(self._added))

    @property
    def pad_token_id(self):
        return self.convert_tokens_to_ids(self.pad_token) if self.pad_token else None

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._added_ids.get(tokens, self._vocab.get(tokens))
        return [self.convert_tokens_to_ids(t) for t in tokens]

    # -- encoding ---------------------------------------------------------

    def _matcher(self, normalized: bool):
        """The added tokens matched on raw or on normalized text, as a
        leftmost-longest alternation (False if none)."""
        if self._matchers is None:
            self._matchers = {}
            for kind in (False, True):
                toks = sorted({t.content for t in self._matched if t.normalized == kind},
                              key=lambda c: (-len(c), c))
                self._matchers[kind] = toks and re.compile("|".join(map(re.escape, toks)))
        return self._matchers[normalized]

    def _split_added(self, text: str, normalized: bool) -> list:
        """tokenizers' AddedVocabulary.find_matches: -> [(piece, id or None)]."""
        matcher = self._matcher(normalized)
        if not matcher:
            return [(text, None)]
        ids = self._added_ids
        out, at = [], 0
        for m in matcher.finditer(text):
            start, stop = m.span()
            tok = self._added[ids[m.group()]]
            if tok.single_word and ((start > 0 and _word_char(text[start - 1]))
                                    or (stop < len(text) and _word_char(text[stop]))):
                continue
            if tok.lstrip:
                start = max(len(text[:start].rstrip(_WHITE_SPACE)), at)
            if tok.rstrip:
                stop = len(text) - len(text[stop:].lstrip(_WHITE_SPACE))
            if at < start:
                out.append((text[at:start], None))
            out.append((text[start:stop], ids[m.group()]))
            at = stop
        if at < len(text):
            out.append((text[at:], None))
        return out

    def _bpe(self, word: str) -> list:
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        parts = list(word)
        ranks = self._ranks
        while len(parts) > 1:
            best = min(zip(parts, parts[1:]), key=lambda p: ranks.get(p, 1 << 62))
            if best not in ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        ids = [self._vocab[p] for p in parts if p in self._vocab]
        if len(self._cache) >= _CACHE_WORDS:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list:
        """The ids of ``text`` (Qwen2's post-processor adds none, so
        add_special_tokens changes nothing)."""
        by_byte = _byte_chars()[0]
        split = _split_pattern().findall
        ids = []
        for raw, id_ in self._split_added(text, normalized=False):
            if id_ is not None:
                ids.append(id_)
                continue
            if self._normalize:
                raw = _nfc(raw)
            for piece, id_ in self._split_added(raw, normalized=True):
                if id_ is not None:
                    ids.append(id_)
                    continue
                for word in split(piece):
                    ids.extend(self._bpe("".join(by_byte[b] for b in word.encode())))
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True):
        return types.SimpleNamespace(input_ids=self.encode(text, add_special_tokens))

    def apply_chat_template(self, messages, add_generation_prompt: bool = False,
                            tokenize: bool = True):
        """Render ``messages`` with ``chat_template`` as transformers does
        (a sandboxed jinja2 environment with trim_blocks and lstrip_blocks,
        the special tokens as variables); the ids of the text with
        ``tokenize``."""
        text = _render(self.chat_template, messages=messages,
                       add_generation_prompt=add_generation_prompt, tools=None, documents=None,
                       **self._special_strings())
        return self.encode(text, add_special_tokens=False) if tokenize else text

    def _special_strings(self) -> dict:
        out = {k: _content(self._config[k]) for k in _SPECIAL_KEYS if self._config.get(k)}
        extra = self._config.get("additional_special_tokens")
        if extra:
            out["additional_special_tokens"] = [_content(t) for t in extra]
        return out

    # -- decoding ---------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        """tokenizers' decode through the ByteLevel decoder: a run of
        vocabulary tokens becomes its bytes, decoded as UTF-8 with U+FFFD
        for what is cut; an added token is its text (dropped, when it is
        special, with skip_special_tokens); an id of neither is dropped.
        Then clean_up_tokenization_spaces as the tokenizer_config says."""
        byte_of = _byte_chars()[1]
        out, run = [], bytearray()
        for i in (int(x) for x in ids):
            added = self._added.get(i)
            if added is not None:
                if skip_special_tokens and added.content in self._special:
                    continue
                out.append(run.decode("utf-8", errors="replace"))
                run = bytearray()
                out.append(added.content)
                continue
            tok = self._id_to_token.get(i)
            if tok is None:
                continue
            try:
                run.extend(byte_of[c] for c in tok)
            except KeyError:
                run.extend(tok.encode())
        out.append(run.decode("utf-8", errors="replace"))
        text = "".join(out)
        return _clean_up_tokenization(text) if self.clean_up_tokenization_spaces else text

    # -- saving -----------------------------------------------------------

    def save_pretrained(self, out_dir: str) -> None:
        """Write tokenizer.json, tokenizer_config.json and
        special_tokens_map.json, which AutoTokenizer (and so the JAX
        package's load_tokenizer) and this class read back to the same ids."""
        os.makedirs(out_dir, exist_ok=True)
        added = sorted(self._added.items())
        tj = {"version": "1.0", "truncation": None, "padding": None,
              "added_tokens": [t.as_json(i) for i, t in added],
              **(_PIPELINE if self._normalize else {**_PIPELINE, "normalizer": None}),
              "model": {"type": "BPE", "dropout": None, "unk_token": None,
                        "continuing_subword_prefix": "", "end_of_word_suffix": "",
                        "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                        "vocab": self._vocab, "merges": [list(m) for m in self._merges]}}
        config = {**self._config, "tokenizer_class": "Qwen2Tokenizer",
                  "clean_up_tokenization_spaces": self.clean_up_tokenization_spaces,
                  "chat_template": self.chat_template,
                  "added_tokens_decoder": {str(i): {k: v for k, v in t.as_json(i).items()
                                                    if k != "id"} for i, t in added}}
        files = {"tokenizer.json": tj, "tokenizer_config.json": config,
                 "special_tokens_map.json": self._special_strings()}
        for name, obj in files.items():
            with open(os.path.join(out_dir, name), "w", encoding="utf-8") as f:
                json.dump(obj, f, ensure_ascii=False)


@functools.cache
def _jinja_env():
    import jinja2
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                          sort_keys=sort_keys)

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                        extensions=["jinja2.ext.loopcontrols"])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    return env


@functools.lru_cache(maxsize=8)
def _template(source: str):
    return _jinja_env().from_string(source)


def _render(source: str, **variables) -> str:
    if source is None:
        raise ValueError("the tokenizer has no chat template")
    return _template(source).render(**variables)


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
