"""PyTorch port: the port's own Qwen2 byte-level BPE (tokenizer.py:
Qwen2Tokenizer through load_tokenizer) against the JAX package's
load_tokenizer (transformers' AutoTokenizer, the Rust ``tokenizers``
library underneath), on the committed fixture (tests/data/
qwen2_tokenizer_tiny, tools/make_tokenizer_fixture.py: Qwen2's pipeline, a
4096-entry BPE trained on the JAX package's sources, Qwen2.5's 22 added
tokens) and on directories the tests write with ``tokenizers``.

Tolerance: none. Ids, rendered chat strings and decoded text must be
identical, over hand-picked text, 500 random Unicode texts (hypothesis),
both chat templates and the checkpoint's, cut byte runs, added tokens,
the tokenizer.json and vocab.json + merges.txt routes with both merge
formats, save_pretrained read back by JAX's loader, and the vocabulary
padded to Qwen2.5's special ids. The split itself is held to the Rust
library's over every code point.
"""
import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from long_vita_tpu import tokenizer as jax_tokenizer
from long_vita_tpu_torch import tokenizer as port_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, chip_smoke.TOKENIZER_FIXTURE)
QWEN25_ADDED = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|box_start|>", "<|vision_pad|>",
                "<tool_call>", "</tool_call>", "<|fim_prefix|>", "<|file_sep|>"]
TEXTS = {
    "ascii": "Hello, world! The quick brown fox jumps over the lazy dog.",
    "contractions": "it's I'm we're they've she'll he'd don't IT'S I'M WE'RE THEY'VE SHE'LL "
                    "HE'D DON'T x'S y'LL z'ſa 'Re'vE'lL",
    "digits": "0 12 345 6789 3.14159 1,000,000 2024-10-18 x86_64 v2.5",
    "cjk": "中文字符，日本語のテキスト。한국어 텍스트 一二三 四五六 〇",
    "emoji": "emoji 🎉🎉 👩‍👩‍👧 👍🏽 flags 🇫🇷🇯🇵 ❤️",
    "nfc": "café Å ö é́ 각 Å Ω",
    "whitespace": "  two  spaces   three\t\ttabs\n\nnl\r\n\r\ncrlf \n \t  nbsp　ideo "
                  " ls  trailing  ",
    "separators": "a\x1cb\x1dc\x1ed\x1fe \x1c \x1d\n\x1e\x1f!",
    "multimodal": "<image>\nDescribe<img></img><IMG_CONTEXT><IMG_CONTEXT>x<vid><VID_CONTEXT>"
                  "</vid>word<patch><PATCH_CONTEXT></patch><quad>1</quad><ref>it</ref>"
                  "<box>(1,2)</box><video>clip<image>",
    "added": "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n<tool_call>{}</tool_call>"
             "<|endoftext|><|endoftext|><|fim_prefix|>x<|file_sep|>",
    "code": "def f(x):\n    return {'a': [1, 2]}  # comment\n\n\tif x != None: pass\n",
    "empty": "",
}


@pytest.fixture(scope="module")
def pair():
    return (port_tokenizer.load_tokenizer(FIXTURE), jax_tokenizer.load_tokenizer(FIXTURE))


def _ids(tok, text):
    return tok(text, add_special_tokens=True).input_ids


@pytest.mark.parametrize("name", list(TEXTS))
def test_ids_match_jax(pair, name):
    port, ref = pair
    want = _ids(ref, TEXTS[name])
    assert _ids(port, TEXTS[name]) == want
    for skip in (False, True):
        assert port.decode(want, skip_special_tokens=skip) == \
            ref.decode(want, skip_special_tokens=skip)


_TAGS = st.sampled_from(port_tokenizer.SPECIAL_TOKENS + QWEN25_ADDED
                        + [" ", "  ", "\n", "\r\n", "\t", "'s", "'LL", "123", "\x1c"])


@settings(max_examples=500, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.one_of(st.text(max_size=24), _TAGS), max_size=8))
def test_random_unicode_matches_jax(pair, parts):
    port, ref = pair
    text = "".join(parts)
    want = _ids(ref, text)
    assert _ids(port, text) == want
    assert port.decode(want) == ref.decode(want)
    assert port.decode(want, skip_special_tokens=True) == \
        ref.decode(want, skip_special_tokens=True)


def test_split_matches_the_rust_library_on_every_code_point():
    """QWEN2_SPLIT as re runs it (tokenizer._split_pattern) against the Rust
    library's Split pre-tokenizer (Oniguruma): every code point but the
    surrogates after a letter and before a mark, before a digit, doubled
    between spaces and before a newline; the Basic Multilingual Plane's
    (where every case fold of the contractions lies) also after and
    before an apostrophe."""
    from tokenizers import Regex, pre_tokenizers

    ref = pre_tokenizers.Split(Regex(port_tokenizer.QWEN2_SPLIT), behavior="isolated",
                               invert=False)
    split = port_tokenizer._split_pattern().findall
    cps = [c for c in range(0x110000) if not 0xD800 <= c < 0xE000]
    blocks = [(cps[i:i + (1 << 16)], "a{c}!{c}1 {c}{c}\n") for i in range(0, len(cps), 1 << 16)]
    blocks.append((cps[:0xD800] + cps[0xD800:0xF800], "x'{c}x{c}'s"))
    for block, ctx in blocks:
        text = "。".join(ctx.format(c=chr(c)) for c in block)
        assert split(text) == [p for p, _ in ref.pre_tokenize_str(text)], (ctx, hex(block[0]))


@pytest.mark.parametrize("template", ["long_vita", "qwen", "checkpoint"])
def test_chat_templates_match_jax(template):
    port = port_tokenizer.load_tokenizer(FIXTURE, template=template)
    ref = jax_tokenizer.load_tokenizer(FIXTURE, template=template)
    assert port.chat_template == ref.chat_template
    chats = [
        [{"role": "user", "content": "<image>\nWhat is in the picture?"}],
        [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "hi"},
         {"role": "assistant", "content": "hello 中文"}, {"role": "user", "content": "<video>"}],
    ]
    for msgs in chats:
        for gen in (True, False):
            text = ref.apply_chat_template(msgs, add_generation_prompt=gen, tokenize=False)
            assert port.apply_chat_template(msgs, add_generation_prompt=gen,
                                            tokenize=False) == text
            assert port.apply_chat_template(msgs, add_generation_prompt=gen) == \
                ref.apply_chat_template(msgs, add_generation_prompt=gen)


def test_decode_cut_characters_matches_jax(pair):
    """Id runs that start or end inside a character's bytes, or are split
    by an added token, decode to U+FFFD where transformers' does."""
    port, ref = pair
    ids = _ids(ref, "中文 héllo 🎉 ok")
    eot, tool = ref.convert_tokens_to_ids(["<|endoftext|>", "<tool_call>"])
    runs = [ids[i:j] for i in range(len(ids)) for j in range(i + 1, len(ids) + 1)]
    runs += [ids[:k] + [t] + ids[k:] for k in range(len(ids)) for t in (eot, tool)]
    runs += [ids + [len(ref) + 5, 10 ** 6]]  # ids of no token are dropped
    for run in runs:
        for skip in (False, True):
            assert port.decode(run, skip_special_tokens=skip) == \
                ref.decode(run, skip_special_tokens=skip), run


def test_add_tokens_matches_jax():
    port = port_tokenizer.load_tokenizer(FIXTURE)
    ref = jax_tokenizer.load_tokenizer(FIXTURE)
    for tokens, special in ((["<new_a>", "<img>", "<new_b>"], True), (["plain", "<new_c>"], False),
                            (["<new_a>", "the"], False), (["<|im_end|>", "<new_d>"], True)):
        assert port.add_tokens(tokens, special_tokens=special) == \
            ref.add_tokens(tokens, special_tokens=special)
        assert len(port) == len(ref)
        assert port.convert_tokens_to_ids(tokens) == ref.convert_tokens_to_ids(tokens)
    text = "a <new_a>plain<new_c> the <new_b>x<new_d>"
    assert _ids(port, text) == _ids(ref, text)
    ids = _ids(ref, text)
    for skip in (False, True):
        assert port.decode(ids, skip_special_tokens=skip) == \
            ref.decode(ids, skip_special_tokens=skip)


def _string_merges(path):
    """The fixture with its merges written as "a b" strings (the released
    Qwen2.5 files' form; tokenizers 0.20 and later write pairs)."""
    with open(os.path.join(FIXTURE, "tokenizer.json"), encoding="utf-8") as f:
        tj = json.load(f)
    tj["model"]["merges"] = [" ".join(m) for m in tj["model"]["merges"]]
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tj, f, ensure_ascii=False)


def _vocab_files(path):
    """vocab.json + merges.txt (tokenizers' own BPE.save) beside the
    fixture's tokenizer_config.json, whose added_tokens_decoder carries the
    added tokens: no tokenizer.json."""
    from tokenizers import Tokenizer

    Tokenizer.from_file(os.path.join(FIXTURE, "tokenizer.json")).model.save(str(path))


@pytest.mark.parametrize("route", ["tokenizer_json_pairs", "tokenizer_json_strings", "vocab_merges"])
def test_directory_routes_match_jax(tmp_path, route):
    import shutil

    shutil.copy(os.path.join(FIXTURE, "tokenizer_config.json"), tmp_path)
    if route == "tokenizer_json_pairs":
        shutil.copy(os.path.join(FIXTURE, "tokenizer.json"), tmp_path)
    elif route == "tokenizer_json_strings":
        _string_merges(tmp_path)
    else:
        _vocab_files(tmp_path)
    assert os.path.exists(tmp_path / "tokenizer.json") == (route != "vocab_merges")
    port = port_tokenizer.load_tokenizer(str(tmp_path))
    ref = jax_tokenizer.load_tokenizer(str(tmp_path))
    assert len(port) == len(ref) and port.pad_token_id == ref.pad_token_id
    for text in TEXTS.values():
        want = _ids(ref, text)
        assert _ids(port, text) == want
        assert port.decode(want, skip_special_tokens=True) == \
            ref.decode(want, skip_special_tokens=True)


def test_save_pretrained_reads_back_in_jax(tmp_path):
    port = port_tokenizer.load_tokenizer(FIXTURE)
    port.add_tokens(["<extra_special>"], special_tokens=True)
    port.add_tokens(["extra_plain"])
    port.save_pretrained(str(tmp_path))
    ref = jax_tokenizer.load_tokenizer(str(tmp_path), template="checkpoint")
    again = port_tokenizer.load_tokenizer(str(tmp_path), template="checkpoint")
    assert ref.chat_template == again.chat_template == port.chat_template
    assert len(ref) == len(again) == len(port)
    text = TEXTS["multimodal"] + TEXTS["added"] + " <extra_special> extra_plain " + TEXTS["cjk"]
    want = _ids(port, text)
    assert _ids(ref, text) == want and _ids(again, text) == want
    for skip in (False, True):
        assert ref.decode(want, skip_special_tokens=skip) == \
            port.decode(want, skip_special_tokens=skip)


def test_vocabulary_padded_to_qwen25_ids(tmp_path):
    """chip_smoke.tokenizer_dir pads the BPE vocabulary with unreachable
    entries: <|endoftext|>, <|im_start|>, <|im_end|> at 151643-151645,
    <|file_sep|> at 151664, the multimodal tokens from 151665 on, as in
    Qwen2.5, and both loaders read the directory to the same ids."""
    path = chip_smoke.tokenizer_dir(str(tmp_path))
    port = port_tokenizer.load_tokenizer(path)
    ref = jax_tokenizer.load_tokenizer(path)
    names = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|file_sep|>",
             *port_tokenizer.SPECIAL_TOKENS]
    assert port.convert_tokens_to_ids(names) == ref.convert_tokens_to_ids(names) == \
        [151643, 151644, 151645, 151664, *range(151665, 151682)]
    assert len(port) == len(ref) == 151682 and port.pad_token_id == ref.pad_token_id == 151643
    for text in TEXTS.values():
        want = _ids(ref, text)
        assert _ids(port, text) == want
        assert port.decode(want) == ref.decode(want)
    msgs = [{"role": "user", "content": "<image>\nhi"}]
    assert port.apply_chat_template(msgs, add_generation_prompt=True) == \
        ref.apply_chat_template(msgs, add_generation_prompt=True)
