"""The traffic generators: the same work from every seed, in another order,
and the same requests from the same seed."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import harness, vocab

IDS = vocab.Ids(152064)
MIXES = ["video-qa", "stage1-captions"]
# the long-document mix's generator, which no cell runs yet, at the
# parameters its first cell had
DOC = {"generator": "doc_qa", "prompt_ids": [2048, 16384], "block": 16, "requests": 400,
       "rate": 1.2}


def _plan(mix: str, seed: int) -> dict:
    p = DOC if mix == "doc-qa" else harness.named("traffic", mix)
    return harness.module("traffic", p["generator"]).generate(p, seed, IDS, 448)


def _sizes(plan: dict) -> list:
    if "samples" in plan:
        return [len(s["caption_ids"]) for s in plan["samples"]]
    return [(len(r["content_ids"]), 0 if r["frames"] is None else len(r["frames"]), r["answer"],
             r.get("due")) for r in plan["requests"]]


@pytest.mark.parametrize("mix", MIXES + ["doc-qa"])
def test_a_seed_repeats(mix):
    a, b = _plan(mix, 2**31 + 5), _plan(mix, 2**31 + 5)
    assert _sizes(a) == _sizes(b)
    key = "samples" if "samples" in a else "requests"
    assert [r.get("content_ids", r.get("caption_ids")) for r in a[key]] == \
        [r.get("content_ids", r.get("caption_ids")) for r in b[key]]
    assert np.array_equal(a["pool"], b["pool"])


@pytest.mark.parametrize("mix", MIXES + ["doc-qa"])
def test_seeds_differ_in_order_not_in_work(mix):
    a, b = _plan(mix, 11), _plan(mix, 12)
    assert _sizes(a) != _sizes(b)
    assert a["pool"] is None or not np.array_equal(a["pool"], b["pool"])
    block = (DOC if mix == "doc-qa" else harness.named("traffic", mix))["block"]
    whole = len(_sizes(a)) // block * block
    assert sorted(map(str, _sizes(a)[:whole])) == sorted(map(str, _sizes(b)[:whole])) or \
        "samples" not in a and mix != "stage1-captions"


def test_doc_schedule_follows_the_seed():
    """Every seed sends the same lengths and the same gaps, in an order and
    with words of its own."""
    a, b = _plan("doc-qa", 11), _plan("doc-qa", 2**31 + 12)
    la, lb = [len(r["content_ids"]) for r in a["requests"]], \
        [len(r["content_ids"]) for r in b["requests"]]
    assert la != lb and sorted(la) == sorted(lb)
    whole = (len(la) - 1) // DOC["block"] * DOC["block"]  # the gaps of whole blocks
    ga, gb = (np.diff([r["due"] for r in p["requests"]])[:whole] for p in (a, b))
    assert not np.allclose(ga, gb) and np.allclose(np.sort(ga), np.sort(gb))
    assert [r["content_ids"] for r in a["requests"]] != [r["content_ids"] for r in b["requests"]]


def test_doc_arrivals_keep_their_rate():
    p = {"generator": "doc_qa", "prompt_ids": [2048, 16384], "block": 16, "requests": 64,
         "rate": 1.25}
    gen = harness.module("traffic", "doc_qa")
    a, b = gen.generate(p, 1, IDS, 448), gen.generate(p, 2, IDS, 448)
    for plan in (a, b):
        due = [r["due"] for r in plan["requests"]]
        assert due == sorted(due) and due[0] == 0.0
        n = [len(IDS.chat(r["content_ids"])) for r in plan["requests"]]
        assert min(n) >= 2048 and max(n) <= 16384
    gaps = lambda plan: sorted(np.diff([r["due"] for r in plan["requests"]] + [0])[:-1])  # noqa
    assert np.allclose(sorted(_sizes(a)[i][0] for i in range(64)),
                       sorted(_sizes(b)[i][0] for i in range(64)))
    assert abs(a["requests"][-1]["due"] - b["requests"][-1]["due"]) < 2.5


def test_one_id_words_and_template_match_the_port_tokenizer(tmp_path):
    """The ids that the generators and the reference use are the ids the
    port's tokenizer gives the same text (at Qwen2.5's padding)."""
    from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
    from long_vita_tpu_torch.tokenizer import load_tokenizer

    mm = MultimodalTokenizer(load_tokenizer(vocab.tokenizer_dir(str(tmp_path), 152064)))
    rng = np.random.default_rng(0)
    pick = rng.integers(0, len(IDS.words), 400)
    text = "".join(IDS.texts[i] for i in pick)
    content = [IDS.words[i] for i in pick]
    assert mm.encode_chat([{"role": "user", "content": text}]) == IDS.chat(content)
    assert mm.encode_chat([{"role": "user", "content": "<video>" + text}]) == \
        IDS.chat([IDS.special["<video>"]] + content)
    for name, i in IDS.special.items():
        assert mm.tokenizer.convert_tokens_to_ids(name) == i
