"""PyTorch port: the training data modules against the JAX package's, on the
same files and one shared byte-level tokenizer (no tokenizer files are in
the repository), each package wrapping it in its own MultimodalTokenizer at
the tiny geometry (56-pixel tiles, 4 tokens a tile):

  - data/dataset.py: load_corpus gives the same samples in the same order
    (the same random.Random(seed) walk: ratio < 1, = 1 and > 1, a num cap, a
    ratio 0 source and a missing file); ChatMLSupervision the same ids,
    labels, tiles and image indices (text, a default system message, images
    read from PNG files); PackedDataset the same packs, with and without
    cross_dataset_joint, and collate_packs the same batches;
  - data/observability.py: the same data_report.json, data_samples.json,
    data_error.log (a sample with an unknown role) and print_batch.log;
  - data/templates.py: every renderer gives the same string;
  - data/prefetch.py: the same sequence, and a worker's error raised again
    in the consumer after the items before it.

Tolerance: none; every id, label, pixel and file byte is identical.
"""
import json

import numpy as np
import pytest
import yaml
from PIL import Image

from long_vita_tpu.data import dataset as jds
from long_vita_tpu.data import observability as jobs
from long_vita_tpu.data import prefetch as jpf
from long_vita_tpu.data import templates as jtpl
from long_vita_tpu.data.image_processor import ImageProcessor as JaxImageProcessor
from long_vita_tpu.data.multimodal import MultimodalTokenizer as JaxMM
from long_vita_tpu_torch.data import dataset as tds
from long_vita_tpu_torch.data import observability as tobs
from long_vita_tpu_torch.data import prefetch as tpf
from long_vita_tpu_torch.data import templates as ttpl
from long_vita_tpu_torch.data.image_processor import ImageProcessor
from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
from long_vita_tpu_torch.training import loss as tloss
from test_torch_serving import tiny_tokenizer

SEQ = 96


@pytest.fixture(scope="module")
def tok():
    return tiny_tokenizer()


def _mms(tok):
    """(port, JAX) multimodal tokenizers over one ByteTokenizer."""
    return (MultimodalTokenizer(tok, image_processor=ImageProcessor(image_size=56),
                                image_token_length=4),
            JaxMM(tok, image_processor=JaxImageProcessor(image_size=56), image_token_length=4))


def _write_corpus(root):
    """Three sources (ratio 0.5, 1 with a num cap, 2.5), a ratio-0 source and
    a missing file; text conversations in jsonl and json, some with images
    (PNG files of odd sizes) and a system turn, one with an unknown role."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        arr = rng.integers(0, 256, (40 + 17 * i, 70 - 9 * i, 3), dtype=np.uint8)
        p = root / f"img{i}.png"
        Image.fromarray(arr).save(p)
        paths.append(str(p))

    def text(n):
        return "".join(chr(c) for c in rng.integers(97, 123, n))

    def convo(i, images=0, system=False):
        msgs = [{"role": "system", "content": "be brief"}] if system else []
        msgs += [{"role": "user", "content": "<image>" * images + f"q{i} " + text(5 + i % 7)},
                 {"role": "assistant", "content": f"a{i} " + text(3 + i % 11)}]
        if i % 4 == 0:
            msgs += [{"role": "human", "content": text(4)}, {"role": "gpt", "content": text(6)}]
        row = {"conversations" if i % 2 else "messages": msgs}
        if images:
            row["images"] = paths[i % 3: i % 3 + images]
        return row

    a = [convo(i, images=1 if i % 3 == 0 else 0) for i in range(12)]
    b = [convo(100 + i, system=i % 2 == 0) for i in range(9)]
    c = [convo(200 + i, images=2 if i == 1 else 0) for i in range(5)]
    c.append({"messages": [{"role": "narrator", "content": "bad"}]})
    (root / "a.jsonl").write_text("\n".join(json.dumps(r) for r in a))
    (root / "b.json").write_text(json.dumps(b))
    (root / "c.jsonl").write_text("\n".join(json.dumps(r) for r in c))
    cfg = {"dataset": {
        "A": {"ratio": 0.5, "data_paths": [str(root / "a.jsonl")]},
        "B": {"ratio": 1, "num": 7, "data_paths": [str(root / "b.json"), str(root / "gone.json")]},
        "C": {"ratio": 2.5, "data_paths": [str(root / "c.jsonl")]},
        "D": {"ratio": 0, "data_paths": [str(root / "a.jsonl")]},
    }}
    path = root / "corpus.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("corpus"))


def _same_expanded(got, want):
    assert got.input_ids == want.input_ids and got.labels == want.labels
    assert (got.images is None) == (want.images is None)
    if want.images is not None:
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.image_indices, want.image_indices)


def _same_pack(got, want):
    for field in ("tokens", "labels", "position_ids", "segment_ids", "images", "image_indices"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if w is not None:
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.actual_seq_len == want.actual_seq_len


@pytest.mark.parametrize("seed", [0, 42])
def test_load_corpus_gives_the_jax_order(corpus, seed):
    got = tds.load_corpus(corpus, seed=seed)
    want = jds.load_corpus(corpus, seed=seed)
    assert got == want
    sources = [r["source"] for r in got]
    assert sources.count("A") == 6 and sources.count("B") == 7 and sources.count("C") == 15
    assert "D" not in sources


def test_supervision_matches_jax(corpus, tok):
    mm, jmm = _mms(tok)
    samples = jds.load_corpus(corpus, seed=0)
    for system in (None, "You are a helpful assistant."):
        got_sup, want_sup = tds.ChatMLSupervision(mm, system), jds.ChatMLSupervision(jmm, system)
        n_images = 0
        for sample in samples:
            if sample["source"] == "C" and "narrator" in json.dumps(sample):
                with pytest.raises(ValueError, match="unknown role"):
                    got_sup.render(sample)
                continue
            got, want = got_sup.render(sample), want_sup.render(sample)
            _same_expanded(got, want)
            n_images += 0 if got.images is None else len(got.images)
            sup = [t for t, lab in zip(got.input_ids, got.labels) if lab != -100]
            assert sup and sup[-2:] == got_sup.im_end + got_sup.nl
        assert n_images > 0


@pytest.mark.parametrize("joint", [False, True], ids=["per_source", "cross_dataset_joint"])
def test_packs_batches_and_reports_match_jax(corpus, tok, tmp_path, joint):
    mm, jmm = _mms(tok)
    samples = jds.load_corpus(corpus, seed=3)
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    got = list(tds.PackedDataset(
        samples, tds.ChatMLSupervision(mm), SEQ, pad_token_id=tok.pad_token_id,
        cross_dataset_joint=joint, report=tobs.DataReport(str(out_t), tokenizer=tok)))
    want = list(jds.PackedDataset(
        samples, jds.ChatMLSupervision(jmm), SEQ, pad_token_id=tok.pad_token_id,
        cross_dataset_joint=joint, report=jobs.DataReport(str(out_j), tokenizer=tok)))
    assert len(got) == len(want) >= 4
    for g, w in zip(got, want):
        _same_pack(g, w)
    assert any(p.images is not None for p in got) and any(p.images is None for p in got)
    assert any(len(set(p.segment_ids.tolist())) > 2 for p in got)
    for name in ("data_report.json", "data_samples.json", "data_error.log"):
        assert (out_t / name).read_text() == (out_j / name).read_text(), name
    report = json.loads((out_t / "data_report.json").read_text())
    assert sum(s["samples"] for s in report.values()) == len(samples) - 3  # the bad rows
    for start in range(0, len(got) - 1, 2):
        batch = tloss.collate_packs(got[start:start + 2], SEQ)
        jbatch = jds.collate_packs(want[start:start + 2], SEQ)
        assert batch.keys() == jbatch.keys()
        for k in batch:
            assert (batch[k] is None) == (jbatch[k] is None), k
            if batch[k] is not None:
                np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    batch = tloss.collate_packs(got[:2], SEQ)
    tobs.dump_first_batch(str(out_t), batch, tok)
    jobs.dump_first_batch(str(out_j), batch, tok)
    log = (out_t / "print_batch.log").read_text()
    assert log == (out_j / "print_batch.log").read_text()
    assert "=== batch row 1 ===" in log and "<|im_start|>assistant" in log


def test_odd_seq_len_packs_match_jax(corpus, tok):
    """seq_len 16383, the length the card's tp-2 training check runs: packs
    of exactly 16383 tokens, and their batch, bit for bit JAX's."""
    seq = 16383
    mm, jmm = _mms(tok)
    samples = jds.load_corpus(corpus, seed=3)
    got = list(tds.PackedDataset(samples, tds.ChatMLSupervision(mm), seq,
                                 pad_token_id=tok.pad_token_id))
    want = list(jds.PackedDataset(samples, jds.ChatMLSupervision(jmm), seq,
                                  pad_token_id=tok.pad_token_id))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert len(g.tokens) == len(g.labels) == len(g.position_ids) == seq
        _same_pack(g, w)
    batch = tloss.collate_packs(got[:2], seq)
    jbatch = jds.collate_packs(want[:2], seq)
    assert batch["tokens"].shape[1] == seq and batch.keys() == jbatch.keys()
    for k in batch:
        assert (batch[k] is None) == (jbatch[k] is None), k
        if batch[k] is not None:
            np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)


MESSAGES = [
    [{"role": "user", "content": "hi"}],
    [{"role": "system", "content": "sys"}, {"role": "user", "content": "a"},
     {"role": "assistant", "content": "b"}, {"role": "user", "content": "c"}],
    [{"role": "human", "content": "x"}, {"role": "gpt", "content": "y"}],
    [],
]


@pytest.mark.parametrize("name", sorted(jtpl.available_templates()))
def test_templates_give_the_jax_strings(name):
    assert ttpl.available_templates() == jtpl.available_templates()
    for msgs in MESSAGES:
        for gen in (True, False):
            assert ttpl.render(name, msgs, gen) == jtpl.render(name, msgs, gen)
            assert ttpl.get_template(name)(msgs, gen) == jtpl.get_template(name)(msgs, gen)


def test_prefetch_keeps_the_order_and_reraises():
    assert list(tpf.prefetch(iter(range(50)), depth=3)) == list(jpf.prefetch(iter(range(50)), depth=3))

    def broken():
        yield from range(5)
        raise KeyError("corrupt shard")

    seen = []
    with pytest.raises(KeyError, match="corrupt shard"):
        for item in tpf.prefetch(broken(), depth=2):
            seen.append(item)
    assert seen == list(range(5))
