"""PyTorch port: eval/ (the jsonl runner and the VLMEvalKit adapter) against
the JAX package's.

  - score and postprocess_answer on the same predictions;
  - build_prompt for every dataset kind the adapter knows (OCRBench, the
    direct-letter MCQ sets, MVBench, MMVet, MathVista, Video-MME's frames,
    and VLMEvalKit's Y/N, MCQ, VQA and Video-MCQ types, which both modules
    ask VLMEvalKit for and which the test answers for them);
  - run_eval on one jsonl through the port's engine, through the port's
    server and its client, and the adapter's generate_inner through that
    server: the same predictions and scores as the JAX run_eval through the
    JAX engine (the engines of tests/test_torch_serving.py: the tiny VLM in
    f32 with the shared byte tokenizer, whose greedy text is identical).
"""
import json

import pytest

from long_vita_tpu.eval import simple_eval as jeval
from long_vita_tpu.eval import vlmeval_adapter as jadapter
from long_vita_tpu_torch.eval import simple_eval as teval
from long_vita_tpu_torch.eval import vlmeval_adapter as tadapter
from long_vita_tpu_torch.inference import server as port_server
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_serving import _serve, _stop, make_engines

PREDICTIONS = [
    ("Paris", "paris"), ("The answer is B.", "B"), ("Reasoning... Answer: 42", "42"),
    ("Answer: yes. Answer: No!", "no"), ("", ""), ("blue sky", ""), ("A", "B"),
]


@pytest.mark.parametrize("pred,answer", PREDICTIONS)
def test_score_and_postprocess_match_jax(pred, answer):
    assert tadapter.postprocess_answer(pred) == jadapter.postprocess_answer(pred)
    assert teval.score(pred, answer) == jeval.score(pred, answer)


PARTS = [
    {"type": "text", "value": "Question: what is shown?\nAnswer: "},
    {"type": "image", "value": "/data/a.png"},
    {"type": "text", "value": "Please select the correct answer from the options above."
                              " Answer the question with Yes or No."
                              " Answer the question using a single word or phrase."
                              " Only give the best option.Best option:("},
    {"type": "video", "value": "/data/v.mp4"},
]
DATASETS = [("OCRBench", None), ("MMMU_DEV_VAL", None), ("MMStar", None), ("MVBench", None),
            ("MMVet", None), ("MathVista_MINI", None), ("Video-MME", None), (None, None),
            ("SomeYN", "Y/N"), ("SomeMCQ", "MCQ"), ("SomeVQA", "VQA"),
            ("SomeVideo", "Video-MCQ"), ("Unknown", "Caption")]


@pytest.mark.parametrize("dataset,kind", DATASETS)
def test_build_prompt_matches_jax(monkeypatch, dataset, kind):
    monkeypatch.setattr(jadapter, "_dataset_type", lambda d: kind)
    monkeypatch.setattr(tadapter, "_dataset_type", lambda d: kind)
    got = tadapter.build_prompt(PARTS, dataset)
    assert got == jadapter.build_prompt(PARTS, dataset)
    assert got[1] == ["/data/a.png"] and got[2] == ["/data/v.mp4"]
    with pytest.raises(ValueError, match="invalid message part"):
        tadapter.build_prompt([{"type": "audio", "value": "x"}], dataset)


@pytest.fixture(scope="module")
def engines():
    return make_engines()


@pytest.fixture(scope="module")
def data(engines, tmp_path_factory):
    """A jsonl whose answers make every score show: the first row's answer is
    JAX's own prediction (exact), the second a word inside it (contains),
    the third something else."""
    jax_eng, _ = engines
    prompts = ["what is the capital", "name a colour", "count to three"]
    path = tmp_path_factory.mktemp("eval") / "qa.jsonl"
    path.write_text("".join(json.dumps({"prompt": p, "answer": ""}) + "\n" for p in prompts))
    preds = [r["prediction"] for r in jeval.run_eval(str(path), engine=jax_eng,
                                                     max_new_tokens=8)["results"]]
    words = [w for w in jeval._normalize(preds[1]).split() if w] or [""]
    answers = [jeval._normalize(preds[0]), words[0], "zebra"]
    path.write_text("".join(json.dumps({"prompt": p, "answer": a, "id": i}) + "\n"
                            for i, (p, a) in enumerate(zip(prompts, answers))))
    return str(path), jeval.run_eval(str(path), engine=jax_eng, max_new_tokens=8)


def test_run_eval_through_the_engine_matches_jax(engines, data, tmp_path):
    _, port = engines
    path, want = data
    out = tmp_path / "out.jsonl"
    got = teval.run_eval(path, engine=port, max_new_tokens=8, out_path=str(out))
    assert got == want
    assert want["summary"]["exact"] > 0 and want["summary"]["n"] == 3
    lines = out.read_text().splitlines()
    assert json.loads(lines[-1]) == {"summary": got["summary"]} and len(lines) == 4


def test_run_eval_and_adapter_through_the_server_match_jax(engines, data):
    """run_eval with url= through the port's server and client, and each
    package's adapter (generate_inner) against that one server."""
    _, port = engines
    path, want = data
    server, thread, url = _serve(port_server, port)
    try:
        got = teval.run_eval(path, url=url, max_new_tokens=8)
        inputs = [{"type": "text", "value": "what is the capital"}]
        answers = [cls(url=url, tokens_to_generate=8).generate_inner(inputs, dataset="MMVet")
                   for cls in (tadapter.LongVITAAPI, jadapter.LongVITAAPI)]
        bad = tadapter.LongVITAAPI(url=url + "/missing", tokens_to_generate=8)
        bad_code, bad_answer, _ = bad.generate_inner("x")
    finally:
        _stop(server, thread)
    assert [r["prediction"] for r in got["results"]] == [r["prediction"]
                                                          for r in want["results"]]
    assert got["summary"] == want["summary"]
    assert answers[0] == answers[1] and answers[0][0] == 0 and answers[0][1]
    assert bad_code == -1 and "Failed to obtain answer" in bad_answer
