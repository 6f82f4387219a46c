"""PyTorch port: the training entry point (training/train.py) against the JAX
package's, on a tiny *_HF directory with random f32 weights written by the
port's exporter, a text corpus of two sources and one shared byte-level
tokenizer (load_tokenizer of both packages returns it; no tokenizer files
are in the repository):

  - build_from_recipe from ``model.checkpoint``, from ``model.graft`` (stock
    Qwen2 + InternViT directories; the fresh projector of the JAX graft is
    copied into the port's, as jax.random cannot be reproduced), from
    ``model.lora`` (lora_only, remat "flash"; the JAX adapters copied into
    the port's) and with ``model.load_stage`` (a previous stage of each
    package's own checkpoint format): the same batch stream (identical
    arrays) and 3 losses within 1e-5 relative;
  - output_dir: metrics.jsonl records with the JAX keys, the same
    print_batch.log, data_report.json and data_samples.json, and the port's
    profiler trace of the window;
  - main(["--config", ...]) runs with device="cpu", and the default device
    raises without a card.
"""
import itertools
import json

import numpy as np
import pytest
import torch
import yaml

import long_vita_tpu.tokenizer as jax_tokenizer
import long_vita_tpu.training.distributed as jax_distributed
import long_vita_tpu.utils.compile_cache as jax_compile_cache
import long_vita_tpu_torch.tokenizer as port_tokenizer
from long_vita_tpu.training import train as jtrain
from long_vita_tpu_torch.config import tiny_test_config
from long_vita_tpu_torch.models.long_vita import init_long_vita_params
from long_vita_tpu_torch.training import train as ttrain
from long_vita_tpu_torch.utils.convert import long_vita_params_from_jax, projector_params_from_jax
from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint
from test_torch_checkpoint_io import _stock_dirs
from test_torch_quantize import one_torch_thread  # noqa: F401
from test_torch_serving import tiny_tokenizer

SEQ, STEPS = 128, 3


@pytest.fixture(scope="module")
def tok():
    return tiny_tokenizer()


@pytest.fixture(autouse=True)
def shared_tokenizer(monkeypatch, tok):
    for module in (jax_tokenizer, port_tokenizer):
        monkeypatch.setattr(module, "load_tokenizer", lambda path, template="long_vita": tok)
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: None)
    monkeypatch.setattr(jax_distributed, "maybe_initialize", lambda *a, **k: None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny *_HF directory and a two-source text corpus."""
    root = tmp_path_factory.mktemp("recipe")
    cfg = tiny_test_config()
    params = init_long_vita_params(torch.Generator().manual_seed(3), cfg)
    save_hf_checkpoint(params, cfg, str(root / "ckpt"))
    rng = np.random.default_rng(0)

    def text(n):
        return "".join(chr(c) for c in rng.integers(97, 123, n))

    for name, n in (("a", 14), ("b", 9)):
        rows = [{"messages": [{"role": "user", "content": text(10 + i % 13)},
                              {"role": "assistant", "content": text(8 + i % 17)}]}
                for i in range(n)]
        (root / f"{name}.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    (root / "corpus.yaml").write_text(yaml.safe_dump({"dataset": {
        "A": {"ratio": 1.5, "data_paths": [str(root / "a.jsonl")]},
        "B": {"ratio": 1, "num": 8, "data_paths": [str(root / "b.jsonl")]},
    }}))
    return root


def _recipe(root, **over) -> dict:
    recipe = {
        "model": {"checkpoint": str(root / "ckpt"), "dtype": "float32"},
        "data": {"corpus": str(root / "corpus.yaml"), "seq_len": SEQ, "logit_budget": SEQ,
                 "system_message": "answer"},
        "optim": {"lr": 1.0e-3, "warmup_steps": 1, "total_steps": 10, "freeze_vision": True},
        "run": {"steps": STEPS, "seed": 5, "remat": True},
    }
    for section, values in over.items():
        recipe[section] = {**recipe.get(section, {}), **values}
    return recipe


def _build(recipe):
    """Both packages' (trainer, first STEPS batches, the rest of the stream)."""
    port, pb, _ = ttrain.build_from_recipe(recipe, device="cpu")
    jax_, jb, _ = jtrain.build_from_recipe(recipe)
    return port, list(itertools.islice(pb, STEPS)), pb, jax_, list(itertools.islice(jb, STEPS)), jb


def _same_batches(got, want):
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert (g[k] is None) == (w[k] is None), k
            if g[k] is not None:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _train(port, pb, jax_, jb, tok):
    got = port.train(iter(pb), tokenizer=tok)["losses"]
    want = jax_.train(iter(jb), tokenizer=tok)["losses"]
    assert len(got) == STEPS and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    return got


@pytest.fixture(scope="module")
def checkpoint_runs(files, tok, tmp_path_factory):
    """The checkpoint recipe through both packages, each writing its own
    output_dir (the port's profiler over step 1)."""
    out = tmp_path_factory.mktemp("out")
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_tokenizer, port_tokenizer):
            mp.setattr(module, "load_tokenizer", lambda path, template="long_vita": tok)
        port, pstream, _ = ttrain.build_from_recipe(_recipe(files, run={
            "output_dir": str(out / "port"), "profile_steps": [1, 2]}), device="cpu")
        jax_, jstream, _ = jtrain.build_from_recipe(_recipe(files, run={
            "output_dir": str(out / "jax")}))
        pb, jb = list(itertools.islice(pstream, STEPS)), list(itertools.islice(jstream, STEPS))
        losses = (port.train(iter(pb), tokenizer=tok)["losses"],
                  jax_.train(iter(jb), tokenizer=tok)["losses"])
        for rest in (pstream, jstream):  # the reports are written when the stream ends
            for _ in rest:
                pass
    return out, {"losses": losses, "batches": (pb, jb)}


def test_checkpoint_recipe_matches_jax(checkpoint_runs):
    _, runs = checkpoint_runs
    _same_batches(*runs["batches"])
    got, want = runs["losses"]
    assert len(got) == STEPS and np.isfinite(got).all() and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_output_dir_holds_the_jax_files(checkpoint_runs):
    out, _ = checkpoint_runs
    port, jax_ = out / "port", out / "jax"
    got = [json.loads(line) for line in (port / "metrics.jsonl").read_text().splitlines()]
    want = [json.loads(line) for line in (jax_ / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(STEPS))
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert set(got[0]) == {"step", "wall_s", "loss", "grad_norm", "supervised_tokens",
                           "step_time_s"}
    for name in ("print_batch.log", "data_report.json", "data_samples.json"):
        assert (port / name).read_text() == (jax_ / name).read_text(), name
    report = json.loads((port / "data_report.json").read_text())
    assert set(report) == {"A", "B"} and report["B"]["samples"] == 8
    trace = json.loads((port / "trace_1_2.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])


def test_graft_recipe_matches_jax(files, tok, tmp_path):
    llm, vit = _stock_dirs(tmp_path)
    port, pb, _, jax_, jb, _ = _build(_recipe(files, model={"graft": {"llm": llm, "vit": vit}}))
    _same_batches(pb, jb)
    proj = projector_params_from_jax(jax_.state.params["projector"], device="cpu")
    with torch.no_grad():
        for (n, p), (_, q) in zip(port.state.params.projector.named_parameters(),
                                  proj.named_parameters()):
            p.copy_(q)
    _train(port, pb, jax_, jb, tok)


def test_lora_recipe_matches_jax(files, tok):
    """lora_only with remat "flash": the adapters move, the base does not."""
    recipe = _recipe(files, model={"lora": {"r": 4, "alpha": 8,
                                            "targets": ["q_proj", "v_proj", "down_proj"]}},
                     run={"remat": "flash"}, optim={"lr": 1.0e-2})
    port, pb, _, jax_, jb, _ = _build(recipe)
    _same_batches(pb, jb)
    assert port.tcfg.optim.lora_only and port.cfg.text.lora_r == 4
    assert port.freeze["freeze_text"] is False
    want = long_vita_params_from_jax(jax_.state.params, device="cpu")
    named = dict(want.named_parameters())
    before = {}
    with torch.no_grad():
        for n, p in port.state.params.named_parameters():
            if n.endswith(".lora.a"):
                p.copy_(named[n])
            before[n] = p.detach().clone()
    _train(port, pb, jax_, jb, tok)
    for n, p in port.state.params.named_parameters():
        if n.endswith(".lora.b"):
            assert not torch.equal(p, before[n]), n
        elif ".lora." not in n:
            assert torch.equal(p, before[n]), n


def test_load_stage_recipe_matches_jax(files, tok, tmp_path):
    """Stage 1 saves, stage 2 starts from it (each package's own format)."""
    stage1 = {"run": {"steps": 2, "save_dir": None}}
    dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    for name, train in (("port", ttrain), ("jax", jtrain)):
        stage1["run"]["save_dir"] = str(dirs[name])
        kw = {"device": "cpu"} if name == "port" else {}
        trainer, batches, _ = train.build_from_recipe(_recipe(files, **stage1), **kw)
        trainer.train(batches, tokenizer=tok)
    port, pb, _ = ttrain.build_from_recipe(
        _recipe(files, model={"load_stage": str(dirs["port"])}), device="cpu")
    jax_, jb, _ = jtrain.build_from_recipe(_recipe(files, model={"load_stage": str(dirs["jax"])}))
    want = long_vita_params_from_jax(jax_.state.params, device="cpu")
    fresh = ttrain.build_from_recipe(_recipe(files), device="cpu")[0]
    moved = False
    for (n, p), (_, w), (_, f) in zip(port.state.params.named_parameters(),
                                      want.named_parameters(),
                                      fresh.state.params.named_parameters()):
        torch.testing.assert_close(p.detach(), w, rtol=1e-5, atol=1e-5, msg=n)
        moved = moved or not torch.equal(p, f)
    assert moved  # the stage's parameters, not the checkpoint's
    pb, jb = list(itertools.islice(pb, STEPS)), list(itertools.islice(jb, STEPS))
    _same_batches(pb, jb)
    _train(port, pb, jax_, jb, tok)


def test_main_runs_on_the_cpu(files, tmp_path):
    path = tmp_path / "recipe.yaml"
    path.write_text(yaml.safe_dump(_recipe(files, run={"output_dir": str(tmp_path / "out")})))
    out = ttrain.main(["--config", str(path)], device="cpu")
    assert len(out["losses"]) == STEPS and np.isfinite(out["losses"]).all()
    assert (tmp_path / "out" / "metrics.jsonl").read_text().count("\n") == STEPS


def test_default_device_is_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.build_from_recipe(_recipe(files))
