"""BENCHMARK.json against the benchmark's contract, and the files it names."""
from __future__ import annotations

import json
import os
import re

import pytest

from portbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(_size|_dim|_rank)$|intermediate|latent|state|projection|head_dim|expansion|"
                    r"per_tok|top_k")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    seen = set()
    for e in MAN[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]) and e["name"] not in seen, e["name"]
        seen.add(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_names_unique_across_metrics():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))


def test_configs_are_used_and_their_files_hold_them():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        body = harness.read_json(harness.ROOT, c["file"])
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key), key
            assert key in body.get("published", {}), key


def test_workloads_resolve_to_files():
    pairs = set()
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.named("cells", w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        mix = harness.named("traffic", w["traffic"])
        harness.module("traffic", mix["generator"])
        assert cell["entry"] in ("serve", "train")
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


def test_metrics_cover_every_cell():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in MAN["workloads"]]
    for cell in cells:
        mine = harness.metrics_of(MAN, "end_to_end", cell)
        assert any(m["name"] == "setup_s" for m in mine) and len(mine) >= 2, cell
        assert harness.metrics_of(MAN, "per_layer", cell), cell


def test_each_layer_metric_moves_what_its_cells_report():
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        harness.reader(m["name"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_named_alike():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_run_seconds_fit_the_full_check():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_command_stays_inside_paths():
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")
    assert os.path.isfile(os.path.join(harness.ROOT, MAN["command"][1]))
