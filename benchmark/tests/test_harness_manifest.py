"""BENCHMARK.json keeps to the contract's form, every part it names is
found by name, and a cell added as files and entries in a copy is listed
and loaded with no code edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# every cell compares these; a cell may add ``ward_excess``
CHECKS = {"tower_sq_err", "partition_faults", "unnamed_clusters",
          "report_faults"}


def test_contract_form():
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["paths"] == ["benchmark"]
    assert 1 <= d["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (d["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    names = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(names) == len(set(names))
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {"setup_s", "images_per_s"} <= {m["name"] for m in
                                           d["end_to_end"]}
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = [w["name"] for w in d["workloads"]]
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(cells) == len(set(cells))


def test_every_part_found():
    m = Manifest()
    for cell in m.cells():
        w = m.cell(cell)
        cfg = m.config(w["config"])
        assert cfg["name"] == w["config"]
        assert m.traffic(w["traffic"])["kind"]
        assert CHECKS <= set(m.limits(cell)) <= CHECKS | {"ward_excess"}
        for trace in (False, True):
            for metric in m.metrics(cell, trace):
                assert callable(m.reader(metric["name"]))


def test_cell_added_without_code_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    d = json.loads((tmp_path / "BENCHMARK.json").read_text())
    d["workloads"].append({"name": "rn50.stream_5k_coarse",
                           "config": "resnet50-v1-7",
                           "traffic": "stream_5k_coarse", "chips": 1,
                           "why": "a test cell"})
    for metric in d["per_layer"]:
        if metric["name"] != "k5_roofline":
            metric["workloads"].append("rn50.stream_5k_coarse")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))
    tr = json.loads((tmp_path / "benchmark/traffic/stream_20k.json")
                    .read_text())
    tr.update(images_per_job=5000, min_size=10, max_size=40)
    (tmp_path / "benchmark/traffic/stream_5k_coarse.json").write_text(
        json.dumps(tr))
    (tmp_path / "benchmark/workloads/rn50.stream_5k_coarse.json"
     ).write_text(json.dumps({"limits": {k: 0 for k in CHECKS}}))
    m = Manifest(tmp_path)
    assert "rn50.stream_5k_coarse" in m.cells()
    assert m.traffic("stream_5k_coarse")["images_per_job"] == 5000
    assert m.config("resnet50-v1-7")["reference"] == "resnet50_v1"
    assert set(m.limits("rn50.stream_5k_coarse")) == CHECKS
    assert "k5_roofline" not in {x["name"] for x in
                                 m.metrics("rn50.stream_5k_coarse", True)}


def test_unknown_cell_named():
    with pytest.raises(KeyError, match="rn50.stream_20k"):
        Manifest().cell("nope")
