"""``BENCHMARK.json`` keeps to its contract, and the harness finds a
configuration, a traffic mix and the stream of its kind, a study and a
metric by name, also ones added in another directory."""

import json
import os
import re

import numpy as np
import pytest
import torch

from _tiny import PKG, ROOT, dummy_root, real_bench
from gridbench.grid import make_grid
from gridbench.reference import compare
from gridbench.spec import load_cell

torch.set_num_threads(1)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_benchmark_json_shape():
    b = real_bench()
    assert set(b) == TOP
    assert b["paths"] == ["gridbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"] == ["python3", "gridbench/run.py"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gridbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(PKG, "traffic",
                                           f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(PKG, "cells",
                                           f"{w['name']}.json"))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(PKG, "metrics",
                                           f"{m['name']}.py"))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
        assert all(m["moves"] in [e["name"] for e in b["end_to_end"]
                                  if "workloads" not in e
                                  or w in e["workloads"]]
                   for w in m["workloads"])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for w in b["workloads"]:
        cell = load_cell(w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
    assert len(json.dumps(b)) < 64 * 1024


def test_a_dummy_config_traffic_study_and_metric_are_found_by_name(
        tmp_path):
    before = {p: os.path.getmtime(os.path.join(dp, p))
              for dp, _, ps in os.walk(PKG) for p in ps}
    root = dummy_root(tmp_path)
    cell = load_cell("dummy.wave", root)
    assert cell.config["n_bus"] == 150 and cell.traffic["kind"] == "ramp"
    assert [m["name"] for m in cell.per_layer] == ["dummy_count"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "pf_snapshots_per_s"}
    arrays = make_grid(cell.config)
    stream = cell.stream(arrays, 12345)
    assert np.array_equal(stream.payload(2), 0.25 * np.arange(8, 12))
    mod = cell.study_module()
    study = mod.Study(arrays, cell.settings, "cpu")
    out = study.run(stream.payload(1))
    kept = study.keep(out, np.array([0, 3]), stream.payload(1))
    ok, rows = compare.judge(mod.numbers(arrays, cell.settings, kept,
                                         study.tally(out), 12345),
                             cell.settings["limits"])
    assert ok, rows
    assert cell.metric_reader("dummy_count").read({"items": 8}) == 8.5
    after = {p: os.path.getmtime(os.path.join(dp, p))
             for dp, _, ps in os.walk(PKG) for p in ps}
    assert {p: after[p] for p in before} == before


def test_a_missing_file_is_an_error(tmp_path):
    root = dummy_root(tmp_path)
    os.remove(os.path.join(root, "gridbench/traffic/wave.json"))
    with pytest.raises(FileNotFoundError):
        load_cell("dummy.wave", root)
    with pytest.raises(KeyError):
        load_cell("no.such", root)
