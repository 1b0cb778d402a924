"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a configuration, traffic mix, metric and reader added as files."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["perfbench"] and all(_line(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert c["reduced"] == spec.config(c["name"])["reduced"]
        assert c["source"] == spec.config(c["name"])["source"]
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] in (1, 4)
        assert w["config"] in names and spec.traffic(w["traffic"])["loop"]
        assert set(spec.limits(w["name"])) and all(
            isinstance(v, float) for v in spec.limits(w["name"]).values())
    assert {c for w in b["workloads"] for c in [w["config"]]} == set(names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["moves"] in [e["name"] for e in b["end_to_end"]]
        meta = spec.metric(m["name"])
        spec.module("readers", meta["reader"])
        layers.setdefault(m["layer"], set()).add(m["name"])
        for cell in m["workloads"]:
            e2e = [e["name"] for e in spec.cell(cell, b)["end_to_end"]]
            assert m["moves"] in e2e
    for cell in cells:
        c = spec.cell(cell, b)
        assert "setup_s" in [m["name"] for m in c["end_to_end"]] and len(c["end_to_end"]) >= 2
        assert c["per_layer"]
    every = [m["name"] for key in ("end_to_end", "per_layer") for m in b[key]]
    assert len(set(every)) == len(every) and all(NAME.match(n) for n in every)
    assert len(json.dumps(b)) < 64 * 1024


def test_metric_files_name_their_cost_functions():
    for m in spec.benchmark()["per_layer"]:
        meta = spec.metric(m["name"])
        if "cost" not in meta:
            continue
        for cell in m["workloads"]:
            cfg = spec.config(spec.cell(cell)["config"])
            assert callable(getattr(spec.module("costs", cfg["costs"]), meta["cost"]))


def test_a_cell_added_as_files_runs(tiny, monkeypatch, tmp_path):
    """A new traffic mix, per-layer metric and reader, added as files and
    entries only, are found by name and reported."""
    import perfbench.readers

    (tiny / "traffic" / "train_b512.json").write_text(json.dumps(
        {"loop": "train", "batch": 512, "pool_rows": 512 * 6, "why": "added"}))
    (tiny / "metrics" / "steps_seen.train.json").write_text(json.dumps(
        {"reader": "steps_seen", "what": "added"}))
    (tiny / "limits" / "dlrm_mlperf_criteo.train_b512.json").write_text(
        (tiny / "limits" / "dlrm_mlperf_criteo.train_b2048.json").read_text())
    readers = tmp_path / "readers"
    readers.mkdir()
    (readers / "steps_seen.py").write_text(
        "def read(spec, run):\n    return float(run['traced']['units']['step'])\n")
    monkeypatch.setattr(perfbench.readers, "__path__", [*perfbench.readers.__path__,
                                                          str(readers)])
    b = spec.benchmark()
    cell = "dlrm_mlperf_criteo.train_b512"
    b["workloads"].append({"name": cell, "config": "dlrm_mlperf_criteo", "traffic": "train_b512",
                           "chips": 1, "why": "added"})
    for m in b["end_to_end"]:
        if m["name"] == "train_examples_per_s":
            m["workloads"].append(cell)
    b["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                           "source": "host_clock", "layer": "Trainer and step",
                           "moves": "train_examples_per_s", "workloads": [cell]})
    r = run.run_cell(cell, 7, 0.4, True, device="cpu", bench=b)
    assert r["metrics"]["steps_seen.train"]["value"] >= 1
    assert "step_enqueue_ms.train" not in r["metrics"]
    r = run.run_cell(cell, 7, 0.4, False, device="cpu", bench=b)
    assert set(r["metrics"]) == {"train_examples_per_s", "setup_s"}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")
