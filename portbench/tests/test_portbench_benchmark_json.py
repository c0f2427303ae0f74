"""BENCHMARK.json keeps to the benchmark's contract, and every entry in it
has the data files and reader the harness finds it by."""

from __future__ import annotations

import json
import os
import re

from portbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_of_the_file():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(map(_line, b["command"]))
    assert 1 <= int(b["run_seconds"]) <= 51
    for p in b["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.endswith("_torch")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert len(c["reduced"]) <= 16
    cells = [w["name"] for w in b["workloads"]]
    assert len(cells) == len(set(cells)) and 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = _bench()
    for w in b["workloads"]:
        def mine(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in b["end_to_end"] if mine(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(mine(m) for m in b["per_layer"])
        for m in b["per_layer"]:
            if mine(m):
                assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_entry_has_its_files():
    b = _bench()
    base = os.path.join(ROOT, "portbench")
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in b["workloads"]:
        with open(os.path.join(base, "traffic", w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.isfile(os.path.join(base, "drivers", driver + ".py"))
        with open(os.path.join(base, "limits", w["name"] + ".json")) as f:
            assert json.load(f)["max"]
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(base, "metrics", m["name"] + ".py"))
    limit = 43200 - 1200
    per_run = b["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 <= limit
