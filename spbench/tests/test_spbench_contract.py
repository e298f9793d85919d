"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and a file of its own for every configuration, traffic mix, cell's limits
and metric."""

import json
import os
import re

import pytest

from spbench.tests.conftest import ROOT, SPBENCH

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
       "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["spbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("spbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_cells(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
        traffic = os.path.join(SPBENCH, "traffic", w["traffic"] + ".json")
        with open(traffic) as f:
            kind = json.load(f)["kind"]
        assert os.path.isfile(os.path.join(SPBENCH, "drivers", kind + ".py"))
        assert os.path.isfile(os.path.join(SPBENCH, "limits", w["name"] + ".json"))


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(bench, group):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert os.path.isfile(os.path.join(SPBENCH, "metrics", m["name"] + ".py"))
        if group == "end_to_end":
            assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                              "layer", "moves"}
            assert line(m["layer"]) and m["moves"] in e2e
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        def has(group):
            return [m["name"] for m in bench[group]
                    if w["name"] in m.get("workloads", [w["name"]])]
        e2e = has("end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2 and has("per_layer")


def test_names_unique(bench):
    metrics = [m["name"] for g in ("end_to_end", "per_layer") for m in bench[g]]
    assert len(metrics) == len(set(metrics))
    assert len({c["name"] for c in bench["configs"]}) == len(bench["configs"])
