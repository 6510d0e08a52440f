"""BENCHMARK.json against the benchmark's format, with and without the
cells of held.json, and every cell resolves to its configuration,
traffic, entry, limits and metric readers."""

import json
import os
import re

import pytest

import harness
from conftest import ALL_CELLS, with_held

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHES = {"benchmark": BENCH, "with_held": with_held()}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("which", sorted(BENCHES))
def test_names_units_and_lines(which):
    bench = BENCHES[which]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics] + cells + [c["name"] for c in bench["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics) and len(set(cells)) == len(cells)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    lines = ([w["why"] for w in bench["workloads"]] + [c["why"] for c in bench["configs"]]
             + [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]])
    assert all(1 <= len(s) <= 200 and "\n" not in s and "\t" not in s for s in lines)


@pytest.mark.parametrize("which", sorted(BENCHES))
def test_bounds_and_sources(which):
    bench = BENCHES[which]
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for m in e2e.values():
        assert set(m.get("workloads", cells)) <= set(cells)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_resolves(cell, bench_path):
    spec = harness.load_spec(cell, bench_path)
    assert spec.workload["chips"] == 1
    assert os.path.exists(os.path.join(harness.HERE, "entries", spec.traffic["entry"] + ".py"))
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"} and len(spec.end_to_end) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert os.path.exists(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
    assert spec.limits and all(isinstance(v, float) for v in spec.limits.values())
    config = next(c for c in BENCHES["with_held"]["configs"]
                  if c["name"] == spec.workload["config"])
    assert config["file"].startswith("benchmark/configs/")
    assert set(config["reduced"]) == set(spec.config["reduced"])
