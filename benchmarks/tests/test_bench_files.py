"""BENCHMARK.json and the files it names: every cell, configuration, driver
and metric is a file of its own, found by its name."""

import json
import re

import pytest

from benchmarks.harness import files

BENCH = files.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_names_existing_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = files.workload(cell)
    assert wl["config"] == entry["config"] and wl["chips"] == entry["chips"] == 1
    assert wl["why"] == entry["why"] and len(entry["why"]) <= 200
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    files.config(wl["config"])
    assert hasattr(files.driver(wl["driver"]), "Job")
    assert set(wl["limits"]) and int(wl["check_jobs"]) >= 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert entry["file"] == f"benchmarks/configs/{entry['name']}.json"
    cfg = files.config(entry["name"])
    assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    assert cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(files.reader(metric["name"]).read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_per_layer_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_names_are_refused_when_they_could_leave_the_folder():
    for bad in ("../x", "a/b", ".hidden", "", "x" * 65):
        with pytest.raises(ValueError):
            files.check_name(bad)
