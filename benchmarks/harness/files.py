"""Find and load the benchmark's files by the names in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    """A cell, configuration, driver or metric name, refused unless it is
    made of the characters a name may have (so it can name no other path)."""
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def spec() -> dict:
    """The repository's BENCHMARK.json."""
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(BENCH / "workloads" / f"{check_name(name)}.json")


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{check_name(name)}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """The job driver ``jobs/<name>.py``."""
    return _module(BENCH / "jobs" / f"{check_name(name)}.py", f"bench_job_{name}")


def reader(metric: str):
    """The reader ``metrics/<metric>.py`` of one metric."""
    return _module(BENCH / "metrics" / f"{check_name(metric)}.py",
                   "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics in a run
    with trace 0, its per-layer metrics with trace 1."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]
