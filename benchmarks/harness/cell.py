"""One run of one cell: set-up, the window of jobs, the metrics, and the
comparison with the plain reference that decides ``correct``.

A cell's driver, ``jobs/<driver>.py``, defines ``Job(config, workload,
device)`` with
  * ``inputs(job_seed)``: what the benchmark makes for one job (untimed);
  * ``run(inputs) -> (output, stages)``: the job's calls into the port, the
    seconds of its spans or stages in ``stages``;
  * ``reference(inputs, level)``: the plain reference, ``level`` "stated" or
    "lower" (the control, one precision step down);
  * ``as_output(reference, inputs)``: a reference result in the form of
    ``run``'s output (for the control);
  * ``compare(output, reference) -> {number: value}``: the numbers the
    workload file's ``limits`` hold.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
import traceback
from types import SimpleNamespace

import torch

from benchmarks.harness import files, loop
from benchmarks.harness import trace as tr

#: whole jobs the profiler records at the start of a traced window, at least
TRACE_STRETCH_S = 2.0


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(stages: dict, name: str, device: torch.device):
    """Seconds of the block into stages[name], the device synchronised at
    both ends, under a ``record_function`` of the same name."""
    with torch.profiler.record_function(name):
        sync(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(device)
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak)}


def window(job, seed: int, seconds: float, trace: bool, device: torch.device):
    """Jobs back to back until `seconds` have passed since the first began.
    Returns (records, failures, trace events or None)."""
    records, failures = [], []
    prof, events = None, None
    if trace:
        prof = tr.profiler(device)
        prof.__enter__()
    start = time.perf_counter()
    j = 0
    while time.perf_counter() - start < seconds:
        inp = job.inputs(loop.job_seed(seed, j))
        try:
            with torch.profiler.record_function(tr.JOB_SPAN):
                sync(device)
                t0 = time.perf_counter()
                out, stages = job.run(inp)
                sync(device)
                wall = time.perf_counter() - t0
        except Exception:  # a job that raises is a failed answer; the loop goes on
            failures.append((j, traceback.format_exc()))
        else:
            records.append(loop.JobRecord(j, loop.job_seed(seed, j), wall, stages, out,
                                          traced=prof is not None))
        j += 1
        if prof is not None and time.perf_counter() - start >= TRACE_STRETCH_S:
            prof.__exit__(None, None, None)
            events, prof = tr.chrome_events(prof), None
    if prof is not None:
        prof.__exit__(None, None, None)
        events = tr.chrome_events(prof)
    return records, failures, events


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
             bench: dict | None = None, workload: dict | None = None,
             config: dict | None = None, started: float | None = None) -> dict:
    """Run `cell` once on `device` and return the result line's fields, the
    list of checks last. `bench`, `workload` and `config` default to the
    files (tests pass small ones); set-up counts from `started`
    (``time.perf_counter()``), or from this call."""
    bench = files.spec() if bench is None else bench
    workload = files.workload(cell) if workload is None else workload
    config = files.config(workload["config"]) if config is None else config
    t0 = time.perf_counter() if started is None else started
    job = files.driver(workload["driver"]).Job(config, workload, device)
    job.run(job.inputs(loop.job_seed(seed, -1)))  # every shape of the cell, once
    sync(device)
    setup_s = time.perf_counter() - t0

    records, failures, events = window(job, seed, seconds, trace, device)
    dev_info = device_info(device, int(workload["chips"]))
    summary = tr.summarize(events) if events is not None else None

    ctx = SimpleNamespace(jobs=records, setup_s=setup_s, trace=summary, config=config,
                          workload=workload, seconds=seconds)
    metrics = {}
    for entry in files.cell_metrics(bench, cell, trace):
        value = files.reader(entry["name"]).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    print(wall_line(records), file=sys.stderr)
    gc.collect()  # the window's temporaries go before the reference runs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(job, records, seed, workload)
    for j, tb in failures:
        print(f"job {j} failed:\n{tb}", file=sys.stderr)
    correct = not failures and bool(records) and judged(checks)
    result = {"correct": correct, "attempted": len(records) + len(failures),
              "failed": len(failures), "metrics": metrics, "device": dev_info}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def check(job, records, seed: int, workload: dict) -> dict:
    """Compare the jobs drawn from the seed with the plain reference; each
    number is the worst over those jobs, beside its limit. A number the
    driver did not give, or a NaN, reads infinite."""
    limits = workload["limits"]
    worst = {name: 0.0 for name in limits}
    for i in loop.checked_jobs(seed, len(records), int(workload["check_jobs"])):
        rec = records[i]
        ref = job.reference(job.inputs(rec.seed), "stated")
        numbers = job.compare(rec.out, ref)
        for name in limits:
            value = float(numbers.get(name, math.inf))
            worst[name] = max(worst[name], math.inf if math.isnan(value) else value)
    # an infinite reading is written as the largest float, which JSON can hold
    return {name: {"value": min(worst[name], sys.float_info.max), "limit": float(limits[name])}
            for name in limits}


def judged(checks: dict) -> bool:
    """Whether every number compared keeps its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def wall_line(result_jobs) -> str:
    """One line on the job walls of the window, for reading a run's spread:
    with the job rate of the window's first and second half of jobs, which
    tells a spread within a run from one between runs."""
    walls = [r.wall for r in result_jobs]
    w = sorted(walls)
    if not w:
        return "walls: no job"
    half = len(walls) // 2
    return (f"walls: {len(w)} jobs, min {w[0]!r}, median {w[len(w) // 2]!r}, "
            f"mean {sum(w) / len(w)!r}, max {w[-1]!r}, halves "
            f"{loop.job_rate(walls[:half])!r} {loop.job_rate(walls[half:])!r}")


def check_lines(checks: dict) -> list:
    return [f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}" for name, c in checks.items()]
