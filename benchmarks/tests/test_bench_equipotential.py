"""The Green-function statistics cell (equipotential_default.f64) at a tiny
size on the CPU: the driver through ``cell.run_cell`` with and without the
trace, the control readings, a program that returns no per-point records
(which the run refuses at its warm-up job), and each new reader on
hand-made windows: None where the stages, counters or trace are missing,
values within 0-100% where they are present."""

import copy
from types import SimpleNamespace

import pytest
import torch

from benchmarks import control
from benchmarks.harness import cell, files, loop
from cmtci_torch.pipelines import equipotential as eq

CELL = "equipotential_default.f64"
CPU = torch.device("cpu")
STAGES = {"equipotential.cloud_ms": "cloud", "equipotential.potential_ms": "potential",
          "equipotential.per_n_ms": "per_n", "equipotential.families_ms": "families",
          "equipotential.curve_ms": "stored_curve"}
PCT = ("equipotential.unescaped_pct", "equipotential.green_roofline")
NEW = (*STAGES, *PCT)
POINTS, UNESCAPED, STEPS = ("equipotential.green_points", "equipotential.green_unescaped",
                            "equipotential.green_escape_steps")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell():
    """(workload, config): n = 2..14, 400 steps, a curve of 300 points from
    the band of a 200 x 200 grid."""
    wl = copy.deepcopy(files.workload(CELL))
    wl["traffic"]["equipotential"] = {"n_max": 14, "max_iter": 400}
    wl["traffic"]["curve"] = {"points": 300}
    cfg = copy.deepcopy(files.config(wl["config"]))
    cfg["curve"]["mandel_band"]["res"] = 200
    return wl, cfg


def run(trace: bool, seed=2**31 + 3):
    wl, cfg = tiny_cell()
    return cell.run_cell(CELL, seed, 0.5, trace, CPU, workload=wl, config=cfg)


def test_sound_run_is_correct():
    res = run(False)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(files.workload(CELL)["limits"])
    assert set(res["metrics"]) == {"job_rate", "setup_s"}


def test_traced_run_reports_the_program_stages_and_counter():
    res = run(True)
    assert res["correct"] is True, res["checks"]
    got = res["metrics"]
    # no device on the CPU: no idle share and no kernel time for the roofline
    assert set(got) == {*STAGES, "equipotential.unescaped_pct"}
    assert all(got[m]["value"] > 0 and got[m]["unit"] == "ms" for m in STAGES)
    assert 0 < got["equipotential.unescaped_pct"]["value"] < 100


def test_control_fails_where_the_program_passes():
    wl, cfg = tiny_cell()
    lines = list(control.readings(CELL, (3, 2**31 + 11), CPU, workload=wl, config=cfg))
    assert [x["side"] for x in lines] == ["program", "control"] * 2
    for x in lines:
        assert x["correct"] == (x["side"] == "program"), x
        if x["side"] == "control":
            assert x["checks"]["g_gap"]["value"] > x["checks"]["g_gap"]["limit"]


def test_a_program_without_points_fails_at_the_warm_up(monkeypatch):
    real = eq.run_equipotential

    def without_points(*a, **k):
        out = real(*a, **k)
        del out["points"]
        return out

    # the driver is loaded anew by the run, and takes the patched function
    monkeypatch.setattr(eq, "run_equipotential", without_points)
    wl, cfg = tiny_cell()
    with pytest.raises(RuntimeError, match="points"):
        cell.run_cell(CELL, 5, 0.5, False, CPU, workload=wl, config=cfg)


def job(i, times=None, counts=None, traced=False, stats=True):
    out = {"stats": {"stage_times": times or {}, **({} if counts is None else {"counts": counts})}}
    return loop.JobRecord(i, i, 1.0, {}, out if stats else [{"row": 1}], traced=traced)


def read(metric, ctx):
    return files.reader(metric).read(ctx)


def test_stage_means_over_the_measured_jobs():
    stages = dict(zip(STAGES.values(), (0.010, 0.002, 0.090, 0.008, 0.004)))
    double = {k: 2 * v for k, v in stages.items()}
    ctx = SimpleNamespace(jobs=[job(0, {k: 9.0 for k in stages}, traced=True), job(1, stages),
                                job(2, double)], trace=None)
    for metric, stage in STAGES.items():
        assert read(metric, ctx) == pytest.approx(1e3 * 1.5 * stages[stage]), metric


@pytest.mark.parametrize("jobs", [[], [job(0, stats=False)], [job(0, {"other": 1.0})]],
                         ids=["no job", "no stats", "other stages"])
def test_no_stages_read_none(jobs):
    ctx = SimpleNamespace(jobs=jobs, trace={"span_kernel_s": {"potential": 1e-3}})
    for metric in NEW:
        assert read(metric, ctx) is None, metric


def test_unescaped_share_sums_the_counters():
    ctx = SimpleNamespace(jobs=[job(0, counts={POINTS: 10, UNESCAPED: 10}, traced=True),
                                job(1, counts={POINTS: 1000, UNESCAPED: 60}),
                                job(2, counts={POINTS: 3000, UNESCAPED: 200}),
                                job(3, counts={POINTS: 50})], trace=None)
    assert read("equipotential.unescaped_pct", ctx) == pytest.approx(100 * 260 / 4000)
    ctx.jobs = [job(1, counts={POINTS: 0, UNESCAPED: 0})]
    assert read("equipotential.unescaped_pct", ctx) is None


def test_roofline_of_the_escape_steps_over_the_solves_kernel_time():
    steps = 2_000_000
    jobs = [job(0, counts={STEPS: steps}, traced=True), job(1, counts={STEPS: steps}, traced=True),
            job(2, counts={STEPS: 10**12})]  # untraced: not counted
    trace = {"span_kernel_s": {"potential": 4e-4, "stored_curve": 2e-4, "cloud": 9.0}}
    ctx = SimpleNamespace(jobs=jobs, trace=trace)
    value = read("equipotential.green_roofline", ctx)
    assert value == pytest.approx(100 * 12 * 2 * steps / 33.5e12 / 6e-4)
    assert 0 < value <= 100
    for trace in (None, {"span_kernel_s": {"cloud": 1.0}}, {}):
        ctx.trace = trace
        assert read("equipotential.green_roofline", ctx) is None
    ctx.trace = {"span_kernel_s": {"potential": 4e-4}}
    ctx.jobs = [job(0, counts={POINTS: 5}, traced=True)]  # no step counter
    assert read("equipotential.green_roofline", ctx) is None
    ctx.jobs = [job(0, counts={STEPS: steps})]  # no traced job
    assert read("equipotential.green_roofline", ctx) is None


def test_the_new_metrics_belong_to_the_new_cell_alone():
    bench = files.spec()
    assert set(NEW) <= {m["name"] for m in files.cell_metrics(bench, CELL, True)}
    for other in (w["name"] for w in bench["workloads"] if w["name"] != CELL):
        assert not set(NEW) & {m["name"] for m in files.cell_metrics(bench, other, True)}
    assert {m["name"] for m in files.cell_metrics(bench, CELL, False)} == {"job_rate", "setup_s"}
