"""The readers of the program's stages and counters inside run_spatial_stats
(``harness/spans.py`` and the six ``pairstats.*`` metrics that use it) on
hand-made windows, their None cases, the idle gaps labelled by the program's
spans, and a tiny traced pair-cell run on the CPU that reports them."""

from types import SimpleNamespace

import pytest

from benchmarks.harness import cell, files, loop
from benchmarks.harness import trace as tr
from benchmarks.tests import tiny

SHELLS = ("spatial_stats.shells_construct", "spatial_stats.shells_mandel")
MS = ("pairstats.shells_ms", "pairstats.hausdorff_ms", "pairstats.curvature_ms",
      "pairstats.boxdim_ms")
NEW = (*MS, "pairstats.shells_busy_pct", "pairstats.shell_hit_pct")


def job(i, times, counts=None, traced=False):
    stats = {"stage_times": times, **({} if counts is None else {"counts": counts})}
    return loop.JobRecord(i, i, 1.0, {"pairstats.stats": 1.0}, {"stats": stats}, traced=traced)


def times(shells, hausdorff, curvature, boxdim):
    return {SHELLS[0]: shells / 2, SHELLS[1]: shells / 2, "spatial_stats.hausdorff": hausdorff,
            "spatial_stats.curvature": curvature, "spatial_stats.boxdim": boxdim}


def read(metric, ctx):
    return files.reader(metric).read(ctx)


def test_stage_means_over_the_measured_jobs():
    # the traced job is left out of the means; the others' stages average
    jobs = [job(0, times(9.0, 9.0, 9.0, 9.0), traced=True), job(1, times(2.0, 0.3, 0.01, 1.0)),
            job(2, times(2.4, 0.5, 0.03, 3.0))]
    ctx = SimpleNamespace(jobs=jobs, trace=None)
    assert read("pairstats.shells_ms", ctx) == pytest.approx(2200.0)
    assert read("pairstats.hausdorff_ms", ctx) == pytest.approx(400.0)
    assert read("pairstats.curvature_ms", ctx) == pytest.approx(20.0)
    assert read("pairstats.boxdim_ms", ctx) == pytest.approx(2000.0)


def test_shells_need_both_stages_of_a_job():
    one = times(2.0, 0.3, 0.01, 1.0)
    del one[SHELLS[1]]
    ctx = SimpleNamespace(jobs=[job(0, one), job(1, times(4.0, 0.3, 0.01, 1.0))], trace=None)
    assert read("pairstats.shells_ms", ctx) == pytest.approx(4000.0)


@pytest.mark.parametrize("out", [{"stats": {"g_construct": [1.0]}}, {"stats": None}, [{"row": 1}],
                                 None], ids=["no stage times", "no stats", "tracker rows", "none"])
def test_no_stage_times_no_counts_read_none(out):
    jobs = [loop.JobRecord(i, i, 1.0, {}, out, traced=i == 0) for i in range(3)]
    trace = {"span_kernel_s": {SHELLS[0]: 1.0, SHELLS[1]: 1.0}}
    ctx = SimpleNamespace(jobs=jobs, trace=trace)
    for metric in NEW:
        assert read(metric, ctx) is None, metric


def test_busy_share_of_the_shell_spans_in_the_traced_jobs():
    jobs = [job(0, times(2.0, 0.3, 0.0, 1.0), traced=True),
            job(1, times(3.0, 0.3, 0.0, 1.0), traced=True),
            job(2, times(50.0, 0.3, 0.0, 1.0))]  # untraced: not in the denominator
    ctx = SimpleNamespace(jobs=jobs, trace={"span_kernel_s": {SHELLS[0]: 1.5, SHELLS[1]: 2.5,
                                                              "pairstats.stats": 9.0}})
    assert read("pairstats.shells_busy_pct", ctx) == pytest.approx(100 * 4.0 / 5.0)
    ctx.trace = None
    assert read("pairstats.shells_busy_pct", ctx) is None
    ctx.trace = {"span_kernel_s": {"pairstats.stats": 9.0}}  # no kernel in the shell spans
    assert read("pairstats.shells_busy_pct", ctx) is None
    ctx.trace = {"span_kernel_s": {SHELLS[0]: 1.0}}
    ctx.jobs = [job(2, times(5.0, 0.3, 0.0, 1.0))]  # no traced job
    assert read("pairstats.shells_busy_pct", ctx) is None


def test_busy_share_from_a_trace_of_nested_spans():
    # one job: a kernel, then the stats span with the two shell spans
    # (kernels 100-400 and 600-700 us) and a host-only box count, then a
    # kernel; the kernel in the Hausdorff span counts for neither shell span
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a} for a, b, n in (
        (0, 2000, tr.JOB_SPAN), (50, 1900, "pairstats.stats"), (60, 500, SHELLS[0]),
        (500, 800, SHELLS[1]), (800, 1000, "spatial_stats.hausdorff"),
        (1000, 1900, "spatial_stats.boxdim"))]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": b - a}
           for a, b in ((10, 40), (100, 400), (600, 700), (850, 950), (1900, 1950))]
    s = tr.summarize(ev)
    ctx = SimpleNamespace(jobs=[job(0, {SHELLS[0]: 440e-6, SHELLS[1]: 300e-6}, traced=True)],
                          trace=s)
    assert read("pairstats.shells_busy_pct", ctx) == pytest.approx(100 * 400 / 740)
    # each idle gap is labelled by the innermost program span at its middle,
    # never by the stats span around them
    gaps = dict(s["idle_gaps"])
    assert gaps["spatial_stats.boxdim/host"] == pytest.approx(950e-6)
    assert not any(k.startswith("pairstats.stats/") for k in gaps)


def test_shell_hit_share_sums_counts_over_the_measured_jobs():
    d, h = "spatial_stats.distances", "spatial_stats.in_shells"
    jobs = [job(0, {}, {d: 10, h: 10}, traced=True), job(1, {}, {d: 100, h: 60}),
            job(2, {}, {d: 300, h: 200}), job(3, {}, {d: 50})]
    ctx = SimpleNamespace(jobs=jobs, trace=None)
    assert read("pairstats.shell_hit_pct", ctx) == pytest.approx(100 * 260 / 400)
    ctx.jobs = [job(1, {}, {d: 0, h: 0})]
    assert read("pairstats.shell_hit_pct", ctx) is None


def test_the_new_metrics_belong_to_the_pair_cell_alone():
    bench = files.spec()
    pair = {m["name"] for m in files.cell_metrics(bench, tiny.PAIRSTATS, True)}
    assert set(NEW) <= pair
    for name in ("tracker_appendixA.dense4", "tracker_appendixA.to1024"):
        assert not set(NEW) & {m["name"] for m in files.cell_metrics(bench, name, True)}
    assert not set(NEW) & {m["name"] for m in files.cell_metrics(bench, tiny.PAIRSTATS, False)}


def test_tiny_traced_pair_run_reports_the_program_stages():
    wl, cfg = tiny.pairstats_cell()
    wl["check_jobs"] = 1
    res = cell.run_cell(tiny.PAIRSTATS, 2**31 + 11, 0.5, True, tiny.CPU, workload=wl, config=cfg)
    assert res["correct"] is True, res["checks"]
    got = res["metrics"]
    assert set(MS) | {"pairstats.shell_hit_pct"} <= set(got)
    assert "pairstats.shells_busy_pct" not in got  # no kernels on the CPU
    assert all(got[m]["value"] > 0 and got[m]["unit"] == "ms" for m in MS)
    assert 0 < got["pairstats.shell_hit_pct"]["value"] <= 100
    # the five stages lie inside the benchmark's span around the call
    assert sum(got[m]["value"] for m in MS) <= got["pairstats.stats_ms"]["value"]
