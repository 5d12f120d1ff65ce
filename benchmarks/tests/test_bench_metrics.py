"""The arithmetic of the end-to-end metrics and of the device trace, on
synthetic walls and intervals, and the pair count of the roofline."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from benchmarks.harness import files, loop
from benchmarks.harness import trace as tr


def ctx_of(walls, traced=0, stages=None):
    jobs = [loop.JobRecord(i, i, w, dict(stages or {}), None, traced=i < traced)
            for i, w in enumerate(walls)]
    return SimpleNamespace(jobs=jobs, setup_s=12.5, trace=None, config={}, workload={})


def test_job_rate_is_all_jobs_over_all_their_time():
    walls = [0.2] * 99 + [5.0]  # one stall of 5 s
    assert files.reader("job_rate").read(ctx_of(walls)) == pytest.approx(100 / (99 * 0.2 + 5.0))


def test_p95_sees_a_stall_once_it_passes_five_percent():
    walls = [0.2] * 190 + [3.0] * 10
    assert files.reader("job_p95_s").read(ctx_of(walls)) == pytest.approx(
        np.percentile(walls, 95))
    assert files.reader("job_p95_s").read(ctx_of([0.2] * 200)) == pytest.approx(0.2)
    assert files.reader("job_p95_s").read(ctx_of([0.2] * 180 + [3.0] * 20)) == pytest.approx(3.0)


def test_setup_and_empty_windows():
    assert files.reader("setup_s").read(ctx_of([])) == 12.5
    assert files.reader("job_rate").read(ctx_of([])) is None


def test_stage_means_leave_out_the_traced_jobs():
    ctx = ctx_of([1.0] * 4, traced=1, stages={"bins64_match": 0.01, "bins128_match": 0.03})
    ctx.jobs[0].stages = {"bins64_match": 1.0, "bins128_match": 1.0}
    assert files.reader("tracker.match_ms").read(ctx) == pytest.approx(40.0)
    assert files.reader("tracker.cloud_ms").read(ctx) is None


def events(jobs, kernels, notes=()):
    ev = [{"ph": "X", "cat": "user_annotation", "name": tr.JOB_SPAN, "ts": a, "dur": b - a}
          for a, b in jobs]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a} for a, b, n in kernels]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for a, b, n in notes]
    return ev


def test_idle_share_of_overlapping_kernels_and_a_stall():
    # two jobs over 0..1000 us; kernels overlap in 100..300, a stall 300..900
    ev = events([(0, 400), (400, 1000)],
                [(100, 250, "k1"), (200, 300, "k2"), (900, 950, "k1"), (-50, 20, "k0")],
                [(300, 900, "bins512_hist")])
    s = tr.summarize(ev)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((200 + 50 + 20) * 1e-6)
    assert s["device_idle_pct"] == pytest.approx(100 * (1 - 270 / 1000))
    assert s["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    assert s["idle_gaps"][0] == ["bins512_hist/host", pytest.approx(600e-6)]
    assert s["idle_gaps"][1] == ["job/host", pytest.approx(130e-6)]
    assert sum(g[1] for g in s["idle_gaps"]) == pytest.approx(730e-6)


def test_no_device_work_leaves_the_idle_share_out():
    s = tr.summarize(events([(0, 100)], []))
    assert s["busy_s"] == 0 and s["device_idle_pct"] is None
    reader = files.reader("device_idle_pct")
    assert reader.read(SimpleNamespace(trace=s)) is None
    assert reader.read(SimpleNamespace(trace=None)) is None


def test_roofline_counts_the_pairs_within_r_max():
    # 4 x 4 unit lattice: pairs at 1 (24), sqrt 2 (18), 2 (16), sqrt 5 (24), ...
    g = np.arange(4.0)
    pts = (g[:, None] + 1j * g[None, :]).ravel()
    rd = files.reader("pairstats.pair_roofline")
    d = np.abs(pts[:, None] - pts[None, :])[np.triu_indices(16, 1)]
    r_max, dr = 2.1, 0.1
    r = np.arange(0, r_max, dr)
    counts = np.array([np.sum((d >= a) & (d < a + dr)) for a in r], dtype=float)
    n, rho = 16, 16 / 9.0
    norm = 2 * np.pi * r * dr * n * rho
    gg = np.where(norm > 0, counts / np.where(norm > 0, norm, 1), 0.0)
    kk = 2 * np.concatenate([[0.0], np.cumsum(counts)[:-1]]) / (n * rho)
    assert rd.pairs_within(pts, gg, kk, r_max, dr) == np.sum(d < r[-1] + dr) == 24 + 18 + 16
    out = {"cloud": pts, "m": pts, "stats": {"g_construct": gg, "K_construct": kk,
                                             "g_mandel": gg, "K_mandel": kk}}
    jobs = [loop.JobRecord(i, i, 1.0, {"pairstats.stats": 9.0}, out, traced=i < 2)
            for i in range(3)]
    # two traced jobs; their stats spans hold 1.5 ms of kernels, a kernel
    # outside any stats span and the untraced job's host time do not count
    ev = events([(0, 5000), (5000, 10000)],
                [(1000, 1800, "scan"), (1500, 2000, "scan"), (4000, 4500, "other"),
                 (6000, 6500, "scan")],
                [(900, 2100, "pairstats.stats"), (5900, 6600, "pairstats.stats"),
                 (3900, 4600, "pairstats.cloud")])
    ctx = SimpleNamespace(jobs=jobs, trace=tr.summarize(ev),
                          config={"pairstats": {"r_max": r_max, "dr": dr}})
    assert ctx.trace["span_kernel_s"] == {"pairstats.stats": pytest.approx(1.5e-3),
                                          "pairstats.cloud": pytest.approx(0.5e-3)}
    assert rd.read(ctx) == pytest.approx(100 * 5 * 2 * 2 * 58 / 67e12 / 1.5e-3)
    assert rd.read(SimpleNamespace(jobs=jobs, trace=None, config=ctx.config)) is None
    ctx.trace = tr.summarize(events([(0, 5000)], [], [(900, 2100, "pairstats.stats")]))
    assert rd.read(ctx) is None  # no kernel in the spans: nothing to read


def test_covered_length_of_merged_intervals():
    merged = tr.union([(0, 2), (1, 3), (5, 6), (8, 10)])
    starts = [a for a, _ in merged]
    assert tr.covered(merged, starts, 2.5, 9) == pytest.approx(0.5 + 1 + 1)
    assert tr.covered(merged, starts, -5, 20) == pytest.approx(3 + 1 + 2)
    assert tr.covered(merged, starts, 3, 5) == 0


def test_job_seeds_fit_numpy_and_differ():
    big = 2**31 + 123
    seeds = {loop.job_seed(big, j) for j in range(-1, 500)}
    assert len(seeds) == 501 and all(0 <= s < 2**32 for s in seeds)
    np.random.RandomState(loop.job_seed(big, 7))
    assert loop.checked_jobs(5, 10, 3)[-1] == 9 and len(loop.checked_jobs(5, 10, 3)) == 3
    assert loop.checked_jobs(5, 10, 3) == loop.checked_jobs(5, 10, 3)
    assert loop.checked_jobs(5, 0, 3) == []
    assert math.isclose(loop.job_rate([0.5, 0.5]), 2.0)
