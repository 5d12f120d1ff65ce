#!/usr/bin/env python3
"""Smoke run of the cmtci_torch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each one checks what it computed; any failure exits non-zero and
prints no result line):
  1. the card (nvidia-smi name and power limit; torch.cuda.is_available());
  2. build every kernel of the tracker's path from csrc/ (nvcc + ctypes);
  3. K1 (csrc/tci_de.cu) against its plain-torch twin on the card at the
     four dense-tracker grids: identical escape and q25 band masks, d bitwise
     equal (or within rtol 1e-6, with the differing pixels counted), and the
     median time of each;
  4. the dense Appendix-A tracker (bench.py's config) on the kernel path,
     twice: 4 rows of the oracle's sizes, finite metrics, one kernel launch
     per stage, rows within the statistical bounds of the oracle
     tests/data/v3_T25_sigma3_dense.csv, and the same rows both times;
  5. the f64 plain-torch tracker path on the card for two stages, at the
     contracts of tests/test_tracker_regression.py (rel 2e-3 / 5%).
The last three lines are the card, a JSON line per kernel, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import csv
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(ROOT, "tests", "data", "v3_T25_sigma3_dense.csv")
DOMAIN = (-2.2, 1.2, -1.6, 1.6)
GRIDS = (600, 690, 793, 912)
MAX_ITER, ESCAPE_R = 250, 250.0
DENSE = dict(sigma_bins=3.0, t_fixed=25, bins_start=64, bins_max=512,
             construct_max_start=300, construct_max_growth=1.6,
             mandelbrot_samples_growth=1.6, mandelbrot_samples_max=300000)
CHECK_KEYS = ("kl_initial", "delta_n", "kl_PM_PC", "tv_XT_PM", "tv_PC_PM",
              "overlap_mass_PC_PM", "tv_bound_PC_PM", "compound")
METRIC_KEYS = ("kl_initial", "delta_n", "kl_PM_PC", "pinsker_tv_bound_XT_PM", "tv_XT_PM",
               "tv_PC_PM", "overlap_mass_PC_PM", "tv_bound_PC_PM", "compound",
               "compound_with_pinsker")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"nvidia-smi failed (rc {proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, reps: int) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_kernels(dev):
    """Phase 3: K1 against its twin on the card at the stage grids."""
    import torch

    from cmtci_torch.kernels import mandelbrot_cuda as mc

    max_err = 0.0
    timing = {}
    for g in GRIDS:
        out_k = mc._tci_field(DOMAIN, g, MAX_ITER, ESCAPE_R, dev)
        out_t = mc.tci_de_field_torch(DOMAIN, g, MAX_ITER, ESCAPE_R, device=dev)
        torch.cuda.synchronize()
        check(out_k.shape == out_t.shape == (g, g), f"grid {g}: shape {tuple(out_k.shape)}")
        check(bool(torch.isfinite(out_k).all()), f"grid {g}: non-finite kernel output")
        esc_k, esc_t = out_k >= 0, out_t >= 0
        check(bool(torch.equal(esc_k, esc_t)),
              f"grid {g}: escape masks differ at {int((esc_k != esc_t).sum())} pixels")
        n_diff = int((out_k != out_t).sum())
        if n_diff:
            close = torch.isclose(out_k, out_t, rtol=1e-6, atol=0.0)
            check(bool(close.all()), f"grid {g}: d differs beyond rtol 1e-6 at "
                                     f"{int((~close).sum())} pixels")
        err = float((out_k - out_t).abs().max())
        max_err = max(max_err, err)
        sel_k, cnt_k, q_k = mc.band_selection(esc_k, out_k.clamp(min=0.0))
        sel_t, cnt_t, q_t = mc.band_selection(esc_t, out_t.clamp(min=0.0))
        check(bool(torch.equal(sel_k, sel_t)), f"grid {g}: band masks differ")
        ms = cuda_ms(lambda: mc._tci_field(DOMAIN, g, MAX_ITER, ESCAPE_R, dev), 3, 20)
        plain_ms = cuda_ms(lambda: mc.tci_de_field_torch(DOMAIN, g, MAX_ITER, ESCAPE_R,
                                                         device=dev), 1, 5)
        timing[g] = (ms, plain_ms)
        print(f"K1 grid {g}: escaped {int(cnt_k)}/{g * g}, band {int(sel_k.sum())}, "
              f"q25 {float(q_k)!r}, d bitwise-differing pixels {n_diff}, "
              f"max|kernel-twin| {err!r}; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms "
              f"(median, CUDA events)")
    return max_err, timing


def run_dense(dev, label):
    """One dense kernel-path tracker run; returns (rows, meta, wall, launches)."""
    import torch

    from cmtci_torch.kernels import mandelbrot_cuda as mc
    from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker

    cfg = TrackerConfig(**DENSE, field_dtype="float32", de_impl="cuda")
    torch.cuda.synchronize()
    mc.launches = 0
    t0 = time.perf_counter()
    rows, meta = run_tracker(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mc.launches
    print(f"tracker ({label}): {len(rows)} rows in {wall:.3f} s wall, "
          f"{launches} K1 launches")
    return rows, meta, wall, launches


def phase_tracker(dev, oracle):
    """Phase 4: the dense tracker on the kernel path, checked twice."""
    import dataclasses

    results = [run_dense(dev, "first run"), run_dense(dev, "second run")]
    for rows, meta, wall, launches in results:
        check(len(rows) == 4, f"expected 4 rows, got {len(rows)}")
        check([r.n_construct_pts for r in rows] == [2400, 6000, 14820, 37820],
              f"n_construct_pts {[r.n_construct_pts for r in rows]}")
        check(launches == 4, f"expected 4 K1 launches, got {launches}")
        for r in rows:
            for k in METRIC_KEYS:
                check(math.isfinite(getattr(r, k)), f"bins {r.bins}: {k} not finite")
    strip = [[{**dataclasses.asdict(r), "runtime_sec": 0.0} for r in res[0]]
             for res in results]
    check(strip[0] == strip[1], "the two kernel-path runs gave different rows")
    rows, meta, wall, launches = results[1]
    for r, ref in zip(rows, oracle):
        ratios = {k: getattr(r, k) / float(ref[k])
                  for k in ("delta_n", "tv_PC_PM", "overlap_mass_PC_PM")}
        print(f"  bins {r.bins}: grid {r.mandelbrot_grid}, n_mandel {r.n_mandel_pts}, "
              f"delta_n {r.delta_n!r} (x{ratios['delta_n']:.4f} oracle), "
              f"tv_PC_PM {r.tv_PC_PM!r} (x{ratios['tv_PC_PM']:.4f}), "
              f"overlap {r.overlap_mass_PC_PM!r} (x{ratios['overlap_mass_PC_PM']:.4f})")
        check(abs(ratios["delta_n"] - 1.0) <= 0.50, f"bins {r.bins}: delta_n off the oracle")
        check(abs(ratios["tv_PC_PM"] - 1.0) <= 0.25, f"bins {r.bins}: tv_PC_PM off the oracle")
        check(abs(ratios["overlap_mass_PC_PM"] - 1.0) <= 0.25,
              f"bins {r.bins}: overlap off the oracle")
    times = meta["stage_times"]
    for b in (64, 128, 256, 512):
        parts = {p: times.get(f"bins{b}_{p}", 0.0)
                 for p in ("cloud", "sample", "match", "hist", "giflow")}
        print(f"  stage bins {b} (second run, s): "
              + ", ".join(f"{p} {t:.4f}" for p, t in parts.items()))
    return results


def phase_f64(dev, oracle):
    """Phase 5: the f64 plain-torch path on the card, two stages."""
    from cmtci_torch.kernels import mandelbrot_cuda as mc
    from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker

    before = mc.launches
    t0 = time.perf_counter()
    rows, _ = run_tracker(TrackerConfig(**DENSE), max_stages=2, device=dev)
    wall = time.perf_counter() - t0
    check(mc.launches == before, "the f64 torch path launched K1")
    check(len(rows) == 2 and rows[1].n_construct_pts == 6000, "f64 path: wrong rows")
    for k in CHECK_KEYS:
        got, want = getattr(rows[0], k), float(oracle[0][k])
        check(abs(got - want) <= 2e-3 * abs(want), f"f64 stage 1 {k}: {got!r} vs {want!r}")
    for k in ("delta_n", "tv_PC_PM", "overlap_mass_PC_PM"):
        got, want = getattr(rows[1], k), float(oracle[1][k])
        check(abs(got - want) <= 0.05 * abs(want), f"f64 stage 2 {k}: {got!r} vs {want!r}")
    worst = max(abs(getattr(r, k) / float(o[k]) - 1.0)
                for r, o in zip(rows, oracle) for k in CHECK_KEYS)
    print(f"f64 torch path: 2 stages in {wall:.3f} s, worst relative deviation from "
          f"the oracle {worst!r}")


def main() -> int:
    card = card_line()
    print(card)
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    with open(ORACLE) as f:
        oracle = list(csv.DictReader(f))

    from cmtci_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library("tci_de")
    print(f"build: tci_de in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS['tci_de']:.2f} s)")
    for line in _build.build_log("tci_de").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    max_err, timing = phase_kernels(dev)
    results = phase_tracker(dev, oracle)
    phase_f64(dev, oracle)

    launches = results[1][3]
    ms, plain_ms = timing[GRIDS[-1]]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "tci_de", "route": "cuda", "source": "cmtci_torch/csrc/tci_de.cu",
        "replaces": "cmtci/kernels/mandelbrot_pallas.py:276", "launches": launches,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # report the failed phase and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
