#!/usr/bin/env python3
"""Smoke run of the cmtci_torch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each one checks what it computed; any failure exits non-zero and
prints no result line):
  1. the card (nvidia-smi name and power limit; torch.cuda.is_available());
  2. build every kernel from csrc/ (one nvcc per source, all started
     together; ctypes), with each build's seconds and ptxas report;
  3. K1 (csrc/tci_de.cu) against its plain-torch twin on the card at the
     four dense-tracker grids: identical escape and q25 band masks, d bitwise
     equal (or within rtol 1e-6, with the differing pixels counted), and the
     median time of each;
  4. the dense Appendix-A tracker (bench.py's config) on the kernel path,
     twice: 4 rows of the oracle's sizes, finite metrics, one kernel launch
     per stage, rows within the statistical bounds of the oracle
     tests/data/v3_T25_sigma3_dense.csv, and the same rows both times; then
     the adaptive config (t_fixed -1, sigma_bins 1) once on the kernel path;
  5. the f64 plain-torch tracker path on the card for two stages, at the
     contracts of tests/test_tracker_regression.py (rel 2e-3 / 5%);
  6. K2 (csrc/dwell.cu) against its twin at 2000 x 2000 and 1001 x 1999,
     max_iter 500: bitwise equal; times, and the orbit steps the kernel
     iterates (interior pixels skip the loop);
  7. run_boundary at the default config (res 2000, max_iter 500) on both
     backends: one K2 launch on "cuda", none on "torch"; K2 equal to the f64
     dwell on >= 99% of pixels; both contours inside their bounds around the
     golden artifacts/mandel_boundary.csv.gz (symmetric Hausdorff);
  8. K3 (csrc/cloud_green.cu) against its twin on the full default cloud
     (n 2..200, four families, after the host interior short-circuit) in one
     launch of 20000 iterations: every output row bitwise equal;
  9. run_equipotential at the CLI defaults with float32 (K3, one launch) and
     float64 (no launch): f32 against f64 on the card, and f64 against the
     reference's numbers in tests/data/equipotential_default_f64.json.
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
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(ROOT, "tests", "data", "v3_T25_sigma3_dense.csv")
GOLDEN = os.path.join(ROOT, "artifacts", "mandel_boundary.csv.gz")
EQUIP_REF = os.path.join(ROOT, "tests", "data", "equipotential_default_f64.json")
KERNELS = ("tci_de", "dwell", "cloud_green")
DOMAIN = (-2.2, 1.2, -1.6, 1.6)
GRIDS = (600, 690, 793, 912)
MAX_ITER, ESCAPE_R = 250, 250.0
DENSE = dict(sigma_bins=3.0, t_fixed=25, bins_start=64, bins_max=512,
             construct_max_start=300, construct_max_growth=1.6,
             mandelbrot_samples_growth=1.6, mandelbrot_samples_max=300000)
ADAPTIVE = dict(sigma_bins=1.0, t_fixed=-1, bins_start=64, bins_max=512)
CHECK_KEYS = ("kl_initial", "delta_n", "kl_PM_PC", "tv_XT_PM", "tv_PC_PM",
              "overlap_mass_PC_PM", "tv_bound_PC_PM", "compound")
METRIC_KEYS = ("kl_initial", "delta_n", "kl_PM_PC", "pinsker_tv_bound_XT_PM", "tv_XT_PM",
               "tv_PC_PM", "overlap_mass_PC_PM", "tv_bound_PC_PM", "compound",
               "compound_with_pinsker")
BOUNDARY_DOMAIN = (-2.1, 0.9, -1.5, 1.5)
DWELL_SHAPES = ((2000, 2000), (1001, 1999))  # (ny, nx)
GOLDEN_VERTICES = 14391
SPACING = 3.0 / 1999
SUMMARY_KEYS = ("count", "escaped", "escaped_frac", "g_median", "g_mean", "g_std",
                "g_p10", "g_p90")


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


def reset_launches():
    from cmtci_torch.kernels import mandelbrot_cuda as mc

    for name in mc.launches:
        mc.launches[name] = 0


def hausdorff(a, b) -> float:
    from scipy.spatial.distance import directed_hausdorff

    return max(directed_hausdorff(a, b)[0], directed_hausdorff(b, a)[0])


def phase_build():
    """Phase 2: one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from cmtci_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        list(ex.map(_build.library, KERNELS))
    print(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s wall")
    for name in KERNELS:
        print(f"  {name}: nvcc {_build.BUILD_SECONDS[name]:.2f} s")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")


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


def run_kernel_tracker(dev, label, config):
    """One kernel-path tracker run; returns (rows, meta, wall, K1 launches)."""
    import torch

    from cmtci_torch.kernels import mandelbrot_cuda as mc
    from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker

    cfg = TrackerConfig(**config, field_dtype="float32", de_impl="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rows, meta = run_tracker(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mc.launches)
    check(launches["dwell"] == launches["cloud_green"] == 0,
          f"the tracker launched another kernel than K1: {launches}")
    print(f"tracker ({label}): {len(rows)} rows in {wall:.3f} s wall, "
          f"{launches['tci_de']} K1 launches")
    return rows, meta, wall, launches["tci_de"]


def phase_tracker(dev, oracle):
    """Phase 4: the dense tracker on the kernel path, checked twice; then the
    adaptive config once."""
    import dataclasses

    results = [run_kernel_tracker(dev, "dense, first run", DENSE),
               run_kernel_tracker(dev, "dense, second run", DENSE)]
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

    # the adaptive config (v3_adaptive's): T_n is not pinned, because the
    # kernel path's sampler is a new realization (ROADMAP Queue 3)
    a_rows, _, a_wall, a_launches = run_kernel_tracker(dev, "adaptive", ADAPTIVE)
    check(len(a_rows) == 4, f"adaptive: expected 4 rows, got {len(a_rows)}")
    check(a_launches == 4, f"adaptive: expected 4 K1 launches, got {a_launches}")
    for r in a_rows:
        check(r.stop_reason == "kl_threshold_met",
              f"adaptive bins {r.bins}: stop_reason {r.stop_reason!r}")
        for k in METRIC_KEYS:
            check(math.isfinite(getattr(r, k)), f"adaptive bins {r.bins}: {k} not finite")
    print(f"  adaptive T_n {[r.T_n for r in a_rows]} (oracle f64: 87/103/106/109), "
          f"delta_n {[r.delta_n for r in a_rows]}")
    return results


def phase_f64(dev, oracle):
    """Phase 5: the f64 plain-torch path on the card, two stages."""
    from cmtci_torch.kernels import mandelbrot_cuda as mc
    from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker

    reset_launches()
    t0 = time.perf_counter()
    rows, _ = run_tracker(TrackerConfig(**DENSE), max_stages=2, device=dev)
    wall = time.perf_counter() - t0
    check(sum(mc.launches.values()) == 0, f"the f64 torch path launched {mc.launches}")
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


def phase_dwell(dev):
    """Phase 6: K2 against its twin on the card."""
    import torch

    from cmtci_torch.kernels import mandelbrot_cuda as mc

    timing = {}
    max_err = 0.0
    max_iter = 500
    for ny, nx in DWELL_SHAPES:
        out_k = mc.mandelbrot_field(BOUNDARY_DOMAIN, nx, ny, max_iter=max_iter, device=dev)
        out_t = mc.dwell_field_torch(BOUNDARY_DOMAIN, nx, ny, max_iter, device=dev)
        torch.cuda.synchronize()
        check(out_k.shape == out_t.shape == (ny, nx), f"{ny}x{nx}: shape {tuple(out_k.shape)}")
        n_diff = int((out_k != out_t).sum())
        max_err = max(max_err, float((out_k - out_t).abs().max()))
        # loop trips: an escaping pixel runs dwell + 1 steps, a bounded one
        # max_iter, an analytically interior one none
        interior = mc._interior_mask_torch(*mc._grid_coords(BOUNDARY_DOMAIN, nx, ny, dev))
        steps = int(torch.where(interior, 0.0, (out_k + 1.0).clamp(max=max_iter))
                    .sum(dtype=torch.float64))
        print(f"K2 {ny}x{nx}: kernel vs twin differing pixels {n_diff}, mean dwell "
              f"{float(out_k.mean())!r}, interior pixels {int(interior.sum())}, iterated "
              f"orbit steps {steps}")
        check(n_diff == 0, f"K2 {ny}x{nx}: {n_diff} pixels differ from the twin")
        ms = cuda_ms(lambda: mc.mandelbrot_field(BOUNDARY_DOMAIN, nx, ny, max_iter=max_iter,
                                                 device=dev), 3, 20)
        plain_ms = cuda_ms(lambda: mc.dwell_field_torch(BOUNDARY_DOMAIN, nx, ny, max_iter,
                                                        device=dev), 1, 3)
        timing[(ny, nx)] = (ms, plain_ms)
        print(f"  kernel {ms:.4f} ms ({steps / ms / 1e9:.4f} G orbit steps per ms), "
              f"twin {plain_ms:.4f} ms (median, CUDA events)")
    return max_err, timing


def phase_boundary(dev):
    """Phase 7: run_boundary at the default config on both backends."""
    import numpy as np

    from cmtci_torch.kernels import mandelbrot_cuda as mc
    from cmtci_torch.pipelines.boundary import BoundaryConfig, run_boundary
    from cmtci_torch.utils.artifacts import StageTimer

    golden = np.loadtxt(GOLDEN, delimiter=",", skiprows=1)
    check(golden.shape == (GOLDEN_VERTICES, 2), f"golden shape {golden.shape}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("cuda", "torch"):
            timer = StageTimer(dev)
            reset_launches()
            t0 = time.perf_counter()
            path, z = run_boundary(BoundaryConfig(backend=backend),
                                   os.path.join(tmp, backend), plots=False, device=dev,
                                   timer=timer)
            wall = time.perf_counter() - t0
            launches = dict(mc.launches)
            want = 1 if backend == "cuda" else 0
            check(launches == {"tci_de": 0, "dwell": want, "cloud_green": 0},
                  f"boundary {backend}: launches {launches}")
            with open(os.path.join(tmp, f"{backend}_boundary.csv")) as f:
                check(f.readline().strip() == "x,y", f"boundary {backend}: CSV header")
            h = hausdorff(path, golden)
            out[backend] = (path, z, launches["dwell"])
            print(f"boundary ({backend}): {len(path)} vertices (golden {GOLDEN_VERTICES}), "
                  f"Hausdorff to the golden {h!r} ({h / SPACING:.3f} spacings), "
                  f"{launches['dwell']} K2 launches, {wall:.3f} s wall; stages (s): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in timer.times.items()))
            if backend == "torch":
                check(abs(len(path) - GOLDEN_VERTICES) <= 0.005 * GOLDEN_VERTICES,
                      f"f64 path: {len(path)} vertices")
                check(h <= 1.5e-3, f"f64 path: Hausdorff {h!r} > 1.5e-3")
            else:
                check(abs(len(path) - GOLDEN_VERTICES) <= 0.02 * GOLDEN_VERTICES,
                      f"K2 path: {len(path)} vertices")
                check(h <= 7.5e-3, f"K2 path: Hausdorff {h!r} > 7.5e-3")
    z32, z64 = out["cuda"][1], out["torch"][1]
    equal = float((z32 == z64).mean())
    print(f"  K2 dwell equal to the f64 dwell on {equal!r} of pixels")
    check(equal >= 0.99, f"K2 vs f64 dwell: {equal!r} < 0.99")
    return out["cuda"][2]


def default_cloud(dev):
    """The equipotential CLI default cloud: four families, n 2..200."""
    import numpy as np

    from cmtci_torch.kernels import companion
    from cmtci_torch.pipelines.equipotential import EquipotentialConfig

    cfg = EquipotentialConfig()
    ns = list(range(cfg.n_min, cfg.n_max + 1))
    return np.concatenate([companion.inverse_cloud(ns, f, tol=cfg.eig_tol, device=dev)
                           for f in cfg.families])


def phase_cloud_green(dev):
    """Phase 8: K3 against its twin on the full default cloud."""
    import numpy as np
    import torch

    from cmtci_torch.kernels import mandelbrot_cuda as mc

    pts = default_cloud(dev)
    check(pts.size == 80395, f"default cloud has {pts.size} points, expected 80395")
    keep = ~mc.exact_interior(pts)
    cr = pts.real[keep].astype(np.float32)
    ci = pts.imag[keep].astype(np.float32)
    z0 = np.zeros_like(cr)
    iters = 20000
    out_k = mc.cloud_green(cr, ci, z0, z0, iters, 2.0, device=dev)
    t0 = time.perf_counter()
    out_t = mc.cloud_green_torch(cr, ci, z0, z0, iters, 2.0, device=dev)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    rows = ("k", "zer", "zei", "zr", "zi", "act")
    diff = {r: int((out_k[i] != out_t[i]).sum()) for i, r in enumerate(rows)}
    n_esc = int((out_k[0] > 0).sum())
    print(f"K3 default cloud: {pts.size} points, {int(keep.sum())} after the interior "
          f"short-circuit, {n_esc} escape in {iters} iterations; differing entries per "
          f"row {diff}")
    check(all(v == 0 for v in diff.values()), f"K3 differs from its twin: {diff}")
    max_err = float((out_k - out_t).abs().max())
    ms = cuda_ms(lambda: mc.cloud_green(cr, ci, z0, z0, iters, 2.0, device=dev), 2, 10)
    plain_ms = cuda_ms(lambda: mc.cloud_green_torch(cr, ci, z0, z0, iters, 2.0,
                                                    device=dev), 0, 1)
    print(f"  kernel {ms:.4f} ms (median, CUDA events), twin {plain_ms:.4f} ms (one rep, "
          f"CUDA events; first twin call {twin_s:.3f} s wall)")
    return max_err, ms, plain_ms


def run_equip(dev, dtype, tmp):
    """One run_equipotential at the CLI defaults; returns (out, g of every
    point in family order, lucas k, K3 launches). The per-point g comes from
    the run's own potential cache, so nothing is solved twice."""
    import glob

    import numpy as np
    import torch

    from cmtci_torch.kernels import mandelbrot_cuda as mc
    from cmtci_torch.pipelines.equipotential import EquipotentialConfig, run_equipotential

    out_dir = os.path.join(tmp, dtype)
    cache = os.path.join(tmp, f"{dtype}_cache")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run_equipotential(EquipotentialConfig(potential_dtype=dtype), out_dir,
                            cache_dir=cache, plots=False, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(mc.launches)
    want = 1 if dtype == "float32" else 0
    check(launches == {"tci_de": 0, "dwell": 0, "cloud_green": want},
          f"equipotential {dtype}: launches {launches}")
    s = out["summary"]
    print(f"equipotential ({dtype}): {wall:.3f} s wall, {launches['cloud_green']} K3 "
          f"launches; lucas count {s['count']}, escaped {s['escaped']}, g_median "
          f"{s['g_median']!r}, g_mean {s['g_mean']!r}, g_p90 {s['g_p90']!r}; stages (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out["stage_times"].items()))
    (npz,) = glob.glob(os.path.join(cache, "green_potential_*.npz"))
    with np.load(npz) as z:
        g_all = z["g"]
    g_lucas = np.load(os.path.join(out_dir, "g_lucas.npy"))
    check(np.array_equal(g_all[: g_lucas.size], g_lucas), f"{dtype}: cache and g_lucas differ")
    k_lucas = np.load(os.path.join(out_dir, "it_lucas.npy"))
    return out, g_all, k_lucas, launches["cloud_green"]


def phase_equipotential(dev):
    """Phase 9: run_equipotential at the CLI defaults, f32 (K3) and f64."""
    import numpy as np

    from cmtci_torch.stats.laws import summarize_outside

    with open(EQUIP_REF) as f:
        ref = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        o32, g32, k32, launches = run_equip(dev, "float32", tmp)
        o64, g64, k64, _ = run_equip(dev, "float64", tmp)
    s32, s64 = o32["summary"], o64["summary"]
    n, max_iter = s64["count"], 20000
    check(s32["count"] == n == ref["summary"]["count"], "lucas counts differ")
    check(abs(s32["escaped"] - s64["escaped"]) <= 0.001 * n,
          f"escaped f32 {s32['escaped']} vs f64 {s64['escaped']}")
    both = (k32 < max_iter) & (k64 < max_iter)
    k_equal = float((k32[both] == k64[both]).mean())
    print(f"  f32 vs f64: escaped {s32['escaped']} vs {s64['escaped']}, k equal on "
          f"{k_equal!r} of the points that escape in both")
    check(k_equal >= 0.99, f"k equal on {k_equal!r} < 0.99")
    # the g statistics over the points whose k agrees: a point whose k lands
    # on either side of 1074 has g = 2^-k log|z_k| > 0 in one run and an
    # underflowed g = 0 in the other, so summarize_g counts it escaped in one
    # run only, and that shifts the whole-cloud median and mean by ~2e-5
    # (ROADMAP Queue 3)
    same = both & (k32 == k64)
    c32 = summarize_outside(g32[:n][same], int(same.sum()))
    c64 = summarize_outside(g64[:n][same], int(same.sum()))
    for key in ("g_median", "g_mean", "g_p90"):
        d = abs(c32[key] - c64[key])
        print(f"  f32 vs f64 {key}: {d!r} on the {int(same.sum())} points whose k "
              f"agrees; {abs(s32[key] - s64[key])!r} on the whole cloud's summary")
        check(d < 1e-5, f"f32 vs f64 {key}: |{c32[key]!r} - {c64[key]!r}| = {d!r}")

    # f64 against the reference's f64 numbers: escaped counts within +-5, and
    # the g statistics over g >= 2^-500 (the points that escape within about
    # 500 steps) within 1e-5. Deeper escapers differ one by one: the
    # reference's XLA contracts FMAs, which moves their chaotic k, and flushes
    # a subnormal g (k > 1022) to 0 where the port keeps it; a handful of
    # them shift the whole-cloud g_mean and g_p10 by up to ~1.4e-5 (ROADMAP
    # Queue 3). The whole-cloud deviations are printed
    check(abs(s64["escaped"] - ref["summary"]["escaped"]) <= 5,
          f"lucas escaped {s64['escaped']} vs {ref['summary']['escaped']}")
    floor = 2.0 ** -500
    worst = 0.0
    off = 0
    for got, want in zip(o64["family_summary"], ref["family_summary"]):
        label, count = want["family"], want["count"]
        check(got["family"] == label and got["count"] == count, f"{label}: count {got}")
        g = g64[off : off + count]
        off += count
        check(abs(got["escaped"] - want["escaped"]) <= 5,
              f"{label}: escaped {got['escaped']} vs {want['escaped']}")
        shallow = summarize_outside(g[g >= floor], count)
        for key in SUMMARY_KEYS[3:]:
            d = abs(shallow[key] - want["shallow_g"][key])
            worst = max(worst, d)
            check(d <= 1e-5, f"{label} {key} (g >= 2^-500): {shallow[key]!r} vs "
                             f"{want['shallow_g'][key]!r}")
        print(f"  f64 {label}: escaped {got['escaped']} (reference {want['escaped']}), "
              f"escaped with g >= 2^-500 {shallow['escaped']} (reference "
              f"{want['shallow_g']['escaped']}); whole-cloud deviations "
              + ", ".join(f"{k} {got[k] - want[k]:+.3e}" for k in SUMMARY_KEYS[3:]))
    check(off == g64.size, f"the families cover {off} of {g64.size} points")
    print(f"  f64 vs the reference's f64 numbers: worst deviation of a g >= 2^-500 "
          f"statistic {worst!r}")
    return launches


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

    phase_build()
    k1_err, k1_timing = phase_kernels(dev)
    results = phase_tracker(dev, oracle)
    phase_f64(dev, oracle)
    k2_err, k2_timing = phase_dwell(dev)
    k2_launches = phase_boundary(dev)
    k3_err, k3_ms, k3_plain_ms = phase_cloud_green(dev)
    k3_launches = phase_equipotential(dev)

    k1_ms, k1_plain = k1_timing[GRIDS[-1]]
    k2_ms, k2_plain = k2_timing[DWELL_SHAPES[0]]
    kernels = [
        ("tci_de", "cmtci/kernels/mandelbrot_pallas.py:276", results[1][3], k1_err,
         k1_ms, k1_plain),
        ("dwell", "cmtci/kernels/mandelbrot_pallas.py:59", k2_launches, k2_err, k2_ms,
         k2_plain),
        ("cloud_green", "cmtci/kernels/mandelbrot_pallas.py:613", k3_launches, k3_err,
         k3_ms, k3_plain_ms),
    ]
    print(card)
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": f"cmtci_torch/csrc/{n}.cu", "replaces": r,
         "launches": la, "max_abs_err": e, "ms": ms, "plain_ms": pm}
        for n, r, la, e, ms, pm in kernels]}))
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
