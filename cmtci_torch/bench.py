"""cmtci_torch benchmark: the port's counterpart of the reference's ``bench.py``,
one JSON line under the same key names.

Run it as ``python -m cmtci_torch.bench`` (or ``cmtci-torch bench``). It runs
on the card; without one it raises unless ``--device cpu`` is given, and a
CPU run is for checking the control flow only (``--small`` cuts every size so
that it takes seconds): a time taken on the CPU is no device metric.

Keys, each at the reference's configuration (``BenchSizes`` holds them):
  * metric/value/unit: escape-time grid throughput, K2 at res 2000,
    max_iter 500 on (-2.1, 0.9) x (-1.5, 1.5), in Mpix/s. K2 takes the 2000
    columns as they are (the reference pads to 2048 and crops).
    dwell_entry_ms (the card only): ms per call of the same grid through
    K2's ctypes entry (_launch.launch), timed the same way; `value` includes
    the host's time in mandelbrot_field, which is close to the kernel's own.
  * dwell_tflops, vpu_peak_tflops, dwell_mfu, dwell_mfu_useful, de_tflops,
    de_mfu: the roofline accounting of K2 and K4 at 2048 x 2048 on the
    padded domain, against K7's measured chained-FMA rate. `useful` steps
    are the pixels' own; `executed` steps are what the SIMD unit burns, by
    the schedule each kernel runs: a warp holds a patch of pixels and
    iterates until its longest pixel stops, rounded up to the steps between
    two exit tests (mandelbrot_cuda.DWELL_FOOTPRINT for K2 and DE_FOOTPRINT
    for K4, the constants dwell.cu and de_std.cu are built with). The keys
    follow the schedule: one that executes fewer steps in less time can
    lower de_tflops. Operations per step are counted from the .cu bodies
    (mandelbrot_cuda.OPS_PER_STEP: each mul, add and compare once), while
    K7's rate counts an FMA as two. K4's executed steps are counted from its
    own orbits, which run to radius 4, a step or two past the dwell's radius
    2 (the reference models them by the dwell grid's).
    fp32_fma_bound_tflops is the card's own ceiling, SMs x 128 lanes x 2 x
    the maximum SM clock.
  * escape_grid_res4096_mpix_s, escape_grid_res8192_mpix_s: K2 at 4x and
    16x the pixels.
  * spatial_stats_150k_s: two 150,000-point f32 shell-count scans plus the
    f32 Hausdorff; knn_150k_s: the f32 kNN kernel build (k = 20).
  * eigensweep_s, tracker_warm_s, equipotential_s, variograms_s, tci_4x_s:
    wall times of the pipelines on their kernel paths, best of three, each
    with the reference's closing assertion.
  * uniformize_green_s: the v40 Riemann-map pipeline at its defaults (n_bdy
    2000, 20,000 interior points) on the export_lucas_boundary defaults
    (made before the timed window), f32 on the card (the f32 QR fit, f32
    map evaluations), f64 on the CPU; best of five, with the reference's
    assertion 0.99 < bdy_mod_median < 1.01.
  * uniformize_fem_s: the v18 FEM study, all four refinement levels, with
    the device solver on the card (SuperLU on the CPU); best of two, with
    the reference's assertion (every level, K_median falling).
  * coupling_s: the iterative variogram <-> Laplacian coupling on the f32
    field path over the default stage-1 bus (built before the timed
    window), best of three warm walls, with the reference's closing
    assertion (n_iter rows, a finite corr_pot).
Times of kernels are taken between two CUDA events around a run of launches
after a warm-up; pipeline times are host-clock walls that end in a device
synchronize.

`not_ported` names the reference's keys whose pipelines the port does not
have yet (none). `omitted` names the reference's ratio keys: each divides by a
constant measured on another machine, so the port prints none of them. A key
that throws is recorded as `<key>_error` and the process exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from cmtci_torch.kernels import companion, fma_peak
from cmtci_torch.kernels import mandelbrot_cuda as mc
from cmtci_torch.pipelines.analysis import TCIConfig, run_tci
from cmtci_torch.pipelines.coupling import CouplingConfig, run_coupling
from cmtci_torch.pipelines.equipotential import EquipotentialConfig, run_equipotential
from cmtci_torch.pipelines.lucas_boundary import LucasBoundaryConfig, export_lucas_boundary
from cmtci_torch.pipelines.stage1 import Stage1Config, run_stage1
from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker
from cmtci_torch.pipelines.uniformize_fem import (REFINEMENT_LEVELS, FEMUniformizeConfig,
                                                  run_fem_uniformization)
from cmtci_torch.pipelines.uniformize_green import (GreenUniformizeConfig,
                                                    run_green_uniformization)
from cmtci_torch.pipelines.variograms import VariogramConfig, run_variograms
from cmtci_torch.stats import pointstats as ps
from cmtci_torch.stats.embeddings import build_sparse_kernel
from cmtci_torch.utils.device import resolve_device

DOM = (-2.1, 0.9, -1.5, 1.5)
#: K4's escape radius in the de_tflops / de_mfu keys
DE_ESCAPE_R = 4.0

#: the reference's keys whose pipelines are not ported yet
NOT_PORTED = []
#: the reference's ratio keys; each divides by a REFERENCE_* constant of
#: another machine
OMITTED = {
    "keys": ["vs_baseline", "eigensweep_vs_lapack", "tracker_vs_reference",
             "equipotential_vs_reference", "variograms_vs_f64_cpu",
             "uniformize_green_vs_f64_cpu", "uniformize_fem_vs_r3_cpu", "tci_4x_vs_f64_cpu",
             "coupling_vs_f64_cpu"],
    "reason": "each is a ratio to a constant measured on another machine",
}


def _dense_tracker() -> TrackerConfig:
    return TrackerConfig(sigma_bins=3.0, t_fixed=25, bins_start=64, bins_max=512,
                         construct_max_start=300, construct_max_growth=1.6,
                         mandelbrot_samples_growth=1.6, mandelbrot_samples_max=300000,
                         field_dtype="float32", de_impl="cuda")


@dataclass
class BenchSizes:
    """Sizes and configurations of every key; the defaults are the
    reference's."""
    res: int = 2000
    max_iter: int = 500
    reps: int = 50
    mfu_res: int = 2048
    fma_elems: int = fma_peak.N_ELEMS
    fma_steps: int = fma_peak.K_STEPS
    scale_grids: tuple = ((4096, 12), (8192, 3))  # (res, launches timed)
    cloud_points: int = 150_000
    knn_k: int = 20
    stage4_ns: tuple = tuple(range(20, 1221, 20))
    tracker: TrackerConfig = field(default_factory=_dense_tracker)
    equipotential: EquipotentialConfig = field(
        default_factory=lambda: EquipotentialConfig(potential_dtype="float32"))
    variograms: VariogramConfig = field(
        default_factory=lambda: VariogramConfig(vario_dtype="float32",
                                                field_dtype="float32"))
    tci: TCIConfig = field(
        default_factory=lambda: TCIConfig(mandelbrot_grid=2400, de_impl="cuda"))
    green_input: LucasBoundaryConfig = field(default_factory=LucasBoundaryConfig)
    #: map_dtype None: float32 on the card, float64 on the CPU
    green: GreenUniformizeConfig = field(
        default_factory=lambda: GreenUniformizeConfig(map_dtype=None))
    fem: FEMUniformizeConfig = field(default_factory=FEMUniformizeConfig)
    fem_levels: tuple = REFINEMENT_LEVELS
    coupling_bus: Stage1Config = field(default_factory=Stage1Config)
    coupling: CouplingConfig = field(
        default_factory=lambda: CouplingConfig(field_dtype="float32"))


def small_sizes() -> BenchSizes:
    """Every key at a size a CPU runs in seconds."""
    return BenchSizes(
        res=96, max_iter=60, reps=2, mfu_res=64, fma_elems=4096, fma_steps=64,
        scale_grids=((128, 2), (160, 1)), cloud_points=600, knn_k=8,
        stage4_ns=(20, 40),
        tracker=TrackerConfig(sigma_bins=3.0, t_fixed=3, bins_start=16, bins_max=32,
                              construct_max_start=60, mandelbrot_grid_start=96,
                              mandelbrot_samples_start=600, field_dtype="float32",
                              de_impl="cuda"),
        equipotential=EquipotentialConfig(n_max=12, max_iter=300,
                                          potential_dtype="float32"),
        variograms=VariogramConfig(vario_dtype="float32", field_dtype="float32",
                                   n_list=(10, 20), boundary_grid=48, boundary_max_iter=60,
                                   grid_nx=24, grid_ny=24, potential_max_iter=60,
                                   m_target=200),
        tci=TCIConfig(construct_ns=(20, 40), mandelbrot_grid=96, mandelbrot_samples=800,
                      grid_bins=32, de_impl="cuda"),
        green_input=LucasBoundaryConfig(n_max=40, n_boundary=300),
        green=GreenUniformizeConfig(n_bdy=200, interior_n=500, map_dtype=None),
        fem=FEMUniformizeConfig(n_max=40),
        fem_levels=REFINEMENT_LEVELS[:2],
        coupling_bus=Stage1Config(max_n=12, boundary_samples=80),
        coupling=CouplingConfig(grid_res=48, max_iter_mb=60, win_local_corr=6,
                                field_dtype="float32"))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _per_launch_s(fn, reps: int, rounds: int, dev: torch.device) -> float:
    """Seconds per call of fn(): after one warm-up call, the best of `rounds`
    timings of `reps` back-to-back calls, between two CUDA events on the card
    (the host clock on the CPU)."""
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(rounds):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) * 1e-3)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, time.perf_counter() - t0)
    return best / reps


def _best_wall_s(fn, rounds: int, dev: torch.device):
    """(best wall seconds of `rounds` calls of fn(), the last result); each
    timing ends in a device synchronize."""
    best = float("inf")
    out = None
    for _ in range(rounds):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def padded_domain(sizes: BenchSizes):
    """The headline domain continued to mfu_res x mfu_res nodes at the
    res-grid's spacing (the reference's padded roofline grid)."""
    dx = (DOM[1] - DOM[0]) / (sizes.res - 1)
    n = sizes.mfu_res
    return (DOM[0], DOM[0] + dx * (n - 1), DOM[2], DOM[2] + dx * (n - 1))


#: a warp of the kernels launched in (32, 8) blocks (K5, K6 and K2's
#: periodic entry in their earlier designs): 32 consecutive columns of one
#: row, an exit test a step
ROW_WARP = {"c": 1, "patch_w": 32, "patch_h": 1}


def warp_executed_steps(lane: torch.Tensor, footprint: dict = ROW_WARP,
                        max_steps: int | None = None) -> float:
    """Steps the SIMD unit burns for a (ny, nx) grid of per-pixel step counts
    under a kernel's schedule (the keys of mandelbrot_cuda.DWELL_FOOTPRINT): a
    warp holds a patch of patch_w columns x patch_h rows of pixels, one a
    thread, and runs until its longest pixel has stopped, rounded up to the
    `c` steps between two exit tests; every one of its 32 lanes counts for
    that long, idle or not (a warp on the grid's edge may be ragged).
    max_steps caps a warp's steps, for a kernel whose chunks never pass
    max_iter (K1 runs its last max_iter mod c steps one by one)."""
    c, w, h = footprint["c"], footprint["patch_w"], footprint["patch_h"]
    ny, nx = lane.shape
    lane = torch.nn.functional.pad(lane, (0, (-nx) % w, 0, (-ny) % h))
    longest = lane.view(lane.shape[0] // h, h, lane.shape[1] // w, w).amax(dim=(1, 3))
    trips = torch.ceil(longest.double() / c) * c
    if max_steps is not None:
        trips = trips.clamp(max=max_steps)
    return float(w * h * trips.sum())


def dwell_step_counts(dwell: torch.Tensor, interior: torch.Tensor, max_iter: int,
                      footprint: dict = mc.DWELL_FOOTPRINT):
    """(useful, executed) orbit steps of one K2 launch, from its (ny, nx)
    output and the analytic-interior mask of the same grid. A pixel needs
    dwell + 1 steps when it escapes, max_iter when it does not, and none when
    it is analytically interior; useful is their sum, executed what the warps
    of `footprint` burn for them (warp_executed_steps; the default is the
    schedule dwell.cu's plain kernel is built with)."""
    lane = torch.where(interior, 0.0, (dwell + 1.0).clamp(max=float(max_iter))).double()
    return float(lane.sum()), warp_executed_steps(lane, footprint)


def escape_lane_steps(cr: torch.Tensor, ci: torch.Tensor, max_iter: int,
                      r2: float) -> torch.Tensor:
    """Per-lane loop trips (int32, the shape of cr) of an escape kernel of
    squared radius r2 on f32 coordinates, in the kernels' op order: none for
    an analytically interior lane, else every step up to and including the
    first with |z|^2 > r2, max_iter for a lane that stays inside."""
    active = ~mc._interior_mask_torch(cr, ci)
    zr, zi = torch.zeros_like(cr), torch.zeros_like(cr)
    lane = torch.zeros(cr.shape, dtype=torch.int32, device=cr.device)
    for _ in range(max_iter):
        lane += active
        zr, zi = (torch.where(active, zr * zr - zi * zi + cr, zr),
                  torch.where(active, 2.0 * zr * zi + ci, zi))
        active = active & (zr * zr + zi * zi <= r2)
    return lane


def periodic_lane_steps(cr: torch.Tensor, ci: torch.Tensor, max_iter: int, c: int):
    """(lane, caught): per-lane loop trips (int32, the shape of cr) of K2's
    periodic entry on f32 coordinates with chunks of c steps (the `c` of
    mandelbrot_cuda.DWELL_PERIODIC_FOOTPRINT), and the step of the
    checkpoint each lane's cycle was caught against (int32; 0 where none
    was). A lane runs every step up to and including the one on which it
    escapes or its cycle is caught, at most max_iter; none for an
    analytically interior lane. The checkpoint starts at (1e30, 0); at each
    chunk end (a multiple of c) z is compared with it, and it moves to z at
    the first chunk end at or past each power of two. c = 1 is the twin's
    step-by-step Brent schedule (and the entry's earlier design). The lanes
    that have stopped are dropped every 32 steps."""
    keep = ~mc._interior_mask_torch(cr, ci)
    lane = torch.zeros(cr.numel(), dtype=torch.int32, device=cr.device)
    caught = torch.zeros_like(lane)
    idx = keep.reshape(-1).nonzero()[:, 0]
    cr, ci = cr.reshape(-1)[idx], ci.reshape(-1)[idx]
    zr, zi = torch.zeros_like(cr), torch.zeros_like(cr)
    pr, pi = torch.full_like(cr, 1e30), torch.zeros_like(cr)
    alive = torch.ones_like(cr, dtype=torch.bool)
    stop_at = torch.zeros_like(idx, dtype=torch.int32)  # the step a lane stopped on
    against = torch.zeros_like(stop_at)  # the step of the checkpoint it was caught against
    nxt, moved = 1, 0  # the next move is at the first chunk end >= nxt
    for n in range(1, max_iter + 1):  # n steps taken after this one
        zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        stop = alive & ~(zr * zr + zi * zi <= 4.0)  # NaN counts as an escape
        alive = alive & ~stop
        if n % c == 0:
            hit = alive & (zr == pr) & (zi == pi)
            alive = alive & ~hit
            against.masked_fill_(hit, moved)
            stop = stop | hit
        stop_at.masked_fill_(stop, n)
        if n % c == 0 and n >= nxt:
            pr, pi, moved = zr, zi, n
            nxt = 1 << n.bit_length()  # the least power of two above n
        if n % 32 == 0:
            lane[idx], caught[idx] = stop_at, against
            idx, cr, ci, zr, zi, pr, pi, stop_at, against = (
                t[alive] for t in (idx, cr, ci, zr, zi, pr, pi, stop_at, against))
            alive = torch.ones_like(cr, dtype=torch.bool)
            if idx.numel() == 0:
                break
    lane[idx] = torch.where(alive, max_iter, stop_at).to(torch.int32)
    caught[idx] = against
    return lane.view(keep.shape), caught.view(keep.shape)


def tci_lane_steps(cr: torch.Tensor, ci: torch.Tensor, max_iter: int, r2: float):
    """(first, second): per-lane loop trips (int32, the shape of cr) of K1's
    two passes on f32 coordinates, in the kernel's op order and with a test
    after every step. first is the z-only pass: none for an analytically
    interior lane, else every step up to and including the first after which
    the lane has escaped and its z is non-finite, max_iter for a lane that
    gets there never. second is the (z, dz) pass of the late escapers, the
    escaped lanes whose z is still finite after max_iter - 1 steps: every
    step until the lane has escaped and its dz is non-finite, else max_iter;
    0 for all other lanes."""
    outside = ~mc._interior_mask_torch(cr, ci)
    active = outside.clone()
    zr, zi = torch.zeros_like(cr), torch.zeros_like(cr)
    hit = torch.zeros_like(active)
    first = torch.zeros(cr.shape, dtype=torch.int32, device=cr.device)
    for _ in range(max_iter):
        first += active
        zr, zi = (torch.where(active, zr * zr - zi * zi + cr, zr),
                  torch.where(active, 2.0 * zr * zi + ci, zi))
        hit = hit | (active & (zr * zr + zi * zi > r2))
        active = active & ~(hit & ~(torch.isfinite(zr) & torch.isfinite(zi)))
    late = hit & (first >= max_iter)
    # the step-by-step (z, dz) loop, on the late escapers only
    idx = late.reshape(-1).nonzero()[:, 0]
    cr_l, ci_l = cr.reshape(-1)[idx], ci.reshape(-1)[idx]
    zr, zi = torch.zeros_like(cr_l), torch.zeros_like(cr_l)
    dzr, dzi = torch.ones_like(cr_l), torch.zeros_like(cr_l)
    active = torch.ones_like(cr_l, dtype=torch.bool)
    esc = torch.zeros_like(active)
    trips = torch.zeros(idx.shape, dtype=torch.int32, device=cr.device)
    for _ in range(max_iter if idx.numel() else 0):
        trips += active
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = (torch.where(active, tr * dzr - ti * dzi + 1.0, dzr),
                    torch.where(active, tr * dzi + ti * dzr, dzi))
        zr, zi = (torch.where(active, zr * zr - zi * zi + cr_l, zr),
                  torch.where(active, tr * zi + ci_l, zi))
        esc = esc | (active & (zr * zr + zi * zi > r2))
        active = active & ~(esc & ~(torch.isfinite(dzr) & torch.isfinite(dzi)))
    second = torch.zeros_like(first)
    second.view(-1)[idx] = trips
    return first, second


def interior_f64_torch(cr: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """csrc/orbit.cu's interior_f64 on f64 tensors: the points orbit_dwell and
    orbit_de_tci (for R >= 2) send away without a step, the reference's
    cardioid and period-2 bulb tests with their 1e-5 margins, in f64, for
    |cr|, |ci| <= 2."""
    xm = cr - 0.25
    q = xm * xm + ci * ci
    in_cardioid = q * (q + xm) <= 0.25 * ci * ci - 1e-5
    xp = cr + 1.0
    in_bulb = xp * xp + ci * ci <= 0.0625 - 1e-5
    return (cr.abs() <= 2.0) & (ci.abs() <= 2.0) & (in_cardioid | in_bulb)


def orbit_dwell_lane_steps(cr: torch.Tensor, ci: torch.Tensor, dwell: torch.Tensor,
                           max_iter: int) -> torch.Tensor:
    """Per-lane steps orbit_dwell's points need, from its dwell output: none
    for an f64 point of the analytic interior, dwell + 1 for an escaper,
    max_iter for the rest (f32 points are never skipped)."""
    lane = torch.where(dwell < max_iter, dwell.long() + 1, max(max_iter, 0))
    if cr.dtype == torch.float64:
        lane = torch.where(interior_f64_torch(cr, ci), 0, lane)
    return lane


def orbit_tci_lane_steps(cr: torch.Tensor, ci: torch.Tensor, max_iter: int,
                         escape_r: float):
    """(first, second, late): per-lane steps of orbit_de_tci's two passes
    (int64, the shape of cr), a test counted after every step. first, the z
    alone: none for a skipped f64 interior point (R >= 2), else every step up
    to the first after which the point has escaped and its z is non-finite
    if that comes within max_iter - 1 steps, else max_iter - 1 for a point
    that escaped within them and max_iter for the rest. second, the (z, dz)
    body: max_iter for a late escaper (escaped, z finite after max_iter - 1
    steps; for R < 2 every escaper), else none. late the late escapers."""
    from cmtci_torch.kernels import mandelbrot as mb

    t = mb.radius_threshold(float(escape_r), cr.dtype == torch.float64)
    fast = t >= 4.0
    run = torch.ones(cr.shape, dtype=torch.bool, device=cr.device)
    if cr.dtype == torch.float64 and fast:
        run = ~interior_f64_torch(cr, ci)
    zr, zi = torch.zeros_like(cr), torch.zeros_like(ci)
    hit = torch.zeros_like(run)
    dead_at = torch.full(cr.shape, max_iter, dtype=torch.int64, device=cr.device)
    for k in range(1, max_iter):
        zr, zi = zr * zr - zi * zi + cr, zr * zi + zi * zr + ci
        hit = hit | (zr * zr + zi * zi > t)
        dead = hit & ~(torch.isfinite(zr) & torch.isfinite(zi)) & (dead_at == max_iter)
        dead_at = torch.where(dead, k, dead_at)
    early = hit.clone()
    if max_iter >= 1:
        zr, zi = zr * zr - zi * zi + cr, zr * zi + zi * zr + ci
        hit = hit | (zr * zr + zi * zi > t)
    hit = hit & run
    first = torch.where(dead_at < max_iter, dead_at,
                        torch.where(early, max_iter - 1, max(max_iter, 0)))
    first = torch.where(run, first, 0)
    late = hit & (dead_at == max_iter)
    second = torch.where(hit & (late | (not fast)), max(max_iter, 0), 0)
    return first, second, late


def max_sm_clock_mhz(dev: torch.device) -> float:
    """The card's maximum SM clock in MHz (nvidia-smi's clocks.max.sm). The
    card is named to nvidia-smi by its UUID: torch's index follows
    CUDA_VISIBLE_DEVICES, nvidia-smi's does not."""
    props = torch.cuda.get_device_properties(dev)
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits", f"--id=GPU-{props.uuid}"],
                          capture_output=True, text=True, timeout=60, check=True)
    return float(proc.stdout.strip().splitlines()[0])


def fp32_fma_bound_tflops(dev: torch.device) -> float:
    """The card's FP32 FMA ceiling in TFLOP/s: SMs x 128 lanes x 2 operations
    x the maximum SM clock."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * 128 * 2 * max_sm_clock_mhz(dev) * 1e6 / 1e12


def bench_dwell(sizes: BenchSizes, dev: torch.device) -> float:
    """Mpix/s of the headline dwell grid."""
    per_grid = _per_launch_s(
        lambda: mc.mandelbrot_field(DOM, sizes.res, sizes.res, sizes.max_iter, device=dev),
        sizes.reps, 3, dev)
    return sizes.res * sizes.res / per_grid / 1e6


def bench_dwell_entry_ms(sizes: BenchSizes, dev: torch.device) -> float:
    """ms per call of K2's ctypes entry (dwell_launch, through the counted
    _launch.launch) at the headline grid, timed as `value` is: what `value`
    would read without the host's time in mandelbrot_field (parameters and
    output allocation). The card only: the CPU has no kernel."""
    from cmtci_torch.kernels import _launch

    if dev.type != "cuda":
        raise RuntimeError(f"K2's ctypes entry runs on a CUDA device, not {dev}")
    n = sizes.res
    xmin, ymin, dx, dy = (float(v) for v in mc._params(DOM, n, n))
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    return _per_launch_s(
        lambda: _launch.launch("dwell", dev, out.data_ptr(), n, n, xmin, ymin, dx, dy,
                               sizes.max_iter),
        sizes.reps, 3, dev) * 1e3


def bench_vpu_peak(sizes: BenchSizes, dev: torch.device) -> float:
    """TFLOP/s of K7's chained FMAs (an FMA is two operations)."""
    per_run = _per_launch_s(
        lambda: fma_peak.fma_chain(sizes.fma_elems, sizes.fma_steps, device=dev), 1, 3, dev)
    return fma_peak.FLOP_PER_STEP * sizes.fma_steps * sizes.fma_elems / per_run / 1e12


def bench_mfu(sizes: BenchSizes, dev: torch.device) -> dict:
    """The roofline keys of K2 and K4 on the padded grid."""
    n = sizes.mfu_res
    dom = padded_domain(sizes)

    def k2():
        return mc.mandelbrot_field(dom, n, n, sizes.max_iter, device=dev)

    per_grid = _per_launch_s(k2, sizes.reps, 3, dev)
    cr, ci = mc._grid_coords(dom, n, n, dev)
    useful, executed = dwell_step_counts(k2(), mc._interior_mask_torch(cr, ci),
                                         sizes.max_iter)
    ops = mc.OPS_PER_STEP
    peak = bench_vpu_peak(sizes, dev)
    out = {"dwell_tflops": round(ops["dwell"] * executed / per_grid / 1e12, 3),
           "vpu_peak_tflops": round(peak, 3)}
    out["dwell_mfu"] = round(out["dwell_tflops"] / peak, 3)
    out["dwell_mfu_useful"] = round(ops["dwell"] * useful / per_grid / 1e12 / peak, 3)
    de_per_grid = _per_launch_s(
        lambda: mc.mandelbrot_field(dom, n, n, sizes.max_iter, "de", DE_ESCAPE_R, dev),
        sizes.reps, 3, dev)
    de_executed = warp_executed_steps(
        escape_lane_steps(cr, ci, sizes.max_iter, DE_ESCAPE_R * DE_ESCAPE_R), mc.DE_FOOTPRINT)
    out["de_tflops"] = round(ops["de_std"] * de_executed / de_per_grid / 1e12, 3)
    out["de_mfu"] = round(out["de_tflops"] / peak, 3)
    if dev.type == "cuda":
        out["fp32_fma_bound_tflops"] = round(fp32_fma_bound_tflops(dev), 3)
    return out


def bench_clouds(n: int):
    """The reference's two noisy-circle clouds of n points (default_rng(1))."""
    rng = np.random.default_rng(1)
    t = rng.uniform(0, 2 * np.pi, n)
    r = 1.0 + 0.05 * rng.standard_normal(n)
    c1 = np.column_stack([r * np.cos(t), r * np.sin(t)])
    c2 = c1[::-1] + 0.01 * rng.standard_normal((n, 2))
    return c1, c2


def bench_scale(sizes: BenchSizes, dev: torch.device) -> dict:
    """The scale keys: K2 at the larger grids, the two f32 pair scans with
    the Hausdorff, and the f32 kNN kernel build."""
    out = {}
    for res, reps in sizes.scale_grids:
        per_grid = _per_launch_s(
            lambda: mc.mandelbrot_field(DOM, res, res, sizes.max_iter, device=dev),
            reps, 2, dev)
        out[f"escape_grid_res{res}_mpix_s"] = round(res * res / per_grid / 1e6, 1)

    c1, c2 = bench_clouds(sizes.cloud_points)
    f32 = torch.float32

    def scan():
        sh1 = ps._shell_counts(c1, 0.5, 0.02, dtype=f32, device=dev)
        sh2 = ps._shell_counts(c2, 0.5, 0.02, dtype=f32, device=dev)
        h = ps.hausdorff(c1, c2, dtype=f32, device=dev)
        assert sh1[1].sum() > 0 and sh2[1].sum() > 0 and h > 0
        return h

    scan()  # first-use kernels
    best, _ = _best_wall_s(scan, 2, dev)
    out["spatial_stats_150k_s"] = round(best, 2)

    best, (kmat, sigma) = _best_wall_s(
        lambda: build_sparse_kernel(c1, k=sizes.knn_k, dtype=f32, device=dev), 2, dev)
    assert kmat.shape == (sizes.cloud_points, sizes.cloud_points) and sigma > 0
    out["knn_150k_s"] = round(best, 2)
    return out


def bench_eigensweep(sizes: BenchSizes, dev: torch.device) -> float:
    """Warm wall time of the stage-4 inverse cloud."""
    ns = list(sizes.stage4_ns)
    companion.inverse_cloud(ns, device=dev)
    best, z = _best_wall_s(lambda: companion.inverse_cloud(ns, device=dev), 3, dev)
    assert z.shape[0] == sum(ns)
    return best


def bench_tracker(sizes: BenchSizes, dev: torch.device) -> float:
    """Warm wall time of the dense tracker on the K1 path."""
    cfg = sizes.tracker
    best, (rows, _) = _best_wall_s(lambda: run_tracker(cfg, device=dev), 3, dev)
    assert len(rows) == int(math.log2(cfg.bins_max // cfg.bins_start)) + 1
    return best


def bench_equipotential(sizes: BenchSizes, dev: torch.device) -> float:
    """Warm wall time of the equipotential pipeline on the K3 path."""
    best, out = _best_wall_s(
        lambda: run_equipotential(sizes.equipotential, plots=False, device=dev), 3, dev)
    assert 0.5 < out["summary"]["escaped_frac"] < 1.0
    return best


def bench_variograms(sizes: BenchSizes, dev: torch.device) -> float:
    """Warm wall time of the variogram pipeline in f32."""
    best, out = _best_wall_s(lambda: run_variograms(sizes.variograms, device=dev), 3, dev)
    assert np.isfinite(out["gamma_construct"][1:]).all()
    return best


def bench_uniformize_green(sizes: BenchSizes, dev: torch.device) -> float:
    """Warm wall time of the Riemann-map pipeline, f32 on the card; its input
    boundary is made outside the timed window."""
    from dataclasses import replace

    pts = export_lucas_boundary(sizes.green_input, device=dev)
    cfg = sizes.green
    if cfg.map_dtype is None:
        cfg = replace(cfg, map_dtype="float32" if dev.type == "cuda" else "float64")
    # best of 5: the first run pays the first-use costs of its solvers
    best, out = _best_wall_s(lambda: run_green_uniformization(pts, cfg, device=dev), 5, dev)
    assert 0.99 < out["diagnostics"]["bdy_mod_median"] < 1.01
    return best


def bench_uniformize_fem(sizes: BenchSizes, dev: torch.device) -> float:
    """Warm wall time of the FEM study (the device solver on the card); the
    second run reuses the memoized meshes and device operators."""
    best, res = _best_wall_s(
        lambda: run_fem_uniformization(sizes.fem, levels=sizes.fem_levels, device=dev),
        2, dev)
    assert (len(res) == len(sizes.fem_levels)
            and res[-1]["all"]["K_median"] < res[0]["all"]["K_median"])
    return best


def bench_tci_4x(sizes: BenchSizes, dev: torch.device) -> float:
    """Warm wall time of the TCI pipeline at the 4x grid on the K1 path."""
    best, (out, kls, _) = _best_wall_s(
        lambda: run_tci(sizes.tci, plots=False, device=dev), 3, dev)
    assert kls[-1] < kls[0] and out["KL_final"] < 1e-5
    return best


def bench_coupling(sizes: BenchSizes, dev: torch.device) -> float:
    """Warm wall time of the coupling pipeline on the f32 field path; the
    stage-1 bus it reads is built outside the timed window."""
    bus = run_stage1(sizes.coupling_bus, plots=False, device=dev)
    cfg = sizes.coupling
    run_coupling(bus["C"], bus["M"], bus["matches"], cfg, device=dev)
    best, (rows, _) = _best_wall_s(
        lambda: run_coupling(bus["C"], bus["M"], bus["matches"], cfg, device=dev), 3, dev)
    assert len(rows) == cfg.n_iter and np.isfinite(rows[-1]["corr_pot"])
    return best


#: (key, function, digits) of the pipeline keys, in the reference's order
PIPELINE_KEYS = (
    ("eigensweep_s", bench_eigensweep, 3),
    ("tracker_warm_s", bench_tracker, 2),
    ("equipotential_s", bench_equipotential, 2),
    ("variograms_s", bench_variograms, 2),
    ("uniformize_green_s", bench_uniformize_green, 2),
    ("uniformize_fem_s", bench_uniformize_fem, 2),
    ("tci_4x_s", bench_tci_4x, 2),
    ("coupling_s", bench_coupling, 2),
)


def run(sizes: BenchSizes | None = None, device="cuda") -> dict:
    """Run every ported key on `device` and return the result dict. A key
    that throws is recorded as `<key>_error` (its message, cut to 300
    characters) and the others still run."""
    sizes = sizes if sizes is not None else BenchSizes()
    dev = resolve_device(device)
    result = {"metric": f"escape_grid_res{sizes.res}_mi{sizes.max_iter}_throughput",
              "value": None, "unit": "Mpix/s",
              "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")}

    def guarded(name: str, fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 (recorded under the key, and main exits non-zero)
            result[name + "_error"] = repr(e)[:300]
            return None

    value = guarded("dwell", lambda: bench_dwell(sizes, dev))
    if value is not None:
        result["value"] = round(value, 2)
    if dev.type == "cuda":
        entry_ms = guarded("dwell_entry", lambda: bench_dwell_entry_ms(sizes, dev))
        if entry_ms is not None:
            result["dwell_entry_ms"] = round(entry_ms, 5)
    result.update(guarded("mfu", lambda: bench_mfu(sizes, dev)) or {})
    result.update(guarded("scale", lambda: bench_scale(sizes, dev)) or {})
    for name, fn, digits in PIPELINE_KEYS:
        s = guarded(name, lambda fn=fn: fn(sizes, dev))
        if s is not None:
            result[name] = round(s, digits)
    result["not_ported"] = list(NOT_PORTED)
    result["omitted"] = dict(OMITTED)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cmtci_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="every key at a size a CPU runs in seconds (control flow only)")
    args = ap.parse_args(argv)
    result = run(small_sizes() if args.small else BenchSizes(), device=args.device)
    print(json.dumps(result))
    return 1 if any(k.endswith("_error") for k in result) else 0


if __name__ == "__main__":
    sys.exit(main())
