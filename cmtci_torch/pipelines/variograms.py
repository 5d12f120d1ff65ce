"""Variogram pipeline (BASELINE config 3).

Port of ``cmtci/pipelines/variograms.py`` (variograms_construct_mandelbrot.py
main, :320-399): the inverse-eigenvalue cloud and the DE-threshold boundary
proxy, a shared grid, the cloud's log potential (U_C) and the smoothed escape
potential (U_M), min-max normalization, the two semivariograms and the cross
variogram, and the CSV. The v2 additions (2-D polynomial detrend, exponential
model fit) are options (variograms_construct_mandelbrotv2.py:179-235).

Every stage runs on the one device the caller names, in f64 or f32 as the
config says; the location subsamples are drawn on the host from
np.random.RandomState(seed), as in the reference.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np
import torch

from cmtci_torch.io import writers
from cmtci_torch.kernels import companion
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels.potential import cloud_log_potential
from cmtci_torch.stats import variogram as vg
from cmtci_torch.utils.artifacts import StageTimer
from cmtci_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class VariogramConfig:
    # dtype of the all-pairs binning (per-bin sums accumulate in f64 either way)
    vario_dtype: str = "float64"
    # dtype of the DE boundary proxy, the escape potential and the cloud's
    # log potential (f32 flips borderline DE-threshold points only)
    field_dtype: str = "float64"
    n_list: tuple = (30, 60, 90, 120, 180, 240, 300)
    boundary_grid: int = 700
    dist_thresh: float = 0.0018
    boundary_max_iter: int = 600
    domain: tuple = (-2.25, 1.25, -1.75, 1.75)
    grid_nx: int = 256
    grid_ny: int = 256
    potential_max_iter: int = 600
    potential_r: float = 4.0
    log_pot_eps: float = 1e-6
    rmax: float = 1.3
    nbins: int = 35
    detrend: bool = False
    fit_model: bool = False
    m_target: int = 15000
    seed: int = 42
    cloud_backend: str = "aberth"


def _norm(u: np.ndarray) -> np.ndarray:
    return (u - np.nanmin(u)) / (np.nanmax(u) - np.nanmin(u) + 1e-12)


def run_variograms(cfg: VariogramConfig, out_csv: str | None = None, timer=None,
                   device="cuda", mesh=None):
    """Run the pipeline on `device`. Returns a dict with r, the three gammas
    and their per-bin pair counts, U_C, U_M and the two cloud sizes (and the
    fits with cfg.fit_model); with `out_csv` writes the CSV and its
    _meta.txt. `timer` records the layers cloud, boundary, potentials and
    variograms (device-synchronized on CUDA). With a `mesh` it runs on the
    rank's device, the three binnings sharded over the ranks
    (stats.variogram.three_semivariograms), and only rank 0 writes."""
    from cmtci_torch.parallel.sharded import is_writer
    for name in (cfg.vario_dtype, cfg.field_dtype):
        if name not in _DTYPES:
            raise ValueError(f"unknown dtype {name!r}; expected one of {tuple(_DTYPES)}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    if not is_writer(mesh):
        out_csv = None
    timer = timer if timer is not None else StageTimer(dev)
    rng = np.random.RandomState(cfg.seed)
    fdt = _DTYPES[cfg.field_dtype]
    with timer.stage("cloud"):
        c_pts = companion.inverse_cloud(list(cfg.n_list), "lucas_all_ones", tol=1e-14,
                                        backend=cfg.cloud_backend, device=dev)
    with timer.stage("boundary"):
        m_pts = mb.boundary_points_threshold(
            domain=cfg.domain, grid_n=cfg.boundary_grid, dist_thresh=cfg.dist_thresh,
            max_iter=cfg.boundary_max_iter, dtype=fdt, device=dev)

    xs = np.linspace(cfg.domain[0], cfg.domain[1], cfg.grid_nx)
    ys = np.linspace(cfg.domain[2], cfg.domain[3], cfg.grid_ny)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")

    with timer.stage("potentials"):
        # U_C = (1/N) sum log(1/(r+eps)) (variograms_construct_mandelbrot.py:128-146)
        np_dt = np.float32 if fdt == torch.float32 else np.float64
        u_c = cloud_log_potential(gx.astype(np_dt), gy.astype(np_dt), c_pts,
                                  eps=cfg.log_pot_eps, sign=-1, device=dev).cpu().numpy()
        cr, ci = mb.complex_grid(cfg.domain, cfg.grid_nx, cfg.grid_ny, dtype=fdt, device=dev)
        u_m = mb.smooth5(mb.escape_potential_grid(
            cr, ci, max_iter=cfg.potential_max_iter, escape_r=cfg.potential_r,
            normalization="two_pow_n")).cpu().numpy()

    u_c_n, u_m_n = _norm(u_c), _norm(u_m)
    if cfg.detrend:
        u_c_n, _ = vg.detrend_poly2d(u_c_n, gx, gy)
        u_m_n, _ = vg.detrend_poly2d(u_m_n, gx, gy)

    r_bins = np.linspace(0.0, cfg.rmax, cfg.nbins + 1)
    with timer.stage("variograms"):
        r_c, g_c, g_m, g_x, n_c, n_m, n_x = vg.three_semivariograms(
            u_c_n, u_m_n, gx, gy, r_bins, cfg.m_target, rng,
            dtype=_DTYPES[cfg.vario_dtype], device=dev, mesh=mesh)

    out = {
        "r": r_c, "gamma_construct": g_c, "gamma_mandelbrot": g_m, "gamma_cross": g_x,
        "counts_construct": n_c, "counts_mandelbrot": n_m, "counts_cross": n_x,
        "U_C": u_c, "U_M": u_m, "n_construct": len(c_pts), "n_boundary": len(m_pts),
        "stage_times": dict(timer.times),
    }
    if cfg.fit_model:
        out["fit_construct"] = vg.fit_exponential_variogram(r_c, g_c)
        out["fit_mandelbrot"] = vg.fit_exponential_variogram(r_c, g_m)
    if out_csv:
        writers.ensure_dir(out_csv)
        writers.write_config_meta(f"{os.path.splitext(out_csv)[0]}_meta.txt", cfg)
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["r_center", "gamma_Construct", "gamma_Mandelbrot", "gamma_cross"])
            for i in range(len(r_c)):
                w.writerow([r_c[i], g_c[i], g_m[i], g_x[i]])
    return out
