"""Iterative variogram <-> Laplacian coupling pipeline (``cmtci coupling``;
port of ``cmtci/pipelines/coupling.py``).

Reference: Iterative_Variogram_Laplacian.py:156-307 — per iteration:
matching-distance variogram -> range a -> gaussian-smooth U_C (sigma from
a) -> Laplacians -> global/local correlations -> nudge C toward matched M
with distance-weighted learning rate.

The nudge trajectory (distances, variogram, range, weights) is host f64
numpy, bitwise the reference's. The potentials run on `device`: U_M through
``kernels/mandelbrot.escape_potential_grid`` and U_C through
``kernels/potential.cloud_log_potential``, in field_dtype. With "float64"
the smoothing is the host filter, bitwise scipy's, and the Laplacians and
the local correlation map run in f64 on `device`; with "float32" the
smoothing, the Laplacians and both correlations run in f32 on `device`,
each iteration's as it comes, and two scalars a iteration are read back.
The diagnostics never feed the nudge, so field_dtype leaves the trajectory
bitwise unchanged. vario_dtype="float32" bins the point variogram in f32 on
`device`: its range feeds the nudge, so that changes the trajectory's
realization. The reference groups its f32 diagnostics into one dispatch
after the trajectory (``_all_iters_device``) only to save TPU round trips;
the values are the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cmtci_torch.io import writers
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels.potential import cloud_log_potential
from cmtci_torch.stats import fields
from cmtci_torch.stats import variogram as vg
from cmtci_torch.transport.histogram import (_sep_correlate_nearest, gaussian_filter_nearest,
                                             gaussian_kernel1d)
from cmtci_torch.utils.artifacts import StageTimer
from cmtci_torch.utils.device import resolve_device


@dataclass
class CouplingConfig:
    n_iter: int = 4
    vario_bins: int = 50
    grid_res: int = 300
    max_iter_mb: int = 300
    escape_rad: float = 10.0
    nudge_alpha: float = 0.25
    smooth_factor: float = 1.0
    vario_percent: float = 0.90
    win_local_corr: int = 12
    # "float32": the two potential fields and the smooth / Laplacian /
    # correlation diagnostics in f32 on the device; the trajectory is
    # unchanged bitwise (corr_pot within ~1e-5, corr_lap ~1e-3 of f64)
    field_dtype: str = "float64"
    # "float32": the per-iteration point variogram in f32 on the device; its
    # range feeds the nudge, so the trajectory is an f32 realization
    vario_dtype: str = "float64"


def run_coupling(c_pts, m_pts, matches, cfg: CouplingConfig,
                 out_prefix: str | None = None, plots: bool = True, device="cuda",
                 timer: StageTimer | None = None, mesh=None):
    """Returns (summary rows, final nudged cloud). With `out_prefix` writes
    per iteration the variogram CSV and the local-correlation npy (and its
    figure unless plots=False), then the summary CSV and _meta.txt.
    `timer` records the layers u_m (U_M and its Laplacian), variogram (the
    point variogram and its range), u_c, smooth, diagnostics (Laplacian,
    global and local correlations), write and nudge, summed over the
    iterations.

    With a `mesh` the two O(n²)-class stages shard over its ranks, on the
    ranks' devices: the point variogram (parallel.sharded
    .sharded_point_variogram: exact counts, f64 sums reduced over the ranks,
    so its range can move the trajectory by rounding only) and U_C, whose
    rows are the same meshgrid rows as the single-device grid
    (sharded_cloud_potential with grid=, bitwise). Only rank 0 writes."""
    from cmtci_torch.parallel.sharded import (is_writer, sharded_cloud_potential,
                                              sharded_point_variogram)

    if matches is None:
        raise ValueError(
            "coupling requires matches (matches_indices.csv missing or "
            "unreadable in the bus directory — rerun `cmtci-torch stage1`)")
    dev = mesh.device if mesh is not None else resolve_device(device)
    if not is_writer(mesh):
        out_prefix = None
    timer = timer if timer is not None else StageTimer(dev)
    c = np.asarray(c_pts, dtype=float).copy()
    m = np.asarray(m_pts, dtype=float)
    matches = np.asarray(matches, dtype=int)

    allp = np.vstack([c, m])
    xmin, ymin = allp.min(axis=0) - 0.5
    xmax, ymax = allp.max(axis=0) + 0.5
    gx1 = np.linspace(xmin, xmax, cfg.grid_res)
    gy1 = np.linspace(ymin, ymax, cfg.grid_res)
    h = gx1[1] - gx1[0]
    gxx, gyy = np.meshgrid(gx1, gy1)

    f32 = cfg.field_dtype == "float32"
    fdt = torch.float32 if f32 else torch.float64
    gxp = gxx.astype(np.float32) if f32 else gxx
    gyp = gyy.astype(np.float32) if f32 else gyy
    gx = torch.as_tensor(gxp, device=dev)
    gy = torch.as_tensor(gyp, device=dev)
    win = int(cfg.win_local_corr)
    h_t = torch.tensor(h, dtype=fdt)  # the stencil's h² in the field dtype
    # U_M is static: the escape potential log|z_k|/(k+1) at R = 10
    with timer.stage("u_m"):
        u_m_t = mb.escape_potential_grid(gx, gy, max_iter=cfg.max_iter_mb,
                                         escape_r=cfg.escape_rad, normalization="k_plus_1")
        lap_m_t = fields.laplacian5(u_m_t, h_t)
        u_m = u_m_t.cpu().numpy().astype(np.float64)
        lap_m = lap_m_t.cpu().numpy()
    rows = []
    vario32 = cfg.vario_dtype == "float32"
    for it in range(1, cfg.n_iter + 1):
        with timer.stage("variogram"):
            matched_m = m[matches]
            dists = np.linalg.norm(c - matched_m, axis=1)
            if mesh is not None:
                lags, gamma, counts = sharded_point_variogram(
                    c, dists, nbins=cfg.vario_bins, mesh=mesh,
                    dtype=torch.float32 if vario32 else None)
            elif vario32:
                lags, gamma, counts = vg.point_variogram_device(
                    c, dists, nbins=cfg.vario_bins, dtype=torch.float32, device=dev)
            else:
                lags, gamma, counts = vg.point_variogram(c, dists, nbins=cfg.vario_bins)
            a_est = vg.variogram_range(lags, gamma, cfg.vario_percent)

        sigma_px = 1.0 if (a_est is None or a_est <= 0) else max(
            0.5, cfg.smooth_factor * (a_est / h) / 2.0
        )
        with timer.stage("u_c"):
            if mesh is not None:
                u_c = sharded_cloud_potential(None, cfg.grid_res, cfg.grid_res, c, mesh,
                                              eps=1e-12, sign=1, grid=(gxp, gyp))
            else:
                u_c = cloud_log_potential(gxp, gyp, c, eps=1e-12, sign=1, device=dev)
        if f32:
            with timer.stage("smooth"):
                kernel_np = gaussian_kernel1d(sigma_px)
                u_c_s_t = _sep_correlate_nearest(
                    u_c, torch.as_tensor(kernel_np, dtype=fdt, device=dev),
                    (len(kernel_np) - 1) // 2)
            with timer.stage("diagnostics"):
                lap_c_t = fields.laplacian5(u_c_s_t, h_t)
                corr = torch.stack([fields.pearson_global_device(u_c_s_t, u_m_t),
                                    fields.pearson_global_device(lap_c_t, lap_m_t)]).cpu()
                corr_pot, corr_lap = float(corr[0]), float(corr[1])
                local_inner = (fields._local_corr_windows(u_c_s_t, u_m_t, win) if out_prefix
                               else None)
                u_c_s = u_c_s_t.cpu().numpy().astype(np.float64) if out_prefix else None
        else:
            with timer.stage("smooth"):
                u_c_s = gaussian_filter_nearest(u_c.cpu().numpy(), sigma_px)
            with timer.stage("diagnostics"):
                u_c_s_t = torch.as_tensor(u_c_s, device=dev)
                lap_c = fields.laplacian5(u_c_s_t, h_t).cpu().numpy()
                corr_pot = fields.pearson_global(u_c_s, u_m)
                corr_lap = fields.pearson_global(lap_c, lap_m)
                local_inner = fields._local_corr(u_c_s_t, u_m_t, win) if out_prefix else None

        rows.append(dict(iter=it, vario_range_a=float(a_est) if a_est else np.nan,
                         sigma_px=float(sigma_px), corr_pot=corr_pot, corr_lap=corr_lap,
                         d_mean=float(np.nanmean(dists)), d_median=float(np.nanmedian(dists)),
                         d_max=float(np.nanmax(dists))))
        if out_prefix:
            with timer.stage("write"):
                writers.ensure_dir(f"{out_prefix}_{it}_variogram_construct.csv")
                np.savetxt(f"{out_prefix}_{it}_variogram_construct.csv",
                           np.c_[lags, gamma, counts], delimiter=",",
                           header="lag,gamma,count", comments="")
                local = fields.framed(local_inner.cpu().numpy(), u_m.shape, win)
                np.save(f"{out_prefix}_{it}_localcorr.npy", local)
                if plots:
                    from cmtci_torch.io import plots as plot_io

                    plot_io.plot_local_correlation_panels(
                        u_c_s, u_m, local, (xmin, xmax, ymin, ymax),
                        f"{out_prefix}_{it}_potential_comparison_with_corrmap.png")

        # nudge (Iterative_Variogram_Laplacian.py:281-295)
        with timer.stage("nudge"):
            maxd = (np.nanmax(dists) if np.isfinite(np.nanmax(dists)) and np.nanmax(dists) > 0
                    else 1.0)
            weights = 1.0 - dists / (maxd + 1e-12)
            scale = 1.0 if (a_est is None or a_est <= 0) else min(2.0, max(0.1, a_est))
            lr = cfg.nudge_alpha * (scale / (scale + 1.0))
            c = c + lr * weights[:, None] * (matched_m - c)

    if out_prefix:
        writers.write_dict_rows_csv(f"{out_prefix}_summary_metrics.csv", rows)
        writers.write_config_meta(f"{out_prefix}_meta.txt", cfg,
                                  extra={"n_construct": len(c), "n_mandel": len(m)})
    return rows, c
