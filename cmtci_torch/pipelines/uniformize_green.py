"""Boundary-integral Riemann-map pipeline (P2), on PyTorch.

Port of ``cmtci/pipelines/uniformize_green.py``. Reference:
lucas_to_cardioid_v40_reference.py main (:476-671): lucas boundary points ->
alpha polygon -> fit Riemann map -> 20k interior samples -> Phi / f -> radii
clamp -> exact disk->cardioid map -> inverse check -> one-row diagnostics
CSV + radii histogram CSV + NPZ map state.

The map evaluations run on `device`. map_dtype "float64" fits with the
host's np.linalg.lstsq and evaluates in f64; "float32" fits with the f32 QR
on the device (refined in f64 on the host) and evaluates in f32. The
polygon, the interior sampler (its own host RNG, overlapped with the fit in
a worker thread), the clamp, the cardioid map and the diagnostics are the
reference's numpy.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass

import numpy as np
import torch

from cmtci_torch.geometry import alpha_shape
from cmtci_torch.geometry.cardioid import cardioid_to_disk, disk_to_cardioid
from cmtci_torch.geometry.polygon import Polygon, sample_interior_points, slightly_inside
from cmtci_torch.geometry.resample import enforce_ccw
from cmtci_torch.io import writers
from cmtci_torch.maps import riemann
from cmtci_torch.utils import artifacts
from cmtci_torch.utils.artifacts import StageTimer
from cmtci_torch.utils.device import resolve_device


@dataclass
class GreenUniformizeConfig:
    alpha: float = 4.5
    n_bdy: int = 2000
    gauss_n: int = 16
    ridge: float = 1e-8
    target_r_clamp: float = 0.995
    inward_eps: float = 1e-3
    interior_n: int = 20000
    interior_seed: int = 0
    interior_max_tries: int = 2_000_000
    enable_jitter: bool = True
    do_inverse_check: bool = True
    # "float32" runs the map evaluations (Phi quadrature + log-kernel
    # modulus, 20000x2000) in f32 on the device and fits with the device's
    # f32 QR, with the documented error budget: Im Phi mod 2pi p99 ~1e-5
    # rad, g abs err <= 1e-4. "float64" fits with the host lstsq.
    map_dtype: str = "float64"
    # "alpha" reproduces v40 (unique+jitter destroys the input ordering, then
    # the alpha shape recovers a polygon); "ordered" treats the input as an
    # ordered closed boundary and maps the FULL domain.
    polygon_source: str = "alpha"


#: the config fields the fit depends on: the cache key holds only these, so
#: sampling and diagnostic knobs never invalidate a cached dense fit
FIT_FIELDS = ("alpha", "n_bdy", "gauss_n", "ridge", "inward_eps", "enable_jitter",
              "map_dtype", "polygon_source")


def run_green_uniformization(lucas_points_xy, cfg: GreenUniformizeConfig,
                             out_dir: str | None = None, verbose: bool = False,
                             cache_dir: str | None = None, timer=None, device="cuda"):
    """Returns dict with the map, samples, and the v40 diagnostics row.

    With cache_dir the fitted map state (the dense N_BDY fit, the pipeline's
    one-time cost) is cached keyed by (input-points digest, fit config). The
    key carries the implementation, so a cache directory shared with cmtci
    never hands one package's fit to the other. `timer`, a StageTimer, takes
    the stages polygon, fit+interior_sample, phi_f_eval and diagnostics.
    """
    dev = resolve_device(device)
    timer = timer if timer is not None else StageTimer(dev)
    if cfg.polygon_source not in ("alpha", "ordered"):
        raise ValueError(f"unknown polygon_source '{cfg.polygon_source}'")
    if cfg.map_dtype not in ("float64", "float32"):
        raise ValueError(f"unknown map_dtype '{cfg.map_dtype}'")
    f32 = cfg.map_dtype == "float32"
    pts = np.ascontiguousarray(np.asarray(lucas_points_xy, dtype=float))
    with timer.stage("polygon"):
        if cfg.polygon_source == "ordered":
            poly_l = Polygon(enforce_ccw(pts))
        else:
            pts = np.unique(pts, axis=0)
            if cfg.enable_jitter:
                rng = np.random.default_rng(0)
                pts = pts + 1e-12 * rng.standard_normal(pts.shape)
            poly_l = alpha_shape.alpha_shape_polygon(pts, cfg.alpha)

    fresh_kds = []

    def _fit():
        # f32: the device's f32 QR fit with f64 host refinement, and g_shift
        # derived from the phi_f_eval call below, which evaluates the same
        # inward-shifted boundary nodes anyway; f64: the host lstsq
        rm = riemann.fit_riemann_map(poly_l, n_bdy=cfg.n_bdy, ridge=cfg.ridge,
                                     inward_eps=cfg.inward_eps, gauss_n=cfg.gauss_n,
                                     verbose=verbose, solver="qr32" if f32 else "lstsq",
                                     calibrate_g_shift=not f32, device=dev)
        # the N×N kernel is too big for the cached state; hand the fresh
        # one to the caller so a cache miss doesn't pay a second assembly
        fresh_kds.append(rm._kds)
        return {"bdy_z": rm.bdy_z, "ds": rm.ds, "sigma": rm.sigma,
                "a": np.complex128(rm.a), "c": np.float64(rm.c),
                "g_shift": np.float64(rm.g_shift)}

    # the interior rejection sampler (host numpy, its own RNG) and the fit
    # are independent: the sampler runs in a worker thread meanwhile
    with timer.stage("fit+interior_sample"):
        with ThreadPoolExecutor(1) as ex:
            fut_int = ex.submit(sample_interior_points, poly_l, cfg.interior_n,
                                cfg.interior_seed, cfg.interior_max_tries)
            cfg_dict = asdict(cfg)
            fit_key = {"impl": "cmtci_torch", **{k: cfg_dict[k] for k in FIT_FIELDS},
                       "points": artifacts.array_digest(lucas_points_xy)}
            st = artifacts.cached("riemann_fit", fit_key, _fit,
                                  cache_dir=cache_dir or ".cmtci_cache",
                                  enabled=cache_dir is not None)
            rm = riemann.RiemannMapGreenModulus(
                bdy_z=np.asarray(st["bdy_z"]), ds=np.asarray(st["ds"]),
                sigma=np.asarray(st["sigma"]), a=complex(st["a"]),
                c=float(st["c"]), g_shift=float(st["g_shift"]), gauss_n=cfg.gauss_n,
                device=dev,
            )
            if fresh_kds and fresh_kds[0] is not None:
                rm._kds = fresh_kds[0]
            elif f32:
                # reconstructed from a cached state (no kernel): the fast
                # form matches the qr32 fit's own kds (the f64 path keeps
                # boundary_residual's exact-form assembly)
                rm._kds = riemann._log_kernel_ds_fast(rm.bdy_z, rm.ds)
            z_int, tries = fut_int.result()

    dt = torch.float32 if f32 else None
    with timer.stage("phi_f_eval"):
        # one evaluation: g on interior+boundary-in points, Im Φ_raw on the
        # interior points. Re Φ IS g (v40:259-264) and
        # f = exp(-g)·exp(-i·Im Φ_raw)
        z_bdy_in = slightly_inside(rm.bdy_z, rm.a, cfg.inward_eps)
        if f32:
            # derive g_shift from THIS evaluation (median g(bdy-in) = 0,
            # the v40 calibration contract); zeroing first makes the result
            # independent of whether a cached fit recorded a shift
            rm.g_shift = 0.0
        g_all, im_int = rm.eval_g_phi(np.concatenate([z_int, z_bdy_in]), z_int, dtype=dt)
        if f32:
            shift = -float(np.median(g_all[len(z_int):]))
            rm.g_shift = shift
            g_all = g_all + shift
        g_int, g_in = g_all[: len(z_int)], g_all[len(z_int):]
        re_phi = g_int
        w_raw = riemann.safe_exp_minus_real(g_int) * np.exp(-1j * im_int)
    rad_raw = np.abs(w_raw)
    finite = np.isfinite(rad_raw)
    rad_f = rad_raw[finite]

    # clamp to the disk (v40:140-147, vectorized)
    r = np.abs(w_raw)
    scale = np.where(np.isfinite(r) & (r > cfg.target_r_clamp),
                     cfg.target_r_clamp / np.where(r == 0, 1.0, r), 1.0)
    w = np.where(np.isfinite(r), w_raw * scale, np.nan + 1j * np.nan)
    rad = np.abs(w)
    mapped = disk_to_cardioid(w)

    err = np.array([])
    if cfg.do_inverse_check:
        err = np.abs(cardioid_to_disk(mapped) - w)
        err = err[np.isfinite(err)]

    with timer.stage("diagnostics"):
        # |f| = exp(-g) exactly (the phase factor has unit modulus), so the
        # boundary-modulus contract needs only the g_in already evaluated
        mod_bdy = riemann.safe_exp_minus_real(g_in)
        resid = rm.boundary_residual()

    row = dict(
        version="cmtci_green_uniformization",
        N_BDY=cfg.n_bdy, PATH_GAUSS_N=cfg.gauss_n, RIDGE_LAMBDA=cfg.ridge,
        INWARD_EPS=cfg.inward_eps, INTERIOR_N=int(len(z_int)),
        a_real=float(rm.a.real), a_imag=float(rm.a.imag), g_shift=float(rm.g_shift),
        bdy_mod_median=float(np.median(mod_bdy)),
        bdy_mod_p90=float(np.quantile(mod_bdy, 0.90)),
        bdy_mod_min=float(mod_bdy.min()), bdy_mod_max=float(mod_bdy.max()),
        bdy_resid_median=float(np.median(resid)),
        bdy_resid_p90_abs=float(np.quantile(np.abs(resid), 0.90)),
        bdy_resid_max_abs=float(np.max(np.abs(resid))),
        g_bdy_in_min=float(g_in.min()), g_bdy_in_median=float(np.median(g_in)),
        g_bdy_in_max=float(g_in.max()),
        RePhi_int_min=float(re_phi.min()), RePhi_int_median=float(np.median(re_phi)),
        RePhi_int_max=float(re_phi.max()),
        rad_raw_median=float(np.median(rad_f)), rad_raw_p90=float(np.quantile(rad_f, 0.90)),
        rad_raw_max=float(rad_f.max()),
        rad_clamped_median=float(np.nanmedian(rad)),
        rad_clamped_p90=float(np.nanquantile(rad, 0.90)),
        rad_clamped_max=float(np.nanmax(rad)),
    )
    if len(err):
        row.update(inverse_err_median=float(np.median(err)),
                   inverse_err_p90=float(np.quantile(err, 0.90)),
                   inverse_err_max=float(err.max()))

    if out_dir:
        writers.write_config_meta(f"{out_dir}/meta.txt", cfg,
                                  extra={"n_input_points": len(pts)})
        writers.write_dict_rows_csv(f"{out_dir}/diagnostics.csv", [row])
        writers.write_hist_csv(f"{out_dir}/radii_hist_w_raw.csv", rad_f, bins=80,
                               range_=(0.0, 1.05))
        writers.ensure_dir(f"{out_dir}/map_state.npz")
        np.savez(f"{out_dir}/map_state.npz", lucas_interior=z_int,
                 disk_points_raw=w_raw, disk_points=w, cardioid_points=mapped,
                 rmL_a=rm.a, rmL_sigma=rm.sigma, rmL_C=rm.c,
                 rmL_g_shift=rm.g_shift, rmL_bdy=rm.bdy_z, rmL_ds=rm.ds,
                 inverse_err=err)
    return {"map": rm, "interior": z_int, "disk": w, "cardioid": mapped,
            "diagnostics": row, "stage_times": dict(timer.times)}
