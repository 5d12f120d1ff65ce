"""The TCI flow pipeline (``cmtci tci``) on PyTorch.

Port of ``TCIConfig`` and ``run_tci`` from ``cmtci/pipelines/analysis.py``
(tci_construct_mandelbrot_v002_fixed.py:120-170): the inverse-eigenvalue
cloud C, the TCI boundary sample M, the kernel-argmax match and Procrustes,
the defensive Hausdorff / curvature / spectral metrics, the probability
histograms and the KL trajectory of the TCI flow. The other analyses of that
module are not ported yet (ROADMAP Queue 1 item 7).

One host stream np.random.RandomState(seed) is consumed in the reference's
order: the sampler, the matcher's subsample, then the two rng.choice draws
of the metrics. de_impl picks the boundary sampler:
  * "numpy": the host numpy DE, bitwise the reference's numpy path;
  * "torch": the plain-torch f64 DE field on `device` (the reference's
    "jax");
  * "cuda": the hand-written K1 kernel (its twin on a CPU device), with the
    q25 band and the subsample on the device, plus the f32 matcher and f32
    pca_eccentricity (the reference's "pallas").
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cmtci_torch.io import writers
from cmtci_torch.kernels import companion, mandelbrot
from cmtci_torch.stats import curvature as curv
from cmtci_torch.stats import pointstats as ps
from cmtci_torch.stats import spectral as sp
from cmtci_torch.transport import giflow
from cmtci_torch.transport import histogram as hg
from cmtci_torch.transport.procrustes import procrustes_align_no_scale
from cmtci_torch.transport.sinkhorn import entropic_argmax_match
from cmtci_torch.utils.artifacts import StageTimer
from cmtci_torch.utils.device import resolve_device

#: sampler implementations of the TCI pipeline; the reference's names map
#: onto them (jax -> torch, pallas -> cuda)
TCI_DE_IMPLS = ("torch", "numpy", "cuda")
_REFERENCE_DE_IMPL = {"jax": "torch", "pallas": "cuda"}

#: above this many points the dense spectral kernel is refused (the
#: reference's MemoryError guard), so Spectral_L2 is NaN at the defaults
SPECTRAL_MAX_POINTS = 8000


@dataclass
class TCIConfig:
    # the reference's fields, in its order (cmtci/pipelines/analysis.py:110)
    construct_ns: tuple = tuple(range(20, 301, 20))
    mandelbrot_grid: int = 600
    mandelbrot_samples: int = 25000
    escape_r: float = 250.0
    max_iter: int = 250
    grid_bins: int = 128
    domain: tuple = (-2.25, 1.25, -1.75, 1.75)
    alpha: float = 0.2
    t_steps: int = 60
    eps: float = 1e-12
    sinkhorn_eps: float = 0.8
    curvature_k: int = 6
    spectral_k: int = 30
    spectral_sigma: float = 0.05
    seed: int = 7
    cloud_backend: str = "aberth"
    de_impl: str = "torch"  # "cuda" = the K1 kernel path; "numpy" = parity


def tci_config_from_reference(d: dict) -> TCIConfig:
    """TCIConfig from ``dataclasses.asdict`` of a ``cmtci`` TCIConfig (or its
    JSON form): the same fields, with de_impl mapped jax -> torch and
    pallas -> cuda, and the tuples restored."""
    names = {f.name for f in dataclasses.fields(TCIConfig)}
    kw = {k: v for k, v in d.items() if k in names}
    if "domain" in kw:
        kw["domain"] = tuple(float(v) for v in kw["domain"])
    if "construct_ns" in kw:
        kw["construct_ns"] = tuple(int(v) for v in kw["construct_ns"])
    if "de_impl" in kw:
        kw["de_impl"] = _REFERENCE_DE_IMPL.get(kw["de_impl"], kw["de_impl"])
    return TCIConfig(**kw)


def run_tci(cfg: TCIConfig, out_json: Optional[str] = None, plots: bool = True,
            timer: Optional[StageTimer] = None, device="cuda"):
    """The v002_fixed main pipeline on `device`. Returns (out, kls, traj):
    out holds Hausdorff_before, Curvature_corr, Spectral_L2, KL_initial,
    KL_final and runtime_sec, as in the reference. With `out_json` the
    results JSON and _meta.txt are written, and the two figures unless
    plots=False. `timer` records the layers cloud, sample, match, stats,
    hist and flow (device-synchronized on CUDA)."""
    if cfg.de_impl not in TCI_DE_IMPLS:
        raise ValueError(f"unknown de_impl {cfg.de_impl!r}; expected one of {TCI_DE_IMPLS}")
    dev = resolve_device(device)
    timer = timer if timer is not None else StageTimer(dev)
    f32 = cfg.de_impl == "cuda"
    t0 = time.time()
    rng = np.random.RandomState(cfg.seed)
    with timer.stage("cloud"):
        c_pts = companion.inverse_cloud(list(cfg.construct_ns), backend=cfg.cloud_backend,
                                        device=dev)
    with timer.stage("sample"):
        m_pts = mandelbrot.sample_boundary_quantile(
            cfg.domain, cfg.mandelbrot_grid, cfg.mandelbrot_samples, cfg.max_iter,
            cfg.escape_r, cfg.eps, rng, dtype=torch.float32 if f32 else torch.float64,
            impl=cfg.de_impl, device=dev)
    with timer.stage("match"):
        m_match, c_trim = entropic_argmax_match(
            c_pts, m_pts, cfg.sinkhorn_eps, rng, backend="torch",
            dtype=torch.float32 if f32 else None, device=dev)
        c_aligned = procrustes_align_no_scale(c_trim, m_match, convention="reference")

    # defensive metrics like the reference (tci_..._v002_fixed.py:129-145): a
    # metric that fails gives NaN, with a warning naming the failure; the
    # spectral distance over the full sample would need a dense 25000²
    # eigensolve, so a cloud above SPECTRAL_MAX_POINTS gives NaN up front
    with timer.stage("stats"):
        try:
            n = min(len(c_aligned), len(m_pts))
            c_sub = rng.choice(c_aligned, n, replace=False)
            m_sub = rng.choice(m_pts, n, replace=False)
            h0 = ps.hausdorff(c_sub, m_sub, device=dev)
            ecc_dt = torch.float32 if f32 else torch.float64
            curv_corr = float(np.corrcoef(
                curv.pca_eccentricity(c_sub, cfg.curvature_k, dtype=ecc_dt, device=dev),
                curv.pca_eccentricity(m_sub, cfg.curvature_k, dtype=ecc_dt, device=dev),
            )[0, 1])
        except (RuntimeError, ValueError, IndexError) as exc:
            warnings.warn(f"run_tci: Hausdorff/curvature failed ({exc!r}); NaN")
            h0, curv_corr = float("nan"), float("nan")
        dspec = float("nan")
        if max(len(c_aligned), len(m_pts)) <= SPECTRAL_MAX_POINTS:
            try:
                dspec = sp.spectral_distance(c_aligned, m_pts, cfg.spectral_k,
                                             cfg.spectral_sigma, device=dev)
            except (RuntimeError, ValueError) as exc:
                warnings.warn(f"run_tci: spectral distance failed ({exc!r}); NaN")

    with timer.stage("hist"):
        p_m = hg.to_prob(m_pts, cfg.grid_bins, cfg.domain, cfg.eps)
        x_c = hg.to_prob(c_aligned, cfg.grid_bins, cfg.domain, cfg.eps)
    with timer.stage("flow"):
        kls, traj = giflow.tci_flow(p_m, x_c, cfg.alpha, cfg.t_steps, cfg.eps)

    out = {
        "Hausdorff_before": float(h0),
        "Curvature_corr": curv_corr,
        "Spectral_L2": float(dspec),
        "KL_initial": float(kls[0]),
        "KL_final": float(kls[-1]),
        "runtime_sec": time.time() - t0,
    }
    if out_json:
        writers.write_json(out_json, out)
        prefix = out_json.rsplit(".", 1)[0]
        if plots:
            from cmtci_torch.io import plots as plot_io

            plot_io.plot_kl_descent(kls, f"{prefix}_KL_descent.png")
            plot_io.plot_field(traj[-1], cfg.domain, f"{prefix}_XT_final.png",
                               title="Final histogram X_T")
        writers.write_config_meta(f"{prefix}_meta.txt", cfg)
    return out, kls, traj
