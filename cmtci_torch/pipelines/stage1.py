"""Stage-1 cleaning pipeline (P6): builds the canonical file bus, on PyTorch.

Port of ``cmtci/pipelines/stage1.py``. Reference:
construct_stage1_clean.py:147-195 — cloud (n=2..maxN), DE band-threshold
boundary sample with d-weighted subsampling, PCA orientation features,
Sinkhorn-or-greedy matching on [features|coords], Procrustes, and the four
file-bus CSVs (construct_points / mandel_boundary_sample / construct_aligned
/ matches_indices) with meta.txt.

The cloud, the f64 DE field and the Sinkhorn plan run on `device`; the
reference pins the two f64 loops to the host CPU only because the TPU
emulates f64. The band thresholds and the d-weighted draws run in numpy on
the host from ``np.random.RandomState(cfg.seed)``, as in the reference, so
the bus equals the reference's file for file wherever the DE field and the
plan agree to well inside the thresholds and the plan's row gaps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cmtci_torch.io import plots as figures
from cmtci_torch.io import writers
from cmtci_torch.kernels import companion
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.transport.procrustes import procrustes_align_no_scale
from cmtci_torch.transport.sinkhorn import sinkhorn_log
from cmtci_torch.utils.artifacts import StageTimer
from cmtci_torch.utils.device import resolve_device

#: the DE grid's domain (construct_stage1_clean.py:60-80)
BAND_DOMAIN = (-2.25, 1.25, -1.25, 1.25)
#: Sinkhorn iterations, the POT default of the reference's ot.sinkhorn call
SINKHORN_ITERS = 1000


@dataclass
class Stage1Config:
    max_n: int = 40
    nx: int = 120
    ny: int = 80
    max_iter: int = 200
    bailout: float = 1e6
    threshold_low: float = 1e-6
    threshold_high: float = 1e-1
    boundary_samples: int = 600
    k_orientation: int = 8
    matcher: str = "sinkhorn"  # "sinkhorn" | "greedy"
    sinkhorn_reg: float = 1e-2
    seed: int = 0
    cloud_backend: str = "aberth"


def band_field(cfg: Stage1Config, device="cuda"):
    """(cr, ci, d): the grid nodes on the host and the stage-1 DE field, run
    in f64 on `device` and returned as a numpy array."""
    dev = resolve_device(device)
    xs = np.linspace(BAND_DOMAIN[0], BAND_DOMAIN[1], cfg.nx)
    ys = np.linspace(BAND_DOMAIN[2], BAND_DOMAIN[3], cfg.ny)
    cr, ci = np.meshgrid(xs, ys, indexing="xy")
    _, d = mb.de_field_stage1(torch.as_tensor(cr, device=dev), torch.as_tensor(ci, device=dev),
                              max_iter=cfg.max_iter, bailout=cfg.bailout)
    return cr, ci, d.cpu().numpy()


def sample_boundary_band(cfg: Stage1Config, rng, device="cuda") -> np.ndarray:
    """DE band-threshold sampler with d-weighted choice (stage1:60-80). The
    thresholds and the draws run on the host, on d as the device gave it."""
    cr, ci, d = band_field(cfg, device=device)
    keep = (d > cfg.threshold_low) & (d < cfg.threshold_high)
    cand = np.column_stack([cr[keep], ci[keep]])
    vals = d[keep]
    if len(cand) == 0:
        return np.empty((0, 2))
    if len(cand) <= cfg.boundary_samples:
        return cand
    probs = vals / vals.sum()
    idx = rng.choice(len(cand), size=cfg.boundary_samples, replace=False, p=probs)
    return cand[idx]


def orientation_features(x: np.ndarray, k: int = 8) -> np.ndarray:
    """Dominant local PCA direction per point (stage1:82-107), vectorized.
    numpy on the host: np.argsort breaks the distance ties as the reference
    does."""
    n = len(x)
    if n == 0:
        return np.zeros((0, 2))
    k = min(k, n)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    idxs = np.argsort(d2, axis=1)[:, 1 : k + 1] if k < n else np.argsort(d2, axis=1)[:, :k]
    neigh = x[idxs]  # (N,k,2)
    m = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", m, m)
    vals, vecs = np.linalg.eigh(cov)
    return vecs[:, :, -1]  # dominant eigenvector per point


def greedy_match(xa: np.ndarray, xb: np.ndarray) -> np.ndarray:
    """Nearest-neighbor matching in feature space (stage1:121-133)."""
    d2 = ((xa[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=1)


def feature_cost(xa: np.ndarray, xb: np.ndarray, device="cuda") -> torch.Tensor:
    """Raw euclidean cost between the [features|coords] rows of the two
    clouds, in f64 on `device` (the reference's ot.sinkhorn cost,
    construct_stage1_clean.py:110-116)."""
    dev = resolve_device(device)
    a = torch.as_tensor(xa, dtype=torch.float64, device=dev)
    b = torch.as_tensor(xb, dtype=torch.float64, device=dev)
    return torch.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))


def run_stage1(cfg: Stage1Config, outdir: str | None = None, plots: bool = True,
               device="cuda", timer: StageTimer | None = None):
    """Returns dict(C, M, C_aligned, matches); writes the file bus if outdir,
    and alignment.png too if `plots`. Stage times (cloud, band, match, align,
    write) go to `timer`, and inside match those of its parts: features (the
    host's orientation features), cost, sinkhorn (the loop) and argmax (the
    matches to the host; the Sinkhorn matcher only)."""
    dev = resolve_device(device)
    if outdir and plots:
        figures.pyplot()  # fail before the work when matplotlib is missing
    timer = timer if timer is not None else StageTimer(dev)
    rng = np.random.RandomState(cfg.seed)
    ns = list(range(2, cfg.max_n + 1))
    with timer.stage("cloud"):
        cz = companion.inverse_cloud(ns, "lucas_all_ones", tol=1e-12,
                                     backend=cfg.cloud_backend, device=dev)
        c = np.column_stack([cz.real, cz.imag])
    with timer.stage("band"):
        m = sample_boundary_band(cfg, rng, device=dev)

    with timer.stage("match"):
        with timer.stage("features"):
            f_c = orientation_features(c, cfg.k_orientation)
            f_m = orientation_features(m, cfg.k_orientation)
            xa = np.hstack([f_c, c])
            xb = np.hstack([f_m, m])
        if len(m) == 0:
            raise ValueError(
                "stage1: no boundary points in the DE band — adjust "
                "threshold_low/threshold_high/bailout (both matchers need a "
                "non-empty Mandelbrot sample)")
        if cfg.matcher == "sinkhorn":
            with timer.stage("cost"):
                cost = feature_cost(xa, xb, device=dev)
            with timer.stage("sinkhorn"):
                plan = sinkhorn_log(cost, iters=SINKHORN_ITERS, eps=cfg.sinkhorn_reg)
            with timer.stage("argmax"):
                matches = plan.argmax(dim=1).cpu().numpy()
        else:
            matches = greedy_match(xa, xb)

    with timer.stage("align"):
        cz_aligned = procrustes_align_no_scale(
            cz, m[matches][:, 0] + 1j * m[matches][:, 1], convention="fixed"
        )
        c_aligned = np.column_stack([cz_aligned.real, cz_aligned.imag])

    if outdir:
        with timer.stage("write"):
            writers.write_points_csv(f"{outdir}/construct_points.csv", c)
            writers.write_points_csv(f"{outdir}/mandel_boundary_sample.csv", m)
            writers.write_points_csv(f"{outdir}/construct_aligned.csv", c_aligned)
            writers.write_matches_csv(f"{outdir}/matches_indices.csv", matches)
            writers.write_config_meta(f"{outdir}/meta.txt", cfg)
            if plots:
                figures.plot_alignment(c, m, c_aligned, f"{outdir}/alignment.png")
    return {"C": c, "M": m, "C_aligned": c_aligned, "matches": matches}
