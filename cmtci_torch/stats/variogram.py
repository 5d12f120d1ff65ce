"""Empirical semivariograms and cross-variograms of grid fields, model fits,
detrending (the variogram pipeline's subset of ``cmtci/stats/variogram.py``).

Reference behaviour:
  * grid-field semivariogram: subsample <= 15k pixels, all-pairs binned mean
    of 0.5*(dV)^2 (variograms_construct_mandelbrot.py:178-252)
  * cross-semivariogram with two independent location subsamples (:254-315)
  * range-at-90% estimator (Iterative_Variogram_Laplacian.py:88-100)
  * exponential model fit by 200-round coordinate search
    (variograms_construct_mandelbrotv2.py:206-235)
  * total-degree-2 polynomial detrend (:179-204)

As in ``cmtci``, every pair is used (the reference scripts cap each bin at
max_pairs_per_bin pairs chosen in chunk order, which only bounds CPU cost).

The binning is one function for both dtypes, on the device the caller
names: per block of rows, the bin of each pair is found with
``torch.bucketize`` (bin k holds edges[k] <= d < edges[k+1], the reference's
searchsorted(side="right") - 1) and the per-bin counts and sums with
``torch.bincount``. Counts are exact int64. The squared differences are
computed in the working dtype and summed per bin in f64, so an f32 run
carries the rounding of each (dV)^2 but no accumulation error. On a CUDA
device bincount adds with atomics, so a sum may differ between two runs in
its last bits (about 1e-16 relative); the counts cannot. The reference's
second, scatter-free form of the same function (cumulative masked
reductions, an int32 (hi, lo) count spill, bitcast-packed fetches) exists
because TPU scatter-adds serialize; it has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.utils.device import resolve_device


def masked_bin_reduce(d, valid, edges, nbins: int, dvv=None):
    """Per-bin pair reductions shared by the variogram and shell-count
    scans: int64 counts of the pairs with `valid` set whose distance d lies
    in [edges[k], edges[k+1]) for k < nbins, and, with `dvv`, also the f64
    per-bin sums of dvv over the same pairs. d, valid and dvv have one shape;
    edges is an ascending (nbins + 1,) tensor of d's dtype. Returns counts, or
    (sums, counts)."""
    b = torch.bucketize(d, edges, right=True) - 1
    ok = valid & (b >= 0) & (b < nbins)
    # pairs outside every bin go to one spill slot past the last bin
    b = torch.where(ok, b, nbins).reshape(-1)
    counts = torch.bincount(b, minlength=nbins + 1)[:nbins]
    if dvv is None:
        return counts
    sums = torch.bincount(b, weights=dvv.reshape(-1).to(torch.float64),
                          minlength=nbins + 1)[:nbins]
    return sums, counts


def _binned_sq_diff(c1, v1, c2, v2, edges, nbins: int, chunk: int, upper: bool):
    """Per-bin (f64 sum, int64 count) of (v1_i - v2_j)^2 over pairs, blocked
    over i, on the tensors' device and in their dtype.

    upper=True restricts to j > i (same-set semivariogram, no diagonal);
    upper=False uses all (i, j) pairs (cross-variogram).
    """
    sums = torch.zeros(nbins, dtype=torch.float64, device=c1.device)
    counts = torch.zeros(nbins, dtype=torch.int64, device=c1.device)
    cols = torch.arange(c2.shape[0], device=c1.device)
    for i in range(0, c1.shape[0], chunk):
        blk_c, blk_v = c1[i : i + chunk], v1[i : i + chunk]
        dx = blk_c[:, 0, None] - c2[None, :, 0]
        dy = blk_c[:, 1, None] - c2[None, :, 1]
        d = torch.sqrt(dx * dx + dy * dy)
        dv = blk_v[:, None] - v2[None, :]
        if upper:
            rows = torch.arange(i, i + blk_c.shape[0], device=c1.device)
            valid = cols[None, :] > rows[:, None]
        else:
            valid = torch.ones_like(d, dtype=torch.bool)
        s, n = masked_bin_reduce(d, valid, edges, nbins, dvv=dv * dv)
        sums += s
        counts += n
    return sums, counts


def _gamma(sums: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """0.5 * mean squared difference per bin; 0 where a bin is empty."""
    gamma = np.zeros(len(counts))
    nz = counts > 0
    gamma[nz] = 0.5 * sums[nz] / counts[nz]
    return gamma


def _binned_gamma(c1, v1, c2, v2, r_bins, chunk, upper, dtype, device):
    """(r_centers, gamma, counts) of one binning of host arrays, run in
    `dtype` on `device`."""
    dev = resolve_device(device)
    r_bins = np.asarray(r_bins, dtype=float)
    c1, v1, c2, v2 = (torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
                      for a in (c1, v1, c2, v2))
    edges = torch.as_tensor(r_bins, dtype=dtype, device=dev)
    sums, counts = _binned_sq_diff(c1, v1, c2, v2, edges, len(r_bins) - 1, chunk, upper)
    counts = counts.cpu().numpy()
    return 0.5 * (r_bins[:-1] + r_bins[1:]), _gamma(sums.cpu().numpy(), counts), counts


def _grid_samples(gx, gy):
    return np.column_stack([np.asarray(gx).ravel(), np.asarray(gy).ravel()])


def grid_semivariogram(field, gx, gy, r_bins, m_target: int = 15000, rng=None,
                       chunk: int = 1024, dtype=torch.float64, device="cuda"):
    """Isotropic empirical semivariogram of a grid field
    (variograms_construct_mandelbrot.py:178-252, without the per-bin pair
    cap). m_target locations are drawn without replacement from `rng` (a
    np.random.RandomState; the global numpy stream when None) on the host;
    the all-pairs binning runs in `dtype` on `device`. Returns (r_centers,
    gamma, counts)."""
    coords = _grid_samples(gx, gy)
    vals = np.asarray(field).ravel()
    r = rng if rng is not None else np.random
    idx = r.choice(coords.shape[0], size=min(m_target, coords.shape[0]), replace=False)
    return _binned_gamma(coords[idx], vals[idx], coords[idx], vals[idx], r_bins, chunk,
                         True, dtype, device)


def cross_semivariogram(field1, field2, gx, gy, r_bins, m_target: int = 15000, rng=None,
                        chunk: int = 1024, dtype=torch.float64, device="cuda"):
    """Cross-semivariogram with two independent location subsamples
    (variograms_construct_mandelbrot.py:254-315): every pair (i of the first
    subsample, j of the second). Returns (r_centers, gamma, counts)."""
    coords = _grid_samples(gx, gy)
    v1 = np.asarray(field1).ravel()
    v2 = np.asarray(field2).ravel()
    r = rng if rng is not None else np.random
    m = min(m_target, coords.shape[0])
    i1 = r.choice(coords.shape[0], size=m, replace=False)
    i2 = r.choice(coords.shape[0], size=m, replace=False)
    return _binned_gamma(coords[i1], v1[i1], coords[i2], v2[i2], r_bins, chunk, False,
                         dtype, device)


def three_semivariograms(field_c, field_m, gx, gy, r_bins, m_target: int = 15000,
                         rng=None, chunk: int = 1024, dtype=torch.float64, device="cuda"):
    """(gamma_C, gamma_M, gamma_cross) of the variogram pipeline. The four
    location subsamples are drawn from `rng` in the reference's order
    (idx_C, idx_M, i1, i2), so the same RandomState gives the reference's
    locations. Returns (r_centers, gamma_c, gamma_m, gamma_x, counts_c,
    counts_m, counts_x)."""
    r_c, g_c, n_c = grid_semivariogram(field_c, gx, gy, r_bins, m_target, rng, chunk,
                                       dtype, device)
    _, g_m, n_m = grid_semivariogram(field_m, gx, gy, r_bins, m_target, rng, chunk,
                                     dtype, device)
    _, g_x, n_x = cross_semivariogram(field_c, field_m, gx, gy, r_bins, m_target, rng,
                                      chunk, dtype, device)
    return r_c, g_c, g_m, g_x, n_c, n_m, n_x


def variogram_range(lags, gamma, pct: float = 0.9):
    """First lag where gamma >= pct*max (Iterative_Variogram_Laplacian.py:88-100)."""
    finite = np.isfinite(gamma)
    if not finite.any():
        return None
    thr = pct * np.nanmax(gamma)
    for lag, g in zip(lags, gamma):
        if np.isfinite(g) and g >= thr:
            return lag
    return lags[-1]


def fit_exponential_variogram(r, gamma, rounds: int = 200):
    """nugget + sill*(1-exp(-r/a)) by coordinate search (v2:206-235)."""
    r = np.asarray(r, dtype=float)
    g_in = np.asarray(gamma, dtype=float)
    m = np.isfinite(r) & np.isfinite(g_in) & (r > 0)
    if m.sum() < 5:
        return {"nugget": np.nan, "sill": np.nan, "a": np.nan, "model": None}
    r, g = r[m], g_in[m]
    params = np.array([max(0.0, g.min()), max(1e-9, g.max() - g.min()), 0.5])

    def model(p, rr):
        return p[0] + p[1] * (1.0 - np.exp(-rr / max(1e-6, p[2])))

    def loss(p):
        return np.sum((g - model(p, r)) ** 2)

    for _ in range(rounds):
        for j in range(3):
            step = 0.05 * (1.0 if j < 2 else max(0.1, params[2]))
            for s in (+1, -1):
                cand = params.copy()
                cand[j] += s * step
                if loss(cand) < loss(params):
                    params = cand
    nug, sil, a = params
    return {"nugget": float(nug), "sill": float(sil), "a": float(a),
            "model": lambda rr: nug + sil * (1.0 - np.exp(-rr / max(1e-6, a)))}


def detrend_poly2d(field, gx, gy, deg: int = 2):
    """Total-degree-deg polynomial detrend (v2:179-204). Returns (resid, fit)."""
    field = np.asarray(field)
    x = np.asarray(gx).ravel()
    y = np.asarray(gy).ravel()
    powers = [(i, j) for i in range(deg + 1) for j in range(deg + 1 - i)]
    phi = np.column_stack([(x**i) * (y**j) for (i, j) in powers])
    coef, *_ = np.linalg.lstsq(phi, field.ravel(), rcond=None)
    fit = (phi @ coef).reshape(field.shape)
    return field - fit, fit
