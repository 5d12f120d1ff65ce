"""Empirical semivariograms and cross-variograms of grid fields and point
clouds, model fits, detrending (port of ``cmtci/stats/variogram.py``).

Reference behaviour:
  * grid-field semivariogram: subsample <= 15k pixels, all-pairs binned mean
    of 0.5*(dV)^2 (variograms_construct_mandelbrot.py:178-252)
  * cross-semivariogram with two independent location subsamples (:254-315)
  * range-at-90% estimator (Iterative_Variogram_Laplacian.py:88-100)
  * exponential model fit by 200-round coordinate search
    (variograms_construct_mandelbrotv2.py:206-235)
  * total-degree-2 polynomial detrend (:179-204)
  * the coupling loop's point variogram over all pairs of a cloud and the
    matched-pair cross-variogram (Iterative_Variogram_Laplacian.py:53-87,
    Variogram-Mandelbrot-Construct.py:155-178)

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


def _binned_sq_diff(c1, v1, c2, v2, edges, nbins: int, chunk: int, upper: bool,
                    row0: int = 0):
    """Per-bin (f64 sum, int64 count) of (v1_i - v2_j)^2 over pairs, blocked
    over i, on the tensors' device and in their dtype.

    upper=True restricts to j > row0 + i (same-set semivariogram, no
    diagonal; row0 is the index of c1's first row in the set, for a block of
    rows); upper=False uses all (i, j) pairs (cross-variogram).
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
            rows = torch.arange(row0 + i, row0 + i + blk_c.shape[0], device=c1.device)
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
                         rng=None, chunk: int = 1024, dtype=torch.float64, device="cuda",
                         mesh=None):
    """(gamma_C, gamma_M, gamma_cross) of the variogram pipeline. The four
    location subsamples are drawn from `rng` in the reference's order
    (idx_C, idx_M, i1, i2), so the same RandomState gives the reference's
    locations. With a `mesh` the three binnings shard their i-rows over its
    ranks (parallel.sharded.sharded_binned_sq_diff: counts exactly the
    single-device ones, f64 sums reduced over the ranks). Returns
    (r_centers, gamma_c, gamma_m, gamma_x, counts_c, counts_m, counts_x)."""
    if mesh is not None:
        from cmtci_torch.parallel.sharded import sharded_binned_sq_diff

        coords = _grid_samples(gx, gy)
        vc, vm = np.asarray(field_c).ravel(), np.asarray(field_m).ravel()
        r = rng if rng is not None else np.random
        m = min(m_target, coords.shape[0])
        idx_c, idx_m, i1, i2 = (r.choice(coords.shape[0], size=m, replace=False)
                                for _ in range(4))
        out = [sharded_binned_sq_diff(coords[a], v1[a], coords[b], v2[b], r_bins, mesh,
                                      upper=up, chunk=chunk, dtype=dtype)
               for a, v1, b, v2, up in ((idx_c, vc, idx_c, vc, True),
                                        (idx_m, vm, idx_m, vm, True),
                                        (i1, vc, i2, vm, False))]
        r_bins = np.asarray(r_bins, dtype=float)
        return (0.5 * (r_bins[:-1] + r_bins[1:]), *(_gamma(s, n) for s, n in out),
                *(n for _, n in out))
    r_c, g_c, n_c = grid_semivariogram(field_c, gx, gy, r_bins, m_target, rng, chunk,
                                       dtype, device)
    _, g_m, n_m = grid_semivariogram(field_m, gx, gy, r_bins, m_target, rng, chunk,
                                     dtype, device)
    _, g_x, n_x = cross_semivariogram(field_c, field_m, gx, gy, r_bins, m_target, rng,
                                      chunk, dtype, device)
    return r_c, g_c, g_m, g_x, n_c, n_m, n_x


_TRIU_CACHE: dict = {}


def _triu_pairs(n: int):
    """Cached np.triu_indices(n, k=1): the coupling loop asks for the same
    pairs every iteration; one entry is kept, and only up to about 4M pairs
    (64 MB of int64 indices), so one large call pins nothing for the life of
    the process."""
    hit = _TRIU_CACHE.get(n)
    if hit is None:
        pairs = np.triu_indices(n, k=1)
        if n * (n - 1) // 2 <= 4_000_000:
            _TRIU_CACHE.clear()
            _TRIU_CACHE[n] = pairs
        return pairs
    return hit


def point_variogram(locs, values=None, max_dist=None, nbins: int = 50):
    """pdist-style variogram on the host in f64 (Iterative_Variogram_Laplacian.py:53-87).

    values=None uses squared pairwise distances as the 'field difference'
    (the reference's coords-only variant). Returns (centers, gamma, counts).
    The coupling nudge reads its range, so it stays bitwise the reference's.
    """
    locs = np.asarray(locs, dtype=float)
    n = len(locs)
    i, j = _triu_pairs(n)
    d = np.linalg.norm(locs[i] - locs[j], axis=1)
    sq = d**2 if values is None else (np.asarray(values)[i] - np.asarray(values)[j]) ** 2
    if max_dist is None:
        max_dist = 0.5 * d.max() if d.size else 1.0
    bins = np.linspace(0, max_dist, nbins + 1)
    centers = 0.5 * (bins[:-1] + bins[1:])
    gamma = np.full(nbins, np.nan)
    counts = np.zeros(nbins, dtype=int)
    which = np.digitize(d, bins) - 1
    # one stable sort instead of nbins boolean scans: a stable sort keeps
    # ascending index order inside each bin, so np.mean sees the same values
    # in the same order as a masked loop would
    order = np.argsort(which, kind="stable")
    ws = which[order]
    sq_sorted = sq[order]
    starts = np.searchsorted(ws, np.arange(nbins), side="left")
    stops = np.searchsorted(ws, np.arange(nbins), side="right")
    for k in range(nbins):
        lo, hi = starts[k], stops[k]
        if hi > lo:
            gamma[k] = 0.5 * np.mean(sq_sorted[lo:hi])
            counts[k] = hi - lo
    return centers, gamma, counts


def point_variogram_device(locs, values=None, max_dist=None, nbins: int = 50,
                           chunk: int = 1024, dtype=torch.float64, device="cuda"):
    """point_variogram's binning of all pairs i < j in `dtype` on `device`
    (Iterative_Variogram_Laplacian.py:53-87), blocked over rows through
    masked_bin_reduce: bin k holds edges[k] <= d < edges[k+1], and
    d == edges[-1] is dropped, as np.digitize(..) - 1 does. With
    max_dist=None the range is 0.5 x the largest pair distance, found in a
    first pass in `dtype`; the edges are a linspace in `dtype`. Counts are
    exact int64, so there is no pair-count ceiling (the reference's int32
    guard, guard_pair_count_int32, has no counterpart); the sums are f64.
    Returns (centers, gamma, counts) as f64 / int64 numpy arrays."""
    return _point_variogram_rows(locs, values, max_dist, nbins, chunk, dtype,
                                 resolve_device(device))


def _point_variogram_rows(locs, values, max_dist, nbins: int, chunk: int, dtype, dev,
                          rows=None, combine=None):
    """point_variogram_device over the pairs whose first index lies in
    rows = (lo, hi) (default: all rows). `combine` (default: none) merges the
    partial results of the other row ranges: combine("max", t) and
    combine("sum", t) return the maximum and the sum of a tensor over them."""
    locs = np.asarray(locs, dtype=float)
    n = len(locs)
    if n < 2:
        centers = np.linspace(0, max_dist or 1.0, nbins + 1)
        centers = 0.5 * (centers[:-1] + centers[1:])
        return centers, np.full(nbins, np.nan), np.zeros(nbins, dtype=int)
    lo, hi = (0, n) if rows is None else rows
    combine = combine or (lambda op, t: t)
    xy = torch.as_tensor(locs, dtype=dtype, device=dev)
    vals = None if values is None else torch.as_tensor(np.asarray(values), dtype=dtype,
                                                       device=dev)
    cols = torch.arange(n, device=dev)

    def blocks():
        for i in range(lo, hi, chunk):
            blk = xy[i : min(i + chunk, hi)]
            dx = blk[:, 0, None] - xy[None, :, 0]
            dy = blk[:, 1, None] - xy[None, :, 1]
            r = torch.arange(i, i + blk.shape[0], device=dev)
            yield i, torch.sqrt(dx * dx + dy * dy), cols[None, :] > r[:, None]

    if max_dist is None:  # the largest d is a value of `dtype`; halving it is exact
        big = torch.full((), float("-inf"), dtype=dtype, device=dev)
        for _, d, valid in blocks():
            big = torch.maximum(big, torch.where(valid, d, float("-inf")).max())
        max_dist = 0.5 * float(combine("max", big))
    edges = torch.linspace(0.0, max_dist, nbins + 1, dtype=dtype, device=dev)
    sums = torch.zeros(nbins, dtype=torch.float64, device=dev)
    counts = torch.zeros(nbins, dtype=torch.int64, device=dev)
    for i, d, valid in blocks():
        if vals is None:
            dv2 = d * d
        else:
            dv = vals[i : i + d.shape[0], None] - vals[None, :]
            dv2 = dv * dv
        s, c = masked_bin_reduce(d, valid, edges, nbins, dvv=dv2)
        sums += s
        counts += c
    counts = combine("sum", counts).cpu().numpy()
    sums = combine("sum", sums).cpu().numpy()
    gamma = np.full(nbins, np.nan)
    nz = counts > 0
    gamma[nz] = 0.5 * sums[nz] / counts[nz]
    centers = (0.5 * (edges[:-1] + edges[1:])).cpu().numpy().astype(np.float64)
    return centers, gamma, counts


def cross_variogram_from_matches(c, m, construct_idx, mandel_idx, nbins: int = 50,
                                 max_dist=None):
    """Matched-pair cross-variogram (Variogram-Mandelbrot-Construct.py:155-178).

    Lag = |C[ci] - M[mi]| per matched pair; semivariance = 0.5*mean(|d|²) per
    lag bin (the reference's matched-pair cross-plot statistic).
    Returns (centers, gamma, counts).
    """
    construct_idx = np.asarray(construct_idx, dtype=int)
    mandel_idx = np.asarray(mandel_idx, dtype=int)
    if len(construct_idx) == 0:
        return np.array([]), np.array([]), np.array([])
    diffs = np.asarray(c)[construct_idx] - np.asarray(m)[mandel_idx]
    mags = np.linalg.norm(diffs, axis=1)
    sq = np.sum(diffs**2, axis=1)
    if max_dist is None:
        max_dist = mags.max() if mags.size else 1.0
    bins = np.linspace(0.0, max_dist, nbins + 1)
    centers = 0.5 * (bins[:-1] + bins[1:])
    gamma = np.full(nbins, np.nan)
    counts = np.zeros(nbins, dtype=int)
    inds = np.digitize(mags, bins) - 1
    for k in range(nbins):
        mask = inds == k
        if mask.any():
            gamma[k] = 0.5 * np.mean(sq[mask])
            counts[k] = mask.sum()
    return centers, gamma, counts


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
