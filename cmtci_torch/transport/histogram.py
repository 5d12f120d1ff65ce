"""2D histograms, mollification, and distribution distances (S9).

Port of the host path of ``cmtci/transport/histogram.py``
(``mollified_histogram(host_numpy=True)``), which is bitwise equal to the
reference's numpy/scipy expressions:
  * mollified_histogram: histogram2d over a fixed domain, floor at eps,
    scipy gaussian_filter(sigma_bins, mode="nearest"), re-floor, normalize —
    gi_assumption_tracker_v3.py:109-125
  * KL with clip, TV = 0.5*sum|p-q|, overlap = sum min(p,q), fraction
    outside the domain — gi_assumption_tracker_v3.py:93-106
  * to_prob: the unmollified probability histogram of the TCI flow —
    tci_construct_mandelbrot_v002_fixed.py:80-84

The histograms are O(bins²) host work between device stages; they stay in
numpy, so the parity rows depend on no device reduction order.
"""

from __future__ import annotations

import math

import numpy as np


def np_edges(bins: int, domain):
    """np.histogram2d's exact bin edges (np.linspace: DE-grid nodes sit ON
    edges, and another linspace formula moves them by an ulp)."""
    xmin, xmax, ymin, ymax = domain
    return np.linspace(xmin, xmax, bins + 1), np.linspace(ymin, ymax, bins + 1)


def _histogram2d_np(x, y, bins: int, domain):
    """np.histogram2d semantics: interior edges right-inclusive via
    searchsorted, rightmost edge inclusive, out-of-range dropped."""
    xmin, xmax, ymin, ymax = domain
    xedges, yedges = np_edges(bins, domain)
    ix = np.searchsorted(xedges, x, side="right") - 1
    iy = np.searchsorted(yedges, y, side="right") - 1
    ix = np.where(x == xmax, bins - 1, ix)
    iy = np.where(y == ymax, bins - 1, iy)
    ok = (ix >= 0) & (ix < bins) & (iy >= 0) & (iy < bins)
    flat = ix[ok] * bins + iy[ok]
    return np.bincount(flat, minlength=bins * bins).astype(float).reshape(bins, bins)


def mollified_histogram(cloud, bins: int, domain, sigma_bins: float, eps: float = 1e-12):
    """gi_assumption_tracker_v3.py:109-125 semantics, on the host."""
    from scipy.ndimage import gaussian_filter

    cloud = np.asarray(cloud)
    h = _histogram2d_np(cloud.real.ravel(), cloud.imag.ravel(), bins, domain)
    h = np.maximum(h, eps)
    if sigma_bins and sigma_bins > 0:
        h = gaussian_filter(h, float(sigma_bins), mode="nearest")
        h = np.maximum(h, eps)
    return h / h.sum()


def to_prob(cloud, bins: int, domain, eps: float = 1e-12):
    """Probability histogram of a complex cloud (tci_..._v002_fixed.py:80-84):
    histogram2d counts over the fixed domain, floor at eps, normalize."""
    cloud = np.asarray(cloud)
    h = _histogram2d_np(cloud.real.ravel(), cloud.imag.ravel(), bins, domain)
    h = np.maximum(h, eps)
    return h / h.sum()


def kl(p, x, eps: float = 1e-12):
    """KL(P||X) with clipping (tci_..._v002_fixed.py:86-88)."""
    p = np.clip(np.asarray(p), eps, None)
    x = np.clip(np.asarray(x), eps, None)
    return float(np.sum(p * (np.log(p) - np.log(x))))


def tv_distance(p, q) -> float:
    return 0.5 * float(np.sum(np.abs(np.asarray(p) - np.asarray(q))))


def overlap_mass(p, q) -> float:
    return float(np.sum(np.minimum(np.asarray(p), np.asarray(q))))


def pinsker_bound(delta: float) -> float:
    return math.sqrt(0.5 * float(delta))


def fraction_outside_domain(cloud, domain) -> float:
    xmin, xmax, ymin, ymax = domain
    cloud = np.asarray(cloud)
    x, y = cloud.real, cloud.imag
    inside = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    return float(1.0 - np.mean(inside))
