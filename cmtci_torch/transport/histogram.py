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
  * gaussian_kernel1d / gaussian_filter_nearest: scipy.ndimage's Gaussian
    filter with mode="nearest", bitwise on the host (the coupling pipeline's
    f64 smoothing), and _sep_correlate_nearest, the same expression tree in
    torch for its f32 diagnostics on the card

The histograms are O(bins²) host work between device stages; they stay in
numpy, so the parity rows depend on no device reduction order.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


def gaussian_kernel1d(sigma: float, truncate: float = 4.0):
    """scipy.ndimage gaussian kernel (order 0), bitwise-exact weights.

    Uses scipy's exact expression tree exp(-0.5/sigma**2 * x**2) — the
    algebraically-equal exp(-0.5*(x/sigma)**2) differs in the last ulp.
    """
    radius = int(truncate * float(sigma) + 0.5)
    sigma2 = float(sigma) * float(sigma)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 / sigma2 * x**2)
    return k / k.sum()


def _corr1_np(a, kernel, radius: int):
    """One numpy correlation pass along axis 0, scipy's expression tree."""
    ap = np.concatenate(
        [np.repeat(a[:1], radius, axis=0), a, np.repeat(a[-1:], radius, axis=0)], axis=0
    )
    n = a.shape[0]
    out = kernel[radius] * a
    for k in range(radius, 0, -1):  # scipy iterates pairs outermost-first
        out += kernel[radius + k] * (ap[radius - k : radius - k + n]
                                     + ap[radius + k : radius + k + n])
    return out


def gaussian_filter_nearest(h, sigma: float, truncate: float = 4.0):
    """scipy.ndimage.gaussian_filter(h, sigma, mode='nearest'), bitwise, on
    the host.

    scipy correlates with the reversed kernel; a symmetric Gaussian makes
    correlation equal to convolution, and the symmetric-pair summation order
    (w[mid]*x + sum_k w[mid+k]*(x[-k]+x[+k]), k descending) is scipy's C
    kernel's; numpy evaluates that expression tree without FMA contraction,
    so the result equals scipy's to the last bit.
    """
    kernel_np = gaussian_kernel1d(sigma, truncate)
    radius = (len(kernel_np) - 1) // 2
    a = np.asarray(h, dtype=float)
    return _corr1_np(_corr1_np(a, kernel_np, radius).T, kernel_np, radius).T


def _sep_correlate_nearest(h: torch.Tensor, kernel: torch.Tensor, radius: int):
    """gaussian_filter_nearest's expression tree in torch, in h's dtype on
    h's device: along axis 0, then along axis 1, each pass
    w[mid]*x[i] + sum_{k=r..1} w[mid+k]*(x[i-k] + x[i+k]) with k descending
    (outermost pair first) and the edge rows repeated ('nearest').
    `kernel` is gaussian_kernel1d's weights as a tensor of h's dtype."""

    def corr1(a):  # along axis 0
        ap = torch.cat([a[:1].expand(radius, -1), a, a[-1:].expand(radius, -1)], dim=0)
        n = a.shape[0]
        out = kernel[radius] * a
        for k in range(radius, 0, -1):
            out = out + kernel[radius + k] * (ap[radius - k : radius - k + n]
                                              + ap[radius + k : radius + k + n])
        return out

    return corr1(corr1(h).T).T


def mollified_histogram(cloud, bins: int, domain, sigma_bins: float, eps: float = 1e-12,
                        mesh=None):
    """gi_assumption_tracker_v3.py:109-125 semantics, on the host. With a
    `mesh` the counts are binned point-sharded over its ranks and summed
    (parallel.sharded.sharded_histogram): the counts are integers, so the
    result is bitwise the single-device one; the mollifier runs on the host
    of every rank."""
    from scipy.ndimage import gaussian_filter

    cloud = np.asarray(cloud)
    if mesh is not None:
        from cmtci_torch.parallel.sharded import sharded_histogram

        h = sharded_histogram(cloud.real.ravel(), cloud.imag.ravel(), bins, domain,
                              mesh).cpu().numpy().astype(float)
    else:
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
