"""Boundary curvature estimators (port of ``cmtci/stats/curvature.py``).

  * the local-polynomial paper estimator (±m window, signed local
    arclength, quadratic least squares in x(s), y(s), κ =
    |x'y''-y'x''|/speed³; boundary_curvature_localpoly.py:65-184): one
    batched windowed gather and a closed-form 3x3 normal-equation solve, in
    f64 on a device (the reference pins this f64 work to the host because
    the TPU emulates f64);
  * the quick gradient estimator (spatial_stats_phase3.py:18-25);
  * the PCA-eccentricity proxy, the kNN covariance λ_min/Σλ of
    tci_construct_mandelbrot_v002_fixed.py:100-108.

For the PCA proxy the upstream script queries a KDTree per point; here, as
in ``cmtci``, it is a dense top-k over row blocks (O(chunk·N) memory). The k nearest neighbours
(self included) are the reference's ``lax.top_k`` choice: ascending squared
distance, equal distances broken by the lower index. That matters on the
Mandelbrot sample, whose points are grid nodes with many equal distances.
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device


def _solve3(m, b):
    """Batched 3x3 linear solve by cofactor expansion. m: (N,3,3), b: (N,3)."""
    a00, a01, a02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    a10, a11, a12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    a20, a21, a22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    x0 = (c00 * b[:, 0] + c10 * b[:, 1] + c20 * b[:, 2]) / det
    x1 = (c01 * b[:, 0] + c11 * b[:, 1] + c21 * b[:, 2]) / det
    x2 = (c02 * b[:, 0] + c12 * b[:, 1] + c22 * b[:, 2]) / det
    return torch.stack([x0, x1, x2], dim=-1)


def _window_indices(n: int, m: int, closed: bool):
    offs = np.arange(-m, m + 1)
    idx = np.arange(n)[:, None] + offs[None, :]
    if closed:
        return idx % n
    return np.clip(idx, 0, n - 1)


def _localpoly_core(xy_win, m: int):
    """xy_win: (N, 2m+1, 2) windowed points; returns curvature fields."""
    mid = m
    seg = torch.sqrt(((xy_win[:, 1:, :] - xy_win[:, :-1, :]) ** 2).sum(dim=-1))  # (N, 2m)
    # signed arclength with s=0 at the window center
    cum = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, dim=1)], dim=1)
    s = cum - cum[:, mid : mid + 1]  # (N, 2m+1)

    ones = torch.ones_like(s)
    a = torch.stack([ones, s, s * s], dim=-1)  # (N, W, 3)
    ata = torch.einsum("nwi,nwj->nij", a, a)
    atx = torch.einsum("nwi,nw->ni", a, xy_win[..., 0])
    aty = torch.einsum("nwi,nw->ni", a, xy_win[..., 1])
    cx = _solve3(ata, atx)
    cy = _solve3(ata, aty)

    x1, x2 = cx[:, 1], 2.0 * cx[:, 2]
    y1, y2 = cy[:, 1], 2.0 * cy[:, 2]
    cross = x1 * y2 - y1 * x2
    speed = torch.sqrt(x1 * x1 + y1 * y1) + 1e-16
    kappa_signed = cross / speed**3
    return torch.abs(kappa_signed), kappa_signed, speed, x1, y1, x2, y2


def localpoly_curvature(p, neighbors: int = 7, closed: bool = True, device="cuda"):
    """Paper curvature estimator in f64 on `device`. Returns numpy (kappa,
    kappa_signed, speed, aux).

    Matches boundary_curvature_localpoly.py:133-184 (stride=1); the
    quadratic fit solves the normal equations in closed form (Cramer), as
    the reference does, with no guard on a small determinant.
    """
    dev = resolve_device(device)
    p = np.asarray(p, dtype=float)
    n = p.shape[0]
    m = int(neighbors)
    if m < 2:
        raise ValueError("neighbors must be >= 2 for a meaningful quadratic fit.")
    if n < 2 * m + 1:
        raise ValueError(f"Need at least {2*m+1} points; got {n}.")
    idx = torch.as_tensor(_window_indices(n, m, closed), device=dev)
    xy = torch.as_tensor(p, dtype=torch.float64, device=dev)
    out = torch.stack(_localpoly_core(xy[idx], m)).cpu().numpy()
    kappa, ks, speed, x1, y1, x2, y2 = out
    aux = dict(xprime=x1, yprime=y1, x2=x2, y2=y2)
    return kappa, ks, speed, aux


def _gradient(f):
    """np.gradient of a 1-D tensor with unit spacing: central differences
    inside, one-sided at the two ends."""
    return torch.cat([f[1:2] - f[:1], (f[2:] - f[:-2]) / 2.0, f[-1:] - f[-2:-1]])


def gradient_curvature(p, device="cuda"):
    """np.gradient-based estimator (spatial_stats_phase3.py:18-25) in f64 on
    `device`; returns a numpy array."""
    p = torch.as_tensor(np.asarray(p, dtype=float), device=resolve_device(device))
    dx = _gradient(p[:, 0])
    dy = _gradient(p[:, 1])
    ddx = _gradient(dx)
    ddy = _gradient(dy)
    return (torch.abs(dx * ddy - dy * ddx) / (dx**2 + dy**2) ** 1.5).cpu().numpy()


def _knn_indices(d2, k: int):
    """(rows, k) indices of the k smallest entries of each row of d2, ordered
    by ascending value with ties to the lower index (``lax.top_k(-d2, k)``).
    torch.topk gives the k-th value; which of the tied entries at that value
    are taken is then decided by index, not left to topk."""
    kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]
    below = d2 < kth
    tie = d2 == kth
    room = k - below.sum(dim=1, keepdim=True)
    take = below | (tie & (torch.cumsum(tie.to(torch.int32), dim=1) <= room))
    idx = take.nonzero()[:, 1].view(-1, k)  # ascending index within each row
    order = torch.sort(torch.gather(d2, 1, idx), dim=1, stable=True).indices
    return torch.gather(idx, 1, order)


def pca_eccentricity(pts, k: int = 6, dtype=torch.float64, device="cuda",
                     chunk: int = 2048):
    """λ_min/Σλ of the covariance of each point's k nearest neighbours (self
    included), in `dtype` on `device`; returns a numpy array. The 2x2
    eigenvalues are the closed form m ± sqrt(((a-d)/2)² + b²)."""
    dev = resolve_device(device)
    xy = torch.as_tensor(_xy(pts), dtype=dtype, device=dev)
    n = xy.shape[0]
    out = torch.empty(n, dtype=dtype, device=dev)
    tiny = xy.new_tensor(1e-300 if dtype == torch.float64 else 1e-30)
    for i in range(0, n, chunk):
        blk = xy[i : i + chunk]
        dx = blk[:, 0, None] - xy[None, :, 0]
        dy = blk[:, 1, None] - xy[None, :, 1]
        neigh = xy[_knn_indices(dx * dx + dy * dy, int(k))]  # (rows, k, 2)
        z = neigh - neigh.mean(dim=1, keepdim=True)
        cov = torch.einsum("nki,nkj->nij", z, z) / (k - 1)
        a, b, d = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
        m = 0.5 * (a + d)
        s = torch.sqrt(torch.clamp(0.25 * (a - d) ** 2 + b * b, min=0.0))
        out[i : i + chunk] = (m - s) / torch.maximum(a + d, tiny)
    return out.cpu().numpy()
