"""Procrustes alignment without scaling (S7).

Copy of ``cmtci/transport/procrustes.py`` (numpy only), with the
transport-plan-weighted variant.
Reference: tci_construct_mandelbrot_v002_fixed.py:73-78.

The reference takes svd(Y0^T X0) = U S V^T and applies R = U V^T to the
row-vector points, which is the INVERSE of the optimal rotation. The
checked-in v3_* oracle artifacts were produced with that convention, so
`convention="reference"` reproduces it exactly; `convention="fixed"` uses
the correct orthogonal-Procrustes rotation from svd(X0^T Y0).
"""

from __future__ import annotations

import numpy as np


def procrustes_align_no_scale(xc, yc, convention: str = "fixed", return_transform: bool = False):
    """Rotate+translate complex cloud xc onto yc (no scaling)."""
    x = np.column_stack([np.asarray(xc).real, np.asarray(xc).imag])
    y = np.column_stack([np.asarray(yc).real, np.asarray(yc).imag])
    x0 = x - x.mean(0)
    y0 = y - y.mean(0)
    if convention == "reference":
        u, _, vt = np.linalg.svd(y0.T @ x0, full_matrices=False)
    elif convention == "fixed":
        u, _, vt = np.linalg.svd(x0.T @ y0, full_matrices=False)
    else:
        raise ValueError(f"unknown convention '{convention}'")
    r = u @ vt
    aligned = (x0 @ r) + y.mean(0)
    out = aligned[:, 0] + 1j * aligned[:, 1]
    if return_transform:
        return out, r, y.mean(0) - x.mean(0) @ r
    return out


def procrustes_align_weighted(x, y, plan):
    """Transport-plan-weighted Procrustes (MandelBoundary.py intent).

    Weighted means by the plan marginals, cross-covariance C = X0^T G Y0,
    rotation R = U V^T from svd(C), aligned = X0 R + mean_Y. Returns
    (aligned (N,2), R)."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    g = np.asarray(plan, dtype=float)
    x_mean = np.average(x, axis=0, weights=g.sum(1))
    y_mean = np.average(y, axis=0, weights=g.sum(0))
    x0 = x - x_mean
    y0 = y - y_mean
    c = x0.T @ g @ y0
    u, _, vt = np.linalg.svd(c)
    r = u @ vt
    return x0 @ r + y_mean, r
