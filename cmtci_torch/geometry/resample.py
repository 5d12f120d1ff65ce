"""Arclength densification / resampling of boundary polylines.

Copy of ``cmtci/geometry/resample.py`` (numpy and scipy only).

Reference behavior (reimplemented, vectorized):
  * densify-to-target with dedupe + force-close + np.interp —
    construct_boundary_alpha_spyder_v2.py:152-177
  * closed-polyline resampler (n_out points, endpoint excluded) —
    lucas_to_cardioid_v18...py:110-138
  * polygon boundary sampler returning (z, ds=L/n) —
    lucas_to_cardioid_v40_reference.py:96-119
"""

from __future__ import annotations

import numpy as np

from cmtci_torch.geometry.polygon import Polygon


def densify_boundary(b: np.ndarray, target_n: int = 1500):
    """Dedupe, force-close, resample to target_n points along arclength.

    Matches construct_boundary_alpha_spyder_v2.py:152-177 (including the
    np.unique dedupe that keeps first occurrences in original order).
    """
    b = np.asarray(b, dtype=float)
    _, uniq_idx = np.unique(b, axis=0, return_index=True)
    b = b[np.sort(uniq_idx)]
    if not np.allclose(b[0], b[-1]):
        b = np.vstack([b, b[0]])
    seg = np.linalg.norm(np.diff(b, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    if s[-1] < 1e-12:
        raise ValueError("Boundary arclength too small after cleaning.")
    s_new = np.linspace(0.0, s[-1], target_n)
    return np.column_stack([np.interp(s_new, s, b[:, 0]), np.interp(s_new, s, b[:, 1])])


def resample_closed_polyline(xy: np.ndarray, n_out: int) -> np.ndarray:
    """Resample a closed polyline (first != last) to n_out points by arclength.

    Same output as the reference's sequential loop
    (lucas_to_cardioid_v18...py:110-138), computed with searchsorted.
    """
    xy = np.asarray(xy, dtype=float)
    pts = np.vstack([xy, xy[0]])
    seg = pts[1:] - pts[:-1]
    d = np.sqrt((seg**2).sum(axis=1))
    s = np.concatenate([[0.0], np.cumsum(d)])
    big_l = s[-1]
    if big_l <= 0:
        raise ValueError("Degenerate boundary (zero length).")
    t = np.linspace(0.0, big_l, n_out + 1)[:-1]
    # reference walk: j advances while s[j+1] < t_i  => last j with s[j+1] >= t_i
    j = np.searchsorted(s[1:], t, side="left")
    j = np.clip(j, 0, len(d) - 1)
    u = np.where(d[j] == 0, 0.0, (t - s[j]) / np.where(d[j] == 0, 1.0, d[j]))
    return pts[j] * (1 - u[:, None]) + pts[j + 1] * u[:, None]


def sample_polygon_boundary(poly: Polygon, n: int):
    """n equispaced-arclength boundary points as complex, plus ds = L/n.

    Matches lucas_to_cardioid_v40_reference.py:96-119 (CCW enforced).
    """
    poly = poly.ccw()
    coords = poly.xy
    seg = np.roll(coords, -1, axis=0) - coords
    seglen = np.sqrt((seg**2).sum(axis=1))
    s = np.concatenate([[0.0], np.cumsum(seglen)])
    big_l = s[-1]
    if big_l <= 0:
        raise ValueError("Degenerate polygon boundary length.")
    su = np.linspace(0, big_l, n, endpoint=False)
    idx = np.clip(np.searchsorted(s, su, side="right") - 1, 0, len(seglen) - 1)
    t = (su - s[idx]) / np.maximum(seglen[idx], 1e-15)
    pts = coords[idx] + seg[idx] * t[:, None]
    return pts[:, 0] + 1j * pts[:, 1], np.full(n, big_l / n)


def enforce_ccw(xy: np.ndarray) -> np.ndarray:
    """Reverse the ring if its signed area is negative (v18:188-190)."""
    xy = np.asarray(xy, dtype=float)
    signed = 0.5 * np.sum(xy[:, 0] * np.roll(xy[:, 1], -1) - np.roll(xy[:, 0], -1) * xy[:, 1])
    return xy[::-1] if signed < 0 else xy
