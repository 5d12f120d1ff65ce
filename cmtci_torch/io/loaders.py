"""Robust CSV loaders (P8).

Copy of ``cmtci/io/loaders.py`` (numpy and scipy only).

Reference: the header-or-headerless x,y loader duplicated across 6 scripts
(boundary_curvature_localpoly.py:45-63) and the multi-format matches
interpreter (Variogram-Mandelbrot-Construct.py:44-101).
"""

from __future__ import annotations

import numpy as np


def load_points(csv_path: str) -> np.ndarray:
    """(N,2) points from a CSV with or without an x,y header."""
    try:
        arr = np.genfromtxt(csv_path, delimiter=",", names=True, dtype=float)
        if arr.dtype.names and ("x" in arr.dtype.names) and ("y" in arr.dtype.names):
            return np.c_[arr["x"], arr["y"]]
    except Exception:
        pass
    pts = np.genfromtxt(csv_path, delimiter=",", dtype=float)
    if pts.ndim == 1:
        pts = pts.reshape(-1, 2)
    if pts.shape[1] != 2:
        raise ValueError("Expect 2 columns (x,y)")
    return pts


def load_matches(path: str, n_expected: int | None = None) -> np.ndarray:
    """Matches index vector, tolerating 1-col/2-col/swapped layouts."""
    m = np.loadtxt(path, delimiter=",", dtype=float, ndmin=2)
    if m.shape[1] == 1:
        idx = m[:, 0]
    else:
        # 2-column (i, j): pick the column that isn't just 0..N-1
        c0, c1 = m[:, 0], m[:, 1]
        if np.array_equal(c0, np.arange(len(c0))):
            idx = c1
        elif np.array_equal(c1, np.arange(len(c1))):
            idx = c0
        else:
            idx = c1
    idx = idx.astype(int)
    if n_expected is not None and len(idx) != n_expected:
        idx = idx[:n_expected]
    return idx
