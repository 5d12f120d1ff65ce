"""Small shared array helpers."""

from __future__ import annotations

import numpy as np


def as_xy(pts) -> np.ndarray:
    """Coerce a complex array or (N,2) real array to (N,2) float."""
    pts = np.asarray(pts)
    if np.iscomplexobj(pts):
        return np.column_stack([pts.real.ravel(), pts.imag.ravel()])
    return np.asarray(pts, dtype=float)
