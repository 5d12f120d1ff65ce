"""Cardioid geometry and exact disk<->cardioid maps (numpy).

Copy of ``cmtci/geometry/cardioid.py``.

Reference: lucas_to_cardioid_v40_reference.py:366-381 (exact maps, polygon)
and lucas_to_cardioid_v18...py:438-443 (n=401 polygon over [-pi, pi]).
"""

from __future__ import annotations

import numpy as np

from cmtci_torch.geometry.polygon import Polygon


def disk_to_cardioid(w):
    """z = w/2 - w^2/4 (main-cardioid uniformization)."""
    w = np.asarray(w, dtype=np.complex128)
    return 0.5 * w - 0.25 * w * w


def cardioid_to_disk(z):
    """w = 1 - sqrt(1 - 4z) (exact inverse, principal branch)."""
    z = np.asarray(z, dtype=np.complex128)
    return 1.0 - np.sqrt(1.0 - 4.0 * z)


def cardioid_polygon(n: int = 401, endpoint: bool = True) -> Polygon:
    """Polygon z = 0.5 e^{it} - 0.25 e^{2it}.

    v18 uses t in [-pi, pi] with endpoint=True (n=401); v40 uses
    t in [0, 2pi) endpoint=False (n=4000). Both describe the same curve.
    """
    if endpoint:
        t = np.linspace(-np.pi, np.pi, n, endpoint=True)
    else:
        t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    z = 0.5 * np.exp(1j * t) - 0.25 * np.exp(2j * t)
    return Polygon(np.column_stack([z.real, z.imag]))
