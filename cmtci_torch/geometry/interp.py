"""UV -> physical inversion via Delaunay + barycentric interpolation.

Copy of ``cmtci/geometry/interp.py``.

Reference: lucas_to_cardioid_v18...py:449-480. The triangulation and simplex
location stay on host (qhull); the barycentric interpolation is vectorized.

DELIBERATE FIX vs reference: v18:469-479 pairs the residual barycentric
weight (1 - b1 - b2) with simplex vertex 0, but scipy's `transform` yields
coordinates for vertices 0..ndim-1 with the REMAINDER belonging to the LAST
vertex. The reference therefore interpolates with permuted weights (its
identity interpolation is wrong); we implement the correct pairing, verified
by an exact identity-roundtrip test.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from cmtci_torch.geometry.mesh import UV_QHULL_OPTIONS


def invert_uv_to_z(uv_query, uv_nodes, z_nodes, qhull_options: str = UV_QHULL_OPTIONS):
    """Interpolate complex nodal values at uv_query; NaN outside the hull.

    Returns (z_out, ok_mask, simplex_indices).
    """
    uv_query = np.asarray(uv_query, dtype=float)
    tri = Delaunay(np.asarray(uv_nodes, dtype=float), qhull_options=qhull_options)
    simp = tri.find_simplex(uv_query)
    ok = simp >= 0
    z_out = np.full(len(uv_query), np.nan + 1j * np.nan, dtype=complex)
    if not np.any(ok):
        return z_out, ok, simp
    x = uv_query[ok]
    s = simp[ok]
    t = tri.transform[s, :2, :]
    r = x - tri.transform[s, 2, :]
    b01 = np.einsum("ijk,ik->ij", t, r)
    b2 = 1.0 - b01[:, 0] - b01[:, 1]
    verts = tri.simplices[s]
    z = np.asarray(z_nodes, dtype=complex)
    z_out[ok] = b01[:, 0] * z[verts[:, 0]] + b01[:, 1] * z[verts[:, 1]] + b2 * z[verts[:, 2]]
    return z_out, ok, simp
