"""Polygon triangulation for FEM (v18 meshing, vectorized host stage).

Copy of ``cmtci/geometry/mesh.py``, with its relative degeneracy filter.

Reference: lucas_to_cardioid_v18...py:222-308 — arclength boundary sampling,
interior grid, jittered boundary layers, dedupe, qhull Delaunay (QJ Qbb Qc),
centroid-in-polygon filter, degenerate-triangle drop. The per-point shapely
covers()/contains() loops (the v18 hot spot at fine levels) are replaced by
one vectorized point-in-polygon call.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from cmtci_torch.geometry.polygon import Polygon

UV_QHULL_OPTIONS = "QJ Qbb Qc"


def polygon_to_mesh(
    poly: Polygon,
    h: float = 0.05,
    boundary_h: float | None = None,
    boundary_layers: int = 1,
    layer_factor: float = 2.0,
    seed: int = 0,
    qhull_options: str = UV_QHULL_OPTIONS,
):
    """Triangulate a (possibly concave) polygon. Returns (P, T)."""
    rng = np.random.default_rng(seed)
    if boundary_h is None:
        boundary_h = 0.5 * h

    # 1) boundary samples by arclength
    big_l = poly.length
    nb = max(16, int(np.ceil(big_l / boundary_h)))
    svals = np.linspace(0.0, big_l, nb, endpoint=False)
    bpts = poly.interpolate(svals)

    # 2) interior grid (x-major order like the reference's comprehension)
    minx, miny, maxx, maxy = poly.bounds
    xs = np.arange(minx, maxx + h, h)
    ys = np.arange(miny, maxy + h, h)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    grid = np.column_stack([gx.ravel(), gy.ravel()])
    inside = poly.contains(grid, include_boundary=True)
    interior = grid[inside]

    # 3) jittered boundary layers
    layers = []
    for k in range(1, boundary_layers + 1):
        r = (k / boundary_layers) * (h / layer_factor)
        cand = bpts + rng.normal(scale=r, size=bpts.shape)
        keep = poly.contains(cand, include_boundary=True)
        if keep.any():
            layers.append(cand[keep])
    bl = np.vstack(layers) if layers else np.zeros((0, 2))

    # 4) combine + dedupe + Delaunay
    pts = np.vstack([bpts, interior, bl])
    # dedupe rounded rows via a complex view: sorts (real, imag) =
    # lexicographic rows, identical output to np.unique(..., axis=0)
    # without the structured-void sort
    pts = np.round(pts, 12) + 0.0  # +0.0 folds -0.0 so the key is unique
    z = np.unique(pts[:, 0] + 1j * pts[:, 1])
    pts = np.column_stack([z.real, z.imag])
    if len(pts) < 30:
        raise RuntimeError("Too few points; decrease h or boundary_h")
    tri = Delaunay(pts, qhull_options=qhull_options)
    t = tri.simplices

    # 5) centroid-in-polygon filter (strict interior, concave-safe)
    centroids = pts[t].mean(axis=1)
    t = t[poly.contains(centroids)]

    # 6) drop degenerate triangles — RELATIVE criterion. Exactly-collinear
    # boundary runs (arclength resampling of straight polygon edges) make
    # qhull's QJ joggle emit "cap" triangles of height ~1e-13 whose P1
    # stiffness rows reach ~1e12 (κ(K)≈2e15): zero geometric content, but
    # enough to put an f32 solve permanently out of reach. Genuine thin
    # triangles on these domains have height ≥ ~1e-3·edge, so the 1e-9
    # relative threshold sits three decades clear of both populations.
    # (The previous ABSOLUTE 2e-14 guard passed the joggle caps.)
    p0, p1, p2 = pts[t[:, 0]], pts[t[:, 1]], pts[t[:, 2]]
    dbl_area = np.abs(
        (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
        - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0])
    )
    edge_sq = np.maximum(
        ((p1 - p0) ** 2).sum(1),
        np.maximum(((p2 - p1) ** 2).sum(1), ((p0 - p2) ** 2).sum(1)),
    )
    t = t[dbl_area > np.maximum(2e-9 * edge_sq, 2e-14)]

    # 7) remove orphaned nodes (a node whose every triangle was a dropped
    # cap would leave a zero stiffness row)
    used = np.zeros(len(pts), dtype=bool)
    used[t.reshape(-1)] = True
    if not used.all():
        remap = np.cumsum(used) - 1
        pts = pts[used]
        t = remap[t]
    return pts, t


def boundary_vertices(triangles: np.ndarray) -> np.ndarray:
    """Vertex indices on the mesh boundary (edges used by one triangle).

    Vectorized version of lucas_to_cardioid_v18...py:349-362; shares the
    once-used-edge extraction with the alpha-shape module.
    """
    from cmtci_torch.geometry.alpha_shape import boundary_edges_of

    return np.unique(boundary_edges_of(triangles))


def tri_centroids(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    return points[triangles].mean(axis=1)
