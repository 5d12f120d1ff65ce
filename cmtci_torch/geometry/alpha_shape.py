"""Alpha shapes via Delaunay + circumradius filtering, and boundary tracing.

Copy of ``cmtci/geometry/alpha_shape.py`` (numpy and scipy only).

Reference behavior (reimplemented):
  * circumradius filter R < 1/alpha over Delaunay simplices —
    construct_boundary_alpha_spyder_v2.py:32-61 (and the alphashape library
    used at lucas_to_cardioid_v18...py:209-219 — same criterion)
  * boundary edges = edges used by exactly one kept triangle — :54-61
  * connected components; prefer the longest CLOSED loop, fall back to the
    longest open chain — :63-148
  * polygon construction (largest loop by area) replacing
    alphashape.alphashape(...) -> shapely Polygon — lucas_to_cardioid_v40_reference.py:85-93

Delaunay runs on host CPU (qhull via scipy; there is no TPU analogue of an
incremental flip algorithm worth building for <100k points). Everything
downstream (circumradii, edge counting) is vectorized numpy.
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np
from scipy.spatial import Delaunay

from cmtci_torch.geometry.polygon import Polygon


def circumradii(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Vectorized triangle circumradius, inf for degenerate triangles.

    Matches construct_boundary_alpha_spyder_v2.py:32-41 (Heron form with
    +1e-16 area guard).
    """
    a = np.linalg.norm(p[tri[:, 1]] - p[tri[:, 2]], axis=1)
    b = np.linalg.norm(p[tri[:, 0]] - p[tri[:, 2]], axis=1)
    c = np.linalg.norm(p[tri[:, 0]] - p[tri[:, 1]], axis=1)
    s = (a + b + c) / 2.0
    heron = np.maximum(s * (s - a) * (s - b) * (s - c), 0.0)
    area = np.sqrt(heron)
    with np.errstate(divide="ignore"):
        r = (a * b * c) / (4.0 * area + 1e-16)
    return np.where(area == 0.0, np.inf, r)


def alpha_complex(points: np.ndarray, alpha: float):
    """Kept Delaunay simplices with circumradius < 1/alpha."""
    points = np.asarray(points, dtype=float)
    tri = Delaunay(points)
    r = circumradii(points, tri.simplices)
    return points, tri.simplices[r < 1.0 / alpha]


def boundary_edges_of(simplices: np.ndarray) -> np.ndarray:
    """Edges used by exactly one kept triangle, as sorted (i,j) pairs."""
    if len(simplices) == 0:
        return np.zeros((0, 2), dtype=int)
    e = np.concatenate(
        [simplices[:, [0, 1]], simplices[:, [1, 2]], simplices[:, [2, 0]]], axis=0
    )
    e = np.sort(e, axis=1)
    # scalar-key unique: rows are (lo, hi) with hi < n_vertices, so
    # lo * n + hi orders exactly like np.unique(e, axis=0) (lexicographic)
    # at a fraction of the structured-void sort cost
    n = int(e.max()) + 1
    # .astype first: under numpy<2 value-based promotion, int32 rows *
    # small int64 scalar stays int32 and wraps beyond ~46341 vertices
    key = e[:, 0].astype(np.int64) * n + e[:, 1]
    uniq, counts = np.unique(key, return_counts=True)
    once = uniq[counts == 1]
    return np.column_stack([once // n, once % n])


def alpha_shape_edges(points: np.ndarray, alpha: float) -> np.ndarray:
    _, kept = alpha_complex(points, alpha)
    return boundary_edges_of(kept)


def _components(edges):
    adj = defaultdict(list)
    nodes = set()
    for i, j in edges:
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
        nodes.add(int(i))
        nodes.add(int(j))
    visited = set()
    comps = []
    for v in nodes:
        if v in visited:
            continue
        q = deque([v])
        visited.add(v)
        comp = {v}
        while q:
            u = q.popleft()
            for w in adj[u]:
                if w not in visited:
                    visited.add(w)
                    q.append(w)
                    comp.add(w)
        comps.append(comp)
    return comps, adj


def _trace(adj, comp_nodes):
    """Order one component; returns (index list, is_closed).

    construct_boundary_alpha_spyder_v2.py:87-116 semantics: a component whose
    nodes all have degree 2 is walked as a closed loop; otherwise the longest
    simple chain from an endpoint is taken.
    """
    endpoints = [v for v in comp_nodes if len(adj[v]) != 2]
    if not endpoints and len(comp_nodes) > 2:
        start = next(iter(comp_nodes))
        ordered = [start]
        prev, curr = None, start
        for _ in range(len(comp_nodes) + 5):
            nbrs = adj[curr]
            nxt = nbrs[0] if nbrs[0] != prev else (nbrs[1] if len(nbrs) > 1 else None)
            if nxt is None:
                break
            ordered.append(nxt)
            prev, curr = curr, nxt
            if curr == start:
                break
        return ordered, True
    starts = [v for v in endpoints if len(adj[v]) == 1] or endpoints or list(comp_nodes)
    best = []
    for s in starts:
        seen = {s}
        path = [s]
        prev, curr = None, s
        for _ in range(len(comp_nodes) + 5):
            nbrs = [x for x in adj[curr] if x != prev]
            if not nbrs:
                break
            nxt = nbrs[0]
            if nxt in seen:
                break
            path.append(nxt)
            seen.add(nxt)
            prev, curr = curr, nxt
        if len(path) > len(best):
            best = path
    return best, False


def trace_boundary(points: np.ndarray, edges, min_len: int = 5):
    """Pick the longest closed loop (else longest open chain) of the edge set.

    Returns (ordered vertex indices, was_closed).
    """
    comps, _ = _components(edges)
    edge_set = {tuple(e) for e in np.asarray(edges).tolist()}
    # one dispatch pass over the edges (was one full edge_set scan PER
    # component — quadratic for noisy small-alpha sets with many tiny
    # components); per-component adjacency order is the same edge_set
    # iteration order as before, so the traced output is identical
    comp_of = {v: ci for ci, comp in enumerate(comps) for v in comp}
    locals_ = [defaultdict(list) for _ in comps]
    for i, j in edge_set:
        local = locals_[comp_of[i]]
        local[i].append(j)
        local[j].append(i)
    closed, open_ = [], []
    for comp, local in zip(comps, locals_):
        ordered, is_closed = _trace(local, comp)
        if len(ordered) < min_len:
            continue
        (closed if is_closed else open_).append(ordered)
    if closed:
        return max(closed, key=len), True
    if open_:
        return max(open_, key=len), False
    raise RuntimeError("No usable boundary component found. Adjust alpha.")


def directed_boundary_loops(pts: np.ndarray, kept: np.ndarray):
    """Closed boundary walks of the kept-triangle region, region-on-left.

    Orients every kept triangle CCW, takes directed edges whose reverse is
    absent (region boundary), and decomposes them into closed walks. At
    pinch junctions the next edge is chosen by the leftmost-turn rule, which
    traces each face boundary consistently — robust where the naive
    degree-2 chain walk (construct_boundary_alpha_spyder_v2.py:87-101)
    breaks, e.g. the thin alpha band around a curve's point set.
    """
    p0, p1, p2 = pts[kept[:, 0]], pts[kept[:, 1]], pts[kept[:, 2]]
    signed = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0])
    tris = kept.copy()
    cw = signed < 0
    tris[cw] = tris[cw][:, [0, 2, 1]]
    d_edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0)
    # boundary = directed edges whose reverse is absent, found on int64
    # scalar keys (a*n+b) with searchsorted — the Python tuple-set over
    # 3T edges was the alpha-polygon hot spot
    n = len(pts)
    fwd = d_edges[:, 0].astype(np.int64) * n + d_edges[:, 1]
    rev = d_edges[:, 1].astype(np.int64) * n + d_edges[:, 0]
    fwd_sorted = np.sort(fwd)
    pos = np.searchsorted(fwd_sorted, rev)
    has_rev = (pos < len(fwd_sorted)) & (fwd_sorted[np.minimum(pos, len(fwd_sorted) - 1)] == rev)
    bnd = d_edges[~has_rev]
    boundary = [(int(a), int(b)) for a, b in bnd]
    out_edges = defaultdict(list)
    for a, b in boundary:
        out_edges[a].append(b)

    used = set()
    loops = []
    for start in boundary:
        if start in used:
            continue
        walk = [start[0], start[1]]
        used.add(start)
        prev, curr = start
        for _ in range(len(boundary) + 5):
            cands = [b for b in out_edges[curr] if (curr, b) not in used]
            if not cands:
                break
            if len(cands) == 1:
                nxt = cands[0]
            else:
                # face-traversal rule: first outgoing edge rotating CLOCKWISE
                # from the reversed incoming direction (keeps the same face;
                # measuring CCW from the incoming direction jumps faces at
                # sharp pinches)
                d_in = pts[curr] - pts[prev]
                ang_rev = np.arctan2(d_in[1], d_in[0]) + np.pi
                def cw_turn(b):
                    d = pts[b] - pts[curr]
                    return (ang_rev - np.arctan2(d[1], d[0])) % (2 * np.pi)
                nxt = min(cands, key=cw_turn)
            used.add((curr, nxt))
            walk.append(nxt)
            prev, curr = curr, nxt
            if curr == start[0]:
                break
        if walk[0] == walk[-1] and len(walk) > 3:
            loops.append(walk[:-1])
    return loops


def alpha_shape_polygon(points, alpha: float) -> Polygon:
    """Largest alpha-shape region's outer boundary (replaces alphashape lib).

    Accepts complex or (N,2) points (lucas_to_cardioid_v18...py:209-219,
    lucas_to_cardioid_v40_reference.py:85-93). CCW outer walks have positive
    signed area; the largest is the outer boundary of the largest region
    (the alphashape library returns the largest-area polygon of a
    MultiPolygon).
    """
    from cmtci_torch.utils.arrays import as_xy

    pts = as_xy(points)
    _, kept = alpha_complex(pts, alpha)
    if len(kept) == 0:
        raise RuntimeError("Alpha-shape kept no triangles; adjust alpha.")
    loops = directed_boundary_loops(pts, kept)
    best_poly, best_area = None, 0.0
    for loop in loops:
        if len(loop) < 3:
            continue
        try:
            poly = Polygon(pts[loop])
        except ValueError:
            continue
        if poly.signed_area > best_area:  # CCW outer boundaries only
            best_area, best_poly = poly.signed_area, poly
    if best_poly is None:
        raise RuntimeError("Alpha shape yielded no closed outer loop; adjust alpha.")
    return best_poly
