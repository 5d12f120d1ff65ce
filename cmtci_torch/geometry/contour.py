"""Marching-squares isocontour extraction (matplotlib-contour replacement).

The reference extracts the Mandelbrot boundary polyline by calling
matplotlib's contouring on the dwell grid and keeping the longest path
(mandelbrot_boundary_sample.py:41-54). matplotlib's contour engine is a C
extension; here we implement marching squares directly: per-cell crossing
segments are generated vectorized in numpy, then chained into ordered paths
on host. Vertex positions use the same linear interpolation as contourpy, so
the extracted polyline agrees geometrically (path point ordering/start may
differ; downstream statistics are invariant to that).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def contour_segments(xs, ys, z, level: float):
    """All marching-squares segments of the level set, as (S,2,2) array."""
    z = np.asarray(z, dtype=float)
    ny, nx = z.shape
    # cell corner values: a=z[j,i], b=z[j,i+1], c=z[j+1,i+1], d=z[j+1,i]
    a = z[:-1, :-1]
    b = z[:-1, 1:]
    c = z[1:, 1:]
    d = z[1:, :-1]
    case = (
        (a > level).astype(np.int8)
        | ((b > level).astype(np.int8) << 1)
        | ((c > level).astype(np.int8) << 2)
        | ((d > level).astype(np.int8) << 3)
    )
    jj, ii = np.nonzero((case != 0) & (case != 15))
    if len(ii) == 0:
        return np.zeros((0, 2, 2))
    cs = case[jj, ii]
    xs = np.asarray(xs, dtype=float)
    ys = np.asarray(ys, dtype=float)
    x0, x1 = xs[ii], xs[ii + 1]
    y0, y1 = ys[jj], ys[jj + 1]
    va, vb, vc, vd = a[jj, ii], b[jj, ii], c[jj, ii], d[jj, ii]

    # edge crossing points: bottom (a-b), right (b-c), top (d-c), left (a-d)
    with np.errstate(divide="ignore", invalid="ignore"):
        tb = (level - va) / (vb - va)
        tr = (level - vb) / (vc - vb)
        tt = (level - vd) / (vc - vd)
        tl = (level - va) / (vd - va)
        bot = np.column_stack([x0 + tb * (x1 - x0), y0 + 0 * tb])
        rgt = np.column_stack([x1 + 0 * tr, y0 + tr * (y1 - y0)])
        top = np.column_stack([x0 + tt * (x1 - x0), y1 + 0 * tt])
        lft = np.column_stack([x0 + 0 * tl, y0 + tl * (y1 - y0)])

    # segment lookup: per case, list of (edge1, edge2) pairs; edges 0=bot,1=rgt,2=top,3=lft
    table = {
        1: [(3, 0)], 2: [(0, 1)], 3: [(3, 1)], 4: [(1, 2)],
        6: [(0, 2)], 7: [(3, 2)], 8: [(2, 3)], 9: [(2, 0)],
        11: [(2, 1)], 12: [(1, 3)], 13: [(1, 0)], 14: [(0, 3)],
        # ambiguous saddles: resolve by center average (same as contourpy default)
        5: None, 10: None,
    }
    pts = np.stack([bot, rgt, top, lft], axis=1)  # (M,4,2)
    segs = []
    for code in np.unique(cs):
        m = cs == code
        if code in (5, 10):
            center = 0.25 * (va[m] + vb[m] + vc[m] + vd[m])
            hi = center > level
            if code == 5:  # corners a,c high
                pairs_hi, pairs_lo = [(3, 2), (1, 0)], [(3, 0), (1, 2)]
            else:  # corners b,d high
                pairs_hi, pairs_lo = [(0, 3), (2, 1)], [(0, 1), (2, 3)]
            sub = pts[m]
            for flag, pairs in ((hi, pairs_hi), (~hi, pairs_lo)):
                for e1, e2 in pairs:
                    segs.append(np.stack([sub[flag][:, e1], sub[flag][:, e2]], axis=1))
        else:
            for e1, e2 in table[int(code)]:
                sub = pts[m]
                segs.append(np.stack([sub[:, e1], sub[:, e2]], axis=1))
    return np.concatenate(segs, axis=0) if segs else np.zeros((0, 2, 2))


def chain_segments(segs: np.ndarray, decimals: int = 10):
    """Join segments into ordered polylines by matching endpoints."""
    if len(segs) == 0:
        return []
    key = lambda p: (round(float(p[0]), decimals), round(float(p[1]), decimals))
    adj = defaultdict(list)
    for s, (p, q) in enumerate(segs):
        adj[key(p)].append((s, 1))
        adj[key(q)].append((s, 0))
    used = np.zeros(len(segs), dtype=bool)
    paths = []
    for s0 in range(len(segs)):
        if used[s0]:
            continue
        used[s0] = True
        path = [segs[s0, 0], segs[s0, 1]]
        # extend forward then backward
        for direction in (1, 0):
            while True:
                endpoint = path[-1] if direction else path[0]
                candidates = [
                    (s, e) for s, e in adj[key(endpoint)] if not used[s]
                ]
                if not candidates:
                    break
                s, e = candidates[0]
                used[s] = True
                nxt = segs[s, e]
                if direction:
                    path.append(nxt)
                else:
                    path.insert(0, nxt)
        paths.append(np.asarray(path))
    return paths


def extract_contour(xs, ys, z, level: float):
    """Longest contour path of z at `level` (mandelbrot_boundary_sample.py:41-54).

    Returns (N,2) vertices or None.
    """
    segs = contour_segments(xs, ys, z, level)
    paths = chain_segments(segs)
    if not paths:
        return None
    return max(paths, key=len)


def dwell_boundary(xs, ys, dwell, max_iter: int, level_frac: float = 0.96):
    """Isocontour of the dwell grid at level_frac*max_iter."""
    return extract_contour(xs, ys, np.asarray(dwell, dtype=float), level_frac * max_iter)
