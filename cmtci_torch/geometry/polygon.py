"""Planar polygon ops (shapely replacement, vectorized numpy).

Copy of ``cmtci/geometry/polygon.py``. Its one jitted function,
``_distances_blocked_jit``, is ``_distances_blocked`` here: the same
clamped-projection scan in torch f64 on a device, which
``Polygon.exterior_distance`` takes as an argument.

The reference leans on shapely for contains/covers/project/interpolate/
distance/centroid (lucas_to_cardioid_v18...py:222-308,365-404,641-646;
lucas_to_cardioid_v40_reference.py:96-162). shapely is not available here and
is a per-point Python loop in the reference anyway; this module provides the
same operations as O(P·E) vectorized kernels over all query points at once.
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.utils.device import resolve_device


class Polygon:
    """Simple polygon given by its exterior ring (no holes).

    Vertices are stored open (first point not repeated). Orientation is
    preserved as given; use .ccw() to enforce counterclockwise.
    """

    def __init__(self, xy):
        xy = np.asarray(xy, dtype=float)
        if xy.ndim != 2 or xy.shape[1] != 2:
            raise ValueError("Polygon expects (N,2) vertices")
        # drop a repeated closing vertex; tolerance is scale-aware and TIGHT
        # (allclose's rtol=1e-5 could merge genuinely distinct vertices on
        # dense rings) while still absorbing the ~1e-16 trig noise of
        # parametric closures like cardioid_polygon(endpoint=True)
        if len(xy) > 1 and np.max(np.abs(xy[0] - xy[-1])) <= 1e-9 * max(
                1.0, float(np.max(np.abs(xy)))):
            xy = xy[:-1]
        if len(xy) < 3:
            raise ValueError("Polygon needs >= 3 distinct vertices")
        self.xy = xy

    # --- basic measures -------------------------------------------------
    @property
    def signed_area(self) -> float:
        x, y = self.xy[:, 0], self.xy[:, 1]
        return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))

    @property
    def area(self) -> float:
        return abs(self.signed_area)

    @property
    def is_ccw(self) -> bool:
        return self.signed_area > 0

    def ccw(self) -> "Polygon":
        return self if self.is_ccw else Polygon(self.xy[::-1])

    @property
    def bounds(self):
        mn = self.xy.min(axis=0)
        mx = self.xy.max(axis=0)
        return float(mn[0]), float(mn[1]), float(mx[0]), float(mx[1])

    @property
    def centroid(self) -> complex:
        x, y = self.xy[:, 0], self.xy[:, 1]
        xn, yn = np.roll(x, -1), np.roll(y, -1)
        cross = x * yn - xn * y
        a = 0.5 * np.sum(cross)
        if abs(a) < 1e-300:
            return complex(x.mean(), y.mean())
        cx = np.sum((x + xn) * cross) / (6.0 * a)
        cy = np.sum((y + yn) * cross) / (6.0 * a)
        return complex(cx, cy)

    # --- segments -------------------------------------------------------
    @property
    def _segs(self):
        p0 = self.xy
        p1 = np.roll(self.xy, -1, axis=0)
        return p0, p1

    @property
    def seg_lengths(self) -> np.ndarray:
        p0, p1 = self._segs
        return np.sqrt(((p1 - p0) ** 2).sum(axis=1))

    @property
    def length(self) -> float:
        return float(self.seg_lengths.sum())

    @property
    def arclengths(self) -> np.ndarray:
        """Cumulative arclength at each vertex, starting at 0."""
        return np.concatenate([[0.0], np.cumsum(self.seg_lengths)])[:-1]

    # --- queries ----------------------------------------------------------
    def _ybuckets(self):
        """Lazy y-bucket edge index for the crossing test.

        An edge is active for a query y iff y lies in the edge's half-open
        y-span, so only edges whose span overlaps the point's y-bucket can
        contribute a crossing — the candidate set is a superset of the
        active set and the exact crossing predicate is still evaluated on
        it, so the accelerated result is bitwise identical to the full
        test. Typical reduction for arclength-resampled boundaries: E=2000
        edges -> ~10-40 candidates/point (the interior rejection sampler's
        dominant cost, v40:149-162)."""
        cached = getattr(self, "_ybucket_cache", None)
        if cached is not None:
            return cached
        p0, p1 = self._segs
        e = len(p0)
        # ~4 buckets per edge: one crowded bucket sets the padded row width
        # K for EVERY query point, and at e//4 buckets the v18 centroid
        # workload paid K=32 against a mean candidate count of 6 (45 ms ->
        # 7 ms at 4e, bitwise identical); capped so the one-off build loop
        # and the (nb, K) index stay small
        nb = int(min(max(4 * e, 8), 4096))
        ylo = float(np.minimum(p0[:, 1], p1[:, 1]).min())
        yhi = float(np.maximum(p0[:, 1], p1[:, 1]).max())
        h = max((yhi - ylo) / nb, 1e-300)
        elo = np.floor((np.minimum(p0[:, 1], p1[:, 1]) - ylo) / h).astype(np.int64)
        ehi = np.floor((np.maximum(p0[:, 1], p1[:, 1]) - ylo) / h).astype(np.int64)
        elo = np.clip(elo, 0, nb - 1)
        ehi = np.clip(ehi, 0, nb - 1)
        buckets = [[] for _ in range(nb)]
        for j in range(e):
            for b in range(elo[j], ehi[j] + 1):
                buckets[b].append(j)
        k = max(1, max(len(b) for b in buckets))
        idx = np.zeros((nb, k), dtype=np.int64)
        cnt = np.zeros(nb, dtype=np.int64)
        for b, lst in enumerate(buckets):
            idx[b, : len(lst)] = lst
            cnt[b] = len(lst)
        self._ybucket_cache = (ylo, h, nb, idx, cnt)
        return self._ybucket_cache

    def contains(self, pts, include_boundary: bool = False, tol: float = 0.0):
        """Even-odd crossing test, vectorized over (P,2) points.

        include_boundary=True emulates shapely .covers() up to `tol` (points
        within tol of the boundary count as inside). For polygons with
        ≥48 edges the y-bucket index prunes the per-point edge set
        (bitwise-identical result — see _ybuckets).
        """
        pts = _as_xy(pts)
        p0, p1 = self._segs
        e = len(p0)
        if e >= 48 and len(pts) > 8:
            ylo, h, nb, idx, cnt = self._ybuckets()
            b = np.clip(np.floor((pts[:, 1] - ylo) / h).astype(np.int64), 0, nb - 1)
            eidx = idx[b]                      # (P, K) candidate edges
            valid = np.arange(idx.shape[1])[None, :] < cnt[b][:, None]
            x, y = pts[:, 0][:, None], pts[:, 1][:, None]
            x0, y0 = p0[eidx, 0], p0[eidx, 1]
            x1, y1 = p1[eidx, 0], p1[eidx, 1]
        else:
            valid = True
            x, y = pts[:, 0][:, None], pts[:, 1][:, None]
            x0, y0 = p0[:, 0][None, :], p0[:, 1][None, :]
            x1, y1 = p1[:, 0][None, :], p1[:, 1][None, :]
        cond = ((y0 <= y) != (y1 <= y)) & valid
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
        crossings = np.sum(cond & (x < xint), axis=1)
        inside = (crossings % 2) == 1
        if include_boundary:
            need = ~inside  # interior points qualify already; only the rest
            if need.any():  # need the (pruned, exact) boundary threshold
                inside[need] = self.boundary_within(pts[need], max(tol, 1e-12))
        return inside

    def _seg_tree(self):
        """Cached (KDTree over boundary samples, sample→segment, half-spacing).

        Boundary samples (spacing <= L/512 per segment, endpoints included)
        tagged with their parent segment: the prune bound is then half the
        sample spacing instead of the max segment half-length, which one
        long alpha-shape edge blew up to ~0.17 (20% full-scan fallback in
        the FEM study). L/512 balances bound tightness against candidate-set
        diversity: the k needed for the bound to hold scales as
        1/(2*sqrt(half)), so OVER-dense samples make far points fail (all k
        nearest samples collapse onto one segment)."""
        cached = getattr(self, "_seg_tree_cache", None)
        if cached is None:
            from scipy.spatial import cKDTree

            p0, p1 = self._segs
            seg_len = np.sqrt(((p1 - p0) ** 2).sum(axis=1))
            delta = max(float(seg_len.sum()) / 512.0, 1e-12)
            reps = np.maximum(np.ceil(seg_len / delta).astype(np.int64), 1)
            seg_of = np.repeat(np.arange(len(p0)), reps + 1)
            t = np.concatenate([np.linspace(0.0, 1.0, r + 1) for r in reps])
            samples = p0[seg_of] + t[:, None] * (p1 - p0)[seg_of]
            half = 0.5 * float((seg_len / reps).max())
            cached = (cKDTree(samples), seg_of, half)
            self._seg_tree_cache = cached
        return cached

    def _nearest(self, pts):
        """(d, seg_idx, t) nearest-segment query; KDTree-pruned for large
        polygons (exact — see _nearest_on_segments_pruned)."""
        p0, p1 = self._segs
        if len(p0) >= 64 and len(pts) > 4:
            tree, seg_of, half = self._seg_tree()
            return _nearest_on_segments_pruned(pts, p0, p1, tree, seg_of, half)
        return _nearest_on_segments(pts, p0, p1)

    def boundary_within(self, pts, tol: float) -> np.ndarray:
        """Boolean: is each point within tol of the boundary polyline (exact).

        Cheaper than thresholding exterior_distance when only the verdict
        matters: every boundary point lies within half_spacing of a tree
        sample, so d >= d_samp1 - half_spacing — ONE k=1 sample query
        rejects every point with d_samp1 > tol + half_spacing outright, and
        only the (typically tiny) survivor set pays an exact nearest-segment
        query. This is the contains(include_boundary=True) hot path of the
        v18 mesher (lucas_to_cardioid_v18...py:244-262 covers() semantics)."""
        pts = _as_xy(pts)
        p0, p1 = self._segs
        if len(p0) >= 64 and len(pts) > 4:
            tree, _, half = self._seg_tree()
            d1, _ = tree.query(pts, k=1)
            out = np.zeros(len(pts), dtype=bool)
            maybe = d1 <= tol + half
            if maybe.any():
                d, _, _ = self._nearest(pts[maybe])
                out[maybe] = d <= tol
            return out
        d, _, _ = _nearest_on_segments(pts, p0, p1)
        return d <= tol

    def exterior_distance(self, pts, device="cuda") -> np.ndarray:
        """Min distance from each point to the boundary polyline.

        Large batches (the v18 per-level centroid workload,
        lucas_to_cardioid_v18...py:365-404) take the distance-only full
        scan `_distances_blocked` on `device`: one (B,E) min-reduction a
        block of points. Values agree with the exact kernels to about an
        ulp; the (d, seg, t) consumers project()/boundary_within() keep the
        bitwise-exact host paths. Smaller batches run on the host whatever
        `device` is (the reference's size rule)."""
        pts = _as_xy(pts)
        if len(pts) >= 1024 and len(self.xy) >= 8:
            return _distances_blocked(pts, *self._segs, device=device)
        d, _, _ = self._nearest(pts)
        return d

    def project(self, pts) -> np.ndarray:
        """Arclength of the nearest boundary point (shapely .project)."""
        pts = _as_xy(pts)
        d, seg_idx, t = self._nearest(pts)
        s0 = self.arclengths
        return s0[seg_idx] + t * self.seg_lengths[seg_idx]

    def interpolate(self, s) -> np.ndarray:
        """Boundary point(s) at arclength(s) s (shapely .interpolate)."""
        s = np.atleast_1d(np.asarray(s, dtype=float)) % max(self.length, 1e-300)
        lengths = self.seg_lengths
        cum = np.concatenate([[0.0], np.cumsum(lengths)])
        idx = np.clip(np.searchsorted(cum, s, side="right") - 1, 0, len(lengths) - 1)
        t = (s - cum[idx]) / np.maximum(lengths[idx], 1e-300)
        p0, p1 = self._segs
        return p0[idx] + (p1[idx] - p0[idx]) * t[:, None]


def _as_xy(pts):
    """arrays.as_xy plus the single-point (2,) -> (1,2) promotion."""
    from cmtci_torch.utils.arrays import as_xy

    pts = as_xy(pts)
    if pts.ndim == 1:
        return pts.reshape(1, 2)
    return pts


def _nearest_on_segments(pts, p0, p1):
    """For each point: (distance, segment index, param t) of nearest segment point."""
    d01 = p1 - p0  # (E,2)
    len2 = np.maximum((d01**2).sum(axis=1), 1e-300)  # (E,)
    # (P,E) parameter of the projection, clamped to the segment
    dp = pts[:, None, :] - p0[None, :, :]  # (P,E,2)
    t = np.clip((dp * d01[None, :, :]).sum(axis=2) / len2[None, :], 0.0, 1.0)
    closest = p0[None, :, :] + t[:, :, None] * d01[None, :, :]
    dist2 = ((pts[:, None, :] - closest) ** 2).sum(axis=2)
    seg_idx = np.argmin(dist2, axis=1)
    rows = np.arange(len(pts))
    return np.sqrt(dist2[rows, seg_idx]), seg_idx, t[rows, seg_idx]


def _exact_over_candidate_segs(pts, p0, p1, cand):
    """Exact (d, seg, t) restricted to per-point candidate segment lists.

    `cand` rows must be sorted ascending so the first-occurrence argmin
    reproduces the full scan's tie rule (smallest segment index among
    minima); duplicate entries are harmless."""
    d01 = p1 - p0
    len2 = np.maximum((d01**2).sum(axis=1), 1e-300)
    c0 = p0[cand]                      # (P,k,2)
    cd = d01[cand]
    dp = pts[:, None, :] - c0
    t = np.clip((dp * cd).sum(axis=2) / len2[cand], 0.0, 1.0)
    closest = c0 + t[:, :, None] * cd
    dist2 = ((pts[:, None, :] - closest) ** 2).sum(axis=2)
    j = np.argmin(dist2, axis=1)
    rows = np.arange(len(pts))
    return np.sqrt(dist2[rows, j]), cand[rows, j], t[rows, j]


_DIST_BLOCK = 2048  # rows of points a block: (2048, E) f64 temporaries


def _distances_blocked(pts, p0, p1, device="cuda"):
    """Distance-only full scan over blocks of points, in f64 on `device`.

    Same clamped-projection formula as _nearest_on_segments; returns a
    numpy array."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(pts, dtype=float), device=dev)
    s0 = torch.as_tensor(np.asarray(p0, dtype=float), device=dev)
    s1 = torch.as_tensor(np.asarray(p1, dtype=float), device=dev)
    d01 = s1 - s0
    len2 = torch.clamp((d01 ** 2).sum(dim=1), min=1e-300)
    out = torch.empty(len(q), dtype=torch.float64, device=dev)
    for i in range(0, len(q), _DIST_BLOCK):
        blk = q[i : i + _DIST_BLOCK]
        dp = blk[:, None, :] - s0[None]
        t = torch.clamp((dp * d01[None]).sum(dim=2) / len2[None], 0.0, 1.0)
        closest = s0[None] + t[..., None] * d01[None]
        out[i : i + _DIST_BLOCK] = torch.sqrt(
            ((blk[:, None, :] - closest) ** 2).sum(dim=2).amin(dim=1))
    return out.cpu().numpy()


def _nearest_on_segments_pruned(pts, p0, p1, tree, samp_seg, half_spacing):
    """Exact nearest-segment query via a boundary-sample KDTree prune.

    Candidates = parent segments of the k nearest boundary SAMPLES (samples
    spaced ≤ 2·half_spacing along every segment, endpoints included).
    Correctness bound: any boundary point lies within half_spacing of some
    sample on its segment, so a segment with no sample among the k nearest
    has d_seg ≥ D_k − half_spacing (D_k = k-th sample distance); if the
    best exact candidate distance dc < D_k − half_spacing, every other
    segment is STRICTLY farther — the result (incl. the argmin tie rule,
    see _exact_over_candidate_segs) is identical to the full scan. Points
    failing the bound escalate k (×4 per round, ending at a round over all
    samples, which IS the full scan), so exactness never depends on the
    bound holding. ×4 measured best on the FEM centroid workload (18% of
    deep-interior points escalate once; ×8's k=128 round cost more than
    two ×4 rounds, and raising k0 taxes the 82% that never escalate). This is the v18 mesher/arclength hot spot
    (exterior_distance/project were 3.7 s of the 5 s L3 level)."""
    n_samp = len(samp_seg)
    n_pts = len(pts)
    d = np.empty(n_pts)
    seg_idx = np.empty(n_pts, dtype=np.int64)
    tt = np.empty(n_pts)
    active = np.arange(n_pts)
    k = 16
    while len(active):
        kk = min(n_samp, k)
        dk, cand_s = tree.query(pts[active], k=kk)
        if kk == 1:
            dk, cand_s = dk[:, None], cand_s[:, None]
        cand = np.sort(samp_seg[cand_s], axis=1)
        da, ja, ta = _exact_over_candidate_segs(pts[active], p0, p1, cand)
        ok = (da < dk[:, -1] - half_spacing) if kk < n_samp else np.ones(len(active), bool)
        done = active[ok]
        d[done], seg_idx[done], tt[done] = da[ok], ja[ok], ta[ok]
        active = active[~ok]
        k *= 4
    return d, seg_idx, tt


def ensure_interior_point(poly: Polygon, z0: complex) -> complex:
    """Bisect toward the centroid until inside (v40:122-132 semantics)."""
    cc = poly.centroid
    z = complex(z0)
    if poly.contains([z])[0]:
        return z
    for _ in range(60):
        z = 0.5 * z + 0.5 * cc
        if poly.contains([z])[0]:
            return z
    return cc


def slightly_inside(z, a: complex, eps: float = 1e-3):
    """Convex shrink toward an interior point (v40:135-138)."""
    z = np.asarray(z, dtype=np.complex128)
    return (1.0 - eps) * z + eps * a


def sample_interior_points(poly: Polygon, n: int, seed: int = 0, max_tries: int = 2_000_000,
                           batch: int = 8192):
    """Uniform rejection sampling inside the polygon (v40:149-162).

    Same distribution as the reference's per-point loop but drawn in batches
    (vectorized contains); the accept/reject stream is identical because the
    same uniform draws are made in the same x,y order.
    """
    rng = np.random.default_rng(seed)
    minx, miny, maxx, maxy = poly.bounds
    out = []
    k = 0
    tries = 0
    while k < n and tries < max_tries:
        m = min(batch, max_tries - tries)
        # interleaved draws to match the reference's x,y per-try order
        u = rng.uniform(size=(m, 2))
        xs = minx + (maxx - minx) * u[:, 0]
        ys = miny + (maxy - miny) * u[:, 1]
        tries += m
        ok = poly.contains(np.column_stack([xs, ys]))
        acc = xs[ok] + 1j * ys[ok]
        out.append(acc[: n - k])
        k += min(len(acc), n - k)
    return (np.concatenate(out) if out else np.empty(0, complex)), tries
