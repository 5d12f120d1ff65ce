"""Symmetry analysis: discrete ops + best reflection-axis search (port of
``cmtci/stats/symmetry.py``).

Reference: symmetry_phase_bestaxis.py:36-296 — ops {identity, reflect_x,
reflect_y, rot_pi, reflect about an arbitrary axis through the centroid};
preservation fraction = share of points whose symmetric image has a nearest
neighbor within TOL; 361-angle coarse scan then bounded scalar refinement.
(The reference file as checked in has a SyntaxError at :181 — `bounds=`
passed twice to minimize_scalar; the clear intent, a bounded refine within
±5° of the coarse optimum, is what ``cmtci`` implements and this copies.)

The op images are exact host f64 (copied unchanged). The nearest-neighbour
distances are a blocked min-distance scan in torch, in the scan dtype on the
caller's device, and the angle scan reflects the cloud about every angle at
once and scans all the images together.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device

#: elements of one block's distance matrix in the nearest-distance scan
_BLOCK_ELEMS = 1 << 24


def reflect_across_line(points, angle: float, origin=None):
    """Reflect about the line through `origin` at `angle` (radians).

    Matches symmetry_phase_bestaxis.py:51-77 (rotate by -angle, flip y,
    rotate back).
    """
    points = _xy(points)
    if origin is None:
        origin = points.mean(axis=0)
    p = points - origin
    c, s = math.cos(angle), math.sin(angle)
    # rotate by -angle, reflect y -> -y, rotate by +angle == reflection matrix
    refl = np.array([[c * c - s * s, 2 * s * c], [2 * s * c, s * s - c * c]])
    return p @ refl.T + origin


def apply_symmetry_op(points, op: str, angle: float | None = None):
    """symmetry_phase_bestaxis.py:79-93 semantics."""
    p = _xy(points).copy()
    if op == "identity":
        return p
    if op == "reflect_x":
        p[:, 1] = -p[:, 1]
        return p
    if op == "reflect_y":
        p[:, 0] = -p[:, 0]
        return p
    if op == "rot_pi":
        return -p
    if op == "reflect_angle":
        if angle is None:
            raise ValueError("angle must be provided for reflect_angle")
        return reflect_across_line(p, angle, origin=p.mean(axis=0))
    raise ValueError(f"Unknown op {op}")


def nearest_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min_j |a_i - b_j| for each row i of a (..., 2) tensor `a` against the
    (m, 2) tensor `b`, in their dtype on their device; blocked over the rows
    of a so that one block's distance matrix holds about _BLOCK_ELEMS
    entries. Returns a tensor of a's leading shape."""
    lead = a.shape[:-1]
    a = a.reshape(-1, 2)
    rows = max(1, _BLOCK_ELEMS // max(1, b.shape[0]))
    out = torch.empty(a.shape[0], dtype=a.dtype, device=a.device)
    for i in range(0, a.shape[0], rows):
        blk = a[i : i + rows]
        dx = blk[:, 0, None] - b[None, :, 0]
        dy = blk[:, 1, None] - b[None, :, 1]
        out[i : i + rows] = torch.sqrt(torch.min(dx * dx + dy * dy, dim=1).values)
    return out.reshape(lead)


def preservation_fractions(points, ops, tol: float = 0.05, dtype=torch.float64,
                           device="cuda"):
    """preservation_fraction of every op in one scan. Returns (fracs list,
    distances (len(ops), N) as f64 numpy)."""
    dev = resolve_device(device)
    p = _xy(points)
    qs = np.stack([apply_symmetry_op(p, op) for op in ops])
    d = nearest_distances(torch.as_tensor(qs, dtype=dtype, device=dev),
                          torch.as_tensor(p, dtype=dtype, device=dev))
    d = d.cpu().numpy().astype(np.float64)
    return [float((di <= tol).mean()) for di in d], d


def preservation_fraction(points, op: str, tol: float = 0.05, angle: float | None = None,
                          dtype=torch.float64, device="cuda"):
    """Fraction of points whose op-image is within tol of some point.

    The op image is computed exactly in host f64; the nearest-neighbour
    scan runs in `dtype` on `device` (f32 distances carry ~1e-7 relative
    noise against a 0.05 tolerance)."""
    dev = resolve_device(device)
    p = _xy(points)
    q = apply_symmetry_op(p, op, angle)
    d = nearest_distances(torch.as_tensor(q, dtype=dtype, device=dev),
                          torch.as_tensor(p, dtype=dtype, device=dev))
    d = d.cpu().numpy().astype(np.float64)
    return float((d <= tol).mean()), d


def _reflect_batch(p: torch.Tensor, angles: torch.Tensor, origin: torch.Tensor):
    """Reflect p (N,2) about lines through origin at each angle -> (A,N,2)."""
    q = p - origin
    c2 = torch.cos(2.0 * angles)[:, None]
    s2 = torch.sin(2.0 * angles)[:, None]
    x, y = q[:, 0][None, :], q[:, 1][None, :]
    xr = c2 * x + s2 * y
    yr = s2 * x - c2 * y
    return torch.stack([xr, yr], dim=-1) + origin


def _score_angles(points, angles, tol: float, dtype=torch.float64, device="cuda"):
    """Preserved fraction for each reflection angle, as f64 numpy: the cloud
    reflected about every angle at once, in `dtype` on `device`, and one
    nearest-distance scan of all the images against the cloud."""
    dev = resolve_device(device)
    p = torch.as_tensor(_xy(points), dtype=dtype, device=dev)
    origin = p.mean(dim=0)
    refl = _reflect_batch(p, torch.as_tensor(np.asarray(angles), dtype=dtype, device=dev),
                          origin)
    d = nearest_distances(refl, p)
    tol_t = torch.tensor(tol, dtype=dtype, device=dev)
    # the mean as the reference's XLA forms it, the count times 1/N: the f64
    # scores then equal the reference's to the last bit
    frac = (d <= tol_t).to(dtype).sum(dim=1) * (1.0 / d.shape[1])
    return frac.cpu().numpy().astype(np.float64)


def best_reflection_axis(points_a, points_b, tol: float = 0.05, n_angles: int = 361,
                         refine: bool = True, dtype=None, device="cuda", mesh=None):
    """Coarse 0..pi scan + bounded refine of the joint preservation score.

    Returns dict(angle, frac_a, frac_b, scan_angles, scan_score).
    Score = frac_a + frac_b, maximized (symmetry_phase_bestaxis.py:153-199).
    In f64 the refine is scipy's bounded minimize_scalar (xatol 1e-4), each
    evaluation a scan on `device`; in f32 it is two batched grid stages of
    128 angles (±π/36 around the coarse optimum, then around the first
    stage's peak: a final step of about 2.2e-5 rad). dtype=None is f64.
    With a `mesh` the coarse scan's angles are sharded over its ranks
    (parallel.sharded.sharded_score_angles, bitwise the single-device
    scores) and the refine runs on the rank's device; the sharded scan is
    the f64 path, so mesh and dtype are mutually exclusive.
    """
    angles = np.linspace(0, np.pi, n_angles)
    if mesh is not None and dtype is not None:
        raise ValueError(
            "best_reflection_axis: mesh and dtype are mutually exclusive — the "
            "sharded scan is the f64 multi-device path; the f32 device scan is "
            "single-device (drop one of them). Mixing them would pick the angle "
            "at f64 but report f32 fractions.")
    dtype = torch.float64 if dtype is None else dtype
    if mesh is not None:
        from cmtci_torch.parallel.sharded import sharded_score_angles

        dev = mesh.device
        fa = sharded_score_angles(points_a, angles, tol, mesh)
        fb = sharded_score_angles(points_b, angles, tol, mesh)
    else:
        dev = resolve_device(device)
        fa = _score_angles(points_a, angles, tol, dtype, dev)
        fb = _score_angles(points_b, angles, tol, dtype, dev)
    score = fa + fb
    best = float(angles[np.argmax(score)])

    if refine and dtype == torch.float32:
        half = math.pi / 36
        best_sc = float(score[np.argmax(score)])
        for _ in range(2):
            lo = max(0.0, best - half)
            hi = min(math.pi, best + half)
            grid = np.linspace(lo, hi, 128)
            sc = (_score_angles(points_a, grid, tol, dtype, dev)
                  + _score_angles(points_b, grid, tol, dtype, dev))
            k = int(np.argmax(sc))
            if sc[k] >= best_sc:  # the incumbent is not on the new grid:
                best, best_sc = float(grid[k]), float(sc[k])  # never regress
            half = grid[1] - grid[0]
    elif refine:
        from scipy.optimize import minimize_scalar

        def neg(a):
            sa = _score_angles(points_a, np.array([a]), tol, dtype, dev)[0]
            sb = _score_angles(points_b, np.array([a]), tol, dtype, dev)[0]
            return -(sa + sb)

        lo = max(0.0, best - math.pi / 36)
        hi = min(math.pi, best + math.pi / 36)
        res = minimize_scalar(neg, bounds=(lo, hi), method="bounded",
                              options={"xatol": 1e-4})
        if res.success:
            best = float(res.x)

    # the final fractions use the scan's dtype and device
    frac_a, _ = preservation_fraction(points_a, "reflect_angle", tol, angle=best,
                                      dtype=dtype, device=dev)
    frac_b, _ = preservation_fraction(points_b, "reflect_angle", tol, angle=best,
                                      dtype=dtype, device=dev)
    return {"angle": best, "frac_a": frac_a, "frac_b": frac_b,
            "scan_angles": angles, "scan_score": score}


def symmetry_report(c_aligned, m_points, matches=None, tol: float = 0.05,
                    scan_dtype=torch.float64, device="cuda"):
    """Full op table + best-axis row (symmetry_phase_bestaxis.py:118-211).

    scan_dtype applies to the op table's scans and the best-axis scan."""
    rows = []
    c = _xy(c_aligned)
    m = _xy(m_points)
    ops = ("identity", "reflect_x", "reflect_y", "rot_pi")
    fcs, dcs = preservation_fractions(c, ops, tol, dtype=scan_dtype, device=device)
    fms, dms = preservation_fractions(m, ops, tol, dtype=scan_dtype, device=device)
    for op, fc, dc, fm, dm in zip(ops, fcs, dcs, fms, dms):
        row = {
            "op": op, "angle_deg": None,
            "preserved_construct_frac": fc, "preserved_mandel_frac": fm,
            "mean_distC": float(dc.mean()), "mean_distM": float(dm.mean()),
        }
        if matches is not None:
            c_op = apply_symmetry_op(c, op)
            m_op = apply_symmetry_op(m, op)[np.asarray(matches, dtype=int)]
            d_cross = np.linalg.norm(c_op - m_op, axis=1)
            row["cross_preserved_frac"] = float((d_cross <= tol).mean())
        rows.append(row)

    best = best_reflection_axis(c, m, tol, dtype=scan_dtype, device=device)
    row = {
        "op": "reflect_best_angle", "angle_deg": float(np.degrees(best["angle"])),
        "preserved_construct_frac": best["frac_a"],
        "preserved_mandel_frac": best["frac_b"],
    }
    if matches is not None:
        c_ref = reflect_across_line(c, best["angle"], origin=c.mean(axis=0))
        m_ref = reflect_across_line(m, best["angle"], origin=m.mean(axis=0))[np.asarray(matches, dtype=int)]
        row["cross_preserved_frac"] = float((np.linalg.norm(c_ref - m_ref, axis=1) <= tol).mean())
    rows.append(row)
    return rows, best
