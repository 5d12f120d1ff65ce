"""Quasiconformal diagnostics: Beltrami μ/K, angle distortion, CR defects (T20).

Copy of ``cmtci/maps/qc.py`` (numpy).

Reference: lucas_to_cardioid_v18...py:487-634 (two Beltrami impls), :788-823
(PL gradients + Cauchy–Riemann defect), :826-839 (boundary-distance binned
medians). All per-triangle loops are vectorized.
"""

from __future__ import annotations

import numpy as np

from cmtci_torch.maps.fem import p1_grads_areas

EPS_FZ = 1e-10
MU_CAP = 0.9999


def triangle_gradients(points, triangles, values):
    """PL gradient of a nodal scalar per triangle (v18:788-807), (nT,2)."""
    p = np.asarray(points)
    t = np.asarray(triangles)
    x1, y1 = p[t[:, 0], 0], p[t[:, 0], 1]
    x2, y2 = p[t[:, 1], 0], p[t[:, 1], 1]
    x3, y3 = p[t[:, 2], 0], p[t[:, 2], 1]
    f1, f2, f3 = values[t[:, 0]], values[t[:, 1]], values[t[:, 2]]
    det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
    # the reference's guard (sign(det)*1e-30 + 1e-30, v18:803) is exactly 0
    # for tiny negative det; clamp magnitude with preserved sign instead
    det_safe = np.where(np.abs(det) < 1e-30, np.where(det < 0, -1e-30, 1e-30), det)
    dfdx = (f1 * (y2 - y3) + f2 * (y3 - y1) + f3 * (y1 - y2)) / det_safe
    dfdy = (f1 * (x3 - x2) + f2 * (x1 - x3) + f3 * (x2 - x1)) / det_safe
    return np.column_stack([dfdx, dfdy])


def cr_defect_metrics(points, triangles, u, v, eps: float = 1e-12):
    """Relative Cauchy–Riemann defect per triangle (v18:810-823)."""
    gu = triangle_gradients(points, triangles, np.asarray(u))
    gv = triangle_gradients(points, triangles, np.asarray(v))
    r1 = gu[:, 0] - gv[:, 1]
    r2 = gu[:, 1] + gv[:, 0]
    abs_def = np.sqrt(r1 * r1 + r2 * r2)
    scale = np.hypot(gu[:, 0], gu[:, 1]) + np.hypot(gv[:, 0], gv[:, 1]) + eps
    return abs_def, abs_def / scale


def beltrami_mu_k(points, triangles, phi, valid_vertex, eps_fz: float = EPS_FZ,
                  mu_cap: float = MU_CAP):
    """Beltrami coefficients and dilatations on valid triangles (v18:487-521).

    Returns (mus complex array, Ks array, used count) filtered like the
    compact reference implementation (fz small / |mu|>=cap dropped).
    """
    mus_full, ks_full, used = beltrami_full(points, triangles, phi, valid_vertex,
                                            eps_fz=eps_fz, mu_cap=mu_cap)
    m = used
    return mus_full[m], ks_full[m], int(m.sum())


def beltrami_full(points, triangles, phi, valid_vertex, eps_fz: float = 1e-15,
                  mu_cap: float = 0.999999):
    """K per triangle aligned with input (NaN where undefined), v18:524-583.

    Vectorized: the per-triangle 2x2 solves become closed-form inverses.
    Returns (mus_full, Ks_full, used_mask).
    """
    p = np.asarray(points)
    t = np.asarray(triangles)
    phi = np.asarray(phi, dtype=complex)
    vv = np.asarray(valid_vertex, dtype=bool)
    ok = vv[t].all(axis=1)

    z1, z2, z3 = (p[t[:, k], 0] + 1j * p[t[:, k], 1] for k in range(3))
    w1, w2, w3 = (phi[t[:, k]] for k in range(3))
    a11 = (z2 - z1).real
    a12 = (z2 - z1).imag
    a21 = (z3 - z1).real
    a22 = (z3 - z1).imag
    det = a11 * a22 - a12 * a21
    ok = ok & (np.abs(det) >= 1e-14)
    det_s = np.where(det == 0, 1.0, det)

    def solve2(b1, b2):
        return (a22 * b1 - a12 * b2) / det_s, (-a21 * b1 + a11 * b2) / det_s

    ux, uy = solve2((w2 - w1).real, (w3 - w1).real)
    vx, vy = solve2((w2 - w1).imag, (w3 - w1).imag)
    f_z = 0.5 * ((ux + vy) + 1j * (vx - uy))
    f_zb = 0.5 * ((ux - vy) + 1j * (vx + uy))
    ok = ok & (np.abs(f_z) >= eps_fz)
    with np.errstate(invalid="ignore", divide="ignore"):
        mu = np.where(ok, f_zb / np.where(np.abs(f_z) == 0, 1.0, f_z), np.nan)
    amu = np.abs(mu)
    ok = ok & np.isfinite(amu) & (amu < mu_cap)
    ks = np.where(ok, (1.0 + amu) / (1.0 - np.where(ok, amu, 0.0)), np.nan)
    return mu, ks, ok


def angle_distortion(points, triangles, phi, valid_vertex, eps_norm: float = 1e-14):
    """Angle error per triangle via Jacobian action on two edges (v18:586-634)."""
    p = np.asarray(points)
    t = np.asarray(triangles)
    phi = np.asarray(phi, dtype=complex)
    vv = np.asarray(valid_vertex, dtype=bool)
    grads, area = p1_grads_areas(p, t)
    ok = vv[t].all(axis=1) & (area >= 1e-14)

    f_loc = phi[t]  # (nT,3)
    fx = np.einsum("ta,ta->t", f_loc, grads[:, :, 0])
    fy = np.einsum("ta,ta->t", f_loc, grads[:, :, 1])
    d1 = p[t[:, 1]] - p[t[:, 0]]
    d2 = p[t[:, 2]] - p[t[:, 0]]
    jac = np.stack([np.stack([fx.real, fy.real], axis=-1),
                    np.stack([fx.imag, fy.imag], axis=-1)], axis=1)  # (nT,2,2)
    dd1 = np.einsum("tij,tj->ti", jac, d1)
    dd2 = np.einsum("tij,tj->ti", jac, d2)

    def angle(u, v):
        nu = np.linalg.norm(u, axis=1)
        nv = np.linalg.norm(v, axis=1)
        c = np.einsum("ti,ti->t", u, v) / np.maximum(nu * nv, 1e-300)
        bad = (nu < eps_norm) | (nv < eps_norm)
        return np.where(bad, np.nan, np.arccos(np.clip(c, -1.0, 1.0)))

    before = angle(d1, d2)
    after = angle(dd1, dd2)
    err = np.abs(after - before)
    return err[ok & np.isfinite(before) & np.isfinite(after)]


def binned_median(x, y, bin_edges):
    """(a, b, median(y|bin), count) per bin (v18:831-839)."""
    out = []
    for a, b in zip(bin_edges[:-1], bin_edges[1:]):
        m = (x >= a) & (x < b)
        if m.any():
            out.append((float(a), float(b), float(np.median(y[m])), int(m.sum())))
        else:
            out.append((float(a), float(b), float("nan"), 0))
    return out
