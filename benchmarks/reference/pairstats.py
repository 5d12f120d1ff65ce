"""Plain reference of the spatial statistics of a construct C and a
Mandelbrot sample M (spatial_stats_phase2.py and spatial_stats_phase3.py),
written from their definitions.

  * shell counts: the pairs i < j of one cloud with r_k <= |p_i - p_j| < r_k + dr,
    r_k = 0, dr, ... below r_max (numpy's arange); rho = n / the area of the
    cloud's bounding box; g(r_k) = count_k / (2 pi r_k dr n rho), 0 at r = 0;
    K(r_k) = 2 (pairs closer than r_k) / (n rho);
  * the Hausdorff distance of C and M;
  * the gradient curvature |x' y'' - y' x''| / (x'^2 + y'^2)^(3/2) along each
    cloud's order, np.gradient with unit spacing;
  * the box-counting dimension over the 10 scales logspace(-2, 0) of the
    bounding box: the slope of log(occupied boxes) over log(1 / scale).

``level="stated"`` computes the pair scans in f64 on the device and the rest
in f64 on the host; "lower" (the control) computes the scans in the step below
the configured stat dtype (f32 -> bf16, f64 -> f32), the cloud in complex64
and the curvature and box counts in f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmarks.reference import lucas

_LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def precisions(cfg: dict, level: str) -> dict:
    if level == "stated":
        return {"cloud": np.complex128, "scan": torch.float64, "host": np.float64}
    if level == "lower":
        return {"cloud": np.complex64, "scan": _LOWER[getattr(torch, cfg["stat_dtype"])],
                "host": np.float32}
    raise ValueError(f"unknown level {level!r}")


def _xy(points, dtype, device):
    p = np.asarray(points)
    return torch.as_tensor(np.stack([p.real, p.imag], 1), device=device).to(dtype)


def shell_counts(points, r_max: float, dr: float, dtype, device, chunk: int = 1024):
    """int64 numpy counts of each shell [r_k, r_k + dr)."""
    r = np.arange(0, r_max, dr)
    edges = torch.as_tensor(np.concatenate([r, [r[-1] + dr]]), dtype=torch.float64, device=device)
    xy = _xy(points, dtype, device)
    n = xy.shape[0]
    counts = torch.zeros(len(r) + 1, dtype=torch.int64, device=device)
    for i in range(0, n - 1, chunk):
        blk = xy[i : i + chunk]
        rest = xy[i + 1 :]
        d = torch.sqrt((blk[:, None, 0] - rest[None, :, 0]) ** 2
                       + (blk[:, None, 1] - rest[None, :, 1]) ** 2).double()
        upper = (torch.arange(rest.shape[0], device=device)[None, :]
                 >= torch.arange(blk.shape[0], device=device)[:, None])  # j > i
        k = torch.bucketize(d[upper], edges, right=True) - 1
        k = torch.where((k >= 0) & (k < len(r)), k, len(r))
        counts += torch.bincount(k, minlength=len(r) + 1)
    return counts[:-1].cpu().numpy()


def g_and_k(points, counts, r_max: float, dr: float):
    p = np.asarray(points)
    n = p.size
    rho = n / ((p.real.max() - p.real.min()) * (p.imag.max() - p.imag.min()))
    r = np.arange(0, r_max, dr)
    norm = 2 * np.pi * r * dr * n * rho
    g = np.where(norm > 0, counts / np.where(norm > 0, norm, 1.0), 0.0)
    below = np.concatenate([[0.0], np.cumsum(counts)[:-1]])
    return g, 2.0 * below / (n * rho)


def hausdorff(a, b, dtype, device, chunk: int = 1024) -> float:
    xa, xb = _xy(a, dtype, device), _xy(b, dtype, device)

    def directed(p, q):
        best = torch.zeros((), dtype=torch.float64, device=device)
        for i in range(0, p.shape[0], chunk):
            blk = p[i : i + chunk]
            d2 = (blk[:, None, 0] - q[None, :, 0]) ** 2 + (blk[:, None, 1] - q[None, :, 1]) ** 2
            best = torch.maximum(best, d2.min(dim=1).values.max().double())
        return best

    return float(torch.sqrt(torch.maximum(directed(xa, xb), directed(xb, xa))))


def curvature(points, dtype) -> np.ndarray:
    p = np.asarray(points)
    x, y = p.real.astype(dtype), p.imag.astype(dtype)
    dx, dy = np.gradient(x), np.gradient(y)
    ddx, ddy = np.gradient(dx), np.gradient(dy)
    return (np.abs(dx * ddy - dy * ddx) / (dx**2 + dy**2) ** 1.5).astype(np.float64)


def box_dimension(points, dtype) -> float:
    p = np.asarray(points)
    xy = np.stack([p.real, p.imag], 1).astype(dtype)
    scales = np.logspace(-2, 0, 10, base=10.0)
    lo = xy.min(axis=0)
    span = xy.max(axis=0) - lo
    boxes = [len(np.unique(np.floor((xy - lo) / (span * s).astype(dtype)).astype(np.int64), axis=0))
             for s in scales]
    return float(np.polyfit(np.log(1 / scales), np.log(boxes), 1)[0])


def spatial_stats(m, cfg: dict, device, level: str = "stated") -> dict:
    """The reference's statistics of its own cloud C, in its own order, and
    of the sample M."""
    prec = precisions(cfg, level)
    ns = range(int(cfg["n_min"]), int(cfg["n_max"]) + 1)
    c_sets = lucas.inverse_cloud(ns, prec["cloud"])
    c = np.concatenate(c_sets).astype(np.complex128)
    r_max, dr = cfg["r_max"], cfg["dr"]
    out = {"cloud_sets": c_sets,
           "counts_construct": shell_counts(c, r_max, dr, prec["scan"], device),
           "counts_mandel": shell_counts(m, r_max, dr, prec["scan"], device),
           "hausdorff": hausdorff(c, m, prec["scan"], device),
           "curv_construct": curvature(c, prec["host"]),
           "curv_mandel": curvature(m, prec["host"]),
           "fractal_dim_construct": box_dimension(c, prec["host"]),
           "fractal_dim_mandel": box_dimension(m, prec["host"])}
    for name, pts in (("construct", c), ("mandel", m)):
        out[f"g_{name}"], out[f"K_{name}"] = g_and_k(pts, out[f"counts_{name}"], r_max, dr)
    return out


def as_output(ref: dict, m) -> dict:
    """A reference result in the form of a job's output, for the control."""
    keys = ("g_construct", "g_mandel", "K_construct", "K_mandel", "hausdorff",
            "curv_construct", "curv_mandel", "fractal_dim_construct", "fractal_dim_mandel")
    return {"cloud": np.concatenate(ref["cloud_sets"]).astype(np.complex128), "m": m,
            "stats": {k: ref[k] for k in keys}}


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    if a.shape != b.shape:
        return math.inf
    scale = np.max(np.abs(b))
    gap = np.max(np.abs(a - b)) if a.size else 0.0
    return float(gap / scale) if scale > 0 else (0.0 if gap == 0 else math.inf)


def _curv_gap(a, b) -> float:
    """Largest |a - b| over max(|b|, the median |b|), finite b only; a
    non-finite value where b is finite counts infinite."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    if a.shape != b.shape:
        return math.inf
    ok = np.isfinite(b)
    if not np.all(np.isfinite(a[ok])):
        return math.inf
    floor = np.median(np.abs(b[ok]))
    return float(np.max(np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), floor)))


def compare(program: dict, reference: dict, cfg: dict) -> dict:
    """The numbers compared, each a gap of the program from the reference:
    cloud_gap, the largest Hausdorff distance between the two root sets of
    one n (infinite where the sizes differ); shells_moved, the share of the
    pairs within r_max that the program counts in another shell (its counts
    read back from its g and K); gk_gap, the largest gap of g or K over the
    largest reference value of that curve; hausdorff_gap, relative;
    curv_gap, over max(|reference|, its median), the reference's C in the
    program's order of each n's roots (``lucas.in_order``); boxdim_gap,
    absolute, C's on the program's own C."""
    c, m, st = program["cloud"], program["m"], program["stats"]
    # the curvature of C follows the order in which the program gives each
    # n's roots: the reference's own roots, put in that order, are the
    # reference's curve. A box count of C moves with any rounding of a point
    # on a box edge (the real axis is one at the finest scale, and the roots
    # that are real lie on it to rounding): the box dimension of C is judged
    # on the program's own C, which cloud_gap holds to the reference's roots
    ordered = lucas.in_order(c, reference["cloud_sets"])
    box_c = box_dimension(c, np.float64)
    r_max, dr = cfg["r_max"], cfg["dr"]
    moved, total = 0.0, 0.0
    gk = 0.0
    for name, pts in (("construct", c), ("mandel", m)):
        ref_counts = reference[f"counts_{name}"]
        g, k = np.asarray(st[f"g_{name}"]), np.asarray(st[f"K_{name}"])
        n = np.asarray(pts).size
        p = np.asarray(pts)
        rho = n / ((p.real.max() - p.real.min()) * (p.imag.max() - p.imag.min()))
        r = np.arange(0, r_max, dr)
        counts = np.empty(len(r))
        counts[1:] = g[1:] * 2 * np.pi * r[1:] * dr * n * rho
        counts[0] = k[1] * n * rho / 2.0
        moved += float(np.abs(np.rint(counts) - ref_counts).sum())
        total += float(ref_counts.sum())
        gk = max(gk, _rel(g, reference[f"g_{name}"]), _rel(k, reference[f"K_{name}"]))
    return {
        "cloud_gap": lucas.cloud_gap(c, reference["cloud_sets"]),
        "shells_moved": moved / total if total > 0 else math.inf,
        "gk_gap": gk,
        "hausdorff_gap": abs(st["hausdorff"] - reference["hausdorff"]) / reference["hausdorff"],
        "curv_gap": max(math.inf if ordered is None
                        else _curv_gap(st["curv_construct"], curvature(ordered, np.float64)),
                        _curv_gap(st["curv_mandel"], reference["curv_mandel"])),
        "boxdim_gap": max(abs(st["fractal_dim_construct"] - box_c),
                          abs(st["fractal_dim_mandel"] - reference["fractal_dim_mandel"])),
    }
