"""Plain reference of the Green-function statistics of four families of
inverse-eigenvalue clouds and of a stored boundary curve
(lucas_equipotential_test_v3.py), written from the upstream's lines in numpy.

  * the clouds (:66-118): for each family and n, the eigenvalues of the n x n
    companion matrix whose first row is the family's and whose subdiagonal is
    ones; eigenvalues with |lambda| <= eig_tol dropped, the rest inverted.
    lucas_all_ones takes its roots from ``lucas`` (a contraction, no
    eigensolver), the other three from ``numpy.linalg.eigvals``;
  * g_M(c) (:124-162): from z = 0, z <- (x^2 - y^2 + cx, 2xy + cy) with no
    fused multiply-add; k the first step with |z|^2 > R^2 (the squared test of
    the reference package the port is held to); g = max(log|z_k| 2^-k, 0),
    its log as 0.5 log(x^2 + y^2); a point that does not escape within
    max_iter reads (g, k) = (0, max_iter), as does one escaping on the last
    step;
  * the rows (:168-246, :294-327): the summary of g (count, escaped = g > 0,
    the escaped share, median, mean, std, p10, p90 of the escaped g), the
    reference laws of the escaped g (KS statistics and log-likelihoods of
    the uniform on [0, gmax], the exponential of rate 1 / mean and the
    uniform on [gmin, gmax], the ECDF on an 800-point grid), per n and for
    every cumulative N of lucas_all_ones, one summary a family, and the
    summary and laws of the curve.

g is computed on the program's own points: a root moved by one rounding can
move a point's escape step, so the reference's roots are held to the
program's by ``cloud_gap`` alone, as the pair cell judges C's box dimension.
``level="stated"`` computes in f64 (complex128 roots); "lower", the control,
one step down: the roots in complex64 and the Green loop in f32.
"""

from __future__ import annotations

import math

import numpy as np

from benchmarks.reference import lucas

#: an ECDF's grid points, as the reference's compare_reference_laws
LAW_GRID = 800
#: the escaped values a law needs, else no laws (the reference's guard)
LAW_MIN = 30
SUMMARY_COUNTS = ("count", "escaped")
SUMMARY_VALUES = ("escaped_frac", "g_median", "g_mean", "g_std", "g_p10", "g_p90")
LAW_VALUES = ("gmin", "gmax", "g_mean", "ks_uniform_0_gmax", "ks_exponential",
              "ks_loguniform_phi", "ll_uniform_0_gmax", "ll_exponential", "ll_loguniform_phi")
NUMBERS = ("cloud_gap", "k_moved", "g_gap", "rows_count_gap", "rows_gap")


def precision(level: str):
    """(complex dtype of the roots, real dtype of the Green loop)."""
    if level == "stated":
        return np.complex128, np.float64
    if level == "lower":
        return np.complex64, np.float32
    raise ValueError(f"unknown level {level!r}")


def _ns(cfg: dict) -> range:
    return range(int(cfg["n_min"]), int(cfg["n_max"]) + 1)


def first_row(family: str, n: int) -> np.ndarray:
    """The first row of the family's n x n companion matrix (:66-91)."""
    top = np.ones(n)
    if family == "pell_like_all_twos":
        top *= 2.0
    elif family == "sparser_gap_1_0_1_then_ones":
        if n >= 2:
            top[1] = 0.0
    elif family == "padovan_like_0_1_then_ones":
        top[0] = 0.0
    elif family != "lucas_all_ones":
        raise ValueError(f"unknown family {family!r}")
    return top


def inverse_roots(family: str, n: int, tol: float, dtype=np.complex128) -> np.ndarray:
    """1 / lambda of the eigenvalues lambda of one companion matrix with
    |lambda| > tol, in `dtype` (complex128 or complex64)."""
    if family == "lucas_all_ones":
        return lucas.inverse_cloud([n], dtype)[0]
    real = np.float64 if dtype == np.complex128 else np.float32
    mat = np.zeros((n, n), dtype=real)
    mat[0] = first_row(family, n)
    mat[np.arange(1, n), np.arange(n - 1)] = 1.0
    lam = np.linalg.eigvals(mat).astype(dtype)
    lam = lam[np.abs(lam) > tol]
    return (1.0 / lam).astype(dtype)


def clouds(cfg: dict, level: str) -> dict:
    """{family: [one array of inverse roots a n]} in the level's precision."""
    cdt, _ = precision(level)
    return {f: [inverse_roots(f, n, float(cfg["eig_tol"]), cdt) for n in _ns(cfg)]
            for f in cfg["families"]}


def green(c, max_iter: int, escape_r: float, real=np.float64):
    """(g, k) of the points c in the real dtype `real`; g as float64, k int64.
    The survivors are compacted at each step where one escapes."""
    c = np.asarray(c).ravel()
    cr, ci = c.real.astype(real), c.imag.astype(real)
    g = np.zeros(c.size)
    k = np.full(c.size, max_iter, dtype=np.int64)
    r2 = real(escape_r) * real(escape_r)
    two, half = real(2.0), real(0.5)
    idx = np.arange(c.size)
    x, y = np.zeros_like(cr), np.zeros_like(ci)
    xx, yy = x * x, y * y
    with np.errstate(over="ignore", invalid="ignore"):
        for step in range(1, max_iter + 1):
            if not idx.size:
                break
            y = two * (x * y) + ci
            x = xx - yy + cr
            xx, yy = x * x, y * y
            s = xx + yy
            hit = s > r2
            if not hit.any():
                continue
            at = idx[hit]
            k[at] = step
            gg = (half * np.log(s[hit])) * np.exp2(-real(step))
            g[at] = np.where(np.isfinite(gg) & (gg >= 0), gg, 0).astype(np.float64)
            keep = ~hit
            idx, cr, ci, x, y, xx, yy = (a[keep] for a in (idx, cr, ci, x, y, xx, yy))
    return g, k


def summarize(g) -> dict:
    """The summary row of one array of g (:168-184): the escaped are g > 0."""
    g = np.asarray(g, dtype=float)
    out = g[g > 0]
    any_out = out.size > 0
    nan = float("nan")
    return {"count": int(g.size), "escaped": int(out.size),
            "escaped_frac": float(out.size / g.size) if g.size else nan,
            "g_median": float(np.median(out)) if any_out else nan,
            "g_mean": float(np.mean(out)) if any_out else nan,
            "g_std": float(np.std(out)) if any_out else nan,
            "g_p10": float(np.quantile(out, 0.10)) if any_out else nan,
            "g_p90": float(np.quantile(out, 0.90)) if any_out else nan}


def reference_laws(g):
    """The three laws against the ECDF of the escaped g (:213-246); None with
    fewer than LAW_MIN of them."""
    g = np.asarray(g, dtype=float)
    g = g[np.isfinite(g) & (g > 0)]
    if g.size < LAW_MIN:
        return None
    gmin, gmax, mean = float(g.min()), float(g.max()), float(g.mean())
    rate = 1.0 / max(mean, 1e-15)
    grid = np.linspace(0.0, gmax, LAW_GRID)
    ecdf = np.searchsorted(np.sort(g), grid, side="right") / g.size
    cdfs = {"ks_uniform_0_gmax": np.clip(grid / (gmax + 1e-15), 0.0, 1.0),
            "ks_exponential": 1.0 - np.exp(-rate * np.maximum(grid, 0.0)),
            "ks_loguniform_phi": np.clip((grid - gmin) / ((gmax - gmin) + 1e-15), 0.0, 1.0)}
    return {"n": int(g.size), "gmin": gmin, "gmax": gmax, "g_mean": mean,
            **{name: float(np.max(np.abs(ecdf - cdf))) for name, cdf in cdfs.items()},
            "ll_uniform_0_gmax": g.size * -math.log(gmax + 1e-15),
            "ll_exponential": g.size * math.log(rate + 1e-15) - rate * float(np.sum(g)),
            "ll_loguniform_phi": g.size * -math.log((gmax - gmin) + 1e-15),
            "grid": grid, "ecdf": ecdf}


def rows(family_g: dict, ns, lucas_sizes, curve_g) -> dict:
    """Every row of the run from the g of each family's concatenated cloud
    (lucas_all_ones cut into the sizes `lucas_sizes` of the n in `ns`) and
    of the curve."""
    g = family_g["lucas_all_ones"]
    per_n, cumulative, at = [], [], 0
    for n, size in zip(ns, lucas_sizes):
        per_n.append({"n": n, **summarize(g[at : at + size])})
        at += size
        cumulative.append({"N": n, **summarize(g[:at])})
    return {"summary": summarize(g), "laws": reference_laws(g), "per_n": per_n,
            "cumulative": cumulative,
            "family_summary": [{**summarize(v), "family": f} for f, v in family_g.items()],
            "curve_summary": summarize(curve_g), "curve_laws": reference_laws(curve_g)}


def equipotential(curve, cfg: dict, level: str = "stated", roots=None) -> dict:
    """The reference's clouds (`roots`, from ``clouds``, where given) and the
    g and k of the curve's points, in the level's precision."""
    _, real = precision(level)
    g, k = green(curve, int(cfg["max_iter"]), float(cfg["escape_radius"]), real)
    return {"level": level, "clouds": clouds(cfg, level) if roots is None else roots,
            "curve": {"c": np.asarray(curve), "g": g, "k": k}}


def as_output(ref: dict, cfg: dict) -> dict:
    """The reference's own run in the form of run_equipotential's result:
    the Green loop on its own clouds in its level's precision, and the rows."""
    _, real = precision(ref["level"])
    fams = {}
    for f, sets in ref["clouds"].items():
        c = np.concatenate(sets).astype(np.complex128)
        g, k = green(c, int(cfg["max_iter"]), float(cfg["escape_radius"]), real)
        fams[f] = {"c": c, "g": g, "k": k}
    sizes = [len(s) for s in ref["clouds"]["lucas_all_ones"]]
    return {"points": {"families": fams, "curve": ref["curve"]},
            **rows({f: v["g"] for f, v in fams.items()}, _ns(cfg), sizes, ref["curve"]["g"])}


def _rel(a, b) -> float:
    """|a - b| / |b| for numbers or arrays (the largest entry), 0 where both
    are equal or both NaN, infinite where b is 0 alone or one side is NaN or
    the shapes differ."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    if a.shape != b.shape:
        return math.inf
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    if same.all():
        return 0.0
    a, b = a[~same], b[~same]
    if np.isnan(a).any() or np.isnan(b).any() or (b == 0).any():
        return math.inf
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _rows_gaps(program: dict, reference: dict):
    """(rows_count_gap, rows_gap): the largest |p - r| of a row's count,
    escaped count and n or N (the laws' n too), and the largest relative gap
    of its values, the laws' ECDF and grid among them. Infinite where a row,
    a family or a law is missing on one side only."""
    pairs = [(program.get("summary"), reference["summary"])]
    for key in ("per_n", "cumulative", "family_summary"):
        p, r = program.get(key) or [], reference[key]
        if len(p) != len(r):
            return math.inf, math.inf
        pairs += list(zip(p, r))
    if any(p is None or p.get("family") != r.get("family") for p, r in pairs):
        return math.inf, math.inf
    pairs.append((program.get("curve_summary"), reference["curve_summary"]))
    laws = [(program.get("laws"), reference["laws"]),
            (program.get("curve_laws"), reference["curve_laws"])]
    counts, values = 0.0, 0.0
    for p, r in pairs:
        if p is None:
            return math.inf, math.inf
        keys = [k for k in (*SUMMARY_COUNTS, "n", "N") if k in r]
        counts = max(counts, *(abs(float(p.get(k, math.inf)) - float(r[k])) for k in keys))
        values = max(values, *(_rel(p[k], r[k]) for k in SUMMARY_VALUES))
    for p, r in laws:
        if (p is None) != (r is None):
            return math.inf, math.inf
        if r is not None:
            counts = max(counts, abs(float(p["n"]) - float(r["n"])))
            values = max(values, *(_rel(p[k], r[k]) for k in (*LAW_VALUES, "grid", "ecdf")))
    return counts, values


def compare(program: dict, reference: dict, cfg: dict) -> dict:
    """The numbers compared, each a gap of the program's result from the
    reference: cloud_gap, the largest Hausdorff distance between the two root
    sets of one n and family (infinite where the sizes differ); k_moved, the
    points of the clouds and the curve whose escape step differs from the
    reference's f64 loop on the same points; g_gap, the largest relative gap
    of g over the points that escaped (k < max_iter) on both sides; the rows
    (``_rows_gaps``) against the reference's rows of that g. Every number is
    infinite where the program returned no per-point records of a family or
    of the curve."""
    pts = program.get("points")
    if (not pts or "curve" not in pts
            or list(pts.get("families", {})) != list(reference["clouds"])):
        return dict.fromkeys(NUMBERS, math.inf)
    max_iter, r = int(cfg["max_iter"]), float(cfg["escape_radius"])
    cloud_gap = max(lucas.cloud_gap(pts["families"][f]["c"], sets)
                    for f, sets in reference["clouds"].items())
    ref_g, mine = {}, []
    for f, rec in pts["families"].items():
        g, k = green(rec["c"], max_iter, r)
        ref_g[f] = g
        mine.append((rec, g, k))
    mine.append((pts["curve"], reference["curve"]["g"], reference["curve"]["k"]))
    moved, g_gap = 0, 0.0
    for rec, g, k in mine:
        pk, pg = np.asarray(rec["k"]), np.asarray(rec["g"], dtype=float)
        if pk.shape != k.shape or pg.shape != g.shape:
            return dict.fromkeys(NUMBERS, math.inf)
        moved += int(np.count_nonzero(pk != k))
        both = (pk < max_iter) & (k < max_iter)
        g_gap = max(g_gap, _rel(pg[both], g[both]))
    sizes = [len(s) for s in reference["clouds"]["lucas_all_ones"]]
    ref_rows = rows(ref_g, _ns(cfg), sizes, reference["curve"]["g"])
    counts, values = _rows_gaps(program, ref_rows)
    return {"cloud_gap": cloud_gap, "k_moved": float(moved), "g_gap": g_gap,
            "rows_count_gap": counts, "rows_gap": values}
