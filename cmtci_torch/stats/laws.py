"""Reference-law comparison and convergence statistics for g_M (T18-T19).

Reference: lucas_equipotential_test_v3.py:168-357 — summarize_g, ECDF-vs-CDF
KS statistics + log-likelihoods for three candidate laws (uniform on
[0,gmax], exponential(rate=1/mean), uniform on [gmin,gmax] == log-uniform in
|Phi|), KDE-or-smoothed-histogram density, per-n and cumulative convergence
rows.
"""

from __future__ import annotations

import math

import numpy as np

try:
    from scipy.stats import gaussian_kde

    HAVE_SCIPY = True
except Exception:  # pragma: no cover
    gaussian_kde = None
    HAVE_SCIPY = False


def summarize_outside(g_out, n_total: int) -> dict:
    """summarize_g given the already-extracted outside (g>0) values.

    Value-identical to summarize_g on the full array: the outside subset is
    extracted in order, ``outside.mean()`` equals the exact integer ratio
    escaped/count in f64, and every statistic runs the same numpy call on
    the same values. Exposed so per-prefix callers (cumulative convergence
    rows, equipotential.py) can extract the escaped values ONCE — a prefix
    of the full array's escaped extraction IS the prefix's escaped
    extraction — instead of re-masking the prefix per row.
    """
    g_out = np.asarray(g_out, dtype=float)
    any_out = len(g_out) > 0
    def q(p):
        return float(np.quantile(g_out, p)) if any_out else float("nan")
    return {
        "count": int(n_total),
        "escaped": int(len(g_out)),
        "escaped_frac": float(len(g_out) / n_total) if n_total else float("nan"),
        "g_median": float(np.median(g_out)) if any_out else float("nan"),
        "g_mean": float(np.mean(g_out)) if any_out else float("nan"),
        "g_std": float(np.std(g_out)) if any_out else float("nan"),
        "g_p10": q(0.10),
        "g_p90": q(0.90),
    }


def summarize_g(g, label: str = "") -> dict:
    """Escaped-fraction and outside-g stats (lucas_equipotential_test_v3.py:168-184)."""
    g = np.asarray(g, dtype=float)
    return summarize_outside(g[g > 0], len(g))


def kde_or_smooth_hist(samples, grid, hist_bins: int = 120):
    """scipy KDE with smoothed-histogram fallback (:201-211)."""
    samples = np.asarray(samples, dtype=float)
    grid = np.asarray(grid, dtype=float)
    if len(samples) < 5:
        return np.zeros_like(grid)
    if HAVE_SCIPY:
        return gaussian_kde(samples)(grid)
    hist, edges = np.histogram(samples, bins=min(hist_bins, max(10, len(samples) // 50)), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    dens = np.interp(grid, centers, hist, left=0.0, right=0.0)
    w = max(3, len(grid) // 200)
    return np.convolve(dens, np.ones(w) / w, mode="same")


def compare_reference_laws(g_out, kde_grid_n: int = 800) -> dict | None:
    """KS + log-likelihood vs the three candidate laws (:213-246).

    Returns None with <30 outside points, matching the reference guard.
    """
    g = np.asarray(g_out, dtype=float)
    g = g[np.isfinite(g)]
    g = g[g > 0]
    if len(g) < 30:
        return None
    gmin, gmax = float(g.min()), float(g.max())
    mean = float(g.mean())
    rate = 1.0 / max(mean, 1e-15)

    grid = np.linspace(0.0, gmax, kde_grid_n)
    g_sorted = np.sort(g)
    ecdf = np.searchsorted(g_sorted, grid, side="right") / len(g_sorted)

    cdf_unif0 = np.clip(grid / (gmax + 1e-15), 0.0, 1.0)
    cdf_exp = 1.0 - np.exp(-rate * np.maximum(grid, 0.0))
    cdf_logunif = np.clip((grid - gmin) / ((gmax - gmin) + 1e-15), 0.0, 1.0)

    return {
        "n": int(len(g)),
        "gmin": gmin,
        "gmax": gmax,
        "g_mean": mean,
        "ks_uniform_0_gmax": float(np.max(np.abs(ecdf - cdf_unif0))),
        "ks_exponential": float(np.max(np.abs(ecdf - cdf_exp))),
        "ks_loguniform_phi": float(np.max(np.abs(ecdf - cdf_logunif))),
        "ll_uniform_0_gmax": float(len(g) * (-math.log(gmax + 1e-15))),
        "ll_exponential": float(len(g) * math.log(rate + 1e-15) - rate * np.sum(g)),
        "ll_loguniform_phi": float(len(g) * (-math.log((gmax - gmin) + 1e-15))),
        "grid": grid,
        "ecdf": ecdf,
    }
