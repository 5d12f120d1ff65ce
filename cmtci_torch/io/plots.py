"""Figure writers of the boundary and equipotential pipelines (subset of
``cmtci/io/plots.py``, copied unchanged apart from the import).

matplotlib is imported inside each function, never at module import: a
machine without it still runs every pipeline with ``plots=False``
(``--no-plots``), and asking it for a figure raises an ImportError that says
so.
"""

from __future__ import annotations

import numpy as np

from cmtci_torch.io.writers import ensure_dir
from cmtci_torch.stats.laws import kde_or_smooth_hist
from cmtci_torch.utils.arrays import as_xy as _xy

#: PNG encode at zlib level 1 (lossless; the reference's setting)
_PNG_FAST = {"compress_level": 1}


def pyplot():
    """matplotlib.pyplot on the Agg backend; raises ImportError naming
    --no-plots when matplotlib is missing."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("the figures need matplotlib, which is not installed; "
                          "pass --no-plots (plots=False) to skip them") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_boundary_overlay(points, boundary, path, title=""):
    plt = pyplot()
    p, b = _xy(points), _xy(boundary)
    fig = plt.figure(figsize=(6, 6))
    plt.scatter(p[:, 0], p[:, 1], s=2, alpha=0.25)
    plt.plot(b[:, 0], b[:, 1], lw=1.0)
    plt.title(title)
    plt.axis("equal")
    plt.axis("off")
    plt.tight_layout()
    fig.savefig(ensure_dir(path), dpi=220, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path


def plot_g_density_compare(laws_out: dict, g_out, prefix):
    """g-space and |Phi|-space density figures vs the reference laws
    (lucas_equipotential_test_v3.py:251-288). Returns the two PNG paths."""
    import math

    plt = pyplot()
    g_out = np.asarray(g_out, dtype=float)
    grid = np.asarray(laws_out["grid"])
    gmin, gmax = laws_out["gmin"], laws_out["gmax"]
    rate = 1.0 / max(laws_out["g_mean"], 1e-15)

    fig = plt.figure()
    plt.hist(g_out, bins=120, density=True, alpha=0.6,
             label="empirical hist (outside)")
    plt.plot(grid, kde_or_smooth_hist(g_out, grid), linewidth=2.0, label="KDE")
    plt.plot(grid, np.where((grid >= 0) & (grid <= gmax),
                            1.0 / (gmax + 1e-15), 0.0),
             linewidth=1.5, label="uniform g on [0,gmax]")
    plt.plot(grid, rate * np.exp(-rate * np.maximum(grid, 0.0)),
             linewidth=1.5, label="exponential g")
    plt.plot(grid, np.where((grid >= gmin) & (grid <= gmax),
                            1.0 / ((gmax - gmin) + 1e-15), 0.0),
             linewidth=1.5, label="log-uniform |Phi|")
    plt.xlabel("g_M(c)")
    plt.ylabel("density")
    plt.title("Empirical density of g_M(c) (outside) + reference laws")
    plt.legend()
    plt.tight_layout()
    p_g = f"{prefix}_g_density_compare.png"
    fig.savefig(ensure_dir(p_g), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)

    r_abs = np.exp(g_out)
    rmin, rmax = float(r_abs.min()), float(r_abs.max())
    rgrid = np.linspace(1.0, rmax, len(grid))
    fig = plt.figure()
    plt.hist(r_abs, bins=120, density=True, alpha=0.6,
             label="empirical hist of |Phi|")
    plt.plot(rgrid, kde_or_smooth_hist(r_abs, rgrid), linewidth=2.0,
             label="KDE(|Phi|)")
    norm = math.log((rmax + 1e-15) / (rmin + 1e-15))
    plt.plot(rgrid, np.where((rgrid >= rmin) & (rgrid <= rmax),
                             1.0 / (rgrid * (norm + 1e-15)), 0.0),
             linewidth=1.5, label="log-uniform |Phi| model")
    plt.xlabel("|Phi(c)|")
    plt.ylabel("density")
    plt.title("Empirical density of |Phi(c)| (outside)")
    plt.legend()
    plt.tight_layout()
    p_phi = f"{prefix}_Phi_density_logunif.png"
    fig.savefig(ensure_dir(p_phi), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return p_g, p_phi


def plot_family_kde_overlay(family_g: dict, path, kde_grid_n: int = 800,
                            min_outside: int = 50):
    """KDE overlays of g_M(c) across companion families
    (lucas_equipotential_test_v3.py:417-446)."""
    plt = pyplot()
    arrs = {f: np.asarray(g, dtype=float) for f, g in family_g.items()}
    outs = {f: g[g > 0] for f, g in arrs.items()}
    outs = {f: g for f, g in outs.items() if len(g) > min_outside}
    if not outs:
        return None
    gmax = max(float(g.max()) for g in outs.values())
    grid = np.linspace(0.0, gmax, kde_grid_n)
    fig = plt.figure()
    for fam, g in outs.items():
        plt.plot(grid, kde_or_smooth_hist(g, grid), label=fam)
    plt.xlabel("g_M(c)")
    plt.ylabel("density (KDE)")
    plt.title("KDE overlays of g_M(c) for different families (outside)")
    plt.legend()
    plt.tight_layout()
    fig.savefig(ensure_dir(path), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path
