"""Figure writers of the boundary, equipotential, TCI, stage-1, curvature,
spectral, multifractal, embeddings, spatial-stats, report, coupling and
uniformize-fem pipelines (subset of ``cmtci/io/plots.py``, copied unchanged apart from the
imports).

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


def plot_alignment(c, m, c_aligned, path, title="Construct vs Mandelbrot (aligned)"):
    plt = pyplot()
    c, m, ca = _xy(c), _xy(m), _xy(c_aligned)
    fig = plt.figure(figsize=(8, 6))
    if len(m):
        plt.scatter(m[:, 0], m[:, 1], s=6, c="red", label="Mandel sample")
    if len(c):
        plt.scatter(c[:, 0], c[:, 1], s=6, c="blue", alpha=0.6, label="Construct")
    if len(ca):
        plt.scatter(ca[:, 0], ca[:, 1], s=6, c="cyan", alpha=0.65, label="Construct aligned")
    plt.legend()
    plt.axis("equal")
    plt.title(title)
    fig.savefig(ensure_dir(path), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path


def plot_curvature(p, kappa, prefix):
    """Histogram + color overlay (boundary_curvature_localpoly.py:195-218)."""
    plt = pyplot()
    p = _xy(p)
    fig = plt.figure(figsize=(6, 4))
    plt.hist(np.asarray(kappa), bins=64)
    plt.xlabel(r"Curvature $\kappa$")
    plt.ylabel("Count")
    plt.title("Local-Polynomial Curvature Histogram")
    plt.tight_layout()
    fig.savefig(ensure_dir(f"{prefix}_curvature_hist.png"), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)

    fig = plt.figure(figsize=(5, 5))
    sc = plt.scatter(p[:, 0], p[:, 1], c=np.asarray(kappa), s=8)
    plt.axis("equal")
    plt.axis("off")
    plt.colorbar(sc, fraction=0.046, pad=0.04)
    plt.title("Curvature Overlay (Local-Polynomial)")
    plt.tight_layout()
    fig.savefig(f"{prefix}_curvature_overlay.png", dpi=220, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return f"{prefix}_curvature_hist.png", f"{prefix}_curvature_overlay.png"


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


def plot_kl_descent(kls, path, title="KL descent (TCI flow)"):
    plt = pyplot()
    fig = plt.figure()
    plt.plot(np.asarray(kls))
    plt.xlabel("t")
    plt.ylabel("D_KL")
    plt.title(title)
    plt.tight_layout()
    fig.savefig(ensure_dir(path), dpi=150, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path


def plot_field(field, domain, path, title="", cmap="viridis"):
    plt = pyplot()
    fig = plt.figure()
    plt.imshow(np.asarray(field), origin="lower",
               extent=[domain[0], domain[1], domain[2], domain[3]], cmap=cmap)
    plt.colorbar()
    plt.title(title)
    plt.tight_layout()
    fig.savefig(ensure_dir(path), dpi=150, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path


def plot_multifractal_compare(res_c, res_m, prefix):
    """D(q) and f(alpha) comparison plots (multifractal_phase6.py:150-172)."""
    plt = pyplot()
    fig = plt.figure(figsize=(8, 5))
    plt.plot(res_c["q"], res_c["Dq"], "o-", label="Construct D(q)")
    plt.plot(res_m["q"], res_m["Dq"], "s-", label="Mandel D(q)")
    plt.xlabel("q")
    plt.ylabel("D(q)")
    plt.legend()
    plt.grid(True)
    plt.title("Generalized dimensions D(q)")
    fig.savefig(ensure_dir(f"{prefix}_Dq_compare.png"), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)

    fig = plt.figure(figsize=(8, 5))
    plt.plot(res_c["alpha"], res_c["f_alpha"], "o-", label=r"Construct f($\alpha$)")
    plt.plot(res_m["alpha"], res_m["f_alpha"], "s-", label=r"Mandel f($\alpha$)")
    plt.xlabel(r"$\alpha$")
    plt.ylabel(r"$f(\alpha)$")
    plt.legend()
    plt.grid(True)
    plt.title("Singularity spectrum")
    fig.savefig(f"{prefix}_falpha_compare.png", dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return f"{prefix}_Dq_compare.png", f"{prefix}_falpha_compare.png"


def plot_fft_reconstructions(c_pts, m_pts, path, modes=(5, 10, 30, 100),
                             ffts=None):
    """Low-mode IFFT reconstruction overlays (spatial_stats_phase4.py:60-78).

    ffts=(f_c, f_m) reuses already-computed boundary FFTs (run_spectral has
    them in scope); otherwise they are computed here.
    """
    import math

    from cmtci_torch.stats import spectral as sp

    plt = pyplot()
    if ffts is not None:
        f_c, f_m = ffts
    else:
        _, f_c = sp.boundary_fft(c_pts)
        _, f_m = sp.boundary_fft(m_pts)
    fig = plt.figure(figsize=(12, 6))
    nrows = 1 if len(modes) <= 2 else 2
    ncols = math.ceil(len(modes) / nrows)
    for i, nm in enumerate(modes, 1):
        rec_c = sp.reconstruct_low_modes(f_c, nm)
        rec_m = sp.reconstruct_low_modes(f_m, nm)
        ax = fig.add_subplot(nrows, ncols, i)
        ax.plot(rec_c.real, rec_c.imag, label=f"Construct {nm} modes", alpha=0.7)
        ax.plot(rec_m.real, rec_m.imag, label=f"Mandelbrot {nm} modes", alpha=0.7)
        ax.set_aspect("equal")
        ax.legend(fontsize=8)
        ax.set_title(f"Reconstruction with {nm} modes")
    fig.tight_layout()
    fig.savefig(ensure_dir(path), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path


def plot_embedding_scatter(points, vec, path, title=""):
    """Cloud colored by a diffusion eigenvector (dynamical_embeddings_phase7.py:158-169)."""
    plt = pyplot()
    p = _xy(points)
    fig = plt.figure(figsize=(6, 6))
    plt.scatter(p[:, 0], p[:, 1], s=6, c=np.asarray(vec), cmap="Spectral", alpha=0.8)
    plt.title(title)
    plt.colorbar()
    fig.savefig(ensure_dir(path), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path


def plot_eigenvalue_spectra(vals_c, vals_m, path):
    """Leading-eigenvalue decay comparison (dynamical_embeddings_phase7.py:142-152)."""
    plt = pyplot()
    vals_c = np.asarray(vals_c)
    vals_m = np.asarray(vals_m)
    fig = plt.figure(figsize=(6, 4))
    plt.plot(np.arange(1, len(vals_c) + 1), vals_c, "o-", label="Construct")
    plt.plot(np.arange(1, len(vals_m) + 1), vals_m, "s-", label="Mandelbrot")
    plt.xlabel("Mode index")
    plt.ylabel("Eigenvalue (symmetrized kernel)")
    plt.title("Spectrum (leading eigenvalues)")
    plt.legend()
    plt.grid(True)
    fig.savefig(ensure_dir(path), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path


def plot_k_bins(bins, tag, out_dir):
    """K-vs-distance-bin medians and counts (lucas_to_cardioid_v18...py:1037-1063).

    bins: list of (lo, hi, K_median, count) rows from qc.binned_median.
    """
    if not bins:
        return []
    plt = pyplot()
    mids = [(a + b) / 2.0 for a, b, _, _ in bins]
    kmed = [k for _, _, k, _ in bins]
    counts = [n for *_, n in bins]
    paths = []
    for ys, ylab, name in ((kmed, "median K in bin", "K_bins"),
                           (counts, "triangles per bin", "bin_counts")):
        fig = plt.figure()
        plt.plot(mids, ys, marker="o")
        plt.xlabel("boundary-distance bin midpoint (d)")
        plt.ylabel(ylab)
        plt.title(f"{'K vs distance bins' if name == 'K_bins' else 'bin counts'} ({tag})")
        plt.grid(True, alpha=0.3)
        plt.tight_layout()
        p = f"{out_dir}/{name}_{tag}.png"
        fig.savefig(ensure_dir(p), dpi=180, pil_kwargs=_PNG_FAST)
        plt.close(fig)
        paths.append(p)
    return paths

def plot_local_correlation_panels(u_c, u_m, corr_map, domain, path):
    """U_C / U_M / difference / local-r panels (Potentials.py:96-124)."""
    plt = pyplot()
    u_c = np.asarray(u_c)
    u_m = np.asarray(u_m)
    u_diff = u_c - u_m
    ext = [domain[0], domain[1], domain[2], domain[3]]
    fig, axs = plt.subplots(1, 4, figsize=(22, 5))
    specs = (
        (u_c, "Logarithmic Potential (Construct)", "viridis", None),
        (u_m, "Escape Potential (Mandelbrot)", "inferno", None),
        (u_diff, "Difference (Construct - Mandelbrot)", "coolwarm",
         (-np.nanmax(np.abs(u_diff)), np.nanmax(np.abs(u_diff)))),
        (corr_map, "Local Correlation Map", "RdYlGn", (-1, 1)),
    )
    for ax, (field, title, cmap, lims) in zip(axs, specs):
        kw = {} if lims is None else {"vmin": lims[0], "vmax": lims[1]}
        im = ax.imshow(field, extent=ext, origin="lower", cmap=cmap, **kw)
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(ensure_dir(path), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path


def plot_match_distance_hist(distances, path):
    """Matching-distance histogram (match_analysis_steps1_2.py:28-32)."""
    plt = pyplot()
    fig = plt.figure()
    plt.hist(np.asarray(distances), bins=50)
    plt.xlabel("Distance between matched points")
    plt.ylabel("Count")
    plt.title("Matching Distance Distribution")
    plt.tight_layout()
    fig.savefig(ensure_dir(path), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path


def plot_curvature_hotspots(c_pts, m_pts, curv_c, curv_m, path):
    """Side-by-side log1p-curvature scatters (spatial_stats_phase3b.py:17-42)."""
    plt = pyplot()
    c, m = _xy(c_pts), _xy(m_pts)
    fig = plt.figure(figsize=(12, 5))
    for i, (p, k, title) in enumerate(
            ((c, curv_c, "Construct curvature hotspots"),
             (m, curv_m, "Mandelbrot boundary curvature hotspots")), 1):
        ax = fig.add_subplot(1, 2, i)
        sc = ax.scatter(p[:, 0], p[:, 1], c=np.log1p(np.asarray(k)), cmap="plasma", s=6)
        fig.colorbar(sc, ax=ax, label="log(1+curvature)")
        ax.set_title(title)
        ax.set_aspect("equal")
    fig.suptitle("Curvature overlay: Construct vs Mandelbrot")
    fig.tight_layout()
    fig.savefig(ensure_dir(path), dpi=200, pil_kwargs=_PNG_FAST)
    plt.close(fig)
    return path
