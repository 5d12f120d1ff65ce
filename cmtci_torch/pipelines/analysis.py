"""The analysis pipelines of ``cmtci/pipelines/analysis.py`` on PyTorch: the
TCI flow (``cmtci tci``) and the bus analyses ``multifractal``,
``embeddings``, ``symmetry``, ``spatial-stats`` and ``report``.

``run_tci`` ports TCIConfig and run_tci (tci_construct_mandelbrot_v002_fixed.py:
120-170): the inverse-eigenvalue cloud C, the TCI boundary sample M, the
kernel-argmax match and Procrustes, the defensive Hausdorff / curvature /
spectral metrics, the probability histograms and the KL trajectory of the
TCI flow.

One host stream np.random.RandomState(seed) is consumed in the reference's
order: the sampler, the matcher's subsample, then the two rng.choice draws
of the metrics. de_impl picks the boundary sampler:
  * "numpy": the host numpy DE, bitwise the reference's numpy path;
  * "torch": the plain-torch f64 DE field on `device` (the reference's
    "jax");
  * "cuda": the hand-written K1 kernel (its twin on a CPU device), with the
    q25 band and the subsample on the device, plus the f32 matcher and f32
    pca_eccentricity (the reference's "pallas").

The bus analyses read the stage-1 file bus (multifractal_phase6.py,
dynamical_embeddings_phase7.py, symmetry_phase_bestaxis.py,
spatial_stats_phase2/3.py, phase5_report.py) and write the reference's files.
Each dtype argument selects the reference's f32 option (torch.float32) or
its f64 default; both run on `device`, apart from the host numpy parts the
reference also keeps on the host.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cmtci_torch.io import writers
from cmtci_torch.kernels import companion, mandelbrot
from cmtci_torch.stats import curvature as curv
from cmtci_torch.stats import embeddings as emb
from cmtci_torch.stats import multifractal as mf
from cmtci_torch.stats import pointstats as ps
from cmtci_torch.stats import spectral as sp
from cmtci_torch.stats import symmetry as sym
from cmtci_torch.transport import giflow
from cmtci_torch.transport import histogram as hg
from cmtci_torch.transport.procrustes import procrustes_align_no_scale
from cmtci_torch.transport.sinkhorn import entropic_argmax_match
from cmtci_torch.utils.artifacts import StageTimer
from cmtci_torch.utils.device import resolve_device

#: sampler implementations of the TCI pipeline; the reference's names map
#: onto them (jax -> torch, pallas -> cuda)
TCI_DE_IMPLS = ("torch", "numpy", "cuda")
_REFERENCE_DE_IMPL = {"jax": "torch", "pallas": "cuda"}

#: above this many points the dense spectral kernel is refused (the
#: reference's MemoryError guard), so Spectral_L2 is NaN at the defaults
SPECTRAL_MAX_POINTS = 8000


@dataclass
class TCIConfig:
    # the reference's fields, in its order (cmtci/pipelines/analysis.py:110)
    construct_ns: tuple = tuple(range(20, 301, 20))
    mandelbrot_grid: int = 600
    mandelbrot_samples: int = 25000
    escape_r: float = 250.0
    max_iter: int = 250
    grid_bins: int = 128
    domain: tuple = (-2.25, 1.25, -1.75, 1.75)
    alpha: float = 0.2
    t_steps: int = 60
    eps: float = 1e-12
    sinkhorn_eps: float = 0.8
    curvature_k: int = 6
    spectral_k: int = 30
    spectral_sigma: float = 0.05
    seed: int = 7
    cloud_backend: str = "aberth"
    de_impl: str = "torch"  # "cuda" = the K1 kernel path; "numpy" = parity


def tci_config_from_reference(d: dict) -> TCIConfig:
    """TCIConfig from ``dataclasses.asdict`` of a ``cmtci`` TCIConfig (or its
    JSON form): the same fields, with de_impl mapped jax -> torch and
    pallas -> cuda, and the tuples restored."""
    names = {f.name for f in dataclasses.fields(TCIConfig)}
    kw = {k: v for k, v in d.items() if k in names}
    if "domain" in kw:
        kw["domain"] = tuple(float(v) for v in kw["domain"])
    if "construct_ns" in kw:
        kw["construct_ns"] = tuple(int(v) for v in kw["construct_ns"])
    if "de_impl" in kw:
        kw["de_impl"] = _REFERENCE_DE_IMPL.get(kw["de_impl"], kw["de_impl"])
    return TCIConfig(**kw)


def run_tci(cfg: TCIConfig, out_json: Optional[str] = None, plots: bool = True,
            timer: Optional[StageTimer] = None, device="cuda"):
    """The v002_fixed main pipeline on `device`. Returns (out, kls, traj):
    out holds Hausdorff_before, Curvature_corr, Spectral_L2, KL_initial,
    KL_final and runtime_sec, as in the reference. With `out_json` the
    results JSON and _meta.txt are written, and the two figures unless
    plots=False. `timer` records the layers cloud, sample, match, stats,
    hist and flow (device-synchronized on CUDA)."""
    if cfg.de_impl not in TCI_DE_IMPLS:
        raise ValueError(f"unknown de_impl {cfg.de_impl!r}; expected one of {TCI_DE_IMPLS}")
    dev = resolve_device(device)
    timer = timer if timer is not None else StageTimer(dev)
    f32 = cfg.de_impl == "cuda"
    t0 = time.time()
    rng = np.random.RandomState(cfg.seed)
    with timer.stage("cloud"):
        c_pts = companion.inverse_cloud(list(cfg.construct_ns), backend=cfg.cloud_backend,
                                        device=dev)
    with timer.stage("sample"):
        m_pts = mandelbrot.sample_boundary_quantile(
            cfg.domain, cfg.mandelbrot_grid, cfg.mandelbrot_samples, cfg.max_iter,
            cfg.escape_r, cfg.eps, rng, dtype=torch.float32 if f32 else torch.float64,
            impl=cfg.de_impl, device=dev)
    with timer.stage("match"):
        m_match, c_trim = entropic_argmax_match(
            c_pts, m_pts, cfg.sinkhorn_eps, rng, backend="torch",
            dtype=torch.float32 if f32 else None, device=dev)
        c_aligned = procrustes_align_no_scale(c_trim, m_match, convention="reference")

    # defensive metrics like the reference (tci_..._v002_fixed.py:129-145): a
    # metric that fails gives NaN, with a warning naming the failure; the
    # spectral distance over the full sample would need a dense 25000²
    # eigensolve, so a cloud above SPECTRAL_MAX_POINTS gives NaN up front
    with timer.stage("stats"):
        try:
            n = min(len(c_aligned), len(m_pts))
            c_sub = rng.choice(c_aligned, n, replace=False)
            m_sub = rng.choice(m_pts, n, replace=False)
            h0 = ps.hausdorff(c_sub, m_sub, device=dev)
            ecc_dt = torch.float32 if f32 else torch.float64
            curv_corr = float(np.corrcoef(
                curv.pca_eccentricity(c_sub, cfg.curvature_k, dtype=ecc_dt, device=dev),
                curv.pca_eccentricity(m_sub, cfg.curvature_k, dtype=ecc_dt, device=dev),
            )[0, 1])
        except (RuntimeError, ValueError, IndexError) as exc:
            warnings.warn(f"run_tci: Hausdorff/curvature failed ({exc!r}); NaN")
            h0, curv_corr = float("nan"), float("nan")
        dspec = float("nan")
        if max(len(c_aligned), len(m_pts)) <= SPECTRAL_MAX_POINTS:
            try:
                dspec = sp.spectral_distance(c_aligned, m_pts, cfg.spectral_k,
                                             cfg.spectral_sigma, device=dev)
            except (RuntimeError, ValueError) as exc:
                warnings.warn(f"run_tci: spectral distance failed ({exc!r}); NaN")

    with timer.stage("hist"):
        p_m = hg.to_prob(m_pts, cfg.grid_bins, cfg.domain, cfg.eps)
        x_c = hg.to_prob(c_aligned, cfg.grid_bins, cfg.domain, cfg.eps)
    with timer.stage("flow"):
        kls, traj = giflow.tci_flow(p_m, x_c, cfg.alpha, cfg.t_steps, cfg.eps)

    out = {
        "Hausdorff_before": float(h0),
        "Curvature_corr": curv_corr,
        "Spectral_L2": float(dspec),
        "KL_initial": float(kls[0]),
        "KL_final": float(kls[-1]),
        "runtime_sec": time.time() - t0,
    }
    if out_json:
        writers.write_json(out_json, out)
        prefix = out_json.rsplit(".", 1)[0]
        if plots:
            from cmtci_torch.io import plots as plot_io

            plot_io.plot_kl_descent(kls, f"{prefix}_KL_descent.png")
            plot_io.plot_field(traj[-1], cfg.domain, f"{prefix}_XT_final.png",
                               title="Final histogram X_T")
        writers.write_config_meta(f"{prefix}_meta.txt", cfg)
    return out, kls, traj


def run_multifractal(c_pts, m_pts, q_values=None, scales=None, out_prefix=None,
                     box_backend="host", box_dtype=torch.float64, plots=True, device="cuda"):
    """Both clouds through the box-counting spectrum; CSV per cloud.

    box_backend="device" computes the counts and partition sums in
    box_dtype on `device`; "host" is the reference's numpy grouping."""
    dev = resolve_device(device)
    res_c = mf.multifractal_spectrum(c_pts, q_values, scales, backend=box_backend,
                                     dtype=box_dtype, device=dev)
    res_m = mf.multifractal_spectrum(m_pts, q_values, scales, backend=box_backend,
                                     dtype=box_dtype, device=dev)
    if out_prefix:
        for res, name in ((res_c, "construct"), (res_m, "mandel")):
            out = np.column_stack((res["q"], res["tau"], res["Dq"], res["alpha"], res["f_alpha"]))
            writers.ensure_dir(f"{out_prefix}_{name}_multifractal.csv")
            np.savetxt(f"{out_prefix}_{name}_multifractal.csv", out, delimiter=",",
                       header="q,tau,Dq,alpha,f_alpha", comments="")
        if plots:
            from cmtci_torch.io import plots as plot_io

            plot_io.plot_multifractal_compare(res_c, res_m, out_prefix)
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "q_values": list(np.asarray(res_c["q"])),
            "scales": list(np.asarray(res_c["scales"])),
            "n_construct": len(np.asarray(c_pts)), "n_mandel": len(np.asarray(m_pts))})
    return {"construct": res_c, "mandel": res_m}


def run_embeddings(c_pts, m_pts, k_nn=20, n_eigs=8, eps_scale=0.5, out_prefix=None,
                   eig_backend="scipy", eig_dtype=torch.float64, knn_dtype=torch.float64,
                   plots=True, device="cuda"):
    """Diffusion-map embeddings + spectral distance (phase7).

    eig_backend="device" runs the dense Lanczos in eig_dtype on `device`
    instead of the scipy eigsh parity oracle; knn_dtype=torch.float32 runs the
    kNN search with hi/lo coordinates."""
    dev = resolve_device(device)
    vals_c, vecs_c, sigma_c = emb.diffusion_map(c_pts, k_nn, n_eigs, eps_scale,
                                                eig_backend=eig_backend, eig_dtype=eig_dtype,
                                                knn_dtype=knn_dtype, device=dev)
    vals_m, vecs_m, sigma_m = emb.diffusion_map(m_pts, k_nn, n_eigs, eps_scale,
                                                eig_backend=eig_backend, eig_dtype=eig_dtype,
                                                knn_dtype=knn_dtype, device=dev)
    dist = emb.embedding_spectral_distance(vals_c, vals_m)
    if out_prefix:
        for vals, vecs, name in ((vals_c, vecs_c, "construct"), (vals_m, vecs_m, "mandel")):
            writers.ensure_dir(f"{out_prefix}_eigenvalues_{name}.csv")
            np.savetxt(f"{out_prefix}_eigenvalues_{name}.csv",
                       np.column_stack((np.arange(1, len(vals) + 1), vals)),
                       delimiter=",", header="idx,lambda")
            np.save(f"{out_prefix}_eigenvectors_{name}.npy", vecs)
        with open(f"{out_prefix}_spectral_distance.txt", "w") as f:
            f.write(f"spectral_distance_norm = {dist}\n")
        if plots:
            from cmtci_torch.io import plots as plot_io

            plot_io.plot_eigenvalue_spectra(vals_c, vals_m, f"{out_prefix}_spectra_compare.png")
            for pts, vecs, name in ((c_pts, vecs_c, "construct"), (m_pts, vecs_m, "mandel")):
                comp = 1 if vecs.shape[1] >= 3 else 0
                plot_io.plot_embedding_scatter(
                    pts, vecs[:, comp], f"{out_prefix}_{name}_embedding_vec{comp}.png",
                    title=f"{name} embedding (colored by eigenvector {comp})")
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "k_nn": k_nn, "n_eigs": n_eigs, "eps_scale": eps_scale,
            "sigma_construct": sigma_c, "sigma_mandel": sigma_m})
    return {"vals_construct": vals_c, "vals_mandel": vals_m,
            "sigma_construct": sigma_c, "sigma_mandel": sigma_m,
            "spectral_distance": dist}


def run_symmetry(c_aligned, m_pts, matches=None, tol=0.05, out_prefix=None,
                 scan_dtype=torch.float64, device="cuda"):
    """Symmetry op table + best axis (symmetry_phase_bestaxis.py)."""
    rows, best = sym.symmetry_report(c_aligned, m_pts, matches, tol, scan_dtype=scan_dtype,
                                     device=device)
    if out_prefix:
        writers.write_dict_rows_csv(f"{out_prefix}_symmetry_report_bestaxis.csv", rows)
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "tol": tol, "n_construct": len(np.asarray(c_aligned)),
            "n_mandel": len(np.asarray(m_pts))})
    return {"rows": rows, "best": best}


def run_spatial_stats(c_aligned, m_pts, r_max=1.5, dr=0.05, out_prefix=None,
                      stat_dtype=torch.float64, plots=True, device="cuda", mesh=None,
                      timer: Optional[StageTimer] = None):
    """phase2 + phase3: g(r), Ripley K, Hausdorff, gradient curvature, box dim.

    stat_dtype=torch.float32 runs the three O(n²) pair scans (the shell
    counts of each cloud and the Hausdorff distance) in f32 on `device`:
    the counts stay exact int64, a borderline pair can land one bin over.
    With a `mesh` the shell counts shard over its ranks (bitwise the
    single-device counts), the rest runs on the rank's device, and only
    rank 0 writes.

    `timer` records the stages spatial_stats.shells_construct,
    spatial_stats.shells_mandel, spatial_stats.hausdorff,
    spatial_stats.curvature and spatial_stats.boxdim (device-synchronized on
    CUDA, each ending where the host already waits for the card or the card
    has nothing queued), on one device the shell scans' counters
    spatial_stats.distances and spatial_stats.in_shells (a mesh counts
    neither), and on a card spatial_stats.box_scales_card, the (cloud,
    scale) box counts of the one boxcount.cu launch (20 at the default
    scales); the result holds them as stage_times and counts."""
    from cmtci_torch.parallel.sharded import is_writer

    dev = mesh.device if mesh is not None else resolve_device(device)
    timer = timer if timer is not None else StageTimer(dev)
    if not is_writer(mesh):
        out_prefix = None
    with timer.stage("spatial_stats.shells_construct"):
        shells_c = ps._shell_counts(c_aligned, r_max, dr, dtype=stat_dtype, device=dev,
                                    mesh=mesh, count=timer.count)
    with timer.stage("spatial_stats.shells_mandel"):
        shells_m = ps._shell_counts(m_pts, r_max, dr, dtype=stat_dtype, device=dev, mesh=mesh,
                                    count=timer.count)
    r_c, g_c = ps.pair_correlation(c_aligned, r_max, dr, _shells=shells_c)
    r_m, g_m = ps.pair_correlation(m_pts, r_max, dr, _shells=shells_m)
    _, k_c = ps.ripley_k(c_aligned, r_max, dr, _shells=shells_c)
    _, k_m = ps.ripley_k(m_pts, r_max, dr, _shells=shells_m)
    out = {
        "r": r_c, "g_construct": g_c, "g_mandel": g_m,
        "K_construct": k_c, "K_mandel": k_m,
    }
    with timer.stage("spatial_stats.hausdorff"):
        out["hausdorff"] = ps.hausdorff(c_aligned, m_pts, dtype=stat_dtype, device=dev)
    with timer.stage("spatial_stats.curvature"):
        out["curv_construct"] = curv.gradient_curvature(np.asarray(c_aligned), device=dev)
        out["curv_mandel"] = curv.gradient_curvature(np.asarray(m_pts), device=dev)
    with timer.stage("spatial_stats.boxdim"):
        (fd_c, _), (fd_m, _) = ps.fractal_dimensions((c_aligned, m_pts), device=dev,
                                                     count=timer.count)
    out["fractal_dim_construct"] = fd_c
    out["fractal_dim_mandel"] = fd_m
    if out_prefix:
        writers.write_dict_rows_csv(f"{out_prefix}_spatial_stats.csv", [{
            "hausdorff": out["hausdorff"],
            "fractal_dim_construct": fd_c, "fractal_dim_mandel": fd_m,
        }])
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "r_max": r_max, "dr": dr, "n_construct": len(np.asarray(c_aligned)),
            "n_mandel": len(np.asarray(m_pts))})
        if plots:
            from cmtci_torch.io import plots as plot_io

            plot_io.plot_curvature_hotspots(
                c_aligned, m_pts, out["curv_construct"], out["curv_mandel"],
                f"{out_prefix}_curvature_hotspots.png")
    out["stage_times"] = dict(timer.times)
    out["counts"] = dict(timer.counts)
    return out


def run_report(c, m, c_aligned, matches, out_prefix=None, plots=True, device="cuda"):
    """phase5 integrative summary (phase5_report.py:190-217 schema)."""
    dev = resolve_device(device)
    row = {"n_construct": len(c), "n_mandel": len(m), "n_aligned": len(c_aligned)}
    match_d = None
    if matches is not None and len(matches):
        ln = min(len(matches), len(c_aligned), len(m))
        match_d = np.linalg.norm(np.asarray(c_aligned)[:ln] - np.asarray(m)[np.asarray(matches)[:ln]], axis=1)
        d = match_d
        row.update(match_min=float(d.min()), match_median=float(np.median(d)),
                   match_mean=float(d.mean()), match_max=float(d.max()),
                   match_std=float(d.std()))
    row["hausdorff"] = ps.hausdorff(c_aligned, m, device=dev)
    for pts, name in ((c_aligned, "construct"), (m, "mandel")):
        k = curv.gradient_curvature(np.asarray(pts), device=dev)
        k = k[np.isfinite(k)]
        row[f"curv_{name}_median"] = float(np.median(k))
        row[f"curv_{name}_mean"] = float(np.mean(k))
        fd, _ = ps.fractal_dimension(pts, device=dev)
        row[f"fractal_dim_{name}"] = float(fd)
    if out_prefix:
        writers.write_dict_rows_csv(f"{out_prefix}_phase5_summary.csv", [row])
        writers.write_config_meta(f"{out_prefix}_meta.txt", {
            "n_construct": len(c), "n_mandel": len(m), "n_aligned": len(c_aligned)})
        if plots:
            from cmtci_torch.io import plots as plot_io

            plot_io.plot_alignment(c, m, c_aligned, f"{out_prefix}_matching_visualization.png",
                                   title="Initial matching visualization")
            if match_d is not None:
                plot_io.plot_match_distance_hist(match_d,
                                                 f"{out_prefix}_match_distance_hist.png")
    return row
