"""Green-function statistics pipeline on PyTorch.

Port of ``cmtci/pipelines/equipotential.py``. Reference:
lucas_equipotential_test_v3.py:363-448 — aggregate cloud g_M stats,
reference-law comparison, per-n and cumulative convergence rows, 4-family
comparison.

The four families' clouds go through ONE batched potential solve on
`device`: potential_dtype="float64" is the f64 Green loop
(mandelbrot.green_potential_compacted: on a card one stage, one orbit_green
launch over the whole budget; on the CPU and on a mesh stages of 512 steps
with the survivors compacted), "float32" the hand-written K3 kernel
(mandelbrot_cuda.green_cloud_f32; its twin on a CPU device). The per-n
and cumulative rows reuse that solve: g is a per-point quantity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmtci_torch.io import plots as figures
from cmtci_torch.io import writers
from cmtci_torch.kernels import companion
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels import mandelbrot_cuda as mc
from cmtci_torch.stats import laws
from cmtci_torch.utils import artifacts
from cmtci_torch.utils.artifacts import StageTimer
from cmtci_torch.utils.device import resolve_device

POTENTIAL_DTYPES = ("float64", "float32")


@dataclass
class EquipotentialConfig:
    n_min: int = 2
    n_max: int = 200
    max_iter: int = 20000
    escape_radius: float = 2.0
    eig_tol: float = 1e-12
    families: tuple = (
        "lucas_all_ones",
        "pell_like_all_twos",
        "sparser_gap_1_0_1_then_ones",
        "padovan_like_0_1_then_ones",
    )
    run_family_comparison: bool = True
    cloud_backend: str = "aberth"
    potential_dtype: str = "float64"  # "float32" = the K3 kernel
    # optional stored-curve analysis (lucas_equipotential_test_v3.py:390-403):
    # path to an .npy of boundary points ((N,2) xy or complex)
    curve_npy: str | None = None


def batch_potential(cloud: np.ndarray, max_iter: int, escape_radius: float,
                    cache_dir: str | None = None, dtype: str = "float64", device="cuda",
                    mesh=None):
    """(g, it, phi) for a complex cloud on `device`. With cache_dir the
    result is stored keyed by (cloud digest, max_iter, R, dtype) and the
    implementation: the port's f64 results differ from the reference's in
    the last bits, so the two never share an entry. With a `mesh` the
    points are sharded over its ranks: in f32 each rank runs the K3 head on
    its block (parallel.sharded.sharded_green_cloud_f32), in f64 each
    compaction stage's points are split (parallel.sharded.
    green_stage_executor); only rank 0 stores the cache entry. In f64 on a
    card without a mesh, one stage of the whole budget (one orbit_green
    launch; bitwise the staged loop's records) runs it."""
    from cmtci_torch.parallel.sharded import (green_stage_executor, is_writer,
                                              sharded_green_cloud_f32)
    if dtype not in POTENTIAL_DTYPES:
        raise ValueError(f"unknown potential dtype {dtype!r}; expected {POTENTIAL_DTYPES}")

    def _run():
        if dtype == "float32" and mesh is not None:
            g, it, phi = sharded_green_cloud_f32(cloud, max_iter=max_iter,
                                                 escape_r=escape_radius, mesh=mesh)
        elif dtype == "float32":
            g, it, phi = mc.green_cloud_f32(cloud, max_iter=max_iter,
                                            escape_r=escape_radius, device=device)
        else:
            one_stage = mesh is None and resolve_device(device).type == "cuda"
            g, it, phi = mb.green_potential_compacted(
                cloud, max_iter=max_iter, escape_r=escape_radius,
                device=device if mesh is None else mesh.device,
                stage_executor=None if mesh is None else green_stage_executor(mesh),
                **({"stage_iters": max(max_iter, 1)} if one_stage else {}))
        return {"g": g, "it": it, "phi": phi}

    out = artifacts.cached(
        "green_potential",
        {"impl": "cmtci_torch", "cloud": artifacts.array_digest(cloud),
         "max_iter": max_iter, "escape_r": escape_radius,
         **({"dtype": dtype} if dtype != "float64" else {})},
        _run, cache_dir=cache_dir or ".cmtci_cache", enabled=cache_dir is not None,
        write=is_writer(mesh),
    )
    return np.asarray(out["g"]), np.asarray(out["it"]), np.asarray(out["phi"])


def _count_green(timer, it, max_iter: int) -> None:
    """Add one solve's escape steps `it` to the timer's Green-loop counters:
    ``equipotential.green_points``, the points solved;
    ``equipotential.green_unescaped``, the records with it = max_iter (no
    escape within the budget; an escape on the last step reads the same);
    ``equipotential.green_escape_steps``, the sum of it over the others."""
    it = np.asarray(it)
    escaped = it < max_iter
    timer.count("equipotential.green_points", int(it.size))
    timer.count("equipotential.green_unescaped", int(it.size - np.count_nonzero(escaped)))
    timer.count("equipotential.green_escape_steps", int(it[escaped].sum(dtype=np.int64)))


def _per_n_potentials(cfg: EquipotentialConfig, family: str | None = None,
                      cache_dir: str | None = None, clouds=None, g=None, device="cuda"):
    """g for every n's inverse-eigenvalue cloud in ONE batched solve. Returns
    a list of (n, g_array). Pass `clouds` (inverse_cloud_split output) and
    the matching flat `g` to reuse a solve already done."""
    fam = family or "lucas_all_ones"
    ns = list(range(cfg.n_min, cfg.n_max + 1))
    if clouds is None:
        clouds = companion.inverse_cloud_split(ns, fam, tol=cfg.eig_tol,
                                               backend=cfg.cloud_backend, device=device)
    if g is None:
        g, _, _ = batch_potential(np.concatenate(clouds), cfg.max_iter,
                                  cfg.escape_radius, cache_dir=cache_dir,
                                  dtype=cfg.potential_dtype, device=device)
    out = []
    off = 0
    for n, c in zip(ns, clouds):
        out.append((n, g[off : off + len(c)]))
        off += len(c)
    return out


def per_n_stats(cfg: EquipotentialConfig, family: str | None = None,
                per_n_g=None, device="cuda"):
    """Per-n escaped fraction and g stats (lucas_equipotential_test_v3.py:294-308)."""
    per_n_g = per_n_g or _per_n_potentials(cfg, family, device=device)
    return [{"n": n, **laws.summarize_outside(g[g > 0], len(g))}
            for n, g in per_n_g]


def cumulative_stats(cfg: EquipotentialConfig, family: str | None = None,
                     per_n_g=None, device="cuda"):
    """Cumulative-N rows (:310-327) from the same single batched solve: the
    escaped values of every prefix are prefixes of one escaped extraction."""
    per_n_g = per_n_g or _per_n_potentials(cfg, family, device=device)
    g_flat = np.concatenate([g for _, g in per_n_g])
    esc = g_flat[g_flat > 0]
    rows = []
    off = 0
    m = 0
    for n, g in per_n_g:
        off += len(g)
        m += int(np.count_nonzero(g > 0))
        rows.append({"N": n, **laws.summarize_outside(esc[:m], off)})
    return rows


def run_equipotential(cfg: EquipotentialConfig, out_dir: str | None = None,
                      with_per_n: bool = True, cache_dir: str | None = None,
                      timer=None, plots: bool = True, device="cuda", mesh=None):
    """Full driver on `device`. Returns a dict of results; writes CSV/NPY
    (and, if `plots`, the density figures) if out_dir. With a `mesh` it runs
    on the rank's device, the Green potential (K3 in f32, the f64 loop)
    sharded over the ranks (batch_potential), and only rank 0 writes.

    Beside the rows, ``points`` holds the per-point records the solves gave:
    ``points["families"][f]`` the family's concatenated cloud ``c`` (by n,
    then root; lucas_all_ones first, then the other families in
    cfg.families order) with its ``g`` and escape step ``k``, and with a
    stored curve ``points["curve"]`` its ``c``, ``g`` and ``k``: the arrays
    written as C_lucas.npy, g_lucas.npy and it_lucas.npy, not copies.
    ``stage_times`` and ``counts`` are the timer's (``_count_green``)."""
    from cmtci_torch.parallel.sharded import is_writer

    dev = mesh.device if mesh is not None else resolve_device(device)
    if not is_writer(mesh):
        out_dir = None
    if out_dir and plots:
        figures.pyplot()  # fail before any stage when matplotlib is missing
    timer = timer if timer is not None else StageTimer(dev)
    c_curve = None
    if cfg.curve_npy is not None:
        # load (and so validate) the stored curve before the expensive stages
        pts = np.load(cfg.curve_npy)
        if pts.ndim == 2 and pts.shape[1] == 2:
            c_curve = pts[:, 0] + 1j * pts[:, 1]
        else:
            c_curve = np.asarray(pts, dtype=complex).ravel()
    ns = list(range(cfg.n_min, cfg.n_max + 1))
    others = ([f for f in cfg.families if f != "lucas_all_ones"]
              if cfg.run_family_comparison else [])
    with timer.stage("cloud"):
        clouds = companion.inverse_cloud_split(ns, "lucas_all_ones", tol=cfg.eig_tol,
                                               backend=cfg.cloud_backend, device=dev)
        c_inv = np.concatenate(clouds)
        fam_clouds = [companion.inverse_cloud(ns, f, tol=cfg.eig_tol,
                                              backend=cfg.cloud_backend, device=dev)
                      for f in others]
    with timer.stage("potential"):
        # ONE solve for lucas + the other families (g is per point)
        all_pts = np.concatenate([c_inv, *fam_clouds]) if fam_clouds else c_inv
        g_all, it_all, phi_all = batch_potential(
            all_pts, cfg.max_iter, cfg.escape_radius, cache_dir=cache_dir,
            dtype=cfg.potential_dtype, device=dev, mesh=mesh)
        g, it, phi = (g_all[: len(c_inv)], it_all[: len(c_inv)],
                      phi_all[: len(c_inv)])
    _count_green(timer, it_all, cfg.max_iter)
    points = {"families": {}}
    off = 0
    for f, c in zip(["lucas_all_ones", *others], [c_inv, *fam_clouds]):
        points["families"][f] = {"c": c, "g": g_all[off : off + len(c)],
                                 "k": it_all[off : off + len(c)]}
        off += len(c)
    out = {
        "summary": laws.summarize_g(g),
        "laws": laws.compare_reference_laws(g[g > 0]),
    }
    if with_per_n:
        with timer.stage("per_n"):
            per_n_g = _per_n_potentials(cfg, clouds=clouds, g=g)
            out["per_n"] = per_n_stats(cfg, per_n_g=per_n_g)
            out["cumulative"] = cumulative_stats(cfg, per_n_g=per_n_g)
    fam_g = None
    if cfg.run_family_comparison:
        with timer.stage("families"):
            fam_g = {"lucas_all_ones": g}
            off = len(c_inv)
            for f, c in zip(others, fam_clouds):
                fam_g[f] = g_all[off : off + len(c)]
                off += len(c)
            fam_rows = []
            for fam in cfg.families:
                s = laws.summarize_g(fam_g[fam])
                s["family"] = fam
                fam_rows.append(s)
            out["family_summary"] = fam_rows
    if c_curve is not None:
        with timer.stage("stored_curve"):
            g_c, it_c, _ = batch_potential(c_curve, cfg.max_iter, cfg.escape_radius,
                                           cache_dir=cache_dir, dtype=cfg.potential_dtype,
                                           device=dev, mesh=mesh)
            out["curve_summary"] = laws.summarize_g(g_c)
            out["curve_laws"] = laws.compare_reference_laws(g_c[g_c > 0])
            out["curve_g"] = g_c
        _count_green(timer, it_c, cfg.max_iter)
        points["curve"] = {"c": c_curve, "g": g_c, "k": it_c}
    out["points"] = points
    out["stage_times"] = dict(timer.times)
    out["counts"] = dict(timer.counts)
    if out_dir:
        writers.write_config_meta(f"{out_dir}/meta.txt", cfg,
                                  extra={"n_cloud": len(c_inv)})
        np.save(f"{out_dir}/C_lucas.npy", c_inv)
        np.save(f"{out_dir}/g_lucas.npy", g)
        np.save(f"{out_dir}/it_lucas.npy", it)
        np.save(f"{out_dir}/phi_lucas.npy", phi)
        if with_per_n:
            writers.write_dict_rows_csv(f"{out_dir}/per_n_stats.csv", out["per_n"])
            writers.write_dict_rows_csv(f"{out_dir}/cumulative_stats.csv", out["cumulative"])
        if cfg.run_family_comparison:
            writers.write_dict_rows_csv(f"{out_dir}/family_summary.csv", out["family_summary"])
        if "curve_g" in out:
            np.save(f"{out_dir}/g_curve.npy", out["curve_g"])
        if plots:
            # density figures (lucas_equipotential_test_v3.py:251-288,417-446)
            if out["laws"] is not None:
                figures.plot_g_density_compare(out["laws"], g[g > 0],
                                                 f"{out_dir}/equipotential")
            if fam_g is not None:
                figures.plot_family_kde_overlay(fam_g,
                                                  f"{out_dir}/family_kde_overlay.png")
            if "curve_g" in out and out["curve_laws"] is not None:
                figures.plot_g_density_compare(
                    out["curve_laws"], out["curve_g"][out["curve_g"] > 0],
                    f"{out_dir}/lucas_curve")
    return out
