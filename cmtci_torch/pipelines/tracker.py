"""GI assumption tracker (Appendix A verification) on PyTorch.

Port of ``cmtci/pipelines/tracker.py``. Per resolution (bins doubling
64 -> bins_max):
  1. construct cloud C (inverse eigenvalues, ns = step..construct_max)
  2. Mandelbrot boundary proxy M (TCI DE grid + 25%-quantile sampler)
  3. kernel-argmax match + Procrustes (reference rotation convention)
  4. mollified histograms P_M, P_C (sigma in bins)
  5. GI flow (fixed-T or adaptive-to-threshold), delta_n = KL(P_M||X_T)
  6. TV / overlap / Pinsker / compound diagnostics; growth schedule
     (gi_assumption_tracker_v3.py:296-299)

All stages share one host stream np.random.RandomState(seed), consumed in
the reference's order: the sampler (one seed draw for de_impl="cuda", or
rng.choice on the host for de_impl="torch"), then the matcher's r.choice.

parity=True is all numpy (LAPACK cloud, numpy DE, scipy-cdist matcher) and
reproduces the checked-in v3_T25_sigma3_dense / v3_adaptive rows. Otherwise
the cloud (f64 Aberth) and the matcher run on `device`, with the DE field
from de_impl:
  * "torch": the plain DE field in field_dtype, quantile and rng.choice on
    the host;
  * "cuda": the hand-written K1 kernel (its twin on a CPU device), with the
    band and the subsample on the device.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from cmtci_torch.io import writers
from cmtci_torch.kernels import companion, mandelbrot
from cmtci_torch.transport import giflow
from cmtci_torch.transport import histogram as hg
from cmtci_torch.transport.procrustes import procrustes_align_no_scale
from cmtci_torch.transport.sinkhorn import entropic_argmax_match
from cmtci_torch.utils import artifacts
from cmtci_torch.utils.artifacts import StageTimer
from cmtci_torch.utils.device import resolve_device

#: DE implementations of the port; the reference's names map onto them
DE_IMPLS = ("torch", "cuda")
_REFERENCE_DE_IMPL = {"jax": "torch", "pallas": "cuda"}


@dataclass
class TrackerConfig:
    # the reference's fields, in its order (cmtci/pipelines/tracker.py)
    seed: int = 7
    domain: tuple = (-2.2, 1.2, -1.6, 1.6)
    alpha: float = 0.1
    bins_start: int = 64
    bins_max: int = 1024
    construct_step: int = 20
    construct_max_start: int = 300
    construct_max_growth: float = 1.35
    mandelbrot_grid_start: int = 600
    mandelbrot_grid_growth: float = 1.15
    mandelbrot_samples_start: int = 25000
    mandelbrot_samples_growth: float = 1.35
    mandelbrot_samples_max: int = 150000
    sigma_bins: float = 1.0
    t_fixed: int = -1
    kl_threshold: float = 1e-6
    max_steps: int = 800
    min_steps: int = 5
    compound_threshold: float = 1e-3
    tv_threshold: float = 0.05
    # TCI module constants (tci_construct_mandelbrot_v002_fixed.py:12-22)
    escape_r: float = 250.0
    max_iter: int = 250
    sinkhorn_eps: float = 0.8
    eps: float = 1e-12
    # execution
    parity: bool = False  # LAPACK cloud + numpy DE + scipy matcher
    family: str = "lucas_all_ones"
    field_dtype: str = "float64"  # "float32" is the CUDA-session default
    de_impl: str = "torch"  # "cuda" = the K1 kernel; parity forces numpy


@dataclass
class TrackerRow:
    # field names/order mirror the reference Row (gi_assumption_tracker_v3.py:48-81)
    bins: int
    mesh_proxy: float
    construct_max_n: int
    construct_step: int
    n_construct_pts: int
    mandelbrot_grid: int
    mandelbrot_samples: int
    n_mandel_pts: int
    alpha: float
    sigma_bins: float
    mode: str
    T_n: int
    kl_initial: float
    delta_n: float
    kl_PM_PC: float
    pinsker_tv_bound_XT_PM: float
    tv_XT_PM: float
    tv_PC_PM: float
    overlap_mass_PC_PM: float
    mass_outside_domain_C: float
    mass_outside_domain_M: float
    tv_bound_PC_PM: float
    compound: float
    compound_with_pinsker: float
    stop_reason: str
    runtime_sec: float


def config_from_reference(d: dict) -> TrackerConfig:
    """TrackerConfig from ``dataclasses.asdict`` of a ``cmtci`` TrackerConfig
    (or its JSON meta): the same fields, with de_impl mapped jax -> torch and
    pallas -> cuda and the domain as a tuple."""
    names = {f.name for f in dataclasses.fields(TrackerConfig)}
    kw = {k: v for k, v in d.items() if k in names}
    if "domain" in kw:
        kw["domain"] = tuple(float(v) for v in kw["domain"])
    if "de_impl" in kw:
        kw["de_impl"] = _REFERENCE_DE_IMPL.get(kw["de_impl"], kw["de_impl"])
    return TrackerConfig(**kw)


def run_tracker(cfg: TrackerConfig, max_stages: Optional[int] = None,
                cache_dir: Optional[str] = None, timer: Optional[StageTimer] = None,
                device="cuda", mesh=None):
    """Run the resolution-doubling tracker on `device`. Returns (rows, meta).

    With `cache_dir`, each stage's products (aligned clouds) and the
    post-stage RNG state are stored keyed by the stage config; reruns with
    identical parameters touch no eigensolve/DE/matcher and the shared RNG
    stream continues where the stage left it. `timer` records per-phase
    wall times (device-synchronized on CUDA) and counts
    ``tracker.match_card``, the stages whose matcher ran on
    csrc/argmax_match.cu.

    With a `mesh` (parallel.sharded.device_mesh) the stage runs on the
    rank's device with its heavy work sharded over the ranks: the DE grid's
    rows (de_impl "torch"; the K1 head "cuda" is single-device and refuses a
    mesh), the matcher's rows and the histograms' points, each bitwise the
    single-device result, so the rows equal the single-device run's. The
    host RNG stream, the quantile and Procrustes run alike on every rank.
    parity=True ignores the mesh (the host numpy oracle path). Every rank
    reads the stage cache; only rank 0 writes it.
    """
    from cmtci_torch.parallel.sharded import is_writer

    if mesh is not None:
        device = mesh.device
    if cfg.de_impl not in DE_IMPLS:
        raise ValueError(f"unknown de_impl {cfg.de_impl!r}; expected one of {DE_IMPLS}")
    if cfg.field_dtype not in ("float32", "float64"):
        raise ValueError(f"unknown field_dtype {cfg.field_dtype!r}")
    dev = resolve_device(device)
    rng = np.random.RandomState(cfg.seed)
    timer = timer if timer is not None else StageTimer(dev)
    rows: List[TrackerRow] = []
    bins = int(cfg.bins_start)
    construct_max = int(cfg.construct_max_start)
    grid = int(cfg.mandelbrot_grid_start)
    samples = int(cfg.mandelbrot_samples_start)
    global_stop = ""
    f32 = cfg.field_dtype == "float32" and not cfg.parity

    while bins <= int(cfg.bins_max):
        if max_stages is not None and len(rows) >= max_stages:
            break
        t0 = time.time()
        ns = list(range(cfg.construct_step, construct_max + 1, cfg.construct_step))
        stage_mesh = None if cfg.parity else mesh
        stage_cfg = {**dataclasses.asdict(cfg), "stage_bins": bins,
                     "construct_max": construct_max, "grid": grid, "samples": samples,
                     "n_stage": len(rows), "device": dev.type}

        def _stage_kernels():
            with timer.stage(f"bins{bins}_cloud"):
                c_cloud = companion.inverse_cloud(
                    ns, cfg.family, tol=1e-10,
                    backend="lapack" if cfg.parity else "aberth", device=dev)
            with timer.stage(f"bins{bins}_sample"):
                m_cloud = mandelbrot.sample_boundary_quantile(
                    cfg.domain, grid, samples, max_iter=cfg.max_iter,
                    escape_r=cfg.escape_r, eps=cfg.eps, rng=rng,
                    dtype=torch.float32 if f32 else torch.float64,
                    impl="numpy" if cfg.parity else cfg.de_impl, device=dev,
                    mesh=stage_mesh)
            with timer.stage(f"bins{bins}_match"):
                m_match, c_sub = entropic_argmax_match(
                    c_cloud, m_cloud, eps=cfg.sinkhorn_eps, rng=rng,
                    backend="numpy" if cfg.parity else "torch",
                    dtype=torch.float32 if f32 else None, device=dev, mesh=stage_mesh,
                    count=timer.count)
            c_aligned = procrustes_align_no_scale(c_sub, m_match, convention="reference")
            return {"c_aligned": c_aligned, "m_aligned": m_match,
                    **artifacts.rng_state_arrays(rng)}

        stage_out = artifacts.cached("tracker_stage", stage_cfg, _stage_kernels,
                                     cache_dir=cache_dir or ".cmtci_cache",
                                     enabled=cache_dir is not None, write=is_writer(mesh))
        artifacts.restore_rng_state(rng, stage_out)
        c_aligned = np.asarray(stage_out["c_aligned"])
        m_aligned = np.asarray(stage_out["m_aligned"])

        outside_c = hg.fraction_outside_domain(c_aligned, cfg.domain)
        outside_m = hg.fraction_outside_domain(m_aligned, cfg.domain)

        with timer.stage(f"bins{bins}_hist"):
            p_m = hg.mollified_histogram(m_aligned, bins, cfg.domain, cfg.sigma_bins, cfg.eps,
                                         mesh=stage_mesh)
            p_c = hg.mollified_histogram(c_aligned, bins, cfg.domain, cfg.sigma_bins, cfg.eps,
                                         mesh=stage_mesh)
        kl_pm_pc = hg.kl(p_m, p_c, cfg.eps)

        # the flow's O(T·bins²) loop runs on the device above 128 bins
        flow_dev = None if (cfg.parity or bins <= 128) else dev
        with timer.stage(f"bins{bins}_giflow"):
            if cfg.t_fixed > 0:
                mode = f"fixedT={cfg.t_fixed}"
                x_t, t_n, kl0, delta = giflow.gi_flow_fixed_t(
                    p_m, p_c, cfg.alpha, cfg.t_fixed, cfg.eps, device=flow_dev)
                stop_reason = "fixed_T"
            else:
                mode = "adaptive"
                x_t, t_n, kl0, delta = giflow.gi_flow_to_threshold(
                    p_m, p_c, cfg.alpha, cfg.kl_threshold, cfg.max_steps, cfg.min_steps,
                    cfg.eps, device=flow_dev)
                stop_reason = ("kl_threshold_met" if delta <= cfg.kl_threshold
                               else "max_steps_reached")

        tv_xt_pm = hg.tv_distance(x_t, p_m)
        tv_pc_pm = hg.tv_distance(p_c, p_m)
        ov = hg.overlap_mass(p_c, p_m)
        pinsker = hg.pinsker_bound(delta)
        factor = (1.0 - cfg.alpha) ** (-int(t_n)) if t_n > 0 else float("inf")

        rows.append(TrackerRow(
            bins=bins,
            mesh_proxy=1.0 / bins,
            construct_max_n=construct_max,
            construct_step=cfg.construct_step,
            n_construct_pts=int(c_aligned.size),
            mandelbrot_grid=grid,
            mandelbrot_samples=samples,
            n_mandel_pts=int(m_aligned.size),
            alpha=cfg.alpha,
            sigma_bins=cfg.sigma_bins,
            mode=mode,
            T_n=int(t_n),
            kl_initial=float(kl0),
            delta_n=float(delta),
            kl_PM_PC=float(kl_pm_pc),
            pinsker_tv_bound_XT_PM=float(pinsker),
            tv_XT_PM=float(tv_xt_pm),
            tv_PC_PM=float(tv_pc_pm),
            overlap_mass_PC_PM=float(ov),
            mass_outside_domain_C=float(outside_c),
            mass_outside_domain_M=float(outside_m),
            tv_bound_PC_PM=float(factor * pinsker),
            compound=float(factor * np.sqrt(delta)),
            compound_with_pinsker=float(factor * pinsker),
            stop_reason=stop_reason,
            runtime_sec=float(time.time() - t0),
        ))

        if (delta <= cfg.kl_threshold and rows[-1].compound <= cfg.compound_threshold
                and tv_pc_pm <= cfg.tv_threshold):
            global_stop = ("global_stop: kl<=threshold AND compound<=threshold "
                           "AND TV(P_C,P_M)<=tv_threshold")
            break

        bins *= 2
        construct_max = int(round((construct_max * cfg.construct_max_growth)
                                  / cfg.construct_step)) * cfg.construct_step
        grid = int(round(grid * cfg.mandelbrot_grid_growth))
        samples = min(cfg.mandelbrot_samples_max,
                      int(round(samples * cfg.mandelbrot_samples_growth)))

    meta = {
        **{k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(cfg).items()},
        "device": str(dev),
        "global_stop_reason": global_stop,
        "stage_times": dict(timer.times),
        "rows": [dataclasses.asdict(r) for r in rows],
    }
    return rows, meta


def write_outputs(rows, meta, out_prefix: str):
    """CSV + JSON + _meta.txt writers, schema-compatible with the reference."""
    csv_path = writers.ensure_dir(f"{out_prefix}.csv")
    json_path = f"{out_prefix}.json"
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        if rows:
            w = csv.DictWriter(f, fieldnames=list(dataclasses.asdict(rows[0]).keys()))
            w.writeheader()
            for r in rows:
                w.writerow(dataclasses.asdict(r))
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    writers.write_config_meta(f"{out_prefix}_meta.txt",
                              {k: v for k, v in meta.items()
                               if k not in ("rows", "stage_times")})
    return csv_path, json_path
