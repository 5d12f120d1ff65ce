"""Mandelbrot boundary pipeline (BASELINE config 1) on PyTorch.

Port of ``cmtci/pipelines/boundary.py``. Reference:
mandelbrot_boundary_sample.py — dwell grid (res², max_iter), isocontour at
level·max_iter, longest path, CSV + meta outputs.

The dwell grid comes from `backend`, on one device or row-sharded over a
mesh of ranks (bitwise the same grid):
  * "cuda": the hand-written K2 kernel in f32 (its twin on a CPU device);
  * "torch": the f64 ``dwell_grid`` on the device;
  * "auto": "cuda" on a CUDA device, else "torch".
Both build the grid from ``np.linspace`` nodes (K2 as xmin + col·dx in f32),
not ``jnp.linspace`` as the reference's f64 path does, so the port's
contour is held to the reference's golden geometrically, not bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cmtci_torch.geometry import contour
from cmtci_torch.io import plots as figures
from cmtci_torch.io import writers
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels import mandelbrot_cuda as mc
from cmtci_torch.utils.artifacts import StageTimer, fetch
from cmtci_torch.utils.device import resolve_device

BACKENDS = ("cuda", "torch", "auto")


@dataclass
class BoundaryConfig:
    xlim: tuple = (-2.1, 0.9)
    ylim: tuple = (-1.5, 1.5)
    res: int = 2000
    max_iter: int = 500
    level: float = 0.96
    backend: str = "auto"  # "cuda" | "torch" | "auto"


def resolve_backend(backend: str, dev) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    return backend


def compute_dwell(cfg: BoundaryConfig, device="cuda", mesh=None) -> np.ndarray:
    """(res, res) dwell grid on the host, computed on `device`.

    With a `mesh` the grid's rows are sharded over its ranks, and the
    gathered grid is bitwise the single-device one: backend "cuda" launches
    K2's row entry on each rank's block (parallel.sharded.sharded_dwell_field),
    backend "torch" runs the f64 loop on the same np.linspace nodes
    (parallel.sharded.sharded_dwell_rows), its rows padded to a mesh
    multiple with copies of the first row, then cropped."""
    domain = (*cfg.xlim, *cfg.ylim)
    if mesh is not None:
        from cmtci_torch.parallel.sharded import sharded_dwell_field, sharded_dwell_rows

        if resolve_backend(cfg.backend, mesh.device) == "cuda":
            return fetch(sharded_dwell_field(domain, cfg.res, cfg.res, cfg.max_iter, mesh))
        cr, ci = mb.complex_grid(domain, cfg.res, cfg.res, dtype=torch.float64,
                                 device=mesh.device)
        pad = -cfg.res % mesh.size
        if pad:
            cr = torch.cat([cr, cr[:1].expand(pad, -1)])
            ci = torch.cat([ci, ci[:1].expand(pad, -1)])
        z = sharded_dwell_rows(cr, ci, cfg.max_iter, mesh)
        return fetch(z[: cfg.res]).astype(float)
    dev = resolve_device(device)
    if resolve_backend(cfg.backend, dev) == "cuda":
        z = mc.mandelbrot_field(domain, cfg.res, cfg.res, max_iter=cfg.max_iter, device=dev)
        return fetch(z)
    cr, ci = mb.complex_grid(domain, cfg.res, cfg.res, dtype=torch.float64, device=dev)
    return fetch(mb.dwell_grid(cr, ci, max_iter=cfg.max_iter)).astype(float)


def run_boundary(cfg: BoundaryConfig, output_prefix: str | None = None,
                 plots: bool = True, device="cuda", timer: StageTimer | None = None,
                 mesh=None):
    """Returns (contour_vertices, dwell_grid); with output_prefix writes
    <prefix>_boundary.csv (header x,y), <prefix>_meta.txt and, if `plots`,
    <prefix>_boundary.png. Stage times (dwell, contour, write) go to
    `timer`. With a `mesh` the dwell grid is sharded over its ranks
    (compute_dwell) on the ranks' devices, and only rank 0 writes."""
    from cmtci_torch.parallel.sharded import is_writer

    dev = mesh.device if mesh is not None else resolve_device(device)
    if not is_writer(mesh):
        output_prefix = None
    if output_prefix and plots:
        figures.pyplot()  # fail before the grid when matplotlib is missing
    timer = timer if timer is not None else StageTimer(dev)
    xs = np.linspace(cfg.xlim[0], cfg.xlim[1], cfg.res)
    ys = np.linspace(cfg.ylim[0], cfg.ylim[1], cfg.res)
    with timer.stage("dwell"):
        z = compute_dwell(cfg, device=dev, mesh=mesh)
    with timer.stage("contour"):
        path = contour.extract_contour(xs, ys, z, cfg.level * cfg.max_iter)
    if path is None or path.shape[0] < 50:
        raise RuntimeError("Failed to extract a usable contour; adjust level/res.")
    if output_prefix:
        with timer.stage("write"):
            writers.write_xy_csv(f"{output_prefix}_boundary.csv", path)
            if plots:
                figures.plot_boundary_overlay(path, path, f"{output_prefix}_boundary.png")
            writers.write_meta_txt(f"{output_prefix}_meta.txt", {
                "xlim": list(cfg.xlim), "ylim": list(cfg.ylim), "res": cfg.res,
                "max_iter": cfg.max_iter, "level": cfg.level,
            })
    return path, z
