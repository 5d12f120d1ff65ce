"""Lucas-loci boundary extraction pipelines (G6 + construct-alpha v2), on
PyTorch.

Port of ``cmtci/pipelines/lucas_boundary.py``. References:
  * export_lucas_boundary_npy — lucas_to_cardioid_v18...py:141-202
    (cloud -> alpha shape -> CCW -> arclength resample -> lucas_points.npy)
  * construct_boundary_alpha_spyder_v2.py — alpha-shape edges, longest
    closed loop (else chain), densify to target_n, boundary CSV

The inverse-eigenvalue cloud is solved on `device`; the alpha shape (scipy's
Delaunay) and the resampling run on the host, as in the reference.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import asdict, dataclass

import numpy as np

from cmtci_torch.geometry import alpha_shape, resample
from cmtci_torch.io import writers
from cmtci_torch.kernels import companion
from cmtci_torch.utils import artifacts
from cmtci_torch.utils.device import resolve_device


@dataclass
class LucasBoundaryConfig:
    n_min: int = 2
    n_max: int = 100
    alpha: float = 4.5
    n_boundary: int = 2000
    center: complex | None = None
    radial_clip: float | None = None
    family: str = "lucas_all_ones"
    cloud_backend: str = "aberth"


def export_lucas_boundary(cfg: LucasBoundaryConfig, out_path: str | None = None,
                          skip_if_exists: bool = False, cache_dir: str | None = None,
                          device="cuda"):
    """Cloud -> alpha polygon -> CCW -> resample. Returns (N,2) and saves npy.

    skip_if_exists reproduces the reference's resume behavior (reload
    lucas_points.npy when present, lucas_to_cardioid_v18...py:1070-1077);
    cache_dir additionally keys the artifact by the config hash, so a
    parameter change invalidates it. The key carries the implementation:
    the port's cloud differs from the reference's in the last bits, so the
    two never share an entry.
    """
    dev = resolve_device(device)
    if skip_if_exists and out_path and os.path.exists(out_path):
        return np.load(out_path)
    if cache_dir is not None:
        out = artifacts.cached("lucas_boundary", {"impl": "cmtci_torch", **asdict(cfg)},
                               lambda: {"xy": _compute_lucas_boundary(cfg, dev)},
                               cache_dir=cache_dir)
        xy_rs = np.asarray(out["xy"])
    else:
        xy_rs = _compute_lucas_boundary(cfg, dev)
    if out_path:
        writers.ensure_dir(out_path)
        np.save(out_path, xy_rs)
        writers.write_config_meta(f"{out_path}_meta.txt", cfg,
                                  extra={"n_boundary_points": len(xy_rs)})
    return xy_rs


def _compute_lucas_boundary(cfg: LucasBoundaryConfig, device):
    ns = list(range(cfg.n_min, cfg.n_max + 1))
    z = companion.inverse_cloud(ns, cfg.family, backend=cfg.cloud_backend, device=device)
    if cfg.center is not None:
        z = z - cfg.center
    if cfg.radial_clip is not None:
        z = z[np.abs(z) <= cfg.radial_clip]
    poly = alpha_shape.alpha_shape_polygon(z, cfg.alpha)
    xy = resample.enforce_ccw(poly.xy)
    xy_rs = resample.resample_closed_polyline(xy, cfg.n_boundary)
    if cfg.center is not None:
        xy_rs = xy_rs + np.array([cfg.center.real, cfg.center.imag])
    return xy_rs


@dataclass
class ConstructBoundaryConfig:
    alpha: float = 65.0
    target_n: int = 1500
    min_points: int = 200


def construct_boundary(points_xy: np.ndarray, cfg: ConstructBoundaryConfig,
                       output_prefix: str | None = None):
    """Alpha-shape boundary of a point set, densified (v2 semantics), on the
    host (numpy and scipy only, as in the reference).

    Returns (boundary (target_n,2), was_closed).
    """
    p = np.asarray(points_xy, dtype=float)
    edges = alpha_shape.alpha_shape_edges(p, cfg.alpha)
    if len(edges) == 0:
        raise RuntimeError("Alpha-shape produced no boundary edges. Adjust alpha.")
    ordered, was_closed = alpha_shape.trace_boundary(p, edges)
    b = resample.densify_boundary(p[ordered], cfg.target_n)
    if len(b) < cfg.min_points or len(ordered) < cfg.min_points:
        # short-boundary warning (construct_boundary_alpha_spyder_v2.py:
        # 180-182); also fired on the TRACED count, which densify would
        # otherwise silently inflate to target_n
        warnings.warn(
            f"boundary has only {len(ordered)} traced / {len(b)} densified "
            f"points (< min_points={cfg.min_points}); consider increasing "
            "point density or adjusting alpha", stacklevel=2)
    if output_prefix:
        writers.write_xy_csv(f"{output_prefix}_boundary.csv", b)
        writers.write_meta_txt(f"{output_prefix}_meta.txt", {
            "alpha": cfg.alpha, "N": len(p), "ordered_points": len(b),
            "closed": was_closed,
        })
    return b, was_closed
