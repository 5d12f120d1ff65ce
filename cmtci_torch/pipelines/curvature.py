"""Curvature pipeline (BASELINE config 2), on PyTorch.

Port of ``cmtci/pipelines/curvature.py``. Reference:
boundary_curvature_localpoly.py — ±neighbors local-polynomial curvature on
an ordered boundary, 10-column CSV + summary TXT. The window fits run in f64
on `device`; the summary and the files are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmtci_torch.io import plots as figures
from cmtci_torch.io import writers
from cmtci_torch.stats import curvature as curv
from cmtci_torch.utils.device import resolve_device


@dataclass
class CurvatureConfig:
    neighbors: int = 7
    closed: bool = True


def run_curvature(points_xy, cfg: CurvatureConfig, output_prefix: str | None = None,
                  plots: bool = True, device="cuda"):
    """Returns (kappa, kappa_signed, speed, aux, summary dict); with
    output_prefix writes <prefix>_curvature.csv, <prefix>_meta.txt,
    <prefix>_summary.txt and, if `plots`, the histogram and overlay PNGs."""
    dev = resolve_device(device)
    if output_prefix and plots:
        figures.pyplot()  # fail before the work when matplotlib is missing
    p = np.asarray(points_xy, dtype=float)
    if p.shape[0] < 2 * cfg.neighbors + 1:
        raise ValueError(f"Need at least {2*cfg.neighbors+1} points; got {p.shape[0]}.")
    kappa, ks, speed, aux = curv.localpoly_curvature(p, cfg.neighbors, cfg.closed, device=dev)
    summary = dict(
        n=len(kappa),
        mean=float(np.mean(kappa)),
        median=float(np.median(kappa)),
        std=float(np.std(kappa)),
        q05=float(np.quantile(kappa, 0.05)),
        q95=float(np.quantile(kappa, 0.95)),
        max=float(np.max(kappa)),
    )
    if output_prefix:
        writers.write_curvature_csv(f"{output_prefix}_curvature.csv", p, kappa, ks, speed, aux)
        if plots:
            figures.plot_curvature(p, kappa, output_prefix)
        writers.write_config_meta(f"{output_prefix}_meta.txt", cfg,
                                  extra={"N": len(p)})
        writers.ensure_dir(f"{output_prefix}_summary.txt")
        with open(f"{output_prefix}_summary.txt", "w") as f:
            f.write("Local-Polynomial Curvature Summary\n")
            f.write("\n".join(f"{k}: {v:.10g}" for k, v in summary.items()) + "\n")
    return kappa, ks, speed, aux, summary
