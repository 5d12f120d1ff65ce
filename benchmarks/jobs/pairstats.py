"""Job driver of the pair-statistics cells: one job builds the Lucas
construct C with ``companion.inverse_cloud`` and runs ``run_spatial_stats``
on C and a fresh sample M of the Mandelbrot boundary band, which the
benchmark draws from the job's seed (``inputs.mandel_band``) before the
job's clock starts. Two spans, each synchronised: ``pairstats.cloud`` and
``pairstats.stats``."""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.harness.cell import span
from benchmarks.inputs.mandel_band import Band
from benchmarks.reference import pairstats as reference
from cmtci_torch.kernels import companion
from cmtci_torch.pipelines.analysis import run_spatial_stats


def _xy(points: np.ndarray) -> np.ndarray:
    """(N, 2) float64 rows, the form run_spatial_stats reads from the file bus."""
    return np.stack([points.real, points.imag], axis=1)


class Job:
    def __init__(self, config: dict, workload: dict, device: torch.device):
        self.cfg = {**config["pairstats"], **workload.get("traffic", {}).get("pairstats", {})}
        self.device = device
        self.band = Band(config["mandel_band"], device)

    def inputs(self, job_seed: int):
        return self.band.draw(job_seed, int(self.cfg["m_points"]))

    def run(self, m):
        cfg, stages = self.cfg, {}
        with span(stages, "pairstats.cloud", self.device):
            c = companion.inverse_cloud(range(int(cfg["n_min"]), int(cfg["n_max"]) + 1),
                                        cfg["family"], device=self.device)
        with span(stages, "pairstats.stats", self.device):
            stats = run_spatial_stats(_xy(c), _xy(m), r_max=cfg["r_max"], dr=cfg["dr"],
                                      stat_dtype=getattr(torch, cfg["stat_dtype"]),
                                      plots=False, out_prefix=None, device=self.device)
        return {"cloud": c, "m": m, "stats": stats}, stages

    def reference(self, m, level: str):
        return reference.spatial_stats(m, self.cfg, self.device, level)

    def as_output(self, ref, m):
        return reference.as_output(ref, m)

    def compare(self, out, ref) -> dict:
        return reference.compare(out, ref, self.cfg)
