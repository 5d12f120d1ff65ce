"""Job driver of the Green-function statistics cell: one job is one
``run_equipotential`` at the configuration's settings, as
``cmtci-torch equipotential --green-dtype float64 --curve-npy <file>`` runs
it, with the four families' clouds built anew (``cache_dir=None``) and a
stored boundary curve that the benchmark draws from the job's seed
(``inputs.mandel_band``) and writes to a ``.npy`` before the job's clock
starts. The program's own ``StageTimer`` gives the stages (``cloud``,
``potential``, ``per_n``, ``families``, ``stored_curve``, each a
``record_function`` span) and the Green loop's counters; the result goes
under ``stats``, where ``harness/spans.py`` reads them."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from benchmarks.inputs.mandel_band import Band
from benchmarks.reference import equipotential as reference
from cmtci_torch.pipelines.equipotential import EquipotentialConfig, run_equipotential
from cmtci_torch.utils.artifacts import StageTimer


class Job:
    def __init__(self, config: dict, workload: dict, device: torch.device):
        traffic = workload.get("traffic", {})
        self.cfg = {**config["equipotential"], **traffic.get("equipotential", {})}
        self.curve = {**config["curve"], **traffic.get("curve", {})}
        self.device = device
        self.band = Band(self.curve["mandel_band"], device)
        self.dir = tempfile.TemporaryDirectory(prefix="bench_equipotential_")
        self.roots = {}  # the reference's clouds a level: fixed by the configuration

    def inputs(self, job_seed: int) -> dict:
        """The job's boundary curve (complex128), written to the Job's .npy."""
        curve = self.band.draw(job_seed, int(self.curve["points"]))
        path = os.path.join(self.dir.name, "curve.npy")
        np.save(path, curve)
        return {"curve": curve, "path": path}

    def run(self, inp: dict):
        fields = {k: v for k, v in self.cfg.items() if k != "with_per_n"}
        cfg = EquipotentialConfig(**{**fields, "families": tuple(fields["families"]),
                                     "curve_npy": inp["path"]})
        timer = StageTimer(self.device)
        out = run_equipotential(cfg, out_dir=None, with_per_n=bool(self.cfg["with_per_n"]),
                                cache_dir=None, timer=timer, plots=False, device=self.device)
        if "points" not in out:
            raise RuntimeError("run_equipotential returned no per-point records ('points'); "
                               "this cell needs them")
        return {"stats": out}, dict(timer.times)

    def reference(self, inp: dict, level: str):
        if level not in self.roots:
            self.roots[level] = reference.clouds(self.cfg, level)
        return reference.equipotential(inp["curve"], self.cfg, level, self.roots[level])

    def as_output(self, ref, inp):
        return {"stats": reference.as_output(ref, self.cfg)}

    def compare(self, out, ref) -> dict:
        return reference.compare(out["stats"], ref, self.cfg)
