"""Job driver of the Appendix-A tracker cells: one job is one
``run_tracker`` over every stage of the schedule, with its own clouds
(``cache_dir=None``, as a fresh command-line run builds them).

The stage walls come from the program's own ``StageTimer`` (a device
synchronize at both ends of each stage), under a ``record_function`` of the
stage's name so that the device trace can tell the stages apart."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from benchmarks.reference import tracker as reference
from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker
from cmtci_torch.utils.artifacts import StageTimer


class SpanTimer(StageTimer):
    """The program's StageTimer, each stage also a profiler span."""

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function(name), super().stage(name):
            yield


class Job:
    def __init__(self, config: dict, workload: dict, device: torch.device):
        self.fields = {**config["tracker"], **workload.get("traffic", {}).get("tracker", {})}
        self.device = device

    def inputs(self, job_seed: int) -> int:
        """A tracker job's only input is its host seed."""
        return job_seed

    def run(self, job_seed: int):
        cfg = TrackerConfig(**{**self.fields, "seed": int(job_seed),
                               "domain": tuple(self.fields["domain"])})
        timer = SpanTimer(self.device)
        rows, _ = run_tracker(cfg, cache_dir=None, timer=timer, device=self.device)
        return [dataclasses.asdict(r) for r in rows], dict(timer.times)

    def reference(self, job_seed: int, level: str):
        return reference.run_tracker(self.fields, int(job_seed), self.device, level)

    def as_output(self, ref, job_seed):
        return ref

    def compare(self, out, ref) -> dict:
        return reference.compare(out, ref)
