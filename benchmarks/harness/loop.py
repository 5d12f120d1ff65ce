"""The closed loop of jobs: job seeds, job records and the statistics the
end-to-end metrics take from the walls of a window."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: job j of a run with --seed s takes job_seed(s, j); the warm-up job takes j = -1
SEEDS_PER_RUN = 1000
SEED_SPACE = 2**32


def job_seed(seed: int, j: int) -> int:
    """1000 s + j, reduced into the 32 bits numpy's RandomState takes."""
    return (SEEDS_PER_RUN * int(seed) + int(j)) % SEED_SPACE


@dataclass
class JobRecord:
    """One job of the window: its index and seed, its wall (host clock around
    calls that end in a device synchronize), the seconds of each span or
    stage the job reported, what it returned, and whether the profiler was on."""
    index: int
    seed: int
    wall: float
    stages: dict = field(default_factory=dict)
    out: object = None
    traced: bool = False


def job_rate(walls) -> float | None:
    """Jobs completed over the seconds they took: every job, all its time."""
    total = float(np.sum(walls)) if len(walls) else 0.0
    return len(walls) / total if total > 0 else None


def p95(walls) -> float | None:
    """95th percentile of the job walls (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(walls, dtype=float), 95)) if len(walls) else None


def checked_jobs(seed: int, n_jobs: int, k: int) -> list:
    """k job indices of n_jobs, drawn from the run's seed, the last job always
    among them (it ends after the window closes)."""
    if n_jobs <= 0:
        return []
    rng = np.random.default_rng(int(seed))
    others = rng.permutation(n_jobs - 1)[: max(0, k - 1)]
    return sorted({n_jobs - 1, *(int(i) for i in others)})
