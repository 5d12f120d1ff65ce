"""Helpers the metric readers share. A reader is ``metrics/<name>.py`` with
``read(ctx) -> float | None``; ctx holds the window's job records (``jobs``),
``setup_s``, the trace summary (``trace``, None with --trace 0), the cell's
``config`` and ``workload``. None leaves the metric out of the line."""

from __future__ import annotations

import numpy as np


def measured(ctx) -> list:
    """The jobs the profiler did not slow: those after the traced stretch,
    or every job where the stretch took them all."""
    plain = [r for r in ctx.jobs if not r.traced]
    return plain or list(ctx.jobs)


def traced(ctx) -> list:
    """The jobs that ran while the profiler recorded the device trace."""
    return [r for r in ctx.jobs if r.traced]


def stage_mean_ms(ctx, suffix: str):
    """Mean per job, in ms, of the seconds of every stage whose name ends
    with `suffix` (a job's stages summed); None where no job has one."""
    per_job = [sum(v for k, v in r.stages.items() if k.endswith(suffix)) for r in measured(ctx)
               if any(k.endswith(suffix) for k in r.stages)]
    return 1e3 * float(np.mean(per_job)) if per_job else None
