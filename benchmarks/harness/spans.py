"""Readers of the program's own stages and counters in a job's output: the
``stage_times`` (``StageTimer.times``) and ``counts`` (``StageTimer.counts``)
that ``run_spatial_stats`` returns beside its statistics, under the job
output's ``stats``. Every function returns None where no job holds what it
reads, as a program without those stages or counters gives."""

from __future__ import annotations

import numpy as np

from benchmarks.harness.readers import measured, traced

#: the program's two shell-scan stages, one a cloud
SHELLS = ("spatial_stats.shells_construct", "spatial_stats.shells_mandel")


def _stats_key(rec, key: str) -> dict:
    out = rec.out if isinstance(rec.out, dict) else {}
    stats = out.get("stats")
    return (stats.get(key) or {}) if isinstance(stats, dict) else {}


def _stage_s(rec, names):
    """Seconds of the stages `names` in one job, summed; None where the job
    lacks one of them."""
    times = _stats_key(rec, "stage_times")
    return sum(times[n] for n in names) if all(n in times for n in names) else None


def mean_ms(ctx, names):
    """Mean per measured job, in ms, of the seconds of the program stages
    `names` (summed within a job)."""
    per_job = [s for s in (_stage_s(r, names) for r in measured(ctx)) if s is not None]
    return 1e3 * float(np.mean(per_job)) if per_job else None


def busy_pct(ctx, names):
    """100 x the card's kernel seconds inside the program spans `names`
    (the device trace's ``span_kernel_s``) over the walls of those stages in
    the traced jobs, the jobs that trace covers."""
    kernel_s = sum(((ctx.trace or {}).get("span_kernel_s") or {}).get(n, 0.0) for n in names)
    walls = [s for s in (_stage_s(r, names) for r in traced(ctx)) if s is not None]
    if kernel_s <= 0 or not walls or sum(walls) <= 0:
        return None
    return 100.0 * kernel_s / sum(walls)


def count_pct(ctx, part: str, whole: str):
    """100 x the program counter `part` over the counter `whole`, each
    summed over the measured jobs that hold both."""
    pairs = [(c[part], c[whole]) for c in (_stats_key(r, "counts") for r in measured(ctx))
             if part in c and whole in c]
    total = sum(w for _, w in pairs)
    return 100.0 * sum(p for p, _ in pairs) / total if total > 0 else None
