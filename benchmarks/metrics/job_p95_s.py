"""job_p95_s (s): the 95th percentile of every job wall of the window."""

from benchmarks.harness import loop


def read(ctx):
    return loop.p95([r.wall for r in ctx.jobs])
