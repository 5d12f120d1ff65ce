"""job_rate (jobs/s): jobs completed in the window over the seconds they took."""

from benchmarks.harness import loop


def read(ctx):
    return loop.job_rate([r.wall for r in ctx.jobs])
