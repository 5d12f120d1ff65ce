"""equipotential.per_n_ms (ms): the program's `per_n` stage in run_equipotential
(StageTimer, the device synchronised at both ends): the per-n and cumulative
rows of lucas_all_ones, on the host; mean per measured job."""

from benchmarks.harness import spans


def read(ctx):
    return spans.mean_ms(ctx, ("per_n",))
