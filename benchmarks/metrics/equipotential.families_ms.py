"""equipotential.families_ms (ms): the program's `families` stage in
run_equipotential (StageTimer, the device synchronised at both ends): the four
families' summary rows, on the host; mean per measured job."""

from benchmarks.harness import spans


def read(ctx):
    return spans.mean_ms(ctx, ("families",))
