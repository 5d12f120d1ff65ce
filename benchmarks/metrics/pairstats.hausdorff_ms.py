"""pairstats.hausdorff_ms (ms): the program's spatial_stats.hausdorff stage in
run_spatial_stats (StageTimer; ends in the distance's copy to the host),
mean per measured job."""

from benchmarks.harness import spans


def read(ctx):
    return spans.mean_ms(ctx, ("spatial_stats.hausdorff",))
