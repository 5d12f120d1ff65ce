"""pairstats.boxdim_ms (ms): the program's spatial_stats.boxdim stage in
run_spatial_stats, both clouds' box counts on the host (StageTimer), mean per
measured job."""

from benchmarks.harness import spans


def read(ctx):
    return spans.mean_ms(ctx, ("spatial_stats.boxdim",))
