"""pairstats.curvature_ms (ms): the program's spatial_stats.curvature stage in
run_spatial_stats, both clouds' gradient curvature (StageTimer), mean per
measured job."""

from benchmarks.harness import spans


def read(ctx):
    return spans.mean_ms(ctx, ("spatial_stats.curvature",))
