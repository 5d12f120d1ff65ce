"""pairstats.stats_ms (ms): the benchmark's synchronised span around
run_spatial_stats, mean per job."""

from benchmarks.harness.readers import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "pairstats.stats")
