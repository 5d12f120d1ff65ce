"""tracker.cloud_ms (ms): the tracker's `bins*_cloud` stages (StageTimer, the
device synchronised at both ends), summed over a job's stages, mean per job."""

from benchmarks.harness.readers import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "_cloud")
