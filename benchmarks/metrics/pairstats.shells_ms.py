"""pairstats.shells_ms (ms): the program's two shell-scan stages in
run_spatial_stats, spatial_stats.shells_construct and spatial_stats.shells_mandel
(StageTimer, the device synchronised at both ends; each ends in the shell
counts' copy to the host), summed over a job, mean per measured job."""

from benchmarks.harness import spans


def read(ctx):
    return spans.mean_ms(ctx, spans.SHELLS)
