"""pairstats.shell_hit_pct (%): the program's counter spatial_stats.in_shells
(pairs that land in a shell, from the two scans' int64 shell counts) over
spatial_stats.distances (the distances the scans evaluate, masked
lower-triangle entries of each block included), summed over the measured
jobs: the share of the evaluated distances a scan keeps, which bounds what a
pruned search could save."""

from benchmarks.harness import spans


def read(ctx):
    return spans.count_pct(ctx, "spatial_stats.in_shells", "spatial_stats.distances")
