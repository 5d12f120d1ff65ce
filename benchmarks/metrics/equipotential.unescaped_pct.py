"""equipotential.unescaped_pct (%): the program's counter
equipotential.green_unescaped (the records of the Green solves, clouds and
curve, with no escape within max_iter) over equipotential.green_points (the
points those solves took), summed over the measured jobs: the share of the
points that run the whole budget."""

from benchmarks.harness import spans


def read(ctx):
    return spans.count_pct(ctx, "equipotential.green_unescaped", "equipotential.green_points")
