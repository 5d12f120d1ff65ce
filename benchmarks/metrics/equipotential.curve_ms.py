"""equipotential.curve_ms (ms): the program's `stored_curve` stage in
run_equipotential (StageTimer, the device synchronised at both ends): the
stored curve's f64 Green solve (one orbit_green launch on a card), its summary
and its laws; mean per measured job."""

from benchmarks.harness import spans


def read(ctx):
    return spans.mean_ms(ctx, ("stored_curve",))
