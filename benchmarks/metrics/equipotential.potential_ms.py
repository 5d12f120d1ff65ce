"""equipotential.potential_ms (ms): the program's `potential` stage in
run_equipotential (StageTimer, the device synchronised at both ends): the one
f64 Green solve of the four clouds (batch_potential: one orbit_green launch on
a card), ending in its records' copy to the host; mean per measured job."""

from benchmarks.harness import spans


def read(ctx):
    return spans.mean_ms(ctx, ("potential",))
