"""equipotential.green_roofline (%): the least time the card could spend on
the Green loop's escaping orbits, as a share of the card's kernel time
inside the program's `potential` and `stored_curve` spans of the traced
stretch (the device trace of a --trace 1 run).

Counted work: the program's counter equipotential.green_escape_steps (the
sum of the escape step k over the points that escaped, clouds and curve) of
the traced jobs, times the 12 operations of one step of orbit.cu's
orbit_green (chip_smoke.ORBIT_OPS_PER_STEP, each one FP64 instruction under
-fmad=false). The points that never escape are not counted: a cycle test
could settle them sooner. Least time: that work at the H100 SXM's published
FP64 rate without the tensor cores, 33.5 TFLOP/s at 700 W. Measured time:
the union of the kernel intervals inside those spans, which hold every
kernel of the two solves (the loop, its epilogue, the zeroing and the
records' gathers). None without a device trace, without kernels in the
spans or without the counter in a traced job."""

from benchmarks.harness.readers import traced
from benchmarks.harness.spans import _stats_key

FLOP_PER_STEP = 12
FP64_FLOP_PER_S = 33.5e12
SPANS = ("potential", "stored_curve")
STEPS = "equipotential.green_escape_steps"


def read(ctx):
    spans = (ctx.trace or {}).get("span_kernel_s") or {}
    kernel_s = sum(spans.get(n, 0.0) for n in SPANS)
    steps = [_stats_key(r, "counts").get(STEPS) for r in traced(ctx)]
    if kernel_s <= 0 or not steps or None in steps:
        return None
    return 100.0 * FLOP_PER_STEP * sum(steps) / FP64_FLOP_PER_S / kernel_s
