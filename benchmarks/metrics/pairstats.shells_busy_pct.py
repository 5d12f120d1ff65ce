"""pairstats.shells_busy_pct (%): the card's kernel time inside the program's
two shell-scan spans (the device trace of a --trace 1 run) over the walls of
those stages in the same traced jobs: how much of the scans the card works,
against the time the host paces them. None without a device trace, without
the stages or without kernels in their spans."""

from benchmarks.harness import spans


def read(ctx):
    return spans.busy_pct(ctx, spans.SHELLS)
