"""pairstats.pair_roofline (%): the least time the card could spend on the
shell scans, as a share of the card's kernel time inside the pairstats.stats
spans of the traced stretch (the device trace of a --trace 1 run).

Counted work: the pairs within r_max of the two clouds, read back from the
g(r) and K(r) that run_spatial_stats returned (the pairs closer than the last
shell's inner radius, from K, plus the last shell, from g), times the 5 FLOP
that one squared distance needs whatever the implementation (two
subtractions, a multiply, a multiply-add). Pairs beyond r_max and the
Hausdorff scan are not counted: a pruned search need not visit them. Least
time: that work of the traced jobs at the card's published FP32 rate
(peaks.json, without the tensor cores). Measured time: the union of the
kernel intervals inside those jobs' pairstats.stats spans, which hold every
kernel of run_spatial_stats (the Hausdorff scan, the curvature and the box
counts' device work with the shell scans), so the share stays under 100%.
None without a device trace or without kernels in the spans."""

import json
from pathlib import Path

import numpy as np

from benchmarks.harness.readers import traced

FLOP_PER_PAIR = 5
PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"
SPAN = "pairstats.stats"


def pairs_within(points, g, k, r_max: float, dr: float) -> float:
    p = np.asarray(points)
    n = p.size
    rho = n / ((p.real.max() - p.real.min()) * (p.imag.max() - p.imag.min()))
    r_last = np.arange(0, r_max, dr)[-1]
    return float(np.rint(k[-1] * n * rho / 2.0 + g[-1] * 2 * np.pi * r_last * dr * n * rho))


def read(ctx):
    kernel_s = (ctx.trace or {}).get("span_kernel_s", {}).get(SPAN)
    jobs = traced(ctx)
    if not kernel_s or not jobs:
        return None
    cfg = ctx.config["pairstats"]
    fp32 = json.loads(PEAKS.read_text())["H100_SXM"]["fp32_flop_per_s"]
    pairs = sum(pairs_within(r.out["cloud"], r.out["stats"]["g_construct"],
                             r.out["stats"]["K_construct"], cfg["r_max"], cfg["dr"])
                + pairs_within(r.out["m"], r.out["stats"]["g_mandel"],
                               r.out["stats"]["K_mandel"], cfg["r_max"], cfg["dr"])
                for r in jobs)
    return 100.0 * FLOP_PER_PAIR * pairs / fp32 / kernel_s
