"""Time schedule variants of K2 (csrc/dwell.cu, dwell_launch), K2's
periodic entry (dwell_periodic_launch, "k2p"), K3 (csrc/cloud_green.cu), K4
(csrc/de_std.cu), K1 (csrc/tci_de.cu), K5 (csrc/green_grid.cu), K6's fine
pass (csrc/dwell_ms.cu), csrc/aberth.cu ("aberth"), csrc/orbit.cu's
orbit_green ("green") and its orbit_dwell, orbit_de_tci, orbit_de_std,
orbit_potential and orbit_de_stage1 ("orbit") and csrc/sinkhorn.cu
("sinkhorn") against the
kernels as committed, in turns on one card.

Run it on the card from the root of a checkout:

    python -m cmtci_torch.sweep_schedules [--only k5,k3] [--alt LABEL=DIR[:KEY=V,...]] ...
                                          [--out FILE]

The committed sources hold one value of each tuning constant. A variant is
the committed source with some `constexpr int KEY = V;` lines rewritten, built
into build/sweep/<label>/ and never anywhere else; the package goes on
launching the committed kernel. `--alt` adds sources from another directory
that export the same C entry points (the kernels of an earlier commit, unpacked
with `git show <commit>:cmtci_torch/csrc/dwell.cu`, or a design that was tried
and not kept: K2 with several orbits a thread, K2 with lane-level refill, K4
with a replay of the flagged chunk in place of the snapshots, K1 iterating dz
in every step, K5 with |z|^2 latched in every step), with constants rewritten
the same way; the directory holds the `.cuh` its sources include. `--only`
names the sweeps to run (k2, k2p, k3, k4, k1, k5, k6, aberth, green,
sinkhorn, orbit and probe, the latency and wrapper measurements; all by
default).

aberth.cu's variants rewrite CLUSTER, the CTAs of a cluster (1: one CTA a
polynomial, the design before the cluster; 2, 4, 8 and 16), with MAX_THREADS,
the threads of a CTA (64, 128 and 256), each launched with the task table and
shared memory companion.aberth_launch_shape and aberth_smem_bytes give that
build, and REP_UNROLL (the repulsion's pair terms computed side by side, 1 to
8), at the tracker's four clouds (n 20..300 to 20..1220) and the
equipotential's lucas cloud (n 2..200), from the cached plan, each held
bitwise (roots and step counts) to the committed launch first; beside them
inverse_cloud_padded's eigenvalues with the plan cached and built anew.
sinkhorn.cu's variants ("sinkhorn") rewrite THREADS (256, 1024; up to
THREADS / 32 lines a streaming pass), RING (4 passes in the streaming ring)
and UNROLL (the terms a lane takes side by side on a resident line: 4), each
launched on its own launch plan at stage1's two costs (the CLI defaults,
819 x 600, resident; the 6x bus, 5,049 x 1,624, streaming) and held bitwise
to the committed kernel, in turns with the committed kernel forced to
stream at the defaults, on plans of 1, 2, 4 and 8 lines a pass at the 6x
bus, and with `--alt` sources: the two-pass design of commit faa791d (one
warp a line, two passes over it; `git show
faa791d:cmtci_torch/csrc/sinkhorn.cu`) is recognised by its signature and
launched on its own plan. Then the split of a half step: builds that cut
every half step after a part (STOP: the barriers alone, + the vector copy, +
the maxima, + the exps), in turns with the whole; for the two-pass design
the same cuts are patched into its text (SINKHORN_TWO_PASS_STOP; its exps
and adds are one loop); and a TRACE build's clock cycles of each
part of a half step (thread 0 of CTA 0). Beside them the barrier floor (the
grid barriers alone on the committed grid), the bytes the ring stages a
step, and the FP64 SASS instructions of one exp and one log (exp_log_sass).
orbit_green's variants rewrite GREEN_CHUNK (1: a branch every step) and
GREEN_EPOCH (the steps between two repacks of a block's running points;
20,000: none) and run the one launch of the f64 equipotential, 80,395 points and 20,000 steps,
each held bitwise to the committed kernel; `--alt parent=DIR` adds the
orbit.cu of another commit. orbit_dwell's and orbit_de_tci's variants
(ORBIT_VARIANTS: DWELL_C and TCI_C, the patch, SKIP_INTERIOR,
LATCH_BY_REPLAY, MIDDLE_OUT) and an --alt orbit.cu (one that takes the
point count n, commit d8d4f7c's, is recognised by its signature) run at
ORBIT_DWELL_CASES and ORBIT_TCI_CASES (sweep_orbit); then orbit_de_std's
and orbit_potential's (ORBIT_VARIO_VARIANTS: STD_C and POT_C, their patch,
POT_WARPS, SKIP_INTERIOR, LATCH_BY_REPLAY, STD_DZ_CARRIED_*; an --alt whose
two entries take n, commit 78d1fc6's, recognised the same way) at
ORBIT_STD_CASES and ORBIT_POTENTIAL_CASES (sweep_orbit_vario); then
orbit_de_stage1's (ORBIT_S1_VARIANTS: SKIP_INTERIOR, S1_C, dz carried or
rerun, LATCH_BY_REPLAY, S1_PATCH_*, S1_WARPS; an --alt whose entry takes n,
commit 1f4d000's, with hypot at every step) at ORBIT_S1_CASES, beside the
committed kernel given the band (-inf, +inf), and the SASS of each kernel
of an --alt orbit.cu against the committed build's (sweep_orbit_stage1).

Every variant's output is held bitwise to the committed kernel's at every
shape before it is timed, and the committed kernel's to its plain twin once a
shape (K2 and K3: once). Times are per launch in ms between two CUDA events:
`single` around one launch (median of the rounds), `chained` around 20
launches back to back, and `replayed` around the same 20 launches captured
once into a CUDA graph, which the host starts with one call (a kernel shorter
than the host's 10 to 25 microseconds a launch reads its own time only there),
on an output tensor allocated once. The variants run in
turns inside each round, so that clock and temperature drift falls on all of
them alike. K4 runs at the bench's padded 2048 x 2048 and at 2000 x 2000 on
the boundary's domain (max_iter 500, R 4), K5 at 2048 x 2048 and 1001 x 1999
(ny x nx) on the boundary's domain (max_iter 500, R 4), K1 at 912 x 912 on
the tracker's domain and at 2400 x 2400 on run_tci's (their max_iter and R);
K4, K1 and K5 also over a range of max_iter at their first shape; K2's periodic
entry at 2000 x 2000 on the boundary's domain at max_iter 500 and 20,000, with
the plain K2 in the same rounds; K6's fine pass at 2048 x 2048 (stride 8,
tiles of 32 x 256) on the flags of the coarse pass, and then the two-pass
dwell_field_ms against K2 (chained only: the fill decision reads a count on
the host); K3 on the equipotential's default cloud, and the committed K3
against the variant with every block resident on two more clouds, a stored
curve of 2,000 points and the equipotential's cloud at n_max 387 (276,355
points). Beside each variant stands the ratio of the orbit steps its warps
execute to the steps the pixels need (bench.warp_executed_steps on the
variant's footprint; for K1 the steps of its two passes, bench.tci_lane_steps;
for the periodic entry the steps under the variant's own checkpoint schedule,
bench.periodic_lane_steps).

It also measures the FP32 and FP64 dependent-issue latencies K3's and
orbit_green's chain floors are worked out from: one warp runs a chain of
dependent MUL -> ADD pairs between two clock64() reads (a probe kernel held
in this file, on no path of the package).
The result is printed, and written as JSON to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from cmtci_torch import bench
from cmtci_torch.kernels import _build, _launch, companion
from cmtci_torch.kernels import mandelbrot_cuda as mc
from cmtci_torch.pipelines import stage1
from cmtci_torch.pipelines.analysis import TCIConfig
from cmtci_torch.pipelines.equipotential import EquipotentialConfig
from cmtci_torch.pipelines.tracker import TrackerConfig
from cmtci_torch.pipelines.variograms import VariogramConfig
from cmtci_torch.transport import sinkhorn

SWEEP_DIR = _build.BUILD_DIR.parent / "sweep"
MAX_ITER = 500
K2_SHAPES = (2000, 4096, 8192)
K3_ITERS = 20000
#: max_iter of the scan of K4, K1 and K5 at their first shape
SCAN_ITERS = (16, 64, 250, 1000, 4000)

#: K2 variants of the committed source: label -> constants rewritten
K2_VARIANTS = {
    "c1": dict(C=1), "c2": dict(C=2), "c3": dict(C=3), "c4": dict(C=4), "c6": dict(C=6),
    "c8": dict(C=8),
    "c4_row": dict(C=4, PATCH_W=32, PATCH_H=1), "c4_16x2": dict(C=4, PATCH_W=16, PATCH_H=2),
    "c4_8x4": dict(C=4, PATCH_W=8, PATCH_H=4), "c4_4x8": dict(C=4, PATCH_W=4, PATCH_H=8),
    "c4_2x16": dict(C=4, PATCH_W=2, PATCH_H=16),
    "c4_w1": dict(C=4, WARPS=1), "c4_w2": dict(C=4, WARPS=2), "c4_w8": dict(C=4, WARPS=8),
}
#: K3 variants of the committed source
K3_VARIANTS = {
    "s16": dict(S=16), "s32": dict(S=32), "s64": dict(S=64), "s128": dict(S=128),
    "s256": dict(S=256),
    # WAVES 1 keeps every block of the default cloud resident (5 an SM), 2 three
    # an SM, 4 two an SM, 8 one an SM
    "s64_waves1": dict(S=64, WAVES=1), "s64_waves2": dict(S=64, WAVES=2),
    "s64_waves4": dict(S=64, WAVES=4), "s128_waves1": dict(S=128, WAVES=1),
    "s64_b64": dict(S=64, BLOCK=64), "s64_b256": dict(S=64, BLOCK=256),
}


def _schedule_variants() -> dict:
    """The variants of a kernel with the constants C, PATCH_W, PATCH_H and
    WARPS: the steps between two exit tests, the warp's patch and the warps a
    block, each varied around C = 4 on a 4 x 8 patch with 4 warps."""
    out = {f"c{c}": dict(C=c) for c in (1, 2, 3, 4, 6, 8)}
    out.update({f"c4_{w}x{32 // w}": dict(C=4, PATCH_W=w, PATCH_H=32 // w)
                for w in (32, 16, 8, 4, 2)})
    out.update({f"c4_w{w}": dict(C=4, WARPS=w) for w in (1, 2, 8)})
    return out


#: K4 and K1 variants of the committed sources
K4_VARIANTS = _schedule_variants()
K1_VARIANTS = _schedule_variants()
#: K5 variants: C, the patch and the warps a block around C = 4 on a 4 x 8
#: patch with 4 warps, and the rows of blocks in order ("rows"; from the
#: middle outwards otherwise)
K5_VARIANTS = {**{f"c{c}": dict(C=c) for c in (2, 3, 4, 6, 8)},
               **{f"c4_{w}x{32 // w}": dict(C=4, PATCH_W=w, PATCH_H=32 // w)
                  for w in (32, 16, 8, 2)},
               **{f"c4_w{w}": dict(C=4, WARPS=w) for w in (1, 2, 8)},
               **{f"c{c}_rows": dict(C=c, MIDDLE_OUT=0) for c in (3, 4, 6)}}
#: K5's (ny, nx), chip_smoke.py phase 10's
K5_SHAPES = ((2048, 2048), (1001, 1999))
#: K6 variants: the same with the rows of blocks in order, and some with
#: the rows from the middle outwards
K6_VARIANTS = {**{lab: dict(c, MIDDLE_OUT=0) for lab, c in _schedule_variants().items()},
               **{f"c{c}_mid": dict(C=c, MIDDLE_OUT=1) for c in (3, 4, 6, 8)}}


def _periodic_variants() -> dict:
    """Variants of dwell.cu's periodic entry (its P_* constants): C, the
    patch, the warps a block and the rows of blocks from the middle outwards
    ("mid"; in order otherwise), around a 4 x 8 patch with 4 warps, and
    C = 8 (the committed chunk, where the chunk end's checkpoint work is
    spread over more steps) on other patches."""
    out = {f"c{c}": dict(P_C=c) for c in (1, 2, 3, 4, 6, 8, 12)}
    out.update({f"c4_{w}x{32 // w}": dict(P_C=4, P_PATCH_W=w, P_PATCH_H=32 // w)
                for w in (32, 16, 8, 2)})
    out.update({f"c4_w{w}": dict(P_C=4, P_WARPS=w) for w in (2, 8)})
    out.update({f"c{c}_mid": dict(P_C=c, P_MIDDLE_OUT=1) for c in (4, 6, 12)})
    out.update({f"c8_{lab}": dict(P_C=8, **kv)
                for lab, kv in (("8x4", dict(P_PATCH_W=8, P_PATCH_H=4)),
                                ("w2", dict(P_WARPS=2)), ("w8", dict(P_WARPS=8)))})
    return {lab: {"P_MIDDLE_OUT": 0, **c} for lab, c in out.items()}


K2P_VARIANTS = _periodic_variants()
#: max_iter of the periodic entry's two timings
K2P_ITERS = (MAX_ITER, 20000)
#: K6's grid, coarse stride and tile (chip_smoke.py phase 11's)
K6_SHAPE, K6_STRIDE, K6_TILE = 2048, 8, (32, 256)
#: the sweeps --only may name
SWEEPS = ("probe", "k2", "k2p", "k3", "k4", "k1", "k5", "k6", "aberth", "green", "sinkhorn",
          "orbit")
#: aberth.cu's builds: CTAs a cluster, threads a CTA
ABERTH_CLUSTERS = (1, 2, 4, 8, 16)
ABERTH_THREADS = (64, 128, 256)
#: the clouds aberth.cu is timed at: (label, family, degrees)
ABERTH_CLOUDS = ([(f"tracker stage {i + 1}", "lucas_all_ones", list(range(20, top + 1, 20)))
                  for i, top in enumerate((300, 480, 760, 1220))]
                 + [("equipotential lucas_all_ones", "lucas_all_ones", list(range(2, 201)))])
#: orbit_green's variants: the steps between two branches and between two
#: repacks of a block's running points
GREEN_VARIANTS = {**{f"chunk{c}": dict(GREEN_CHUNK=c) for c in (1, 4, 8, 16, 32, 64)},
                  **{f"epoch{e}": dict(GREEN_EPOCH=e) for e in (64, 128, 256, 1024, 4096,
                                                               20000)}}
#: orbit_dwell's and orbit_de_tci's variants: the steps between two exit
#: tests (both entries), the warp's patch, the f64 interior iterated, the
#: first escape's z latched by a select every step (a replay of the flagged
#: chunk committed), the rows of blocks in order
ORBIT_VARIANTS = {**{f"c{c}": dict(DWELL_C=c, TCI_C=c) for c in (4, 6, 8)},
                  "8x4": dict(PATCH_W=8, PATCH_H=4), "row": dict(PATCH_W=32, PATCH_H=1),
                  "no_skip": dict(SKIP_INTERIOR=0), "select": dict(LATCH_BY_REPLAY=0),
                  "rows_in_order": dict(MIDDLE_OUT=0)}
#: the cardioid-bulb junction, a grid of it, and its max_iter
ORBIT_JUNCTION = (-0.80, -0.70, -0.05, 0.05)
#: orbit_dwell's cases: (label, domain, n, dtype, max_iter); the first is
#: the f64 boundary's
ORBIT_DWELL_CASES = (("boundary 2000^2 f64, 500 it.", bench.DOM, 2000, torch.float64, 500),
                     ("junction 1000^2 f64, 2000 it.", ORBIT_JUNCTION, 1000, torch.float64,
                      2000),
                     ("boundary 2000^2 f32, 500 it.", bench.DOM, 2000, torch.float32, 500))
#: orbit_de_tci's cases: (label, domain, n, dtype); max_iter and R the
#: tracker's; the first is the f64 tracker's second stage
ORBIT_TCI_CASES = (("tracker 690^2 f64", TrackerConfig().domain, 690, torch.float64),
                   ("run_tci 912^2 f64", TCIConfig().domain, 912, torch.float64),
                   ("tracker 690^2 f32", TrackerConfig().domain, 690, torch.float32))
#: orbit_de_std's and orbit_potential's variants: the steps between two
#: exit tests (both entries; 8 committed), their patch (4 x 8, one row),
#: the potential's warps a block (1, 4), the f64 interior iterated, the
#: first escape latched by a select every step (a replay of the flagged
#: chunk committed), de_std's dz by a second pass of the escapers in f64
#: and carried in f32 (carried in f64 and a second pass in f32 committed)
ORBIT_VARIO_VARIANTS = {
    **{f"c{c}": dict(STD_C=c, POT_C=c) for c in (4, 6, 8)},
    "4x8": dict(ESC_PATCH_W=4, ESC_PATCH_H=8), "row": dict(ESC_PATCH_W=32, ESC_PATCH_H=1),
    **{f"pot_warps{w}": dict(POT_WARPS=w) for w in (1, 4)},
    "no_skip": dict(SKIP_INTERIOR=0), "select": dict(LATCH_BY_REPLAY=0),
    "dz_second_f64": dict(STD_DZ_CARRIED_F64=0), "dz_carried_f32": dict(STD_DZ_CARRIED_F32=1)}
#: orbit_de_std's cases: (label, domain, n, dtype, max_iter), R 4; the first
#: is the variograms' boundary proxy
ORBIT_STD_CASES = (("variograms 700^2 f64, 600 it.", VariogramConfig().domain, 700,
                    torch.float64, 600),
                   ("junction 1000^2 f64, 2000 it.", ORBIT_JUNCTION, 1000, torch.float64, 2000),
                   ("variograms 700^2 f32, 600 it.", VariogramConfig().domain, 700,
                    torch.float32, 600))
#: orbit_potential's cases: (label, grid, max_iter, R, normalization), all
#: f64; grid "variograms" is the variograms' 256^2 U_M grid, "coupling"
#: coupling's 300^2 on the default bus's box (coupling_um_grid), "junction"
#: 1000^2 over ORBIT_JUNCTION
ORBIT_POTENTIAL_CASES = (("variograms' U_M 256^2 f64, 600 it., R 4", "variograms", 600, 4.0,
                          "two_pow_n"),
                         ("coupling's U_M 300^2 f64, 300 it., R 10", "coupling", 300, 10.0,
                          "k_plus_1"),
                         ("junction 1000^2 f64, 2000 it., R 4", "junction", 2000, 4.0,
                          "two_pow_n"))
#: orbit_de_stage1's variants: the f64 interior iterated, the steps between
#: two exit tests, dz carried in the first pass or rerun by the escapers (in
#: both dtypes), the first escape latched by a select every step (a replay
#: of the flagged chunk committed), the warp's patch (8 x 4, 4 x 8, one
#: row), the warps a block
ORBIT_S1_VARIANTS = {
    "no_skip": dict(SKIP_INTERIOR=0), **{f"c{c}": dict(S1_C=c) for c in (4, 6, 8)},
    "dz_carried": dict(S1_DZ_CARRIED_F64=1, S1_DZ_CARRIED_F32=1),
    "dz_second": dict(S1_DZ_CARRIED_F64=0, S1_DZ_CARRIED_F32=0),
    "select": dict(LATCH_BY_REPLAY=0), "8x4": dict(S1_PATCH_W=8, S1_PATCH_H=4),
    "4x8": dict(S1_PATCH_W=4, S1_PATCH_H=8), "row": dict(S1_PATCH_W=32, S1_PATCH_H=1),
    **{f"warps{w}": dict(S1_WARPS=w) for w in (1, 2, 4)}}
#: orbit_de_stage1's cases: (label, grid, dtype, max_iter, R); grid "stage1"
#: is stage1's band field (Stage1Config's ny x nx on BAND_DOMAIN, its
#: max_iter and bailout), "junction" 1000^2 over ORBIT_JUNCTION
ORBIT_S1_CASES = (("stage1 80x120 f64, 200 it., R 1e6", "stage1", torch.float64, 200, 1e6),
                  ("stage1 80x120 f32, 200 it., R 1e6", "stage1", torch.float32, 200, 1e6),
                  ("junction 1000^2 f64, 2000 it., R 1e6", "junction", torch.float64, 2000,
                   1e6))
_VP, _VL, _VI, _VD = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
#: the argument types of the orbit.cu entries in a source that takes the
#: point count n instead of (ny, nx): orbit_dwell and orbit_de_tci up to
#: commit d8d4f7c, orbit_de_std (with R) and orbit_potential (without the
#: skip flag) up to commit 78d1fc6, orbit_de_stage1 (with R) up to commit
#: 1f4d000
ORBIT_N_ARGTYPES = {"orbit_dwell": [_VP] * 3 + [_VL, _VI, _VI, _VP],
                    "orbit_de_tci": [_VP] * 7 + [_VL, _VI, _VD, _VI, _VP],
                    "orbit_de_std": [_VP] * 7 + [_VL, _VI, _VD, _VI, _VP],
                    "orbit_de_stage1": [_VP] * 7 + [_VL, _VI, _VD, _VI, _VP],
                    "orbit_potential": [_VP] * 6 + [_VL, _VI, _VD, _VI, _VP]}
#: aberth.cu's variants: the CTAs of a cluster and the threads of a CTA, and
#: the repulsion's pair terms computed side by side
ABERTH_VARIANTS = {**{f"c{c}_t{t}": dict(CLUSTER=c, MAX_THREADS=t)
                      for c in ABERTH_CLUSTERS for t in ABERTH_THREADS},
                   **{f"unroll{u}": dict(REP_UNROLL=u) for u in (1, 2, 4, 8)}}
#: sinkhorn.cu's builds: the threads of a CTA (so up to THREADS / 32 lines a
#: streaming pass), a ring of 4 passes (3 committed), the terms a lane takes
#: side by side on a resident line (8 committed)
SINKHORN_VARIANTS = {"t256": dict(THREADS=256), "t1024": dict(THREADS=1024),
                     "ring4": dict(RING=4), "unroll4": dict(UNROLL=4)}
#: the committed build launched on streaming plans of at most this many lines
#: a pass
SINKHORN_PASSES = (1, 2, 4, 8)
#: the builds that stop each half step after a part (sinkhorn.cu's STOP):
#: the split of a half step's time
SINKHORN_STOPS = {0: "barriers", 1: "+ vector copy", 2: "+ max", 3: "+ exps"}
#: the parts sinkhorn.cu's TRACE build adds up the cycles of (thread 0 of
#: CTA 0), in the order it writes them over the plan, then the loop's ns
SINKHORN_TRACE = ("vector copy", "lines, or a round's exps and adds", "wait for the copy",
                  "next pass's maxima", "round's barrier", "grid barrier")
#: stage1's two Sinkhorn costs: the CLI defaults (819 x 600) and the 6x bus
#: (--max-n 100 --boundary-samples 2000: 5,049 x 1,624, every band pixel), as
#: Stage1Config overrides
SINKHORN_BUSES = {"default": {}, "6x": dict(max_n=100, boundary_samples=2000)}
#: the schedule constants of a variant that move its step accounting
FOOT_KEYS = ("C", "PATCH_W", "PATCH_H")

PROBE_SRC = r"""
#include <cuda_runtime.h>
template <typename T>
__global__ void probe(T* out, long long* cycles, T x, T a, T b, int n) {
    const long long t0 = clock64();
#pragma unroll 64
    for (int i = 0; i < n; ++i) {
        x = x * a;
        x = x + b;
    }
    const long long t1 = clock64();
    out[threadIdx.x] = x;
    cycles[threadIdx.x] = t1 - t0;
}
extern "C" int probe_launch(void* out, void* cycles, float x, float a, float b, int n,
                            void* stream) {
    probe<float><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), static_cast<long long*>(cycles), x, a, b, n);
    return static_cast<int>(cudaGetLastError());
}
extern "C" int probe64_launch(void* out, void* cycles, double x, double a, double b, int n,
                              void* stream) {
    probe<double><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<double*>(out), static_cast<long long*>(cycles), x, a, b, n);
    return static_cast<int>(cudaGetLastError());
}
"""

#: one libdevice exp and one log a thread, whose SASS FP64 instructions
#: exp_log_sass counts (the Sinkhorn bound's operations an element)
EXP_LOG_SRC = r"""
extern "C" __global__ void exp_probe(const double* x, double* y) {
    y[threadIdx.x] = exp(x[threadIdx.x]);
}
extern "C" __global__ void log_probe(const double* x, double* y) {
    y[threadIdx.x] = log(x[threadIdx.x]);
}
"""
#: SASS opcodes counted as FP64 instructions
FP64_SASS = re.compile(r"\b(D(?:ADD|MUL|FMA|SETP|MNMX|SET)|MUFU\.\w*64\w*|[FI]2[FI]\.\S*64\S*)\b")


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rewrite(text: str, consts: dict) -> str:
    for key, val in consts.items():
        text, n = re.subn(rf"(constexpr int {key} = )\d+;", rf"\g<1>{int(val)};", text)
        if n != 1:
            raise ValueError(f"`constexpr int {key} = ...;` found {n} times")
    return text


def build(label: str, name: str, src_dir: Path, consts: dict):
    """(ctypes library, registers and spill lines of ptxas) of src_dir/<name>.cu
    with `consts` rewritten, built into build/sweep/<label>/."""
    out_dir = SWEEP_DIR / label
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in src_dir.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    src = out_dir / f"{name}.cu"
    src.write_text(rewrite((src_dir / f"{name}.cu").read_text(), consts))
    so = out_dir / f"lib{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{proc.stdout}{proc.stderr}")
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(so)), ptxas


def entry(lib, name: str):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = _launch.ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def in_turns(calls: dict, rounds: int = 7, chain: int = 20, graphs: bool = True) -> dict:
    """{label: (single ms, chained ms per launch, replayed ms per launch)},
    medians over `rounds`; within a round every variant runs once, in the
    dict's order. `replayed` is `chain` launches captured once into a CUDA
    graph and replayed between the two events: the host does nothing in
    between, so a kernel shorter than the host's time to launch it (some 10 to
    25 microseconds through ctypes) still reads its own time. graphs=False
    (calls that synchronize with the host) leaves `replayed` NaN."""
    single = {k: [] for k in calls}
    chained = {k: [] for k in calls}
    replayed = {k: [] for k in calls}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    captured = {}
    for label, fn in calls.items():
        if not graphs:
            break
        captured[label] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured[label]):
            for _ in range(chain):
                fn()
        captured[label].replay()
    torch.cuda.synchronize()

    def timed(run, reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    for _ in range(rounds):
        for label, fn in calls.items():
            def back_to_back(fn=fn):
                for _ in range(chain):
                    fn()

            single[label].append(timed(fn, 1))
            chained[label].append(timed(back_to_back, chain))
            replayed[label].append(timed(captured[label].replay, chain) if graphs
                                   else float("nan"))
    return {k: tuple(statistics.median(v[k]) for v in (single, chained, replayed))
            for k in calls}


def parse_alts(specs, name: str):
    """[(label, dir, consts)] of the --alt entries whose directory holds
    <name>.cu."""
    out = []
    for spec in specs:
        label, _, rest = spec.partition("=")
        path, _, consts = rest.partition(":")
        if not (Path(path) / f"{name}.cu").exists():
            continue
        kv = dict(item.split("=") for item in consts.split(",")) if consts else {}
        out.append((label, Path(path), {k: int(v) for k, v in kv.items()}))
    return out


def build_all(name: str, variants: dict, alts, tag: str | None = None) -> dict:
    """{label: build(...)} of every variant and alternative of csrc/<name>.cu,
    each into build/sweep/<tag>-<label>/ (tag: name by default; a sweep of
    another entry of the same source takes its own, so that no library is
    rebuilt while another sweep has it loaded)."""
    tag = tag or name
    jobs = ([(f"{tag}-{lab}", name, _build.CSRC, c) for lab, c in variants.items()]
            + [(f"{tag}-{lab}", name, d, c) for lab, d, c in alts])
    with ThreadPoolExecutor(8) as ex:
        built = list(ex.map(lambda j: build(*j), jobs))
    labels = list(variants) + [lab for lab, _, _ in alts]
    return dict(zip(labels, built))


def stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def sweep_k2(dev, alts) -> dict:
    built = build_all("dwell", K2_VARIANTS, alts)
    report = {"ptxas": {lab: p for lab, (_, p) in built.items()}, "shapes": {}}
    dom = bench.DOM
    foot = mc.DWELL_FOOTPRINT
    for n in K2_SHAPES:
        xmin, ymin, dx, dy = (float(v) for v in mc._params(dom, n, n))
        want = mc.mandelbrot_field(dom, n, n, MAX_ITER, device=dev)
        if n == K2_SHAPES[0]:
            twin = mc.dwell_field_torch(dom, n, n, MAX_ITER, device=dev)
            check(torch.equal(want, twin), "the committed K2 differs from its twin")
            interior = mc._interior_mask_torch(*mc._grid_coords(dom, n, n, dev))
            ratios = {}
            for lab, c in K2_VARIANTS.items():
                f = dict(foot, **{k.lower(): v for k, v in c.items() if k != "WARPS"})
                useful, executed = bench.dwell_step_counts(want, interior, MAX_ITER, f)
                ratios[lab] = executed / useful
            report["executed_over_useful"] = ratios
        out = torch.empty((n, n), dtype=torch.float32, device=dev)
        calls = {"committed": lambda: _launch.launch(
            "dwell", dev, out.data_ptr(), n, n, xmin, ymin, dx, dy, MAX_ITER)}
        for lab, (lib, _) in built.items():
            fn = entry(lib, "dwell")

            def call(fn=fn):
                rc = fn(out.data_ptr(), n, n, xmin, ymin, dx, dy, MAX_ITER, stream(dev))
                check(rc == 0, f"dwell_launch returned cudaError {rc}")

            out.fill_(-1.0)
            call()
            torch.cuda.synchronize()
            diff = int((out != want).sum())
            check(diff == 0, f"K2 variant {lab} differs from the committed kernel at {diff} px")
            calls[lab] = call
        report["shapes"][n] = in_turns(calls)
    return report


def same_bits(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries at which a and b differ, a NaN equal to a NaN."""
    return int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())


def sweep_de(dev, kernel: str, alts) -> dict:
    """K4 (kernel "de_std"), K1 ("tci_de") or K5 ("green_grid"): every
    variant and alternative against the committed kernel at the kernel's two
    shapes, then the committed kernel over SCAN_ITERS at the first."""
    k1 = kernel == "tci_de"
    if kernel == "de_std":
        variants, foot, label = K4_VARIANTS, mc.DE_FOOTPRINT, "K4"
        cases = [(bench.padded_domain(bench.BenchSizes()), 2048, 2048, MAX_ITER,
                  bench.DE_ESCAPE_R), (bench.DOM, 2000, 2000, MAX_ITER, bench.DE_ESCAPE_R)]
    elif kernel == "green_grid":
        variants, foot, label = K5_VARIANTS, mc.GREEN_FOOTPRINT, "K5"
        cases = [(bench.DOM, ny, nx, MAX_ITER, bench.DE_ESCAPE_R) for ny, nx in K5_SHAPES]
    else:
        variants, foot, label = K1_VARIANTS, mc.TCI_FOOTPRINT, "K1"
        trk, tci = TrackerConfig(), TCIConfig()
        cases = [(trk.domain, 912, 912, trk.max_iter, trk.escape_r),
                 (tci.domain, 2400, 2400, tci.max_iter, tci.escape_r)]
    built = build_all(kernel, variants, alts)
    report = {"ptxas": {lab: p for lab, (_, p) in built.items()}, "shapes": {},
              "executed_over_useful": {}, "useful_steps": {}}

    def lane_steps(cr, ci, max_iter, r2):
        """Per-lane trips of the kernel's loops: one grid for K4 and K5, two
        for K1."""
        if k1:
            return list(bench.tci_lane_steps(cr, ci, max_iter, r2))
        return [bench.escape_lane_steps(cr, ci, max_iter, r2)]

    def grid_args(out, dom, ny, nx, max_iter, r2):
        xmin, ymin, dx, dy = (float(v) for v in mc._params(dom, nx, ny))
        grid = (nx,) if k1 else (nx, ny)
        return (out.data_ptr(), *grid, xmin, ymin, dx, dy, max_iter, r2)

    for dom, ny, nx, max_iter, escape_r in cases:
        shape = f"{ny}x{nx}"
        r2 = float(np.float32(escape_r * escape_r))
        if k1:
            want = mc._tci_field(dom, nx, max_iter, escape_r, dev)
            twin = mc.tci_de_field_torch(dom, nx, max_iter, escape_r, device=dev)
        else:
            kind = "de" if kernel == "de_std" else "green"
            twin_fn = mc.de_field_std_torch if kind == "de" else mc.green_field_torch
            want = mc.mandelbrot_field(dom, nx, ny, max_iter, kind, escape_r, dev)
            twin = twin_fn(dom, nx, ny, max_iter, escape_r, device=dev)
        check(same_bits(want, twin) == 0, f"the committed {label} differs from its twin at "
                                          f"{shape}")
        cr, ci = mc._grid_coords(dom, nx, ny, dev)
        lanes = lane_steps(cr, ci, max_iter, r2)
        useful = float(sum(lane.sum(dtype=torch.float64) for lane in lanes))

        def executed(f):
            # K1's chunks never pass max_iter; its second pass tests every step
            if not k1:
                return bench.warp_executed_steps(lanes[0], f)
            return (bench.warp_executed_steps(lanes[0], f, max_iter)
                    + bench.warp_executed_steps(lanes[1], dict(f, c=1)))

        ratios = {"committed": executed(foot) / useful,
                  "one-row warps, a test a step": executed(bench.ROW_WARP) / useful}
        for lab, c in variants.items():
            f = dict(foot, **{k.lower(): v for k, v in c.items() if k in FOOT_KEYS})
            ratios[lab] = executed(f) / useful
        report["executed_over_useful"][shape] = ratios
        report["useful_steps"][shape] = useful
        out = torch.empty((ny, nx), dtype=torch.float32, device=dev)
        args = grid_args(out, dom, ny, nx, max_iter, r2)
        calls = {"committed": lambda args=args: _launch.launch(kernel, dev, *args)}
        for lab, (lib, _) in built.items():
            fn = entry(lib, kernel)

            def call(fn=fn, args=args):
                rc = fn(*args, stream(dev))
                check(rc == 0, f"{kernel}_launch returned cudaError {rc}")

            out.fill_(-2.0)
            call()
            torch.cuda.synchronize()
            diff = same_bits(out, want)
            check(diff == 0, f"{label} variant {lab} differs from the committed kernel at "
                             f"{diff} px of {shape}")
            calls[lab] = call
        report["shapes"][shape] = in_turns(calls)

    # the committed kernel at the first shape over a range of max_iter: what
    # the pixels that run max_iter out cost, beside the steps all pixels need
    dom, ny, nx, _, escape_r = cases[0]
    r2 = float(np.float32(escape_r * escape_r))
    cr, ci = mc._grid_coords(dom, nx, ny, dev)
    out = torch.empty((ny, nx), dtype=torch.float32, device=dev)
    calls, useful = {}, {}
    for it in SCAN_ITERS:
        args = grid_args(out, dom, ny, nx, it, r2)
        calls[it] = lambda args=args: _launch.launch(kernel, dev, *args)
        useful[it] = float(sum(lane.sum(dtype=torch.float64)
                               for lane in lane_steps(cr, ci, it, r2)))
    times = in_turns(calls)
    report["max_iter_scan"] = {"shape": f"{ny}x{nx}",
                               "ms": {it: times[it][2] for it in SCAN_ITERS},
                               "useful_steps": useful}
    return report


def _grid_call(fn, name: str, out, n: int, dom, max_iter: int, dev):
    """A call of the C entry `fn` (<name>_launch) on the n x n grid of `dom`
    into `out`, raising on a launch error."""
    xmin, ymin, dx, dy = (float(v) for v in mc._params(dom, n, n))

    def call():
        rc = fn(out.data_ptr(), n, n, xmin, ymin, dx, dy, max_iter, stream(dev))
        check(rc == 0, f"{name}_launch returned cudaError {rc}")

    return call


def sweep_k2p(dev, alts) -> dict:
    """K2's periodic entry: every variant and alternative against the
    committed entry and plain K2 at 2000 x 2000, max_iter 500 and 20,000,
    with plain K2 timed in the same rounds."""
    built = build_all("dwell", K2P_VARIANTS, alts, tag="dwell_periodic")
    report = {"ptxas": {lab: p for lab, (_, p) in built.items()}, "max_iter": {},
              "executed_over_useful": {}, "useful_steps": {}}
    dom, n = bench.DOM, K2_SHAPES[0]
    cr, ci = mc._grid_coords(dom, n, n, dev)
    foot = mc.DWELL_PERIODIC_FOOTPRINT
    for max_iter in K2P_ITERS:
        want = mc.mandelbrot_field(dom, n, n, max_iter, device=dev)
        per = mc.mandelbrot_field(dom, n, n, max_iter, device=dev, periodicity=True)
        check(torch.equal(per, want), f"the committed periodic K2 differs from plain K2 at "
                                      f"max_iter {max_iter}")
        if max_iter == MAX_ITER:
            twin = mc.dwell_field_torch(dom, n, n, max_iter, device=dev, periodicity=True)
            check(torch.equal(per, twin), "the committed periodic K2 differs from its twin")
        lanes = {}

        def ratio(f):
            if f["c"] not in lanes:
                lanes[f["c"]] = bench.periodic_lane_steps(cr, ci, max_iter, f["c"])[0]
            lane = lanes[f["c"]]
            return bench.warp_executed_steps(lane, f) / float(lane.sum(dtype=torch.float64))

        ratios = {"committed": ratio(foot)}
        report["useful_steps"][max_iter] = float(lanes[foot["c"]].sum(dtype=torch.float64))
        for lab, c in K2P_VARIANTS.items():
            f = {"c": c.get("P_C", foot["c"]), "patch_w": c.get("P_PATCH_W", foot["patch_w"]),
                 "patch_h": c.get("P_PATCH_H", foot["patch_h"])}
            ratios[lab] = ratio(f)
        report["executed_over_useful"][max_iter] = ratios
        out = torch.empty((n, n), dtype=torch.float32, device=dev)
        calls = {"plain K2": _grid_call(entry(_build.library("dwell"), "dwell"), "dwell", out,
                                        n, dom, max_iter, dev),
                 "committed": _grid_call(entry(_build.library("dwell"), "dwell_periodic"),
                                         "dwell_periodic", out, n, dom, max_iter, dev)}
        for lab, (lib, _) in built.items():
            call = _grid_call(entry(lib, "dwell_periodic"), "dwell_periodic", out, n, dom,
                              max_iter, dev)
            out.fill_(-1.0)
            call()
            torch.cuda.synchronize()
            diff = int((out != want).sum())
            check(diff == 0, f"periodic K2 variant {lab} differs from plain K2 at {diff} px "
                             f"(max_iter {max_iter})")
            calls[lab] = call
        report["max_iter"][max_iter] = in_turns(calls, chain=20 if max_iter == MAX_ITER else 5)
    return report


def sweep_k6(dev, alts) -> dict:
    """K6's fine pass: every variant and alternative against the committed
    kernel on the coarse pass's flags at 2048 x 2048; then the two-pass
    dwell_field_ms against K2, chained."""
    built = build_all("dwell_ms", K6_VARIANTS, alts)
    dom, n, stride, (th, tw) = bench.DOM, K6_SHAPE, K6_STRIDE, K6_TILE
    cparams = mc._coarse_params(dom, n, n, stride)
    coarse = mc._dwell(cparams, n // stride, n // stride, MAX_ITER, dev)
    fill = mc.fill_flags(coarse, th // stride, tw // stride).contiguous()
    want = mc.dwell_fill(dom, n, n, fill, K6_TILE, MAX_ITER, device=dev)
    twin = mc.dwell_fill_torch(dom, n, n, fill, K6_TILE, MAX_ITER, device=dev)
    check(torch.equal(want, twin), "the committed K6 differs from its twin")
    plain = mc.mandelbrot_field(dom, n, n, MAX_ITER, device=dev)
    filled = mc._fill_pixels(fill, K6_TILE) >= 0
    interior = mc._interior_mask_torch(*mc._grid_coords(dom, n, n, dev))
    # the unfilled pixels' steps, as K2 needs them; a filled pixel needs none
    lane = torch.where(filled | interior, 0.0, (plain + 1.0).clamp(max=float(MAX_ITER)))
    useful = float(lane.sum(dtype=torch.float64))
    foot = mc.DWELL_MS_FOOTPRINT
    ratios = {"committed": bench.warp_executed_steps(lane, foot) / useful,
              "one-row warps, a test a step": bench.warp_executed_steps(lane) / useful}
    for lab, c in K6_VARIANTS.items():
        f = dict(foot, **{k.lower(): v for k, v in c.items() if k in FOOT_KEYS})
        ratios[lab] = bench.warp_executed_steps(lane, f) / useful
    xmin, ymin, dx, dy = (float(v) for v in mc._params(dom, n, n))
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    args = (fill.data_ptr(), out.data_ptr(), n, n, xmin, ymin, dx, dy, MAX_ITER, th, tw)
    calls = {"committed": lambda: _launch.launch("dwell_ms", dev, *args)}
    for lab, (lib, _) in built.items():
        fn = entry(lib, "dwell_ms")

        def call(fn=fn):
            rc = fn(*args, stream(dev))
            check(rc == 0, f"dwell_ms_launch returned cudaError {rc}")

        out.fill_(-2.0)
        call()
        torch.cuda.synchronize()
        diff = int((out != want).sum())
        check(diff == 0, f"K6 variant {lab} differs from the committed kernel at {diff} px")
        calls[lab] = call
    fine = in_turns(calls)
    ms_out, _ = mc.dwell_field_ms(dom, n, n, MAX_ITER, stride, K6_TILE, device=dev)
    check(torch.equal(ms_out, plain), "dwell_field_ms differs from K2 at 2048 x 2048")
    two_pass = in_turns({
        "K2": lambda: mc.mandelbrot_field(dom, n, n, MAX_ITER, device=dev),
        "two-pass": lambda: mc.dwell_field_ms(dom, n, n, MAX_ITER, stride, K6_TILE,
                                              device=dev)}, graphs=False)
    return {"ptxas": {lab: p for lab, (_, p) in built.items()}, "fine": fine,
            "two_pass": two_pass, "executed_over_useful": ratios, "useful_steps": useful,
            "filled_tiles": int((fill >= 0).sum()), "tiles": fill.numel()}


#: n_max of the equipotential's cloud that K3's launcher is also timed at
#: (276,355 points after the interior short-circuit, where the default n_max
#: 200 gives 73,993)
K3_LARGE_N_MAX = 387
#: points of the stored curve K3's launcher is also timed at
K3_CURVE_POINTS = 2000
#: the golden boundary polyline the stored curve is taken from
GOLDEN_BOUNDARY = Path(__file__).resolve().parents[1] / "artifacts" / "mandel_boundary.csv.gz"


def _f32_cloud(pts, dev):
    """(cr, ci) f32 tensors on the card of the complex points `pts` after the
    host's interior short-circuit, as green_cloud_f32 launches K3 on them."""
    pts = pts[~mc.exact_interior(pts)]
    return (torch.as_tensor(pts.real.astype(np.float32), device=dev),
            torch.as_tensor(pts.imag.astype(np.float32), device=dev))


def default_cloud(dev, n_max: int | None = None):
    """The equipotential's cloud (the CLI defaults, or n 2..n_max) after the
    host's interior short-circuit, as f32 tensors on the card."""
    cfg = EquipotentialConfig()
    ns = list(range(cfg.n_min, (n_max or cfg.n_max) + 1))
    pts = np.concatenate([companion.inverse_cloud(ns, f, tol=cfg.eig_tol, device=dev)
                          for f in cfg.families])
    return _f32_cloud(pts, dev)


def curve_cloud(dev):
    """K3_CURVE_POINTS vertices of the golden boundary polyline, evenly spaced
    along its order: a stored curve as the equipotential's --curve-npy reads
    one."""
    xy = np.loadtxt(GOLDEN_BOUNDARY, delimiter=",", skiprows=1)
    idx = np.linspace(0, len(xy) - 1, K3_CURVE_POINTS).round().astype(int)
    return _f32_cloud(xy[idx, 0] + 1j * xy[idx, 1], dev)


def sweep_k3(dev, alts) -> dict:
    """Every K3 variant and alternative against the committed kernel on the
    default cloud; then the committed launcher against every block resident
    (s64_waves1) on a stored curve and on a large cloud, each held to the
    twin first."""
    built = build_all("cloud_green", K3_VARIANTS, alts)
    cr, ci = default_cloud(dev)
    z0 = torch.zeros_like(cr)
    m = cr.numel()
    want = mc.cloud_green(cr, ci, z0, z0, K3_ITERS, 2.0, device=dev)
    twin = mc.cloud_green_torch(cr, ci, z0, z0, K3_ITERS, 2.0, device=dev)
    check(torch.equal(want, twin), "the committed K3 differs from its twin")
    out = torch.empty((6, m), dtype=torch.float32, device=dev)
    args = (cr.data_ptr(), ci.data_ptr(), z0.data_ptr(), z0.data_ptr(), out.data_ptr(), m,
            K3_ITERS, 4.0)
    calls = {"committed": lambda: _launch.launch("cloud_green", dev, *args)}
    for lab, (lib, _) in built.items():
        fn = entry(lib, "cloud_green")

        def call(fn=fn):
            rc = fn(*args, stream(dev))
            check(rc == 0, f"cloud_green_launch returned cudaError {rc}")

        out.fill_(-1.0)
        call()
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"K3 variant {lab} differs from the committed kernel")
        calls[lab] = call
    longest = int(torch.where(want[0] > 0, want[0], float(K3_ITERS)).max())
    report = {"ptxas": {lab: p for lab, (_, p) in built.items()}, "points": m,
              "longest_lane_steps": longest, "times": in_turns(calls, chain=5),
              "clouds": {}}
    resident = entry(built["s64_waves1"][0], "cloud_green")
    for label, (cr, ci) in (("curve", curve_cloud(dev)),
                            (f"n_max {K3_LARGE_N_MAX}", default_cloud(dev, K3_LARGE_N_MAX))):
        z0 = torch.zeros_like(cr)
        m = cr.numel()
        want = mc.cloud_green(cr, ci, z0, z0, K3_ITERS, 2.0, device=dev)
        twin = mc.cloud_green_torch(cr, ci, z0, z0, K3_ITERS, 2.0, device=dev)
        check(torch.equal(want, twin), f"the committed K3 differs from its twin on {label}")
        out = torch.empty((6, m), dtype=torch.float32, device=dev)
        args = (cr.data_ptr(), ci.data_ptr(), z0.data_ptr(), z0.data_ptr(), out.data_ptr(), m,
                K3_ITERS, 4.0)

        def call(args=args):
            rc = resident(*args, stream(dev))
            check(rc == 0, f"cloud_green_launch returned cudaError {rc}")

        out.fill_(-1.0)
        call()
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"K3 s64_waves1 differs from the committed kernel on "
                                      f"{label}")
        longest = int(torch.where(want[0] > 0, want[0], float(K3_ITERS)).max())
        report["clouds"][label] = {
            "points": m, "longest_lane_steps": longest,
            "times": in_turns({"committed": lambda args=args: _launch.launch(
                "cloud_green", dev, *args), "s64_waves1": call}, chain=5)}
    return report


def dependent_latency(dev) -> dict:
    """Cycles between two dependent FP32 (and FP64) instructions (MUL -> ADD
    -> MUL ...) of one warp alone on its SM, and the clock the chain ran at:
    {"fp32": {...}, "fp64": {...}}."""
    out_dir = SWEEP_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "probe.cu").write_text(PROBE_SRC)
    so = out_dir / "libprobe.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(out_dir / "probe.cu")], capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    n = 1 << 20  # 2^21 dependent instructions
    result = {}
    for key, name, ctype, dtype in (("fp32", "probe_launch", ctypes.c_float, torch.float32),
                                    ("fp64", "probe64_launch", ctypes.c_double,
                                     torch.float64)):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, ctype, ctype, ctype, I, P]
        fn.restype = I
        out = torch.empty(32, dtype=dtype, device=dev)
        cyc = torch.empty(32, dtype=torch.int64, device=dev)

        def call(fn=fn, out=out, cyc=cyc):
            rc = fn(out.data_ptr(), cyc.data_ptr(), 1.0, 1.0, 0.0, n, stream(dev))
            check(rc == 0, f"probe returned cudaError {rc}")

        ms, _, _ = in_turns({"probe": call}, rounds=5, chain=2)["probe"]
        cycles = float(cyc.max())
        result[key] = {"dependent_instructions": 2 * n, "cycles": cycles,
                       "cycles_per_instruction": cycles / (2 * n), "ms": ms,
                       "ns_per_instruction": ms * 1e6 / (2 * n),
                       "clock_ghz": cycles / (ms * 1e6)}
    return result


def sweep_aberth(dev) -> dict:
    """aberth.cu's builds of every cluster size and threads a CTA, and of
    each REP_UNROLL, in turns with the committed launch at each of
    ABERTH_CLOUDS, from the cached plan; each variant's roots and step
    counts held bitwise to the committed launch's first. Beside them the
    wrapper (eigvals_one_launch) with the plan cached and built anew."""
    import time

    built = build_all("aberth", ABERTH_VARIANTS, [])
    report = {"ptxas": {lab: p for lab, (_, p) in built.items()}, "clouds": {}}
    for label, fam, ns in ABERTH_CLOUDS:
        plan = companion._one_launch_plan(ns, fam, True, dev)
        zr, zi, steps, go = companion._aberth_prepare(*plan[:6], fam, 200, 1e-13, torch.float32)
        z0 = (zr.clone(), zi.clone())
        args = launch_args(go)

        def committed(go=go):
            zr.copy_(z0[0])
            zi.copy_(z0[1])
            go()

        committed()
        torch.cuda.synchronize()
        want = (zr.clone(), zi.clone(), steps.clone())
        calls = {"committed": committed}
        for lab, (lib, _) in built.items():
            vargs, task = aberth_variant_args(args, plan, ABERTH_VARIANTS[lab], dev)
            fn = entry(lib, "aberth")

            def call(fn=fn, vargs=vargs, task=task):
                zr.copy_(z0[0])
                zi.copy_(z0[1])
                rc = fn(*vargs, stream(dev))
                check(rc == 0, f"aberth_launch returned cudaError {rc}")

            call()
            torch.cuda.synchronize()
            check(torch.equal(zr, want[0]) and torch.equal(zi, want[1])
                  and torch.equal(steps, want[2]),
                  f"aberth {lab} differs from the committed launch at {label}")
            calls[lab] = call

        def wrapper(build):
            if build:
                companion._CACHE.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            companion.eigvals_one_launch(ns, fam, device=dev)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        wrapper(False)
        report["clouds"][label] = {
            "polynomials": len(ns), "n": [ns[0], ns[-1]],
            "steps": [int(want[2].min()), int(want[2].max())],
            "times": in_turns(calls, chain=20),
            "wrapper_ms": {"cached": statistics.median(wrapper(False) for _ in range(7)),
                           "built": statistics.median(wrapper(True) for _ in range(7))}}
    return report


def aberth_variant_args(args, plan, consts: dict, dev):
    """(arguments, task table) of a build of aberth.cu with `consts`
    rewritten, for the launch whose committed arguments are `args`
    (launch_args) on the f32-repulsion plan `plan` (_one_launch_plan): the
    task table, CTAs, threads and shared memory of the build's CLUSTER and
    MAX_THREADS. Keep the table alive while the arguments are launched."""
    threads = consts.get("MAX_THREADS", companion.ABERTH_THREADS)
    cluster = consts.get("CLUSTER", companion.ABERTH_CLUSTER)
    task, block = companion.aberth_launch_shape(plan[2], threads, cluster)
    task = torch.as_tensor(task, device=dev)
    out = list(args)
    out[3], out[9], out[20] = task.data_ptr(), len(task), block
    out[21] = companion.aberth_smem_bytes(plan[2], plan[4], plan[5], False, threads, cluster)
    return out, task


def launch_args(go) -> tuple:
    """The arguments (but the stream) go() hands _launch for its kernel."""
    got = []
    original = companion._launch
    companion._launch = lambda entry, dev, *args: got.append(args)
    try:
        go()
    finally:
        companion._launch = original
    return got[0]


def equipotential_points(dev) -> np.ndarray:
    """The equipotential's cloud at the CLI defaults (complex128, all four
    families, n 2..200), as run_equipotential hands it to the potential."""
    cfg = EquipotentialConfig()
    ns = list(range(cfg.n_min, cfg.n_max + 1))
    return np.concatenate([companion.inverse_cloud(ns, f, tol=cfg.eig_tol, device=dev)
                           for f in cfg.families])


def sweep_green(dev, alts) -> dict:
    """orbit_green's one launch of the f64 equipotential (every point, the
    whole budget) for each GREEN_CHUNK and alternative, held bitwise to the
    committed kernel, in turns."""
    built = build_all("orbit", GREEN_VARIANTS, alts, tag="green")
    cfg = EquipotentialConfig()
    pts = equipotential_points(dev)
    cr = torch.as_tensor(pts.real.copy(), device=dev)
    ci = torch.as_tensor(pts.imag.copy(), device=dev)
    zero = torch.zeros_like(cr)
    m = cr.numel()
    r2 = cfg.escape_radius * cfg.escape_radius
    outs = (torch.empty_like(cr), torch.empty_like(cr), torch.empty(m, dtype=torch.bool,
                                                                    device=dev),
            torch.empty(m, dtype=torch.int32, device=dev), torch.empty_like(cr),
            torch.empty_like(cr))
    args = (zero.data_ptr(), zero.data_ptr(), cr.data_ptr(), ci.data_ptr(),
            *(o.data_ptr() for o in outs), m, 0, cfg.max_iter, r2, cfg.max_iter, 1)
    calls = {"committed": lambda: _launch.launch("orbit_green", dev, *args)}
    calls["committed"]()
    torch.cuda.synchronize()
    want = tuple(o.clone() for o in outs)
    for lab, (lib, _) in built.items():
        fn = entry(lib, "orbit_green")

        def call(fn=fn):
            rc = fn(*args, stream(dev))
            check(rc == 0, f"orbit_green_launch returned cudaError {rc}")

        for o in outs:
            o.zero_()
        call()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(outs, want)),
              f"orbit_green variant {lab} differs from the committed kernel")
        calls[lab] = call
    steps = torch.where(want[2], want[3].long(), cfg.max_iter)
    return {"ptxas": {lab: p for lab, (_, p) in built.items()}, "points": m,
            "escaped": int(want[2].sum()), "deepest_steps": int(steps.max()),
            "steps": int(steps.sum()), "times": in_turns(calls, rounds=5, chain=5)}


def takes_grid(src_dir: Path, entry: str = "orbit_dwell") -> bool:
    """Whether src_dir/orbit.cu's `entry` takes (ny, nx) (else n)."""
    text = (src_dir / "orbit.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}_launch\(([^)]*)\)', text).group(1)
    return "long long ny" in sig


def orbit_entry(lib, name: str, grid: bool):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = _launch.ARGTYPES[name] if grid else ORBIT_N_ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def sweep_orbit(dev, alts) -> dict:
    """orbit_dwell and orbit_de_tci: every variant and alternative (with
    --alt parent=DIR, the orbit.cu of commit d8d4f7c, one thread a point on
    256-thread blocks, every step with a test and a branch) against the
    committed kernel at ORBIT_DWELL_CASES and ORBIT_TCI_CASES, in turns.
    orbit_dwell's outputs are held bitwise to the committed kernel's, the
    committed kernel's to dwell_grid_torch; orbit_de_tci's (esc, lr, li)
    and the epilogue's d bitwise to the committed kernel's, dz too for the
    variants of this source, and the committed kernel's loop state to its
    contract against _de_tci_loop_torch. Beside each time the ratio of the
    steps its warps execute to the steps the committed design needs (its
    lane steps at step granularity, bench.orbit_*_lane_steps), and the
    steps the twin runs."""
    from cmtci_torch.kernels import mandelbrot as mb

    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                               (_build.CSRC / "orbit.cu").read_text())}
    built = build_all("orbit", ORBIT_VARIANTS, alts, tag="orbit-loops")
    grid_of = {lab: takes_grid(SWEEP_DIR / f"orbit-loops-{lab}") for lab in built}
    report = {"ptxas": {lab: p for lab, (_, p) in built.items()}, "dwell": {}, "de_tci": {}}

    def footprint(lab, key):
        c = {**consts, **(ORBIT_VARIANTS.get(lab) or {})}
        return {"c": c[key], "patch_w": c["PATCH_W"], "patch_h": c["PATCH_H"]}

    for label, dom, n, dt, it in ORBIT_DWELL_CASES:
        cr, ci = mb.complex_grid(dom, n, n, dtype=dt, device=dev)
        want = mb._dwell_cuda(cr, ci, it)
        check(torch.equal(want, mb.dwell_grid_torch(cr, ci, it)),
              f"orbit_dwell {label}: the committed kernel differs from its twin")
        lane = bench.orbit_dwell_lane_steps(cr, ci, want, it)
        every = torch.where(want < it, want.long() + 1, it)
        useful = float(lane.sum())
        ratios = {}
        for lab in ["committed", *ORBIT_VARIANTS]:
            skip = (ORBIT_VARIANTS.get(lab) or {}).get("SKIP_INTERIOR", 1)
            ratios[lab] = bench.warp_executed_steps((lane if skip else every).double(),
                                                    footprint(lab, "DWELL_C")) / useful
        out = torch.empty_like(want)
        is_double = int(dt == torch.float64)
        ptrs = (cr.data_ptr(), ci.data_ptr(), out.data_ptr())
        calls = {"committed": lambda ptrs=ptrs, n=n, it=it, is_double=is_double: _launch.launch(
            "orbit_dwell", dev, *ptrs, n, n, it, is_double)}
        for lab, (lib, _) in built.items():
            g = grid_of[lab]
            fn = orbit_entry(lib, "orbit_dwell", g)
            size = (n, n) if g else (n * n,)

            def call(fn=fn, ptrs=ptrs, size=size, it=it, is_double=is_double):
                rc = fn(*ptrs, *size, it, is_double, stream(dev))
                check(rc == 0, f"orbit_dwell_launch returned cudaError {rc}")

            out.fill_(-7)
            call()
            torch.cuda.synchronize()
            check(torch.equal(out, want), f"orbit_dwell variant {lab} differs at {label}")
            calls[lab] = call
        report["dwell"][label] = {"useful_steps": useful, "twin_steps": float(every.sum()),
                                  "executed_over_useful": ratios, "times": in_turns(calls)}

    trk = TrackerConfig()
    it, radius = trk.max_iter, trk.escape_r
    for label, dom, n, dt in ORBIT_TCI_CASES:
        cr, ci = mb.complex_grid(dom, n, n, dtype=dt, device=dev)
        want = mb._de_tci_loop_cuda(cr, ci, it, radius)
        twin = mb._de_tci_loop_torch(cr, ci, it, radius)
        contract = mb._de_tci_contract(twin, radius)
        check(sum(same_bits(a.double(), b.double()) for a, b in zip(want, contract)) == 0,
              f"orbit_de_tci {label}: the committed kernel breaks its contract")
        want_d = mb._de_tci_epilogue(*want, 1e-12)[1]
        first, second, late = bench.orbit_tci_lane_steps(cr, ci, it, radius)
        # without the skip, an interior point runs every step (it never escapes)
        skipped = (bench.interior_f64_torch(cr, ci) if dt == torch.float64
                   else torch.zeros_like(late))
        every_first = torch.where(skipped, it, first)
        useful = float(first.sum() + second.sum())
        ratios = {}
        for lab in ["committed", *ORBIT_VARIANTS]:
            f = footprint(lab, "TCI_C")
            skip = (ORBIT_VARIANTS.get(lab) or {}).get("SKIP_INTERIOR", 1)
            ratios[lab] = (bench.warp_executed_steps((first if skip else every_first).double(),
                                                     f, it)
                           + bench.warp_executed_steps(second.double(), dict(f, c=1))) / useful
        outs = tuple(torch.empty_like(a) for a in want)
        is_double = int(dt == torch.float64)
        t = mb.radius_threshold(radius, dt == torch.float64)
        ptrs = (cr.data_ptr(), ci.data_ptr(), *(o.data_ptr() for o in outs))
        calls = {"committed": lambda ptrs=ptrs, n=n, t=t, is_double=is_double: _launch.launch(
            "orbit_de_tci", dev, *ptrs, n, n, it, t, None, is_double)}
        for lab, (lib, _) in built.items():
            g = grid_of[lab]
            fn = orbit_entry(lib, "orbit_de_tci", g)
            tail = (n, n, it, t, None) if g else (n * n, it, radius)

            def call(fn=fn, ptrs=ptrs, tail=tail, is_double=is_double):
                rc = fn(*ptrs, *tail, is_double, stream(dev))
                check(rc == 0, f"orbit_de_tci_launch returned cudaError {rc}")

            for o in outs:
                o.zero_()
            call()
            torch.cuda.synchronize()
            got_d = mb._de_tci_epilogue(*outs, 1e-12)[1]
            # an earlier design writes the twin's dz, finite or not: held
            # through (esc, lr, li) and the epilogue's d
            pairs = list(zip(outs, want)) if g else list(zip(outs[:3], want[:3]))
            diff = sum(same_bits(a.double(), b.double()) for a, b in pairs)
            diff += same_bits(got_d, want_d)
            check(diff == 0, f"orbit_de_tci variant {lab} differs at {label} ({diff})")
            calls[lab] = call
        report["de_tci"][label] = {
            "useful_steps": useful, "z_steps": float(first.sum()),
            "late_escapers": int(late.sum()), "late_steps": float(second.sum()),
            "twin_steps": float(it * cr.numel()), "executed_over_useful": ratios,
            "times": in_turns(calls)}
    report.update(sweep_orbit_vario(dev, alts))
    report.update(sweep_orbit_stage1(dev, alts))
    return report


def coupling_um_grid(dev):
    """coupling's U_M grid at the defaults: grid_res^2 f64 nodes on the box
    of the default bus's C and M clouds (run_stage1 at the CLI defaults),
    0.5 around them, as run_coupling builds it."""
    import tempfile

    from cmtci_torch.pipelines.coupling import CouplingConfig

    with tempfile.TemporaryDirectory() as tmp:
        bus = stage1.run_stage1(stage1.Stage1Config(), f"{tmp}/bus", plots=False, device=dev)
    res = CouplingConfig().grid_res
    allp = np.vstack([bus["C"], bus["M"]])
    lo, hi = allp.min(axis=0) - 0.5, allp.max(axis=0) + 0.5
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], res), np.linspace(lo[1], hi[1], res))
    return torch.as_tensor(gx, device=dev), torch.as_tensor(gy, device=dev)


def sweep_orbit_vario(dev, alts) -> dict:
    """orbit_de_std and orbit_potential: every variant of ORBIT_VARIO_VARIANTS
    and alternative (with --alt parent=DIR, the orbit.cu of commit 78d1fc6,
    whose two entries take the point count and run one thread a point on
    256-thread blocks, a test and a branch every step) against the
    committed kernel at ORBIT_STD_CASES and ORBIT_POTENTIAL_CASES, in turns.
    orbit_de_std's outputs are held bitwise to the committed kernel's, the
    committed kernel's to _de_latched_loop_torch; orbit_potential's loop
    state to _potential_contract against _potential_loop_torch under the
    skip it was built and called with (none for the parent and the no_skip
    build). Beside each time the ratio of the steps its warps execute to the
    steps the committed design needs (bench.orbit_de_std_lane_steps and
    orbit_potential_lane_steps; a first pass that carries dz counted as
    one pass), and the steps the twin runs."""
    from cmtci_torch.kernels import mandelbrot as mb

    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                               (_build.CSRC / "orbit.cu").read_text())}
    built = build_all("orbit", ORBIT_VARIO_VARIANTS, alts, tag="orbit-vario")
    grid_of = {lab: takes_grid(SWEEP_DIR / f"orbit-vario-{lab}", "orbit_de_std")
               for lab in built}
    report = {"ptxas_vario": {lab: p for lab, (_, p) in built.items()}, "de_std": {},
              "potential": {}}
    labels = ["committed", *ORBIT_VARIO_VARIANTS]

    def const(lab, key):
        return {**consts, **(ORBIT_VARIO_VARIANTS.get(lab) or {})}[key]

    def footprint(lab, key):
        return {"c": const(lab, key), "patch_w": const(lab, "ESC_PATCH_W"),
                "patch_h": const(lab, "ESC_PATCH_H")}

    for label, dom, n, dt, it in ORBIT_STD_CASES:
        cr, ci = mb.complex_grid(dom, n, n, dtype=dt, device=dev)
        want = mb._de_latched_loop_cuda(cr, ci, it, 4.0, False)
        twin = mb._de_latched_loop_torch(cr, ci, it, 4.0, False)
        check(sum(same_bits(a.double(), b.double()) for a, b in zip(want, twin)) == 0,
              f"orbit_de_std {label}: the committed kernel differs from its twin")
        first, second = bench.orbit_de_std_lane_steps(cr, ci, it, 4.0)
        skipped = first.new_zeros(first.shape, dtype=torch.bool)
        if dt == torch.float64:
            skipped = mb.interior_f64(cr, ci)
        useful = float(first.sum() + second.sum())
        ratios = {}
        for lab in labels:
            f = footprint(lab, "STD_C")
            z = torch.where(skipped, it, first) if not const(lab, "SKIP_INTERIOR") else first
            executed = bench.warp_executed_steps(z.double(), f, it)
            if not const(lab, "STD_DZ_CARRIED_F64" if dt == torch.float64
                         else "STD_DZ_CARRIED_F32"):
                executed += bench.warp_executed_steps(second.double(), dict(f, c=1))
            ratios[lab] = executed / useful
        outs = tuple(torch.empty_like(a) for a in want)
        is_double = int(dt == torch.float64)
        t = mb.radius_threshold(4.0, dt == torch.float64)
        ptrs = (cr.data_ptr(), ci.data_ptr(), *(o.data_ptr() for o in outs))
        calls = {"committed": lambda ptrs=ptrs, n=n, it=it, t=t, is_double=is_double:
                 _launch.launch("orbit_de_std", dev, *ptrs, n, n, it, t, is_double)}
        for lab, (lib, _) in built.items():
            g = grid_of[lab]
            fn = orbit_entry(lib, "orbit_de_std", g)
            tail = (n, n, it, t) if g else (n * n, it, 4.0)

            def call(fn=fn, ptrs=ptrs, tail=tail, is_double=is_double):
                rc = fn(*ptrs, *tail, is_double, stream(dev))
                check(rc == 0, f"orbit_de_std_launch returned cudaError {rc}")

            for o in outs:
                o.zero_()
            call()
            torch.cuda.synchronize()
            diff = sum(same_bits(a.double(), b.double()) for a, b in zip(outs, want))
            check(diff == 0, f"orbit_de_std variant {lab} differs at {label} ({diff})")
            calls[lab] = call
        report["de_std"][label] = {
            "useful_steps": useful, "z_steps": float(first.sum()),
            "dz_steps": float(second.sum()), "escapers": int((second > 0).sum()),
            "twin_steps": float(it * cr.numel()), "executed_over_useful": ratios,
            "times": in_turns(calls)}

    vc = VariogramConfig()
    grids = {"variograms": mb.complex_grid(vc.domain, vc.grid_nx, vc.grid_ny, device=dev),
             "coupling": coupling_um_grid(dev),
             "junction": mb.complex_grid(ORBIT_JUNCTION, 1000, 1000, device=dev)}
    for label, which, it, rad, norm in ORBIT_POTENTIAL_CASES:
        cr, ci = grids[which]
        ny, nx = cr.shape
        r2 = rad * rad
        skip = mb._skips_interior(norm)
        twin = mb._potential_loop_torch(cr, ci, it, r2)
        want = mb._potential_loop_cuda(cr, ci, it, r2, skip)
        check(sum(same_bits(a.double(), b.double())
                  for a, b in zip(want, mb._potential_contract(twin, cr, ci, r2, skip))) == 0,
              f"orbit_potential {label}: the committed kernel breaks its contract")
        lane = bench.orbit_potential_lane_steps(cr, ci, it, r2, skip)
        every = bench.orbit_potential_lane_steps(cr, ci, it, r2, False)
        useful = float(lane.sum())
        ratios = {lab: bench.warp_executed_steps(
            (lane if const(lab, "SKIP_INTERIOR") else every).double(), footprint(lab, "POT_C"),
            it) / useful for lab in labels}
        outs = tuple(torch.empty_like(a) for a in want)
        ptrs = (cr.data_ptr(), ci.data_ptr(), *(o.data_ptr() for o in outs))
        calls = {"committed": lambda ptrs=ptrs, ny=ny, nx=nx, it=it, r2=r2, skip=skip:
                 _launch.launch("orbit_potential", dev, *ptrs, ny, nx, it, r2, int(skip), 1)}
        for lab, (lib, _) in built.items():
            g = grid_of[lab]
            fn = orbit_entry(lib, "orbit_potential", g)
            tail = (ny, nx, it, r2, int(skip)) if g else (ny * nx, it, r2)
            skips = g and skip and bool(const(lab, "SKIP_INTERIOR"))
            expect = mb._potential_contract(twin, cr, ci, r2, skips)

            def call(fn=fn, ptrs=ptrs, tail=tail):
                rc = fn(*ptrs, *tail, 1, stream(dev))
                check(rc == 0, f"orbit_potential_launch returned cudaError {rc}")

            for o in outs:
                o.zero_()
            call()
            torch.cuda.synchronize()
            diff = sum(same_bits(a.double(), b.double()) for a, b in zip(outs, expect))
            check(diff == 0, f"orbit_potential variant {lab} differs at {label} ({diff})")
            calls[lab] = call
        report["potential"][label] = {
            "useful_steps": useful, "deepest_steps": int(lane.max()),
            "twin_steps": float(it * cr.numel()), "executed_over_useful": ratios,
            "times": in_turns(calls)}
    return report


def stage1_band_grid(dev):
    """stage1's band-field grid at the defaults on `dev`: the f64 meshgrid
    band_field passes de_field_stage1, (ny, nx) = (80, 120)."""
    cfg = stage1.Stage1Config()
    gx, gy = np.meshgrid(np.linspace(stage1.BAND_DOMAIN[0], stage1.BAND_DOMAIN[1], cfg.nx),
                         np.linspace(stage1.BAND_DOMAIN[2], stage1.BAND_DOMAIN[3], cfg.ny),
                         indexing="xy")
    return torch.as_tensor(gx, device=dev), torch.as_tensor(gy, device=dev)


def kernel_sass(src_dir: Path, tag: str) -> dict:
    """{kernel name: its SASS text} of src_dir/orbit.cu built with the
    package's flags into build/sweep/<tag>/ (cuobjdump -sass of the cubin),
    the hash of the anonymous namespace, which differs from one source text
    to another, taken out of the names and of the calls that name them."""
    out_dir = SWEEP_DIR / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / "orbit.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o", str(cubin),
                    str(src_dir / "orbit.cu")], capture_output=True, text=True, check=True)
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    return {part.split("\n", 1)[0].strip(): part.split("\n", 1)[1]
            for part in text.split("Function : ")[1:]}


def sass_against(src_dir: Path, tag: str) -> dict:
    """For each kernel of src_dir/orbit.cu, whether the committed orbit.cu
    holds a kernel of the same SASS text (a kernel renamed counts as the
    same): {name: "same"} or {name: "differs in n of m lines"} against the
    committed kernel of the same name."""
    theirs, ours = kernel_sass(src_dir, f"{tag}-sass"), kernel_sass(_build.CSRC, "committed-sass")
    bodies = set(ours.values())
    out = {}
    for name, body in theirs.items():
        if body in bodies:
            out[name] = "same"
            continue
        mine = ours.get(name, "").splitlines()
        lines = body.splitlines()
        diff = sum(a != b for a, b in zip(lines, mine)) + abs(len(lines) - len(mine))
        out[name] = f"differs in {diff} of {len(lines)} lines" if mine else "no kernel of that name"
    return out


def sweep_orbit_stage1(dev, alts) -> dict:
    """orbit_de_stage1: every variant of ORBIT_S1_VARIANTS and alternative
    (with --alt parent=DIR, the orbit.cu of commit 1f4d000, whose entry
    takes the point count and runs one thread a point on 256-thread blocks
    with hypot, a test and a branch every step) against the committed kernel
    at ORBIT_S1_CASES, in turns, beside the committed kernel given the band
    (-inf, +inf) (hypot at every step, its own schedule otherwise). Every
    output is held bitwise to the committed kernel's, the committed kernel's
    to _de_latched_loop_torch, and its count of hypot calls to
    bench.orbit_de_stage1_hypot_calls. Beside each time the ratio of the
    steps its warps execute to the steps the committed design needs
    (bench.orbit_de_stage1_lane_steps; a first pass that carries dz counted
    as one pass), and the steps the twin runs. With an alternative, the
    SASS of each of its kernels against the committed build's
    (sass_against)."""
    from cmtci_torch.kernels import mandelbrot as mb

    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                               (_build.CSRC / "orbit.cu").read_text())}
    built = build_all("orbit", ORBIT_S1_VARIANTS, alts, tag="orbit-stage1")
    grid_of = {lab: takes_grid(SWEEP_DIR / f"orbit-stage1-{lab}", "orbit_de_stage1")
               for lab in built}
    report = {"ptxas_stage1": {lab: p for lab, (_, p) in built.items()}, "de_stage1": {},
              "sass": {lab: sass_against(d, f"alt-{lab}") for lab, d, _ in alts}}
    labels = ["committed", *ORBIT_S1_VARIANTS]

    def const(lab, key):
        return {**consts, **(ORBIT_S1_VARIANTS.get(lab) or {})}[key]

    grids = {"stage1": stage1_band_grid(dev),
             "junction": mb.complex_grid(ORBIT_JUNCTION, 1000, 1000, device=dev)}
    for label, which, dt, it, rad in ORBIT_S1_CASES:
        cr, ci = (t.to(dt) for t in grids[which])
        ny, nx = cr.shape
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        want = mb._de_latched_loop_cuda(cr, ci, it, rad, True, hypot_calls=count)
        twin = mb._de_latched_loop_torch(cr, ci, it, rad, True)
        check(sum(same_bits(a.double(), b.double()) for a, b in zip(want, twin)) == 0,
              f"orbit_de_stage1 {label}: the committed kernel differs from its twin")
        calls_n = int(bench.orbit_de_stage1_hypot_calls(cr, ci, it, rad).sum())
        check(int(count.item()) == calls_n, f"orbit_de_stage1 {label}: {int(count.item())} hypot "
              f"calls, the schedule has {calls_n}")
        first, second = bench.orbit_de_stage1_lane_steps(cr, ci, it, rad)
        skipped = bench._stage1_skipped(cr, ci, rad)
        useful = float(first.sum() + second.sum())
        ratios = {}
        for lab in labels:
            f = {"c": const(lab, "S1_C"), "patch_w": const(lab, "S1_PATCH_W"),
                 "patch_h": const(lab, "S1_PATCH_H")}
            z = torch.where(skipped, it, first) if not const(lab, "SKIP_INTERIOR") else first
            executed = bench.warp_executed_steps(z.double(), f, it)
            if not const(lab, "S1_DZ_CARRIED_F64" if dt == torch.float64
                         else "S1_DZ_CARRIED_F32"):
                executed += bench.warp_executed_steps(second.double(), dict(f, c=1))
            ratios[lab] = executed / useful
        outs = tuple(torch.empty_like(a) for a in want)
        is_double = int(dt == torch.float64)
        band = mb.hypot_band(rad, dt == torch.float64)
        ptrs = (cr.data_ptr(), ci.data_ptr(), *(o.data_ptr() for o in outs))
        calls = {
            "committed": lambda ptrs=ptrs, ny=ny, nx=nx, it=it, rad=rad, band=band,
            is_double=is_double: _launch.launch("orbit_de_stage1", dev, *ptrs, ny, nx, it, rad,
                                                *band, None, is_double),
            "committed, no band": lambda ptrs=ptrs, ny=ny, nx=nx, it=it, rad=rad,
            is_double=is_double: _launch.launch("orbit_de_stage1", dev, *ptrs, ny, nx, it, rad,
                                                -math.inf, math.inf, None, is_double)}
        for lab, fn in calls.items():
            for o in outs:
                o.zero_()
            fn()
            torch.cuda.synchronize()
            diff = sum(same_bits(a.double(), b.double()) for a, b in zip(outs, want))
            check(diff == 0, f"orbit_de_stage1 {lab} differs at {label} ({diff})")
        for lab, (lib, _) in built.items():
            g = grid_of[lab]
            fn = orbit_entry(lib, "orbit_de_stage1", g)
            tail = (ny, nx, it, rad, *band, None) if g else (ny * nx, it, rad)

            def call(fn=fn, ptrs=ptrs, tail=tail, is_double=is_double):
                rc = fn(*ptrs, *tail, is_double, stream(dev))
                check(rc == 0, f"orbit_de_stage1_launch returned cudaError {rc}")

            for o in outs:
                o.zero_()
            call()
            torch.cuda.synchronize()
            diff = sum(same_bits(a.double(), b.double()) for a, b in zip(outs, want))
            check(diff == 0, f"orbit_de_stage1 variant {lab} differs at {label} ({diff})")
            calls[lab] = call
        report["de_stage1"][label] = {
            "useful_steps": useful, "z_steps": float(first.sum()),
            "dz_steps": float(second.sum()), "escapers": int((second > 0).sum()),
            "deepest_steps": int(first.max()),
            "deepest_two_passes": int((first + second).max()), "hypot_calls": calls_n,
            "twin_steps": float(it * cr.numel()), "executed_over_useful": ratios,
            "times": in_turns(calls)}
    return report


def stage1_cost(cfg: stage1.Stage1Config, dev) -> torch.Tensor:
    """The f64 Sinkhorn cost run_stage1 matches with under `cfg` on `dev`
    (its cloud and band, their orientation features and coordinates)."""
    out = stage1.run_stage1(cfg, None, plots=False, device=dev)
    xa = np.hstack([stage1.orientation_features(out["C"], cfg.k_orientation), out["C"]])
    xb = np.hstack([stage1.orientation_features(out["M"], cfg.k_orientation), out["M"]])
    return stage1.feature_cost(xa, xb, device=dev)


def logsumexp_loop(cost: torch.Tensor, iters: int, eps: float) -> torch.Tensor:
    """The Sinkhorn loop as the port ran it before csrc/sinkhorn.cu: the
    reference's two torch.logsumexp calls a step, divisions by eps (the
    yardstick sinkhorn_graph captures; its plan is not the kernel's bits)."""
    n, m = cost.shape
    log_mu = -math.log(n) * torch.ones(n, dtype=cost.dtype, device=cost.device)
    log_nu = -math.log(m) * torch.ones(m, dtype=cost.dtype, device=cost.device)
    mk = -cost / eps
    f = torch.zeros(n, dtype=cost.dtype, device=cost.device)
    g = torch.zeros(m, dtype=cost.dtype, device=cost.device)
    for _ in range(iters):
        f = eps * (log_mu - torch.logsumexp(mk + g[None, :] / eps, dim=1))
        g = eps * (log_nu - torch.logsumexp(mk + f[:, None] / eps, dim=0))
    return torch.exp(mk + f[:, None] / eps + g[None, :] / eps)


def sinkhorn_graph(cost: torch.Tensor, iters: int, eps: float):
    """(graph, static, plan): logsumexp_loop captured once into a CUDA graph
    over `static`, a copy of `cost` (after a warm-up step on a side stream,
    as torch.cuda.graphs asks); graph.replay() rewrites plan from static."""
    static = cost.detach().clone(memory_format=torch.contiguous_format)
    side = torch.cuda.Stream(cost.device)
    side.wait_stream(torch.cuda.current_stream(cost.device))
    with torch.cuda.stream(side):
        logsumexp_loop(static, 1, eps)
    torch.cuda.current_stream(cost.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        plan = logsumexp_loop(static, iters, eps)
    return graph, static, plan


def barrier_floor_ms(dev, plan: sinkhorn.SinkhornPlan, count: int, reps: int = 5) -> float:
    """Median ms of `count` grid barriers and nothing else on the grid of
    `plan` (sinkhorn_barriers_launch): the floor of a loop of count / 2
    steps."""
    def call():
        _launch.launch("sinkhorn_barriers", dev, plan.ctas, plan.smem, count)

    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def exp_log_sass() -> dict:
    """FP64 instructions (FP64_SASS's opcodes) in the SASS of one f64 exp and
    one log, built with the package's flags: {"exp": n, "log": n,
    "opcodes": {...}}. A static count: a special case's instructions count
    once though they rarely run."""
    out_dir = SWEEP_DIR / "exp_log"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = out_dir / "exp_log.cu", out_dir / "exp_log.cubin"
    src.write_text(EXP_LOG_SRC)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o", str(cubin), str(src)],
                   capture_output=True, text=True, check=True)
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    result, opcodes = {}, {}
    for name in ("exp", "log"):
        body = sass.split(f"Function : {name}_probe")[1].split("Function :")[0]
        ops = [m.group(1) for m in FP64_SASS.finditer(body)]
        result[name] = len(ops)
        opcodes[name] = {op: ops.count(op) for op in sorted(set(ops))}
    result["opcodes"] = opcodes
    return result


#: the ctypes argument types of the sinkhorn_launch of csrc/sinkhorn.cu as
#: the two-pass design of commit faa791d wrote it (16 arguments, no passes), for
#: --alt sources of that design
SINKHORN_TWO_PASS_ARGTYPES = _launch.ARGTYPES["sinkhorn"][:16] + [ctypes.c_void_p]
#: the lines of the two-pass sinkhorn.cu that a STOP build of it guards, each
#: found once: the vector copies (STOP >= 1), the line loops (STOP >= 2),
#: and line_lse's return after the max (STOP < 4)
SINKHORN_TWO_PASS_STOP = (
    ("constexpr int UNROLL = 8;\n", "constexpr int UNROLL = 8;\nconstexpr int STOP = 4;\n"),
    ("        for (int j = threadIdx.x; j < m; j += THREADS)\n            gs[j] = (it == 0",
     "        if (STOP >= 1)\n        for (int j = threadIdx.x; j < m; j += THREADS)\n"
     "            gs[j] = (it == 0"),
    ("        for (int i = threadIdx.x; i < n; i += THREADS) fs[i] = __ldcg",
     "        if (STOP >= 1) for (int i = threadIdx.x; i < n; i += THREADS) fs[i] = __ldcg"),
    ("        for (int i = r0 + warp; i < r1; i += WARPS) {",
     "        if (STOP >= 2) for (int i = r0 + warp; i < r1; i += WARPS) {"),
    ("        for (int j = c0 + warp; j < c1; j += WARPS) {",
     "        if (STOP >= 2) for (int j = c0 + warp; j < c1; j += WARPS) {"),
    ("    if (fabs(mx) == INFINITY) mx = 0.0;\n",
     "    if (fabs(mx) == INFINITY) mx = 0.0;\n    if (STOP < 4) return mx;\n"))


def is_two_pass(src_dir: Path) -> bool:
    """Whether src_dir/sinkhorn.cu is the two-pass design (a sinkhorn_launch
    without passes)."""
    return "int pass_rows" not in (src_dir / "sinkhorn.cu").read_text()


def with_two_pass_stop(src_dir: Path, out_dir: Path) -> Path:
    """A copy of the two-pass sinkhorn.cu in out_dir with a `constexpr int STOP`
    guarding its parts (SINKHORN_TWO_PASS_STOP); its STOP builds stop after the
    vector copies (1) or the max (2), 4 runs all."""
    text = (src_dir / "sinkhorn.cu").read_text()
    for old, new in SINKHORN_TWO_PASS_STOP:
        check(text.count(old) == 1, f"the two-pass sinkhorn.cu: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "sinkhorn.cu").write_text(text)
    return out_dir


def two_pass_call(lib, cost: torch.Tensor, iters: int, eps: float, streaming: bool, keep: list):
    """(call, out): one launch of the two-pass sinkhorn_launch from `lib` on its
    own plan (one CTA an SM; resident when f, g and a CTA's blocks of rows
    and columns fit, else mk and mkT unpadded in global scratch)."""
    dev = cost.device
    n, m = cost.shape
    sms, smem_max = sinkhorn.card_limits(dev)
    rows, cols = -(-n // sms), -(-m // sms)
    held = 8 * (n + m + rows * m + cols * n)
    resident = not streaming and held <= smem_max
    bufs = [torch.zeros(n, dtype=cost.dtype, device=dev),
            torch.zeros(m, dtype=cost.dtype, device=dev)]
    if not resident:
        bufs += [torch.empty_like(cost), torch.empty((m, n), dtype=cost.dtype, device=dev)]
    out = torch.empty_like(cost)
    keep.append(bufs)
    args = (cost.data_ptr(), bufs[2].data_ptr() if not resident else 0,
            bufs[3].data_ptr() if not resident else 0, bufs[0].data_ptr(), bufs[1].data_ptr(),
            out.data_ptr(), n, m, iters, float(eps), 1.0 / eps, -math.log(n), -math.log(m), sms,
            int(resident), held if resident else 8 * (n + m))
    fn = getattr(lib, "sinkhorn_launch")
    fn.argtypes = SINKHORN_TWO_PASS_ARGTYPES
    fn.restype = ctypes.c_int

    def call():
        check(fn(*args, stream(dev)) == 0, "the two-pass sinkhorn_launch failed")

    return call, out


def stop_calls(cost: torch.Tensor, iters: int, eps: float, plan, libs: dict, keep: list) -> dict:
    """{label: call}: one launch of each sinkhorn.cu library of `libs` (by
    label: STOP builds, or the committed one) on `plan`, f and g zero at the
    start (a build cut before the adds writes neither); `keep` holds the
    buffers. A cut build's plan is not the kernel's."""
    dev = cost.device
    calls = {}
    for label, lib in libs.items():
        args, _, bufs = sinkhorn.kernel_args(cost, iters, eps, plan)
        bufs[0].zero_()
        bufs[1].zero_()
        keep.append(bufs)
        fn = entry(lib, "sinkhorn")

        def call(fn=fn, args=args):
            rc = fn(*args, stream(dev))
            check(rc == 0, f"sinkhorn_launch returned cudaError {rc}")

        calls[label] = call
    return calls


def sweep_sinkhorn(dev, alts) -> dict:
    """At stage1's two costs (the defaults, resident; the 6x bus,
    streaming): the committed kernel in turns with its builds of
    SINKHORN_VARIANTS, with itself on streaming plans of SINKHORN_PASSES
    lines a pass (and forced to stream at the defaults), and with the --alt
    sources (the two-pass design launched through its own signature and
    plan), every plan held bitwise to the committed one's first; then the
    split of the half step, the committed kernel's STOP builds in turns with
    it (and the two-pass design's, with an --alt of it: stops 0 to 2), f and
    g zero; the TRACE build's cycles a part; the barrier floor of each
    committed grid."""
    built = build_all("sinkhorn", SINKHORN_VARIANTS, alts)
    stops = build_all("sinkhorn", {**{f"stop{k}": dict(STOP=k) for k in SINKHORN_STOPS},
                                   "trace": dict(TRACE=1)}, [], tag="sinkhorn-split")
    parents = {lab: d for lab, d, _ in alts if is_two_pass(d)}
    parent_stops = {}
    for lab, d in parents.items():
        patched = with_two_pass_stop(d, SWEEP_DIR / f"sinkhorn-{lab}-stop-src")
        with ThreadPoolExecutor(3) as ex:
            libs = ex.map(lambda k: build(f"sinkhorn-{lab}-stop{k}", "sinkhorn", patched,
                                          dict(STOP=k)), (0, 1, 2))
            parent_stops.update({(lab, k): b for k, b in zip((0, 1, 2), libs)})
    report = {"ptxas": {lab: p for lab, (_, p) in {**built, **stops}.items()}, "buses": {}}
    sms, smem_max = sinkhorn.card_limits(dev)
    for label, over in SINKHORN_BUSES.items():
        cfg = stage1.Stage1Config(**over)
        cost = stage1_cost(cfg, dev)
        iters, eps = stage1.SINKHORN_ITERS, cfg.sinkhorn_reg
        n, m = cost.shape
        plan = sinkhorn.card_plan(dev, n, m)
        keep = []

        def call_on(fn, vplan):
            args, out, bufs = sinkhorn.kernel_args(cost, iters, eps, vplan)
            keep.append(bufs)

            def call():
                rc = fn(*args, stream(dev))
                check(rc == 0, f"sinkhorn_launch returned cudaError {rc}")

            return call, out

        committed = entry(_build.library("sinkhorn"), "sinkhorn")
        calls, outs = {}, {}
        for lab in parents:
            calls[lab], outs[lab] = two_pass_call(built[lab][0], cost, iters, eps,
                                              not plan.resident, keep)
        calls["committed"], outs["committed"] = call_on(committed, plan)
        if plan.resident:
            calls["streaming"], outs["streaming"] = call_on(
                committed, sinkhorn.card_plan(dev, n, m, streaming=True))
        for k in SINKHORN_PASSES if not plan.resident else ():
            calls[f"pass{k}"], outs[f"pass{k}"] = call_on(committed, sinkhorn.launch_plan(
                n, m, sms, smem_max, streaming=True, pass_max=k))
        errors, plans = {}, {}
        for lab, (lib, _) in built.items():
            if lab in parents:
                continue
            consts = SINKHORN_VARIANTS.get(lab, {})
            vplan = sinkhorn.launch_plan(
                n, m, sms, smem_max, streaming=not plan.resident,
                threads=consts.get("THREADS", sinkhorn.SINKHORN_THREADS),
                depth=consts.get("RING", sinkhorn.SINKHORN_RING))
            plans[lab] = vplan.__dict__
            call, out = call_on(entry(lib, "sinkhorn"), vplan)
            try:
                call()
            except RuntimeError as exc:  # a build the card cannot launch
                errors[lab] = str(exc)
                continue
            calls[lab], outs[lab] = call, out
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        want = outs["committed"]
        for lab, out in outs.items():
            check(torch.equal(out, want), f"sinkhorn {lab} differs from the committed kernel")
        rounds = 5 if label == "default" else 3
        times = in_turns(calls, rounds=rounds, chain=1, graphs=False)
        split = {"committed": calls["committed"],
                 **stop_calls(cost, iters, eps, plan,
                              {f"stop{k}": stops[f"stop{k}"][0] for k in SINKHORN_STOPS}, keep)}
        for lab in parents:
            split[lab] = calls[lab]
            for k in (0, 1, 2):
                split[f"{lab} stop{k}"], _ = two_pass_call(parent_stops[(lab, k)][0], cost, iters,
                                                       eps, not plan.resident, keep)
        split_times = in_turns(split, rounds=rounds, chain=1, graphs=False)
        # the trace build: cycles of each part a half step, and the SM clock
        args, traced, bufs = sinkhorn.kernel_args(cost, iters, eps, plan)
        check(entry(stops["trace"][0], "sinkhorn")(*args, stream(dev)) == 0, "trace launch")
        torch.cuda.synchronize()
        cycles = traced.flatten()[:len(SINKHORN_TRACE) + 1].tolist()
        trace = {part: c / (2 * iters) for part, c in zip(SINKHORN_TRACE, cycles)}
        trace["sm_ghz"] = sum(cycles[:-1]) / cycles[-1]
        report["buses"][label] = {
            "shape": [n, m], "plan": plan.__dict__, "variant_plans": plans,
            "launch_errors": errors, "staged_bytes_a_step": plan.staged,
            "barrier_floor_ms": barrier_floor_ms(dev, plan, 2 * iters),
            "times": times, "split": split_times, "trace_cycles_a_half_step": trace}
        del keep
    return report


def wrapper_overhead_us(dev) -> dict:
    """Host microseconds a call of K2 through each layer, on an 8 x 8 grid
    whose kernel takes no time: the raw ctypes entry, _launch.launch, and
    mandelbrot_field (which also builds the parameters and the output)."""
    import time

    out = torch.empty((8, 8), dtype=torch.float32, device=dev)
    raw = entry(_build.library("dwell"), "dwell")
    calls = {
        "ctypes": lambda: raw(out.data_ptr(), 8, 8, -2.0, -1.0, 0.1, 0.1, 5, stream(dev)),
        "launch": lambda: _launch.launch("dwell", dev, out.data_ptr(), 8, 8, -2.0, -1.0, 0.1,
                                         0.1, 5),
        "mandelbrot_field": lambda: mc.mandelbrot_field(bench.DOM, 8, 8, 5, device=dev),
    }
    result = {}
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        result[label] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cmtci_torch.sweep_schedules",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--alt", action="append", default=[],
                    help="LABEL=DIR[:KEY=V,...]: sources of another directory")
    ap.add_argument("--only", default=",".join(SWEEPS),
                    help="comma-separated sweeps to run: " + ", ".join(SWEEPS))
    ap.add_argument("--out", default=None, help="write the report as JSON here")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    check(only <= set(SWEEPS), f"unknown sweep in --only {args.only}")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    report = {"card": card}
    print(card)
    if "probe" in only:
        report["latency"] = dependent_latency(dev)
        report["wrapper_overhead_us"] = wrapper_overhead_us(dev)
        for key, lat in report["latency"].items():
            print(f"{key.upper()} latency between dependent instructions:", json.dumps(lat))
        print("host microseconds a K2 call:", json.dumps(report["wrapper_overhead_us"]))
    if "k2" in only:
        report["k2"] = sweep_k2(dev, parse_alts(args.alt, "dwell"))
        for n, times in report["k2"]["shapes"].items():
            print(f"K2 {n} x {n}, max_iter {MAX_ITER} (ms per launch: single, chained, "
                  "replayed from a CUDA graph):")
            for lab, (s, c, g) in times.items():
                ratio = report["k2"]["executed_over_useful"].get(lab)
                print(f"  {lab:>14}: {s:.4f} {c:.4f} {g:.4f}"
                      + (f"  executed/useful {ratio:.3f}" if ratio and n == K2_SHAPES[0] else ""))
    if "k2p" in only:
        report["k2p"] = sweep_k2p(dev, parse_alts(args.alt, "dwell"))
        for it, times in report["k2p"]["max_iter"].items():
            ratios = report["k2p"]["executed_over_useful"][it]
            print(f"K2 periodic {K2_SHAPES[0]} x {K2_SHAPES[0]}, max_iter {it}, "
                  f"{report['k2p']['useful_steps'][it]:.0f} useful steps under the committed "
                  "schedule (ms per launch: single, chained, replayed from a CUDA graph):")
            for lab, (s, c, g) in times.items():
                ratio = ratios.get(lab)
                print(f"  {lab:>16}: {s:.4f} {c:.4f} {g:.4f}"
                      + (f"  executed/useful {ratio:.3f}" if ratio else ""))
    if "k6" in only:
        report["k6"] = sweep_k6(dev, parse_alts(args.alt, "dwell_ms"))
        k6 = report["k6"]
        print(f"K6 fine pass {K6_SHAPE} x {K6_SHAPE}, {k6['filled_tiles']} of {k6['tiles']} "
              f"tiles filled, {k6['useful_steps']:.0f} useful steps (ms per launch: single, "
              "chained, replayed from a CUDA graph):")
        for lab, (s, c, g) in k6["fine"].items():
            ratio = k6["executed_over_useful"].get(lab)
            print(f"  {lab:>14}: {s:.4f} {c:.4f} {g:.4f}"
                  + (f"  executed/useful {ratio:.3f}" if ratio else ""))
        print("K6 two-pass dwell_field_ms against K2 (ms per call: single, chained): "
              + ", ".join(f"{lab} {s:.4f} {c:.4f}" for lab, (s, c, _) in k6["two_pass"].items()))
    if "k3" in only:
        report["k3"] = sweep_k3(dev, parse_alts(args.alt, "cloud_green"))
        print(f"K3 {report['k3']['points']} points, {K3_ITERS} iterations, longest lane "
              f"{report['k3']['longest_lane_steps']} steps (ms per launch: single, chained, "
              "replayed from a CUDA graph):")
        for lab, (s, c, g) in report["k3"]["times"].items():
            print(f"  {lab:>14}: {s:.4f} {c:.4f} {g:.4f}")
        for label, cloud in report["k3"]["clouds"].items():
            print(f"K3 on the {label} cloud, {cloud['points']} points, longest lane "
                  f"{cloud['longest_lane_steps']} steps (ms per launch: single, chained, "
                  "replayed from a CUDA graph):")
            for lab, (s, c, g) in cloud["times"].items():
                print(f"  {lab:>14}: {s:.4f} {c:.4f} {g:.4f}")
    for key, kernel in (("k4", "de_std"), ("k1", "tci_de"), ("k5", "green_grid")):
        if key not in only:
            continue
        report[key] = sweep_de(dev, kernel, parse_alts(args.alt, kernel))
        for shape, times in report[key]["shapes"].items():
            ratios = report[key]["executed_over_useful"][shape]
            print(f"{key.upper()} {shape}, {report[key]['useful_steps'][shape]:.0f} useful "
                  f"steps; one-row warps with a test a step would execute "
                  f"{ratios['one-row warps, a test a step']:.3f} of them "
                  "(ms per launch: single, chained, replayed from a CUDA graph):")
            for lab, (s, c, g) in times.items():
                ratio = ratios.get(lab)
                print(f"  {lab:>14}: {s:.4f} {c:.4f} {g:.4f}"
                      + (f"  executed/useful {ratio:.3f}" if ratio else ""))
        scan = report[key]["max_iter_scan"]
        print(f"{key.upper()} {scan['shape']}, the committed kernel by max_iter "
              "(ms replayed from a CUDA graph, useful steps): "
              + ", ".join(f"{it}: {scan['ms'][it]:.4f}, {scan['useful_steps'][it]:.0f}"
                          for it in SCAN_ITERS))
    if "aberth" in only:
        report["aberth"] = sweep_aberth(dev)
        for label, cloud in report["aberth"]["clouds"].items():
            print(f"aberth {label}: {cloud['polynomials']} polynomials, n {cloud['n'][0]}.."
                  f"{cloud['n'][1]}, steps {cloud['steps'][0]}..{cloud['steps'][1]} (ms per "
                  "launch: single, chained, replayed from a CUDA graph); eigvals_one_launch "
                  f"{cloud['wrapper_ms']['cached']:.4f} ms with the plan cached, "
                  f"{cloud['wrapper_ms']['built']:.4f} built anew:")
            for lab, (s1, c1, g1) in cloud["times"].items():
                print(f"  {lab:>10}: {s1:.4f} {c1:.4f} {g1:.4f}")
    if "green" in only:
        report["green"] = sweep_green(dev, parse_alts(args.alt, "orbit"))
        gr = report["green"]
        print(f"orbit_green, one launch: {gr['points']} points, {gr['escaped']} escape, "
              f"{gr['steps']} steps, the deepest {gr['deepest_steps']} (ms per launch: "
              "single, chained, replayed from a CUDA graph):")
        for lab, (s1, c1, g1) in gr["times"].items():
            print(f"  {lab:>10}: {s1:.4f} {c1:.4f} {g1:.4f}")
    if "orbit" in only:
        report["orbit"] = sweep_orbit(dev, parse_alts(args.alt, "orbit"))
        for entry_name, cases in (("orbit_dwell", report["orbit"]["dwell"]),
                                  ("orbit_de_tci", report["orbit"]["de_tci"]),
                                  ("orbit_de_std", report["orbit"]["de_std"]),
                                  ("orbit_potential", report["orbit"]["potential"]),
                                  ("orbit_de_stage1", report["orbit"]["de_stage1"])):
            for label, case in cases.items():
                extra = (f", {case['late_escapers']} late escapers" if "late_escapers" in case
                         else f", {case['escapers']} escapers" if "escapers" in case
                         else f", deepest lane {case['deepest_steps']}" if "deepest_steps" in case
                         else "")
                if "hypot_calls" in case:
                    extra += (f", deepest lane {case['deepest_steps']} ("
                              f"{case['deepest_two_passes']} with its second pass), "
                              f"{case['hypot_calls']} hypot calls")
                print(f"{entry_name} {label}: {case['useful_steps']:.0f} steps needed, "
                      f"{case['twin_steps']:.0f} the twin's{extra} (ms per launch: single, "
                      "chained, replayed from a CUDA graph; executed/needed):")
                for lab, (s1, c1, g1) in case["times"].items():
                    ratio = case["executed_over_useful"].get(lab)
                    print(f"  {lab:>14}: {s1:.4f} {c1:.4f} {g1:.4f}"
                          + (f"  {ratio:.3f}" if ratio else ""))
    if "sinkhorn" in only:
        report["sinkhorn"] = sweep_sinkhorn(dev, parse_alts(args.alt, "sinkhorn"))
        report["exp_log_sass"] = exp_log_sass()
        print("FP64 SASS instructions:", json.dumps(report["exp_log_sass"]))
        for label, bus in report["sinkhorn"]["buses"].items():
            print(f"sinkhorn, {label} bus, {bus['shape'][0]} x {bus['shape'][1]}, plan "
                  f"{json.dumps(bus['plan'])}; {bus['staged_bytes_a_step']} B staged a step; "
                  f"barrier floor {bus['barrier_floor_ms']:.4f} ms; launch errors "
                  f"{bus['launch_errors']} (ms per call: single, chained):")
            for lab, (s1, c1, _) in bus["times"].items():
                print(f"  {lab:>10}: {s1:.4f} {c1:.4f}")
            print("  split, each half step cut after a part (ms per call, single): "
                  + ", ".join(f"{lab} {s1:.4f}" for lab, (s1, _, _) in bus["split"].items()))
            print("  trace, cycles a half step of thread 0 of CTA 0 (and the SM clock in GHz): "
                  + json.dumps(bus["trace_cycles_a_half_step"]))
    for k in ("k2", "k2p", "k3", "k4", "k1", "k5", "k6", "aberth", "green", "sinkhorn",
              "orbit"):
        for lab, lines in report.get(k, {}).get("ptxas", {}).items():
            print(f"ptxas {k} {lab}: " + " | ".join(lines))
    for key in ("ptxas_vario", "ptxas_stage1"):
        for lab, lines in report.get("orbit", {}).get(key, {}).items():
            print(f"ptxas orbit {key[6:]} {lab}: " + " | ".join(lines))
    for lab, kernels in report.get("orbit", {}).get("sass", {}).items():
        for name, verdict in kernels.items():
            print(f"SASS of {lab}'s {name}: {verdict} in the committed build")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
