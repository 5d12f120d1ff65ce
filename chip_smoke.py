#!/usr/bin/env python3
"""Smoke run of the cmtci_torch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each one checks what it computed; any failure exits non-zero and
prints no result line):
  1. the card (nvidia-smi name and power limit; torch.cuda.is_available());
  2. build every kernel from csrc/ (one nvcc per source, all started
     together; ctypes; aberth.cu, orbit.cu and sinkhorn.cu among them), with each build's
     seconds and ptxas report (a spill fails the run), and the footprints csrc/dwell.cu (both entries),
     dwell_ms.cu, de_std.cu, tci_de.cu and green_grid.cu are built with
     against mandelbrot_cuda.DWELL_FOOTPRINT, DWELL_PERIODIC_FOOTPRINT,
     DWELL_MS_FOOTPRINT, DE_FOOTPRINT, TCI_FOOTPRINT and GREEN_FOOTPRINT;
  3. K1 (csrc/tci_de.cu) against its plain-torch twin on the card at small
     and ragged grids (smaller than a warp's patch, one row and column more
     than a patch and a block) with max_iter 1, C - 1, C, C + 1, 2C - 1, 250,
     500 and 501 for C steps between two exit tests, at the four
     dense-tracker grids on the tracker's domain, and at run_tci's 600 x 600
     and 2400 x 2400 grids on its own domain: identical escape masks, identical
     sets of pixels with d > 0 (counted at each grid) and identical q25 band
     masks, d bitwise equal (or within rtol 1e-6, with the differing pixels
     counted; bitwise at the schedule's cases), and the median time, the
     orbit steps the pixels need in the kernel's two passes (z alone for all,
     z and dz for the late escapers), the steps the kernel's warps execute
     for them and the bound of each;
  4. the dense Appendix-A tracker (bench.py's config) on the kernel path,
     twice: 4 rows of the oracle's sizes, finite metrics, one K1 and one
     aberth launch per stage and no other, rows within the statistical bounds of the oracle
     tests/data/v3_T25_sigma3_dense.csv, and the same rows both times; then
     the adaptive config (t_fixed -1, sigma_bins 1) once on the kernel path;
  5. the f64 plain-torch tracker path on the card for two stages, at the
     contracts of tests/test_tracker_regression.py (rel 2e-3 / 5%), an aberth
     and an orbit_de_tci launch a stage;
  6. K2 (csrc/dwell.cu) against its twin at 2000 x 2000 and 1001 x 1999, and
     at the other grids the bench launches it on (2048 x 2048 on the bench's
     padded domain, 4096 x 4096 and 8192 x 8192), max_iter 500, and at the
     shapes and iteration counts that stress its schedule (2 x 2, 3 x 5,
     ragged widths and heights, max_iter 1, C - 1, C, C + 1, 500 and 20,000
     for C steps between two exit tests): bitwise equal; times, the orbit
     steps the pixels need (interior pixels skip the loop) and the steps the
     kernel's warps execute for them;
  7. run_boundary at the default config (res 2000, max_iter 500) on both
     backends: one K2 launch on "cuda", one orbit_dwell on "torch"; K2 equal to the f64
     dwell on >= 99% of pixels; both contours inside their bounds around the
     golden artifacts/mandel_boundary.csv.gz (symmetric Hausdorff);
  8. K3 (csrc/cloud_green.cu) against its twin on the full default cloud
     (n 2..200, four families, after the host interior short-circuit) in one
     launch of 20000 iterations, on 1, 31, 33, 257 and all points at 1,
     S - 1, S and S + 1 iterations (S steps a speculative chunk), on points
     that leave on the last step of a chunk and on the first of the next, on
     resumed states outside the radius and non-finite inputs, and on a
     launch resumed from another's state rows: every output row bitwise
     equal; green_cloud_f32 staged (stage_iters 4096) equal to the single
     launch; the kernel's time on device-resident inputs, the wrapper's from
     numpy inputs, and the chain bound;
  9. run_equipotential at the CLI defaults with float32 (K3, one launch) and
     float64 (one orbit_green launch over the whole budget; twice, the
     second warm), four aberth launches each: f32 against f64 on the card, and f64 against the
     reference's numbers in tests/data/equipotential_default_f64.json;
 10. K4 (csrc/de_std.cu) and K5 (csrc/green_grid.cu) at small and ragged
     grids and the iteration counts of phase 3 around each one's schedule:
     bitwise equal to their twins; K5 also on a grid whose pixels first
     escape on every position of a chunk, at max_iter equal to such a
     pixel's escape step and one below it, and on deep escapers whose
     2^-(k+1) is the last normal, the first subnormal, the last subnormal and
     0; then K4 and K5 through mandelbrot_field(kind="de" | "green") at
     2048 x 2048 and 1001 x 1999, and K4 at 2048 x 2048 on the bench's padded
     domain (its de_mfu grid), max_iter 500, R 4: K5 bitwise equal to its
     twin, K4 bitwise or within rtol 1e-6 (the differing pixels counted), the
     reference's contracts against the f64 de_field_std /
     escape_potential_grid on the card, one launch each, times, the orbit
     steps the pixels need, the steps each kernel's warps execute for them on
     its footprint, and bounds (K5's also at the 11 operations a step of its
     earlier design);
 11. K6 (csrc/dwell_ms.cu) through dwell_field_ms at 2048 x 2048, max_iter
     500, stride 8, tile (32, 256): one K2 (coarse) and one K6 launch, the
     output bitwise equal to K2's with tiles filled, the fine pass bitwise
     equal to its twin, and so on tiles that blocks straddle (flags drawn
     from a seed); coarse, fill, fine (chained and from a CUDA graph) and
     two-pass times against K2, timed in turns (K2, K6, K6, K2); the fine
     pass's useful and executed steps on its footprint, and its bound at the
     new operations a step beside the earlier design's;
 12. run_tci on the kernel path (de_impl "cuda", one K1 and one aberth
     launch a run) at the
     default 600 x 600 grid and at 2400 x 2400 (BASELINE configs[4]), twice
     each: KL non-increasing, KL_final < 1e-5, Spectral_L2 NaN, and at 2400
     KL_initial within 2% of 17.933 and Hausdorff_before within 10% of 1.725
     (cmtci's f64 values there); layer times of the second run;
 13. run_tci's f64 parity path (de_impl "numpy", one aberth launch) at the
     default config against tests/data/tci_default_numpy.json;
 14. K7 (csrc/fma_peak.cu) at the bench's full size, 16,777,216 elements x
     8192 chained FMAs: every element 0x3F800001 and bitwise equal to the
     plain twin at the same size (16,384 eager launches, timed once); its
     time, the bound and the card's own ceiling from its SM count and maximum
     clock;
 15. K2's periodicity entry (csrc/dwell.cu, dwell_periodic_launch) through
     mandelbrot_field(periodicity=True) at 2000 x 2000 and 1001 x 1999,
     max_iter 500, and at cases around its schedule (exact cycles caught by
     the first checkpoint, the period-3 window at 2000 and 20,000
     iterations, ragged grids, max_iter below a chunk, escapes on the last
     step; cycles caught on every position of a chunk and against the
     checkpoint past the first power of two above C): bitwise equal to
     plain K2 and to its twin; then plain and periodic K2 timed in turns at
     2000 x 2000 at max_iter 500 and 20,000, with the orbit steps each needs
     (the periodic entry's under its own checkpoint schedule) and executes,
     and the bound at the new operations a step beside the earlier design's;
 16. run_variograms at the defaults in f32 (twice) and f64, an aberth, an
     orbit_de_std and an orbit_potential launch a run: the same counts
     both times, each self-variogram's total count equal to the number of
     subsample pairs under rmax, f32 gamma within 1e-3 relative of f64;
 17. the 150,000-point statistics: f32 shell counts against f64 on a
     20,000-point subset (per shell within the pairs that sit on an edge),
     the f32 kNN kernel's neighbour sets against the f64 search on a
     5,000-point subset, and the f32 Hausdorff at 150,000 x 150,000 with its
     peak device memory;
 18. cmtci_torch.bench at full size, its JSON on a line of its own: no
     `_error` key, every ported key present and finite (coupling_s,
     uniformize_green_s and uniformize_fem_s among them), `not_ported`
     empty, no ratio key,
     vpu_peak_tflops no higher than the card's FP32 FMA ceiling,
     dwell_mfu_useful <= dwell_mfu <= 1, and K1, K2, K3, K4 and K7 each
     launched, and aberth, orbit_de_std and orbit_potential;
 19. the file bus at the CLI defaults on the card with plots off (aberth and
     orbit_de_stage1 and sinkhorn launches, nothing else; one stage1 run
     exactly one of each): stage1 (max_n 40, 120 x 80 grid, 200
     iterations, 600 samples,
     Sinkhorn eps 1e-2 for 1000 iterations) written to a temporary bus and
     held to the port's own CPU run of the same call (construct_points within
     1e-12, the band's pixels and mandel_boundary_sample.csv equal,
     matches_indices.csv equal, construct_aligned within 1e-10), with the
     smallest Sinkhorn top-1 to top-2 gap; construct-boundary (alpha 65, 1500
     points) of that bus and curvature (k = 7) against the CPU run (within
     1e-10 of the points, kappa within 1e-10 of itself plus 1e-10 of its
     largest value), against artifacts/construct_boundary.csv.gz (Hausdorff
     <= 1e-4) and against construct_curv_localpoly_summary.txt (n equal;
     mean, std, q95 within 2%); curvature of artifacts/mandel_boundary.csv.gz
     against mandel_curv_localpoly_summary.txt (every value within 1e-8);
     lucas-boundary at the defaults (n 2..100, alpha 4.5, 2000 points) within
     1e-10 of the CPU run. Each subcommand's wall is the best of 3 on the host
     clock ending in a synchronize, beside the Sinkhorn kernel's and the DE
     field's alone;
 20. `cmtci-torch suite` (the seven bus analyses in one process, plots off)
     through cmtci_torch.cli.main at two buses built on the card by the
     port's stage1: the CLI defaults (819 C_aligned, 600 M) and the 6x bus
     (--max-n 100 --boundary-samples 2000: 5,049 C_aligned, all 1,624 band
     pixels), each on the CUDA-session defaults (every stage's f32/device
     path) and with --parity, printing each stage's wall as the best of 2
     warm runs from the suite's JSON line (at the default bus after a
     first, cold run). At the default bus the card's parity run is held to
     the port's CPU run: the summary within 1e-9 and every CSV and text file
     within 1e-9 relative (the spectral CIs within 1e-12: the same host
     draws). At both buses the accel files are held to the parity ones
     (suite_accel_against_parity): the stages without an f32 path equal;
     the f32 multifractal tau within 1e-5 of the same f32 path on the CPU;
     the f32 Lanczos eigenvalues within 4e-3 of eigsh; the symmetry op
     table within 0.02 and the best axis's joint score no lower by more
     than 0.02; the f32 Hausdorff within 1e-6; the coupling trajectory
     within 1e-6, corr_pot within 1e-4, corr_lap within 5e-3. The launches
     are aberth, orbit_de_stage1 and sinkhorn (the buses), orbit_potential
     (U_M) and boxcount (spatial-stats and report); each bus's stage1 is also
     timed alone with its layers, best of 2;
 21. the conformal maps on the card (the clouds' aberth launches only): `uniformize-green`
     at its defaults (n_bdy 2000, 20,000 interior points) on the port's
     export_lucas_boundary defaults, in f64 (the host lstsq fit, f64 map
     evaluations on the card) and f32 (the f32 QR fit, f32 evaluations),
     each timed by stage as the best of 2 warm runs: f64 bdy_mod_median
     within 1 +- 1e-3 and inverse_err_max <= 1e-12, its diagnostics.csv row
     within 1e-9 relative of the port's CPU run of the same config (abs
     1e-12 on inverse_err_* and on the two columns that are 0 by
     construction, g_bdy_in_median and bdy_resid_median); on the interior
     points the f32 map's phase and |f| within 1e-3 of f64 at the 99th
     percentile and f32 bdy_mod_median in (0.99, 1.01). `uniformize-fem`,
     all 4 levels of the v18 study, with the device solver (dense f64
     Cholesky on the card) against SuperLU in the same process: K_median,
     mu_L2, angle_median and the Lucas CR abs_med within rtol 1e-7 and the
     period mismatch within 1e-9 at every level, K_median falling from L0
     to L3; each path's warm wall as the best of 2;
 22. multi-device on torch.distributed, doctor and the traces, one after
     another: the dense tracker (field_dtype float32, de_impl torch) on the
     single device and on a one-rank NCCL mesh, the rows bitwise equal, an
     aberth and an orbit_de_tci launch a stage;
     `tracker --devices 2` refused on the one card ("needs 2 devices");
     `doctor --smoke` with no *_error field, 2 K2 launches and the twin's
     checksum; `tracker --trace-dir` writing a torch.profiler trace a stage
     with K1's kernel in it; last, a two-rank gloo group with both ranks on
     cuda:0 (NCCL refuses two ranks on one card; gloo stages through host
     memory) running each sharded head at its pipeline's size, held to the
     port's single-device function on the card: compute_dwell at res 2000
     in f64 and on K2 (each rank launching K2's row entry) and the TCI DE
     field at 912² in f64 and f32 bitwise, the matcher at 37,820 x 37,820
     and the mollified histogram at 512 bins bitwise, the shell counts of
     the default bus bitwise, its point variogram's counts exact and gamma
     within 1e-12, the Green cloud of n = 2..20 in f64 with k equal and g
     within 1e-10 and on K3 (a launch a rank) bitwise; no rank holds jax;
 23. the reference's compiled device loops: aberth.cu (one launch a cloud,
     a polynomial of more lanes than a CTA has threads split over a cluster
     of ABERTH_CLUSTER CTAs) against its eager twin on the card at every
     cloud the pipelines build (the tracker's four stages, the fourth the
     bench's eigensweep and the first run_tci's; the equipotential's four
     families at n 2..200; stage1; lucas-boundary): every valid root within
     1e-12 relative, the parked lanes equal, the step counts within one, and
     bitwise aberth.cu built with CLUSTER 1 (one CTA a polynomial, the design
     before the cluster; built in phase 2), with the kernel's time (the
     launch alone from the start roots, and the CLUSTER 1 build's), the
     wrapper's with the plan cached and built anew, the twin's and the bound
     over the card, over the one SM of the largest polynomial and over its
     cluster; torch.linalg.eigvals on the eigensweep's companion matrices
     beside it; last in the phase, after all its timings, at degree 4,843,
     one above what one CTA held before the cluster, against the twin run on
     the host;
     each orbit.cu entry bitwise its twin (NaN equal to NaN; one launch) at
     its pipeline's size (the f64 dwell at 2000 x 2000 and 500 steps, the TCI
     DE at the tracker's grids in f64 and f32 and at 912 x 912 on run_tci's
     domain, the standard DE on the variograms' 700 x 700 grid at 600 steps in
     f64 and f32, stage1's 80 x 120 band field at 200 steps, the first and a
     resumed Green stage on the equipotential's default cloud, the one
     launch over its whole budget (green_potential_compacted with one stage,
     80,395 points x 20,000 steps) against the compacted loop on the twin and on the
     kernel's stages, with the chain bound of its deepest points, and U_M on
     coupling's and the variograms' grids in each normalization), at max_iter
     1 and on ragged grids in f64 and f32, with times and bounds; orbit_dwell
     and orbit_de_tci (redesigned: the f64 analytic interior skipped,
     branch-free chunks on warp patches of the (ny, nx) grid, de_tci's dz
     only for the late escapers) also on a row slice, one row as a 1-D
     input and a 1000 x 1000 f64 grid over the cardioid-bulb junction at
     2,000 steps, orbit_de_tci's loop state bitwise its contract against
     the twin's (mandelbrot._de_tci_contract: finite dz at the same
     escapers) with its second passes, counted on the card, as many as the
     twin's late escapers, each with the bound on the steps the redesign
     needs, the FP64 instruction floor, and the earlier count's bound and
     floor beside them; orbit_de_std and orbit_potential (redesigned: the
     f64 analytic interior skipped, first_escape's chunks on warp patches,
     de_std's sqrt as a squared threshold and its dz only for the escapers,
     the potential's skip only under two_pow_n and k_plus_1) also on a
     14 x 14 grid of special values (NaN, +-inf, huge) and on the junction
     at 2,000 steps, de_std on all its outputs, the potential's g in all
     three normalizations and its loop state, with and without the skip,
     bitwise its contract (mandelbrot._potential_contract: lz NaN at the
     skipped interior points) on both U_M grids, the junction, the ragged
     grids and the special values, with the bound and floor on the steps
     the redesign needs, the earlier count's beside them, and the
     potential's chain bound; orbit_de_stage1 (redesigned: its hypot test
     through a band around R^2, hypot only inside it, the f64 interior
     skipped for R >= 2, first_escape's chunks on warp patches) at stage1's
     80 x 120 in f64 and f32, on the ragged grids, the special values at 1,
     7 and 200 steps, R 1e-200 and 1e300 (the fallback band: hypot every
     step) on the special values and a 37 x 61 grid and the junction at
     2,000 steps, its loop state bitwise the twin's and its calls of hypot,
     counted on the card, as many as bench.orbit_de_stage1_hypot_calls
     counts, with the same bounds and its chain bound;
     csrc/sinkhorn.cu (one cooperative launch a call) torch.equal its twin
     sinkhorn_log_torch at stage1's cost at the CLI defaults (819 x 600) on its
     own plan (resident, one CTA an SM), on 97 and 66 CTAs, each also forced
     to stream, at 0, 1, 3 and 1,000 steps, and at the 6x bus's cost (5,049 x
     1,624, streaming), argmax equal, and at ragged costs (lines shorter than
     a warp, shorter and longer than a CTA, more CTAs than lines) on six
     grids at 0, 1 and 3 steps; the kernel's time beside the recorded one of
     the earlier two-pass design (commit faa791d), the bytes its ring stages
     from HBM a step, the split of a half step
     (builds cut after each part, in turns with the whole), the twin's time,
     the graph yardstick's (the torch.logsumexp loop the port ran before the
     kernel, captured into a CUDA graph, within 1e-10 of the twin, argmax
     equal) and the barrier floor (the grid barriers alone,
     sweep_schedules.barrier_floor_ms);
 24. csrc/boxcount.cu (the box counts of fractal_dimensions, one launch for
     every cloud and scale) against its twin box_counts_torch on the card:
     counts and bitmaps bitwise, in one launch, on the pair cell's
     149,877-point Lucas construct C (n 2..547, aberth.cu; its real roots on
     the finest scale's box edge), a 150,000-point band M (escape counts
     8 <= k < 500 of the 2000 x 2000 f64 grid of the boundary's domain,
     jittered) and points on box edges (mins + k * step), at the default
     scales (bitmaps in shared memory) and at 12 scales down to 1e-3 (atomics
     in device memory); the counts of C and M also against numpy's np.unique
     rows, the reference's lines; run_spatial_stats on C and M as the pair
     cell runs it: one boxcount launch, the counter
     spatial_stats.box_scales_card 20, the dimensions the twin's; the
     kernel's time (a CUDA graph of the bitmaps' zeroing and the launch)
     against its bound by bytes, and the wrapper's from numpy clouds.
`python3 chip_smoke.py --cards N` on a machine with N cards runs only the
multi-card check (phase_cards): phase 22's sharded heads, each called twice,
on an N-rank NCCL group, one card a rank, against the single device, each
head's warm time on N cards beside its warm time on one, and `tracker
--devices N` against the single-device tracker.

The kernels line gives, per kernel, its launches on its path (for the new
entries one run of the path MAIN_PATH names, their times and bound at the
largest shape that run gives them, named in `shape`), max |kernel - twin|,
kernel and twin ms, and bound_ms: the larger of the FP32 operations
(the orbit steps these inputs need times the operations per step of the .cu
body; for K1 the z-only steps of all pixels and the z and dz steps of the late
escapers, each at its own count; for K7 two per FMA) over 67 TFLOP/s and the
bytes (inputs read once, outputs written once) over 3.35 TB/s, the H100 SXM's
published peaks at 700 W. K3's operations are dependent ones: a lane's orbit
is a serial chain, so its bound is the longest lane's steps x 3 dependent FP32
instructions x the measured latency between dependent instructions at the
card's maximum SM clock, far above the other two; its bound_by stays
"operations" and bound_detail says so. A kernel's ms is the median time per
launch of CHAIN launches back to back (K7, a kernel of milliseconds: of one
launch); K3's is taken on inputs resident on the card. For K1, K4 and K5 ms is
the time of the same launches replayed from a CUDA graph, which the host's
time to start a launch cannot enter (K1 at the tracker's grids is shorter than
that time), and chained_ms the time of the launches started one by one; K6
and K2's periodic entry keep the chained time as ms and give graph_ms. No
single PyTorch call computes an escape-time field or a chain of dependent
FMAs, so library_ms is null. The new entries: orbit.cu's bound is its
loop's operations (ORBIT_OPS_PER_STEP on the steps these points need) over
the H100's 33.5 TFLOP/s FP64 (67 for f32) or its bytes, floor_ms the same
operations over the FP64 (FP32) instruction rate, SMs x FP64_LANES
(FP32_LANES) x the maximum SM clock, each operation one instruction under
-fmad=false; for orbit_dwell, orbit_de_tci, orbit_de_std, orbit_de_stage1
and orbit_potential the operations are those the redesign needs (ops_needed:
CARRIED_STEP_OPS a step outside the f64 interior, up to the escape and, for
de_tci, on to a non-finite z; LATE_STEP_OPS a (z, dz) step of de_tci's late
escapers' second pass, STD_SECOND_STEP_OPS one of de_std's escapers',
STD_CARRIED_DZ_STEP_OPS a step of de_std's or de_stage1's first pass where
it carries dz), with
bound_before_ms and floor_before_ms on the earlier count (every step a
point needs, or for de_tci ran, at ORBIT_OPS_PER_STEP); orbit_potential's
coupling_u_m holds the same numbers for coupling's U_M; max_abs_err the
largest |kernel - twin| over the entries finite in both, in every case phase
23 holds (the check itself is bitwise, NaN equal to NaN, whose positions the
line counts); aberth's bound is the f32 repulsion of the lanes not yet frozen
(ABERTH_OPS_PER_PAIR a pair term) over the whole card, with bound_one_sm_ms
that of the largest polynomial on one SM and bound_cluster_ms on the SMs of
its cluster, tracker_ms its four tracker launches summed and cluster1_ms
the launch with one CTA a polynomial, its max_abs_err the largest
|kernel - twin| of a root, and its library_ms torch.linalg.eigvals on the
eigensweep's 61 companion matrices, one call each, summed. orbit_green's,
orbit_potential's and orbit_de_stage1's bound_chain_ms is the deepest
point's steps x 3 dependent f64 instructions x FP64_DEPENDENT_CYCLES at the
card's maximum SM clock; orbit_de_stage1's hypot_calls its calls of hypot
there (the band's). sinkhorn's line is
the CLI defaults' (819 x 600, resident; bus_6x holds the 6x bus's): ms the
median of 5 single calls, plain_ms the twin's one call, graph_ms the graph
yardstick's replay; its operations count a term's add, max, add,
subtraction, exp and sum, each line's log, and the plan's exps, the exp and
log at their FP64 instructions in the SASS of one each
(sweep_schedules.exp_log_sass; bound_ops_4_ms at the 4 an element counted
before), over 33.5 TFLOP/s; its bytes the cost in and the plan out
(bound_streaming_ms: mk and mkT from HBM every step); barrier_floor_ms the
2,000 grid barriers alone.

The kernels line reports K1 at the tracker's largest grid, 912 x 912; the
other grids' times are printed in phase 3; K2's launches are those of the
boundary run (phase 7) and of doctor --smoke (phase 22, 2), and K7's those
of the bench run (phase 18). The last
three lines are the card, a JSON line of the kernels, and {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(ROOT, "tests", "data", "v3_T25_sigma3_dense.csv")
GOLDEN = os.path.join(ROOT, "artifacts", "mandel_boundary.csv.gz")
EQUIP_REF = os.path.join(ROOT, "tests", "data", "equipotential_default_f64.json")
TCI_REF = os.path.join(ROOT, "tests", "data", "tci_default_numpy.json")
CONSTRUCT_GOLDEN = os.path.join(ROOT, "artifacts", "construct_boundary.csv.gz")
CONSTRUCT_SUMMARY = os.path.join(ROOT, "artifacts", "construct_curv_localpoly_summary.txt")
MANDEL_SUMMARY = os.path.join(ROOT, "artifacts", "mandel_curv_localpoly_summary.txt")
#: the libraries to build, one csrc/<name>.cu each
KERNELS = ("tci_de", "dwell", "cloud_green", "de_std", "green_grid", "dwell_ms", "fma_peak",
           "aberth", "orbit", "sinkhorn", "boxcount")
#: the entry points of csrc/orbit.cu, in the order of the kernels line
ORBIT_ENTRIES = ("orbit_dwell", "orbit_de_tci", "orbit_de_std", "orbit_de_stage1",
                 "orbit_green", "orbit_potential")
#: operations a step of each orbit.cu loop in the loop's dtype, each mul,
#: add, sub, compare and sqrt counted once (-fmad=false keeps them apart):
#: z^2 + c 4 mul 4 add/sub; |z|^2 > r^2 2 mul 1 add 1 compare; the dz step 6
#: mul 3 add/sub; sqrt(|z|^2) > R one more; orbit_de_stage1 what its
#: redesigned step executes, a (dz, z) step on the carried squares with the
#: band's flag: dz 6 mul 3 add/sub, z 3 mul 4 add/sub, |z|^2 1 add, 1 compare (the
#: hypot, counted as 2 before, runs only inside the band)
ORBIT_OPS_PER_STEP = {"orbit_dwell": 12, "orbit_de_tci": 22, "orbit_de_std": 22,
                      "orbit_de_stage1": 18, "orbit_green": 12, "orbit_potential": 12}
#: operations (instructions) a step of the redesigned orbit_dwell and
#: orbit_de_tci: a carried step with its radius test (3 mul, 5 add/sub, 1
#: compare), and the late escapers' (z, dz) step, which tests nothing (dz 6
#: mul 3 add/sub, z 4 mul 4 add/sub)
CARRIED_STEP_OPS, LATE_STEP_OPS = 9, 17
#: operations a step of orbit_de_std's second pass, the escapers' (dz, z)
#: body without a test: dz 6 mul 3 add/sub, z as a carried step 3 mul 4
#: add/sub; and a first-pass step that carries dz, with its test (dz's 9
#: and a carried step's 9)
STD_SECOND_STEP_OPS, STD_CARRIED_DZ_STEP_OPS = 16, 18
#: FP64 and FP32 instructions an SM issues a clock outside the tensor cores:
#: with -fmad=false every operation is one, so the orbit loops' instruction
#: floor is their operations over SMs x these x the maximum SM clock (FP64:
#: about 16.7e12 a second, half the 33.5 TFLOP/s that counts an FMA as two)
FP64_LANES, FP32_LANES = 64, 128
#: the cardioid-bulb junction, where the f64 mask's rim meets the parabolic
#: point c = -3/4; phase 23 holds orbit_dwell and orbit_de_tci there at
#: 1000 x 1000 and 2,000 steps
JUNCTION = (-0.80, -0.70, -0.05, 0.05)
#: f32 operations a pair term of aberth.cu's repulsion: 2 sub, 2 mul and an add
#: for |z_i - z_j|^2, a compare, the reciprocal, 2 mul and 2 add into the sums
ABERTH_OPS_PER_PAIR = 11
PEAK_FP64 = 33.5e12  # H100 SXM FP64 outside the tensor cores, published, at 700 W
ABERTH_RTOL = 1e-12
#: the pipelines' clouds: (label, family, degrees); the tracker's fourth stage
#: is the bench's eigensweep, its first run_tci's cloud
ABERTH_CLOUDS = ([(f"tracker stage {i + 1}", "lucas_all_ones", list(range(20, top + 1, 20)))
                  for i, top in enumerate((300, 480, 760, 1220))]
                 + [(f"equipotential {f}", f, list(range(2, 201)))
                    for f in ("lucas_all_ones", "pell_like_all_twos",
                              "sparser_gap_1_0_1_then_ones", "padovan_like_0_1_then_ones")]
                 + [("stage1", "lucas_all_ones", list(range(2, 41))),
                    ("lucas-boundary", "lucas_all_ones", list(range(2, 101)))])


#: the entry points of the kernels line, and the source of one named otherwise
ENTRIES = KERNELS[:-4] + ("dwell_periodic", "aberth") + ORBIT_ENTRIES + ("sinkhorn",
                                                                            "boxcount")
SOURCE = {"dwell_periodic": "dwell", **{name: "orbit" for name in ORBIT_ENTRIES}}
#: the TPU kernel, or the reference's compiled device loop, each entry replaces
REPLACES = {
    "tci_de": "cmtci/kernels/mandelbrot_pallas.py:276",
    "dwell": "cmtci/kernels/mandelbrot_pallas.py:59",
    "cloud_green": "cmtci/kernels/mandelbrot_pallas.py:613",
    "de_std": "cmtci/kernels/mandelbrot_pallas.py:198",
    "green_grid": "cmtci/kernels/mandelbrot_pallas.py:156",
    "dwell_ms": "cmtci/kernels/mandelbrot_pallas.py:816",
    "fma_peak": "bench.py:238",
    "dwell_periodic": "cmtci/kernels/mandelbrot_pallas.py:94",
    "aberth": "cmtci/kernels/companion.py:437",
    "orbit_dwell": "cmtci/kernels/mandelbrot.py:83",
    "orbit_de_tci": "cmtci/kernels/mandelbrot.py:115",
    "orbit_de_std": "cmtci/kernels/mandelbrot.py:163",
    "orbit_de_stage1": "cmtci/kernels/mandelbrot.py:326",
    "orbit_green": "cmtci/kernels/mandelbrot.py:204",
    "orbit_potential": "cmtci/kernels/mandelbrot.py:380",
    "sinkhorn": "cmtci/transport/sinkhorn.py:148",
    "boxcount": "cmtci/stats/pointstats.py:197",  # host np.unique rows; no TPU kernel
}
#: the run (a label of launched()) whose launches the kernels line gives for
#: each new entry: its main path
MAIN_PATH = {"aberth": "tracker (dense, second run)", "orbit_dwell": "boundary torch",
             "orbit_de_tci": "f64 tracker", "orbit_de_std": "run_variograms f64",
             "orbit_de_stage1": "stage1, one run", "orbit_green": "equipotential float64",
             "orbit_potential": "run_variograms f64",
             "sinkhorn": "stage1, one run", "boxcount": "run_spatial_stats"}
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM, published, at 700 W
#: FP32 operations a step of the loops K6, K2's periodic entry and K5 ran
#: before their redesign (one pixel a thread on one-row warps, a compare and
#: a break in every step; the periodic check two compares more), beside which
#: the new bounds are printed
OPS_BEFORE = {"dwell_ms": 11, "dwell_periodic": 13, "green_grid": 11}
#: launches back to back in one timing of a kernel (cuda_ms)
CHAIN = 20
#: cycles between two dependent FP32 instructions of one warp, measured on an
#: H100 80GB HBM3 by `python -m cmtci_torch.sweep_schedules` (4.05 at 1.92 and
#: at 1.97 GHz); K3's chain bound is worked out from it
FP32_DEPENDENT_CYCLES = 4.05
#: the same for FP64 (DMUL -> DADD), measured by `sweep_schedules --only
#: probe` on an H100 80GB HBM3 at 700 W (8.02 at 1.96 GHz); orbit_green's chain
#: bound is worked out from it
FP64_DEPENDENT_CYCLES = 8.02
#: a Horner polynomial one degree above the largest one CTA held before the
#: cluster (40 B a lane and 8 a coefficient in 232,448 B: 4,842)
ABERTH_ABOVE_ONE_CTA = 4843
#: aberth.cu's constants rewritten for phase 23's yardstick: one CTA a
#: polynomial, the design before the cluster (a sweep_schedules variant,
#: built in phase 2 into build/sweep/smoke-aberth-c1/)
ABERTH_C1 = {"CLUSTER": 1}
ABERTH_C1_LIB: list = []
#: sinkhorn.cu built to stop every half step after a part (STOP 0 to 3,
#: sweep_schedules.SINKHORN_STOPS), built in phase 2 into
#: build/sweep/smoke-sinkhorn-stop<k>/: phase 23's split of a half step
SINKHORN_STOP_LIBS: dict = {}
FIELD_SHAPES = ((2048, 2048), (1001, 1999))  # (ny, nx)
MS_SHAPE, MS_STRIDE, MS_TILE = (2048, 2048), 8, (32, 256)
TCI_GRIDS = (600, 2400)
TCI_4X = {"KL_initial": (17.933, 0.02), "Hausdorff_before": (1.725, 0.10)}
DOMAIN = (-2.2, 1.2, -1.6, 1.6)
GRIDS = (600, 690, 793, 912)
MAX_ITER, ESCAPE_R = 250, 250.0
DENSE = dict(sigma_bins=3.0, t_fixed=25, bins_start=64, bins_max=512,
             construct_max_start=300, construct_max_growth=1.6,
             mandelbrot_samples_growth=1.6, mandelbrot_samples_max=300000)
ADAPTIVE = dict(sigma_bins=1.0, t_fixed=-1, bins_start=64, bins_max=512)
CHECK_KEYS = ("kl_initial", "delta_n", "kl_PM_PC", "tv_XT_PM", "tv_PC_PM",
              "overlap_mass_PC_PM", "tv_bound_PC_PM", "compound")
METRIC_KEYS = ("kl_initial", "delta_n", "kl_PM_PC", "pinsker_tv_bound_XT_PM", "tv_XT_PM",
               "tv_PC_PM", "overlap_mass_PC_PM", "tv_bound_PC_PM", "compound",
               "compound_with_pinsker")
BOUNDARY_DOMAIN = (-2.1, 0.9, -1.5, 1.5)
DWELL_SHAPES = ((2000, 2000), (1001, 1999))  # (ny, nx)
GOLDEN_VERTICES = 14391
SPACING = 3.0 / 1999
SUMMARY_KEYS = ("count", "escaped", "escaped_frac", "g_median", "g_mean", "g_std",
                "g_p10", "g_p90")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"nvidia-smi failed (rc {proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, reps: int, chain: int = 1, graph: bool = False) -> float:
    """Median device time of fn() in ms over `reps` timings, each between two
    CUDA events around `chain` calls back to back, divided by `chain`. With
    chain 1 the events also enclose the host's time to issue the one launch,
    which is most of the reading for a kernel of a few hundredths of a ms;
    CHAIN calls keep the card busy, so the reading is the kernel's, as long as
    the kernel outlasts the host's 10 to 25 microseconds a launch. graph
    captures the `chain` calls once into a CUDA graph and times its replays:
    the host does nothing between the launches, so a shorter kernel reads
    its own time too."""
    import torch

    for _ in range(warmup):
        fn()

    def back_to_back():
        for _ in range(chain):
            fn()

    run = back_to_back
    if graph:
        torch.cuda.synchronize()
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            back_to_back()
        captured.replay()
        run = captured.replay
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / chain)
    return statistics.median(times)


def reset_launches():
    from cmtci_torch.kernels import _launch

    _launch.reset_launches()


#: the launches each launched() call saw, by its label
LAUNCHED: dict = {}


def launched(label: str, want: dict) -> dict:
    """The kernel launches since reset_launches(), held to `want` (entry ->
    count, or None for at least one); an entry `want` does not name must not
    have launched. Returns the entries that launched, with their counts, and
    keeps them in LAUNCHED[label]."""
    from cmtci_torch.kernels import _launch

    got = {k: v for k, v in _launch.launches.items() if v}
    LAUNCHED[label] = got
    for k, v in want.items():
        check(got.get(k, 0) >= 1 if v is None else got.get(k, 0) == v,
              f"{label}: launches {got}, expected {want}")
    check(set(got) <= set(want), f"{label}: launches {got}, expected only {want}")
    return got


def bound_ms(name: str, steps: int, nbytes: int):
    """(ms, "operations" | "bytes"): the least time the card could take for
    `steps` orbit steps of kernel `name` (mandelbrot_cuda.OPS_PER_STEP FP32
    operations each) and `nbytes` of traffic."""
    from cmtci_torch.kernels.mandelbrot_cuda import OPS_PER_STEP

    return least_ms(steps * OPS_PER_STEP[name], nbytes)


def least_ms(ops: float, nbytes: int):
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dwell_steps(dwell, interior, max_iter: int) -> int:
    """K2's loop trips from its output: dwell + 1 for an escaping pixel,
    max_iter for a bounded one, none for an interior one."""
    import torch

    return int(torch.where(interior, 0.0, (dwell + 1.0).clamp(max=max_iter))
               .sum(dtype=torch.float64))


def hausdorff(a, b) -> float:
    from scipy.spatial.distance import directed_hausdorff

    return max(directed_hausdorff(a, b)[0], directed_hausdorff(b, a)[0])


def phase_build():
    """Phase 2: one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from cmtci_torch.kernels import _build

    from cmtci_torch import sweep_schedules as sweep

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1 + len(sweep.SINKHORN_STOPS)) as ex:
        c1 = ex.submit(sweep.build, "smoke-aberth-c1", "aberth", _build.CSRC, ABERTH_C1)
        stops = {k: ex.submit(sweep.build, f"smoke-sinkhorn-stop{k}", "sinkhorn", _build.CSRC,
                              {"STOP": k}) for k in sweep.SINKHORN_STOPS}
        list(ex.map(_build.library, KERNELS))
        ABERTH_C1_LIB.append(c1.result()[0])
        SINKHORN_STOP_LIBS.update({f"stop{k}": f.result()[0] for k, f in stops.items()})
    print(f"build: {', '.join(KERNELS)}, aberth with CLUSTER 1 and sinkhorn cut after each "
          f"part (STOP {', '.join(map(str, sweep.SINKHORN_STOPS))}) in "
          f"{time.perf_counter() - t0:.2f} s wall")
    for name in KERNELS:
        print(f"  {name}: nvcc {_build.BUILD_SECONDS[name]:.2f} s")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")
            if "spill" in line:
                check("0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{name}: ptxas reports a spill: {line.strip()}")
    from cmtci_torch.kernels import mandelbrot_cuda as mc

    for name, (lib, _) in mc.FOOTPRINT_ENTRY.items():
        built, want = mc.footprint_built(name), getattr(mc, name)
        print(f"  {lib}.cu is built with the footprint {built}")
        check(built == want, f"{lib}.cu reports {built}, mandelbrot_cuda.{name} is {want}")


def schedule_iters(c: int):
    """Iteration counts around a schedule of `c` steps between two exit
    tests: below, at and above a chunk, one short of two chunks, the
    pipelines' 250 and 500, and 501."""
    return sorted({1, max(c - 1, 1), c, c + 1, 2 * c - 1, 250, 500, 501})


def tci_edge_cases(c: int):
    """(grid_n, max_iter) beyond the pipelines' grids, for K1's schedule:
    grids smaller than a patch, one row and column more than a patch's width,
    its height and a block's width, and no multiple of any of them."""
    return [(n, it) for n in (2, 5, 9, 17, 37, 130) for it in schedule_iters(c)]


def de_edge_cases(c: int):
    """(ny, nx, max_iter) beyond the field shapes, for the schedules of K4
    and K5, as tci_edge_cases on grids that need not be square."""
    grids = [(2, 2), (3, 5), (9, 5), (8, 17), (13, 37), (257, 33), (130, 1003)]
    return [(ny, nx, it) for ny, nx in grids for it in schedule_iters(c)]


def tci_against_twin(label, dom, g, max_iter, escape_r, dev):
    """K1 on the card against its twin on one grid: the shape, finite output,
    equal escape masks, equal sets of pixels with d > 0 (the late escapers
    that decide the band), d bitwise equal or within rtol 1e-6 with the
    differing pixels counted. Returns (kernel output, twin output, differing
    pixels, max |kernel - twin|, pixels with d > 0)."""
    import torch

    from cmtci_torch.kernels import mandelbrot_cuda as mc

    out_k = mc._tci_field(dom, g, max_iter, escape_r, dev)
    out_t = mc.tci_de_field_torch(dom, g, max_iter, escape_r, device=dev)
    torch.cuda.synchronize()
    check(out_k.shape == out_t.shape == (g, g), f"{label}: shape {tuple(out_k.shape)}")
    check(bool(torch.isfinite(out_k).all()), f"{label}: non-finite kernel output")
    esc_k, esc_t = out_k >= 0, out_t >= 0
    check(bool(torch.equal(esc_k, esc_t)),
          f"{label}: escape masks differ at {int((esc_k != esc_t).sum())} pixels")
    pos_k, pos_t = out_k > 0, out_t > 0
    check(bool(torch.equal(pos_k, pos_t)),
          f"{label}: the pixels with d > 0 differ at {int((pos_k != pos_t).sum())} pixels")
    n_diff = int((out_k != out_t).sum())
    if n_diff:
        close = torch.isclose(out_k, out_t, rtol=1e-6, atol=0.0)
        check(bool(close.all()), f"{label}: d differs beyond rtol 1e-6 at "
                                 f"{int((~close).sum())} pixels")
    return out_k, out_t, n_diff, float((out_k - out_t).abs().max()), int(pos_k.sum())


def phase_kernels(dev):
    """Phase 3: K1 against its twin on the card at the grids and iteration
    counts that stress its schedule, at the tracker's stage grids and at
    run_tci's grids, each on its pipeline's domain."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import mandelbrot_cuda as mc
    from cmtci_torch.pipelines.analysis import TCIConfig

    foot = mc.TCI_FOOTPRINT
    edge = tci_edge_cases(foot["c"])
    max_err = 0.0
    positive = []
    for g, max_iter in edge:
        _, _, n_diff, err, n_pos = tci_against_twin(f"K1 grid {g}, max_iter {max_iter}", DOMAIN,
                                                    g, max_iter, ESCAPE_R, dev)
        check(n_diff == 0, f"K1 grid {g}, max_iter {max_iter}: {n_diff} pixels differ from "
                           "the twin")
        max_err = max(max_err, err)
        positive.append(n_pos)
    print(f"K1 schedule cases (footprint {foot}): {len(edge)} grids and iteration counts, "
          + ", ".join(f"{g}@{it}: {n} px with d > 0" for (g, it), n in zip(edge, positive))
          + "; 0 differing pixels each, the d > 0 sets equal")

    tci = TCIConfig()
    cases = ([("tracker", DOMAIN, g, MAX_ITER, ESCAPE_R) for g in GRIDS]
             + [("tci", tci.domain, g, tci.max_iter, tci.escape_r) for g in TCI_GRIDS])
    timing = {}
    for path, dom, g, max_iter, escape_r in cases:
        out_k, out_t, n_diff, err, n_pos = tci_against_twin(f"{path} grid {g}", dom, g, max_iter,
                                                            escape_r, dev)
        max_err = max(max_err, err)
        esc_k, esc_t = out_k >= 0, out_t >= 0
        sel_k, cnt_k, q_k = mc.band_selection(esc_k, out_k.clamp(min=0.0))
        sel_t, cnt_t, q_t = mc.band_selection(esc_t, out_t.clamp(min=0.0))
        check(bool(torch.equal(sel_k, sel_t)), f"{path} grid {g}: band masks differ")
        ms = cuda_ms(lambda: mc._tci_field(dom, g, max_iter, escape_r, dev), 3, 20, CHAIN)
        graph_ms = cuda_ms(lambda: mc._tci_field(dom, g, max_iter, escape_r, dev), 3, 20, CHAIN,
                           graph=True)
        plain_ms = cuda_ms(lambda: mc.tci_de_field_torch(dom, g, max_iter, escape_r,
                                                         device=dev), 1, 3)
        first, second = bench.tci_lane_steps(*mc._grid_coords(dom, g, g, dev), max_iter,
                                             float(escape_r * escape_r))
        steps = [int(lane.sum(dtype=torch.int64)) for lane in (first, second)]
        executed = (bench.warp_executed_steps(first, foot, max_iter)
                    + bench.warp_executed_steps(second, dict(foot, c=1)))
        bound, by = least_ms(steps[0] * mc.OPS_PER_STEP["tci_de"]
                             + steps[1] * mc.OPS_PER_STEP["tci_de_late"], 4 * g * g)
        timing[(path, g)] = (ms, plain_ms, bound, by, graph_ms)
        print(f"K1 {path} grid {g}: escaped {int(cnt_k)}/{g * g}, d > 0 at {n_pos} pixels, "
              f"band {int(sel_k.sum())}, "
              f"q25 {float(q_k)!r}, d bitwise-differing pixels {n_diff}, "
              f"max|kernel-twin| {err!r}; kernel {ms:.4f} ms (median per launch, {CHAIN} back "
              f"to back; {graph_ms:.4f} ms replayed from a CUDA graph), twin {plain_ms:.4f} ms "
              f"(median, CUDA events); {steps[0]} z-only "
              f"orbit steps, {steps[1]} (z, dz) steps of the {int((second > 0).sum())} late "
              f"escapers, executed by the kernel's warps {int(executed)} (executed / useful "
              f"{executed / sum(steps):.4f}), bound {bound:.5f} ms ({by})")
    return max_err, timing


def run_kernel_tracker(dev, label, config):
    """One kernel-path tracker run; returns (rows, meta, wall, K1 launches):
    one K1 and one aberth launch a stage, nothing else."""
    import torch

    from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker

    cfg = TrackerConfig(**config, field_dtype="float32", de_impl="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rows, meta = run_tracker(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launched(f"tracker ({label})", {"tci_de": None, "aberth": len(rows)})
    print(f"tracker ({label}): {len(rows)} rows in {wall:.3f} s wall, "
          f"{launches['tci_de']} K1 and {launches['aberth']} aberth launches")
    return rows, meta, wall, launches["tci_de"]


def phase_tracker(dev, oracle):
    """Phase 4: the dense tracker on the kernel path, checked twice; then the
    adaptive config once."""
    import dataclasses

    results = [run_kernel_tracker(dev, "dense, first run", DENSE),
               run_kernel_tracker(dev, "dense, second run", DENSE)]
    for rows, meta, wall, launches in results:
        check(len(rows) == 4, f"expected 4 rows, got {len(rows)}")
        check([r.n_construct_pts for r in rows] == [2400, 6000, 14820, 37820],
              f"n_construct_pts {[r.n_construct_pts for r in rows]}")
        check(launches == 4, f"expected 4 K1 launches, got {launches}")
        for r in rows:
            for k in METRIC_KEYS:
                check(math.isfinite(getattr(r, k)), f"bins {r.bins}: {k} not finite")
    strip = [[{**dataclasses.asdict(r), "runtime_sec": 0.0} for r in res[0]]
             for res in results]
    check(strip[0] == strip[1], "the two kernel-path runs gave different rows")
    rows, meta, wall, launches = results[1]
    for r, ref in zip(rows, oracle):
        ratios = {k: getattr(r, k) / float(ref[k])
                  for k in ("delta_n", "tv_PC_PM", "overlap_mass_PC_PM")}
        print(f"  bins {r.bins}: grid {r.mandelbrot_grid}, n_mandel {r.n_mandel_pts}, "
              f"delta_n {r.delta_n!r} (x{ratios['delta_n']:.4f} oracle), "
              f"tv_PC_PM {r.tv_PC_PM!r} (x{ratios['tv_PC_PM']:.4f}), "
              f"overlap {r.overlap_mass_PC_PM!r} (x{ratios['overlap_mass_PC_PM']:.4f})")
        check(abs(ratios["delta_n"] - 1.0) <= 0.50, f"bins {r.bins}: delta_n off the oracle")
        check(abs(ratios["tv_PC_PM"] - 1.0) <= 0.25, f"bins {r.bins}: tv_PC_PM off the oracle")
        check(abs(ratios["overlap_mass_PC_PM"] - 1.0) <= 0.25,
              f"bins {r.bins}: overlap off the oracle")
    times = meta["stage_times"]
    for b in (64, 128, 256, 512):
        parts = {p: times.get(f"bins{b}_{p}", 0.0)
                 for p in ("cloud", "sample", "match", "hist", "giflow")}
        print(f"  stage bins {b} (second run, s): "
              + ", ".join(f"{p} {t:.4f}" for p, t in parts.items()))

    # the adaptive config (v3_adaptive's): T_n is not pinned, because the
    # kernel path's sampler is a new realization (ROADMAP Queue 3)
    a_rows, _, a_wall, a_launches = run_kernel_tracker(dev, "adaptive", ADAPTIVE)
    check(len(a_rows) == 4, f"adaptive: expected 4 rows, got {len(a_rows)}")
    check(a_launches == 4, f"adaptive: expected 4 K1 launches, got {a_launches}")
    for r in a_rows:
        check(r.stop_reason == "kl_threshold_met",
              f"adaptive bins {r.bins}: stop_reason {r.stop_reason!r}")
        for k in METRIC_KEYS:
            check(math.isfinite(getattr(r, k)), f"adaptive bins {r.bins}: {k} not finite")
    print(f"  adaptive T_n {[r.T_n for r in a_rows]} (oracle f64: 87/103/106/109), "
          f"delta_n {[r.delta_n for r in a_rows]}")
    return results


def phase_f64(dev, oracle):
    """Phase 5: the f64 plain-torch path on the card, two stages: an aberth and
    an orbit_de_tci launch a stage."""
    from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker

    reset_launches()
    t0 = time.perf_counter()
    rows, _ = run_tracker(TrackerConfig(**DENSE), max_stages=2, device=dev)
    wall = time.perf_counter() - t0
    launched("f64 tracker", {"aberth": 2, "orbit_de_tci": 2})
    check(len(rows) == 2 and rows[1].n_construct_pts == 6000, "f64 path: wrong rows")
    for k in CHECK_KEYS:
        got, want = getattr(rows[0], k), float(oracle[0][k])
        check(abs(got - want) <= 2e-3 * abs(want), f"f64 stage 1 {k}: {got!r} vs {want!r}")
    for k in ("delta_n", "tv_PC_PM", "overlap_mass_PC_PM"):
        got, want = getattr(rows[1], k), float(oracle[1][k])
        check(abs(got - want) <= 0.05 * abs(want), f"f64 stage 2 {k}: {got!r} vs {want!r}")
    worst = max(abs(getattr(r, k) / float(o[k]) - 1.0)
                for r, o in zip(rows, oracle) for k in CHECK_KEYS)
    print(f"f64 torch path: 2 stages in {wall:.3f} s, worst relative deviation from "
          f"the oracle {worst!r}")


def bench_grids():
    """The (domain, ny, nx) grids that cmtci_torch.bench gives K2 beyond the
    headline 2000 x 2000: the padded roofline grid (K4's too) and the two
    scale grids."""
    from cmtci_torch import bench

    sizes = bench.BenchSizes()
    check(bench.DOM == BOUNDARY_DOMAIN and (sizes.res, sizes.res) == DWELL_SHAPES[0],
          "the bench's headline grid is not DWELL_SHAPES[0] on BOUNDARY_DOMAIN")
    return ([(bench.padded_domain(sizes), sizes.mfu_res, sizes.mfu_res)]
            + [(bench.DOM, res, res) for res, _ in sizes.scale_grids])


def dwell_edge_cases(c: int):
    """(ny, nx, max_iter) beyond the pipelines' grids, for K2's schedule: nx no
    multiple of a thread's, a warp's or a block's columns, ny no multiple of a
    patch's rows, grids smaller than one patch, and max_iter around `c`, the
    steps between two exit tests, and far above them."""
    small = [(2, 2), (3, 5), (13, 37), (257, 33)]
    cases = [(ny, nx, it) for ny, nx in small for it in sorted({1, max(c - 1, 1), c, c + 1})]
    return cases + [(13, 37, 500), (130, 1003, 500), (130, 1003, 20000)]


def phase_dwell(dev):
    """Phase 6: K2 against its twin on the card, at the boundary's shapes, at
    every grid the bench launches it on, and at the shapes and iteration
    counts that stress its schedule."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import mandelbrot_cuda as mc

    timing = {}
    max_err = 0.0
    foot = mc.DWELL_FOOTPRINT
    edge = dwell_edge_cases(foot["c"])
    for ny, nx, max_iter in edge:
        out_k = mc.mandelbrot_field(BOUNDARY_DOMAIN, nx, ny, max_iter=max_iter, device=dev)
        out_t = mc.dwell_field_torch(BOUNDARY_DOMAIN, nx, ny, max_iter, device=dev)
        torch.cuda.synchronize()
        check(out_k.shape == out_t.shape == (ny, nx), f"K2 {ny}x{nx}: shape")
        n_diff = int((out_k != out_t).sum())
        max_err = max(max_err, float((out_k - out_t).abs().max()))
        check(n_diff == 0, f"K2 {ny}x{nx}, max_iter {max_iter}: {n_diff} pixels differ "
                           "from the twin")
    print(f"K2 schedule cases (footprint {foot}): {len(edge)} grids and iteration counts, "
          f"{', '.join(f'{ny}x{nx}@{it}' for ny, nx, it in edge)}: 0 differing pixels each")

    max_iter = 500
    cases = [(BOUNDARY_DOMAIN, ny, nx) for ny, nx in DWELL_SHAPES] + bench_grids()
    for dom, ny, nx in cases:
        label = f"K2 {ny}x{nx}" + ("" if dom == BOUNDARY_DOMAIN else " (padded domain)")
        out_k = mc.mandelbrot_field(dom, nx, ny, max_iter=max_iter, device=dev)
        out_t = mc.dwell_field_torch(dom, nx, ny, max_iter, device=dev)
        torch.cuda.synchronize()
        check(out_k.shape == out_t.shape == (ny, nx), f"{label}: shape {tuple(out_k.shape)}")
        n_diff = int((out_k != out_t).sum())
        max_err = max(max_err, float((out_k - out_t).abs().max()))
        # loop trips: an escaping pixel needs dwell + 1 steps, a bounded one
        # max_iter, an analytically interior one none; executed is what the
        # warps of the kernel's footprint burn for them
        interior = mc._interior_mask_torch(*mc._grid_coords(dom, nx, ny, dev))
        useful, executed = bench.dwell_step_counts(out_k, interior, max_iter)
        _, executed_rows = bench.dwell_step_counts(out_k, interior, max_iter, bench.ROW_WARP)
        steps = int(useful)
        print(f"{label}: kernel vs twin differing pixels {n_diff}, mean dwell "
              f"{float(out_k.mean())!r}, interior pixels {int(interior.sum())}, useful "
              f"orbit steps {steps}, executed by the kernel's warps {int(executed)} "
              f"(executed / useful {executed / useful:.4f}; one-row warps with a test every "
              f"step would execute {executed_rows / useful:.4f})")
        check(n_diff == 0, f"{label}: {n_diff} pixels differ from the twin")
        del out_t

        def k2():
            return mc.mandelbrot_field(dom, nx, ny, max_iter=max_iter, device=dev)

        ms = cuda_ms(k2, 3, 20, CHAIN)
        single_ms = cuda_ms(k2, 3, 20)
        # the twin takes seconds at the two scale grids: one timed run there
        plain_ms = cuda_ms(lambda: mc.dwell_field_torch(dom, nx, ny, max_iter, device=dev),
                           *((1, 3) if nx * ny <= 2048 * 2048 else (0, 1)))
        bound, by = bound_ms("dwell", steps, 4 * nx * ny)
        if dom == BOUNDARY_DOMAIN:
            timing[(ny, nx)] = (ms, plain_ms, bound, by)
        print(f"  kernel {ms:.4f} ms (median per launch, {CHAIN} back to back; "
              f"{steps / ms / 1e9:.4f} G orbit steps per ms), {single_ms:.4f} ms around one "
              f"launch, twin {plain_ms:.4f} ms (median, CUDA events); bound {bound:.5f} ms "
              f"({by})")
    return max_err, timing


def phase_boundary(dev):
    """Phase 7: run_boundary at the default config on both backends."""
    import numpy as np

    from cmtci_torch.pipelines.boundary import BoundaryConfig, run_boundary
    from cmtci_torch.utils.artifacts import StageTimer

    golden = np.loadtxt(GOLDEN, delimiter=",", skiprows=1)
    check(golden.shape == (GOLDEN_VERTICES, 2), f"golden shape {golden.shape}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("cuda", "torch"):
            timer = StageTimer(dev)
            reset_launches()
            t0 = time.perf_counter()
            path, z = run_boundary(BoundaryConfig(backend=backend),
                                   os.path.join(tmp, backend), plots=False, device=dev,
                                   timer=timer)
            wall = time.perf_counter() - t0
            launches = launched(f"boundary {backend}",
                                {"dwell": 1} if backend == "cuda" else {"orbit_dwell": 1})
            with open(os.path.join(tmp, f"{backend}_boundary.csv")) as f:
                check(f.readline().strip() == "x,y", f"boundary {backend}: CSV header")
            h = hausdorff(path, golden)
            out[backend] = (path, z, launches.get("dwell", 0))
            print(f"boundary ({backend}): {len(path)} vertices (golden {GOLDEN_VERTICES}), "
                  f"Hausdorff to the golden {h!r} ({h / SPACING:.3f} spacings), "
                  f"launches {launches}, {wall:.3f} s wall; stages (s): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in timer.times.items()))
            if backend == "torch":
                check(abs(len(path) - GOLDEN_VERTICES) <= 0.005 * GOLDEN_VERTICES,
                      f"f64 path: {len(path)} vertices")
                check(h <= 1.5e-3, f"f64 path: Hausdorff {h!r} > 1.5e-3")
            else:
                check(abs(len(path) - GOLDEN_VERTICES) <= 0.02 * GOLDEN_VERTICES,
                      f"K2 path: {len(path)} vertices")
                check(h <= 7.5e-3, f"K2 path: Hausdorff {h!r} > 7.5e-3")
    z32, z64 = out["cuda"][1], out["torch"][1]
    equal = float((z32 == z64).mean())
    print(f"  K2 dwell equal to the f64 dwell on {equal!r} of pixels")
    check(equal >= 0.99, f"K2 vs f64 dwell: {equal!r} < 0.99")
    return out["cuda"][2]


def default_cloud(dev):
    """The equipotential CLI default cloud: four families, n 2..200."""
    import numpy as np

    from cmtci_torch.kernels import companion
    from cmtci_torch.pipelines.equipotential import EquipotentialConfig

    cfg = EquipotentialConfig()
    ns = list(range(cfg.n_min, cfg.n_max + 1))
    return np.concatenate([companion.inverse_cloud(ns, f, tol=cfg.eig_tol, device=dev)
                           for f in cfg.families])


K3_ROWS = ("k", "zer", "zei", "zr", "zi", "act")


def k3_chunk() -> int:
    """S, the steps of a speculative chunk csrc/cloud_green.cu is built with."""
    import re

    with open(os.path.join(ROOT, "cmtci_torch", "csrc", "cloud_green.cu")) as f:
        return int(re.search(r"constexpr int S = (\d+);", f.read()).group(1))


def real_point_escaping_at(step: int, r2: float = 4.0) -> float:
    """An f32 real c past the cusp at 1/4 whose orbit leaves the disc of
    squared radius r2 exactly at the 1-based `step` (the step falls as c
    grows, about pi / sqrt(c - 1/4)), found by bisection on the scalar f32
    orbit."""
    import numpy as np

    f32 = np.float32

    def escape_step(c):
        c, z = f32(c), f32(0)
        for n in range(1, 100_000):
            z = z * z + c
            if z * z > f32(r2):
                return n
        raise SmokeFailure(f"c = {c!r} does not escape")

    lo, hi = 0.25 + (3.0 / step) ** 2 / 4, 0.25 + (3.3 / step) ** 2 * 4
    for _ in range(60):
        mid = float(f32(0.5 * (lo + hi)))
        got = escape_step(mid)
        if got == step:
            return mid
        lo, hi = (mid, hi) if got > step else (lo, mid)
    raise SmokeFailure(f"no f32 real point escapes at step {step}")


def k3_against_twin(label, cr, ci, zr0, zi0, iters, dev):
    """K3 on the card against its twin on the same inputs: every row
    bitwise (NaN equal to NaN). Returns (kernel output, max |kernel - twin|)."""
    import torch

    from cmtci_torch.kernels import mandelbrot_cuda as mc

    out_k = mc.cloud_green(cr, ci, zr0, zi0, iters, 2.0, device=dev)
    out_t = mc.cloud_green_torch(cr, ci, zr0, zi0, iters, 2.0, device=dev)
    torch.cuda.synchronize()
    check(out_k.shape == out_t.shape == (6, len(cr)), f"{label}: shape {tuple(out_k.shape)}")
    same = (out_k == out_t) | (torch.isnan(out_k) & torch.isnan(out_t))
    diff = {r: int((~same[i]).sum()) for i, r in enumerate(K3_ROWS)}
    check(all(v == 0 for v in diff.values()), f"{label}: K3 differs from its twin: {diff}")
    err = float(torch.where(same, 0.0, (out_k - out_t).abs()).max())
    return out_k, err


def phase_cloud_green(dev):
    """Phase 8: K3 against its twin on the full default cloud and on the
    cases that stress its chunks; its time on device-resident inputs, the
    wrapper's from numpy inputs, and the chain bound."""
    import numpy as np
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import mandelbrot_cuda as mc

    pts = default_cloud(dev)
    check(pts.size == 80395, f"default cloud has {pts.size} points, expected 80395")
    keep = ~mc.exact_interior(pts)
    cr = pts.real[keep].astype(np.float32)
    ci = pts.imag[keep].astype(np.float32)
    z0 = np.zeros_like(cr)
    iters = 20000
    s = k3_chunk()

    # the whole cloud at the full budget: the twin takes seconds, so once
    t0 = time.perf_counter()
    out_t = mc.cloud_green_torch(cr, ci, z0, z0, iters, 2.0, device=dev)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    out_k = mc.cloud_green(cr, ci, z0, z0, iters, 2.0, device=dev)
    diff = {r: int((out_k[i] != out_t[i]).sum()) for i, r in enumerate(K3_ROWS)}
    n_esc = int((out_k[0] > 0).sum())
    print(f"K3 default cloud: {pts.size} points, {int(keep.sum())} after the interior "
          f"short-circuit, {n_esc} escape in {iters} iterations; differing entries per "
          f"row {diff}; chunks of S = {s} steps")
    check(all(v == 0 for v in diff.values()), f"K3 differs from its twin: {diff}")
    max_err = float((out_k - out_t).abs().max())
    del out_t

    # m and iters around a warp and a chunk (the long budget on a few points
    # too: their twin stops as soon as no lane is active)
    cases = [(m, it) for m in (1, 31, 33, 257, cr.size) for it in (1, s - 1, s, s + 1)]
    cases += [(m, iters) for m in (1, 33)] + [(257, 3 * s + 7), (cr.size, 3 * s + 7)]
    for m, it in cases:
        _, err = k3_against_twin(f"K3 m {m}, iters {it}", cr[:m], ci[:m], z0[:m], z0[:m], it,
                                 dev)
        max_err = max(max_err, err)
    print(f"K3 m x iters cases: {', '.join(f'{m}@{it}' for m, it in cases)}: all six rows "
          "bitwise the twin's")

    # lanes that leave on the last step of a chunk (S, 2S), on the first of
    # the next (S + 1, 2S + 1) and just before (S - 1)
    want = [s - 1, s, s + 1, 2 * s, 2 * s + 1]
    ecr = np.asarray([real_point_escaping_at(k) for k in want], dtype=np.float32)
    ez = np.zeros_like(ecr)
    out_e, err = k3_against_twin("K3 chunk edges", ecr, ez, ez, ez, 3 * s + 7, dev)
    got = out_e[0].cpu().numpy().astype(int).tolist()
    print(f"K3 chunk edges: real points {ecr.tolist()} leave at steps {got}")
    check(got == want, f"K3 chunk edges: escape steps {got}, expected {want}")
    max_err = max(max_err, err)

    # resumed states: beyond the radius already, overflowing, inf and NaN, NaN
    # and inf coordinates, an interior c with a state outside
    rcr = np.array([0.5, 0.5, 0.5, 0.5, np.nan, np.inf, -np.inf, 0.5, 0.0, 0.5], np.float32)
    rci = np.array([0.1, 0.1, 0.1, 0.1, 0.0, 0.0, 1.0, np.nan, 0.0, 0.1], np.float32)
    rzr = np.array([3.0, 1e20, np.inf, np.nan, 0.0, 0.0, 0.0, 0.0, 5.0, -2.0001], np.float32)
    rzi = np.array([0.0, 1e20, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 5.0, 0.0], np.float32)
    for it in (1, s, 2 * s + 3):
        out_r, err = k3_against_twin(f"K3 resumed states, iters {it}", rcr, rci, rzr, rzi, it,
                                     dev)
        max_err = max(max_err, err)
    k_r = out_r[0].cpu().numpy()
    check(k_r[0] == 1 and k_r[9] == 1 and k_r[8] == 0,
          f"K3 resumed states: k {k_r.tolist()} (a state outside leaves on step 1, an "
          "interior c never)")
    print(f"K3 resumed states outside the radius, non-finite states and coordinates: "
          f"bitwise the twin's at iters 1, {s}, {2 * s + 3}; k {k_r.tolist()}")

    # a launch resumed from the state rows of an earlier one
    first = s + 5
    one = mc.cloud_green(cr, ci, z0, z0, first, 2.0, device=dev).cpu().numpy()
    act = one[5] == 1
    _, err = k3_against_twin("K3 resumed launch", cr[act], ci[act], one[3][act], one[4][act],
                             2 * s + 1, dev)
    max_err = max(max_err, err)

    # the staged host loop against the single launch, on the whole cloud
    reset_launches()
    g1, k1, phi1 = mc.green_cloud_f32(pts, iters, 2.0, device=dev)
    single_launches = mc.launches["cloud_green"]
    g5, k5, phi5 = mc.green_cloud_f32(pts, iters, 2.0, stage_iters=4096, device=dev)
    staged_launches = mc.launches["cloud_green"] - single_launches
    check(single_launches == 1 and staged_launches == 5,
          f"green_cloud_f32 launches: single {single_launches}, staged {staged_launches}")
    check(np.array_equal(g1, g5) and np.array_equal(k1, k5)
          and np.array_equal(phi1, phi5, equal_nan=True),
          "green_cloud_f32 with stage_iters 4096 differs from the single launch")
    print(f"K3 resumed launch ({int(act.sum())} lanes after {first} steps) bitwise the "
          f"twin's; green_cloud_f32 staged (stage_iters 4096, {staged_launches} launches) "
          f"equal to the single launch on g, k and phi of all {pts.size} points")

    # the kernel alone: inputs resident on the card; and the wrapper as the
    # pipeline calls it, from numpy arrays (four host-to-device copies)
    crd, cid, z0d = (torch.as_tensor(a, device=dev) for a in (cr, ci, z0))
    ms = cuda_ms(lambda: mc.cloud_green(crd, cid, z0d, z0d, iters, 2.0, device=dev), 2, 10,
                 5)
    single_ms = cuda_ms(lambda: mc.cloud_green(crd, cid, z0d, z0d, iters, 2.0, device=dev),
                        2, 10)
    numpy_ms = cuda_ms(lambda: mc.cloud_green(cr, ci, z0, z0, iters, 2.0, device=dev), 2, 10)
    plain_ms = cuda_ms(lambda: mc.cloud_green_torch(crd, cid, z0d, z0d, iters, 2.0,
                                                    device=dev), 0, 1)
    # loop trips: k for a point that escapes at step k, iters for a bounded
    # one, none for an analytically interior one
    interior = mc._interior_mask_torch(crd, cid)
    lane = torch.where(interior, 0.0, torch.where(out_k[0] > 0, out_k[0], float(iters)))
    steps = int(lane.sum(dtype=torch.float64))
    longest = int(lane.max())
    long_lanes = int((lane >= iters).sum())
    flat, by = bound_ms("cloud_green", steps, 4 * 4 * cr.size + 6 * 4 * cr.size)
    # the bound: one lane's orbit is a serial chain, each step's z update
    # three dependent FP32 instructions (mul, sub, add) at the measured
    # dependent-issue latency and the card's maximum SM clock
    clock_hz = bench.max_sm_clock_mhz(dev) * 1e6
    chain = longest * 3 * FP32_DEPENDENT_CYCLES / clock_hz * 1e3
    check(chain > flat, f"K3: the chain bound {chain} ms is below the {by} bound {flat} ms")
    print(f"  kernel {ms:.4f} ms on device-resident inputs (median per launch, 5 back to "
          f"back; {single_ms:.4f} ms around one launch), wrapper from numpy inputs "
          f"{numpy_ms:.4f} ms, twin {plain_ms:.4f} ms (one rep, CUDA events; first twin "
          f"call {twin_s:.3f} s wall); {steps} orbit steps, {long_lanes} lanes run all "
          f"{iters}; bound {chain:.5f} ms (the longest lane's {longest} steps x 3 dependent "
          f"FP32 instructions x {FP32_DEPENDENT_CYCLES} cycles at {clock_hz / 1e9:.3f} GHz; "
          f"kernel at {chain / ms:.1%} of it); by {by} alone {flat:.5f} ms")
    return max_err, ms, plain_ms, chain


def run_equip(dev, dtype, tmp):
    """One run_equipotential at the CLI defaults; returns (out, g of every
    point in family order, lucas k, K3 launches). The per-point g comes from
    the run's own potential cache, so nothing is solved twice."""
    import glob

    import numpy as np
    import torch

    from cmtci_torch.pipelines.equipotential import EquipotentialConfig, run_equipotential

    out_dir = os.path.join(tmp, dtype)
    cache = os.path.join(tmp, f"{dtype}_cache")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run_equipotential(EquipotentialConfig(potential_dtype=dtype), out_dir,
                            cache_dir=cache, plots=False, device=dev)
    wall = time.perf_counter() - t0
    # a cloud a family; f32 one K3 launch, f64 one orbit_green launch over the
    # whole budget
    launches = launched(f"equipotential {dtype}",
                        {"aberth": 4, "cloud_green": 1} if dtype == "float32"
                        else {"aberth": 4, "orbit_green": 1})
    s = out["summary"]
    print(f"equipotential ({dtype}): {wall:.3f} s wall, launches {launches}; lucas count {s['count']}, escaped {s['escaped']}, g_median "
          f"{s['g_median']!r}, g_mean {s['g_mean']!r}, g_p90 {s['g_p90']!r}; stages (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out["stage_times"].items()))
    (npz,) = glob.glob(os.path.join(cache, "green_potential_*.npz"))
    with np.load(npz) as z:
        g_all = z["g"]
    g_lucas = np.load(os.path.join(out_dir, "g_lucas.npy"))
    check(np.array_equal(g_all[: g_lucas.size], g_lucas), f"{dtype}: cache and g_lucas differ")
    k_lucas = np.load(os.path.join(out_dir, "it_lucas.npy"))
    return out, g_all, k_lucas, launches.get("cloud_green", 0)


def phase_equipotential(dev):
    """Phase 9: run_equipotential at the CLI defaults, f32 (K3) and f64."""
    import numpy as np

    from cmtci_torch.stats.laws import summarize_outside

    with open(EQUIP_REF) as f:
        ref = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        o32, g32, k32, launches = run_equip(dev, "float32", tmp)
        o64, g64, k64, _ = run_equip(dev, "float64", tmp)
        # again, warm: the first f64 run also pays torch's first calls of the
        # f64 epilogue's kernels in this process
        _, g64_warm, _, _ = run_equip(dev, "float64", os.path.join(tmp, "warm"))
    check(np.array_equal(g64, g64_warm), "f64 equipotential: the warm run's g differs")
    s32, s64 = o32["summary"], o64["summary"]
    n, max_iter = s64["count"], 20000
    check(s32["count"] == n == ref["summary"]["count"], "lucas counts differ")
    check(abs(s32["escaped"] - s64["escaped"]) <= 0.001 * n,
          f"escaped f32 {s32['escaped']} vs f64 {s64['escaped']}")
    both = (k32 < max_iter) & (k64 < max_iter)
    k_equal = float((k32[both] == k64[both]).mean())
    print(f"  f32 vs f64: escaped {s32['escaped']} vs {s64['escaped']}, k equal on "
          f"{k_equal!r} of the points that escape in both")
    check(k_equal >= 0.99, f"k equal on {k_equal!r} < 0.99")
    # the g statistics over the points whose k agrees: a point whose k lands
    # on either side of 1074 has g = 2^-k log|z_k| > 0 in one run and an
    # underflowed g = 0 in the other, so summarize_g counts it escaped in one
    # run only, and that shifts the whole-cloud median and mean by ~2e-5
    # (ROADMAP Queue 3)
    same = both & (k32 == k64)
    c32 = summarize_outside(g32[:n][same], int(same.sum()))
    c64 = summarize_outside(g64[:n][same], int(same.sum()))
    for key in ("g_median", "g_mean", "g_p90"):
        d = abs(c32[key] - c64[key])
        print(f"  f32 vs f64 {key}: {d!r} on the {int(same.sum())} points whose k "
              f"agrees; {abs(s32[key] - s64[key])!r} on the whole cloud's summary")
        check(d < 1e-5, f"f32 vs f64 {key}: |{c32[key]!r} - {c64[key]!r}| = {d!r}")

    # f64 against the reference's f64 numbers: escaped counts within +-5, and
    # the g statistics over g >= 2^-500 (the points that escape within about
    # 500 steps) within 1e-5. Deeper escapers differ one by one: the
    # reference's XLA contracts FMAs, which moves their chaotic k, and flushes
    # a subnormal g (k > 1022) to 0 where the port keeps it; a handful of
    # them shift the whole-cloud g_mean and g_p10 by up to ~1.4e-5 (ROADMAP
    # Queue 3). The whole-cloud deviations are printed
    check(abs(s64["escaped"] - ref["summary"]["escaped"]) <= 5,
          f"lucas escaped {s64['escaped']} vs {ref['summary']['escaped']}")
    floor = 2.0 ** -500
    worst = 0.0
    off = 0
    for got, want in zip(o64["family_summary"], ref["family_summary"]):
        label, count = want["family"], want["count"]
        check(got["family"] == label and got["count"] == count, f"{label}: count {got}")
        g = g64[off : off + count]
        off += count
        check(abs(got["escaped"] - want["escaped"]) <= 5,
              f"{label}: escaped {got['escaped']} vs {want['escaped']}")
        shallow = summarize_outside(g[g >= floor], count)
        for key in SUMMARY_KEYS[3:]:
            d = abs(shallow[key] - want["shallow_g"][key])
            worst = max(worst, d)
            check(d <= 1e-5, f"{label} {key} (g >= 2^-500): {shallow[key]!r} vs "
                             f"{want['shallow_g'][key]!r}")
        print(f"  f64 {label}: escaped {got['escaped']} (reference {want['escaped']}), "
              f"escaped with g >= 2^-500 {shallow['escaped']} (reference "
              f"{want['shallow_g']['escaped']}); whole-cloud deviations "
              + ", ".join(f"{k} {got[k] - want[k]:+.3e}" for k in SUMMARY_KEYS[3:]))
    check(off == g64.size, f"the families cover {off} of {g64.size} points")
    print(f"  f64 vs the reference's f64 numbers: worst deviation of a g >= 2^-500 "
          f"statistic {worst!r}")
    return launches


def compare_twin(out_k, out_t, label):
    """Kernel against twin: bitwise (NaN equal to NaN), or within rtol 1e-6
    with the differing pixels counted. Returns (differing pixels, max err)."""
    import torch

    nan_k, nan_t = torch.isnan(out_k), torch.isnan(out_t)
    check(bool(torch.equal(nan_k, nan_t)), f"{label}: NaN pixels differ "
                                           f"({int(nan_k.sum())} vs {int(nan_t.sum())})")
    same = (out_k == out_t) | nan_k
    n_diff = int((~same).sum())
    if n_diff:
        close = torch.isclose(out_k, out_t, rtol=1e-6, atol=0.0) | nan_k
        check(bool(close.all()), f"{label}: {int((~close).sum())} pixels beyond rtol 1e-6")
    err = float(torch.where(nan_k, 0.0, (out_k - out_t).abs()).max())
    return n_diff, err


def phase_fields(dev):
    """Phase 10: K4 and K5 at the grids and iteration counts that stress
    their schedules, K5 also at the chunk's positions and on deep escapers;
    K4 and K5 through mandelbrot_field against their twins and the f64
    contracts."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import mandelbrot as mb
    from cmtci_torch.kernels import mandelbrot_cuda as mc

    max_iter, escape_r = 500, 4.0
    twins = {"de": mc.de_field_std_torch, "green": mc.green_field_torch}
    foots = {"de": mc.DE_FOOTPRINT, "green": mc.GREEN_FOOTPRINT}
    edge_err = {}

    def against_twin(label, kind, dom, ny, nx, it):
        out_k = mc.mandelbrot_field(dom, nx, ny, it, kind, escape_r, dev)
        out_t = twins[kind](dom, nx, ny, it, escape_r, device=dev)
        torch.cuda.synchronize()
        check(out_k.shape == out_t.shape == (ny, nx), f"{label}: shape")
        n_diff, err = compare_twin(out_k, out_t, label)
        check(n_diff == 0, f"{label}: {n_diff} pixels differ from the twin")
        edge_err[kind] = max(edge_err.get(kind, 0.0), err)
        return out_t

    for kind, name in (("de", "K4"), ("green", "K5")):
        foot = foots[kind]
        edge = de_edge_cases(foot["c"])
        for ny, nx, it in edge:
            against_twin(f"{name} {ny}x{nx}, max_iter {it}", kind, BOUNDARY_DOMAIN, ny, nx, it)
        print(f"{name} schedule cases (footprint {foot}): {len(edge)} grids and iteration counts, "
              f"{', '.join(f'{ny}x{nx}@{it}' for ny, nx, it in edge)}: 0 differing pixels each")

    # K5: first escapes on every position of a chunk, and max_iter at the
    # escape step (it counts) and one below (it does not, though the chunk
    # runs over it and raises the flag)
    c5 = mc.GREEN_FOOTPRINT["c"]
    ny, nx, it = 19, 41, 200
    r2 = float(escape_r * escape_r)
    steps = bench.escape_lane_steps(*mc._grid_coords(BOUNDARY_DOMAIN, nx, ny, dev), it, r2)
    against_twin(f"K5 {ny}x{nx}, max_iter {it}", "green", BOUNDARY_DOMAIN, ny, nx, it)
    picked = []
    for pos in range(c5):
        rows, cols = torch.nonzero((steps % c5 == pos) & (steps > c5) & (steps < it),
                                   as_tuple=True)
        check(rows.numel() > 0, f"K5: no pixel of {ny}x{nx} escapes on position {pos} of a "
                                "chunk")
        row, col = int(rows[0]), int(cols[0])
        k = int(steps[row, col])
        for max_it, escaped in ((k, True), (k - 1, False)):
            out_t = against_twin(f"K5 {ny}x{nx}, max_iter {max_it}", "green",
                                 BOUNDARY_DOMAIN, ny, nx, max_it)
            check(bool(out_t[row, col] != 0) == escaped,
                  f"K5: pixel ({row}, {col}) escaping at step {k}, max_iter {max_it}: "
                  f"g {float(out_t[row, col])!r}")
        picked.append((pos, k))
    # deep escapers: 1-based escape step k + 1 = 126 (2^-126, the last normal
    # scale), 127 (subnormal), 149 (the last subnormal) and 150 (0)
    deep = {}
    for step in (126, 127, 149, 150):
        c = real_point_escaping_at(step, r2)
        out_t = against_twin(f"K5 deep escaper at step {step}", "green",
                             (c, c + 1.0, 0.0, 1.0), 2, 2, max_iter)
        deep[step] = float(out_t[0, 0])
    check(deep[126] > 0 and deep[127] > 0 and deep[149] > 0 and deep[150] == 0,
          f"K5 deep escapers: g {deep}")
    print(f"K5 chunk positions on {ny}x{nx} (position, escape step): {picked}, each at "
          f"max_iter = step and step - 1; deep escapers, g by escape step: {deep}: 0 "
          "differing pixels each")

    libs = {"de": "de_std", "green": "green_grid"}
    contract = {"de": (dict(rtol=1e-3, atol=1e-9), 0.98),
                "green": (dict(rtol=1e-4, atol=1e-7), 0.99)}
    result = {}
    for kind in ("de", "green"):
        lib = libs[kind]
        cases = [(BOUNDARY_DOMAIN, ny, nx) for ny, nx in FIELD_SHAPES]
        if kind == "de":
            cases.append(bench_grids()[0])  # the bench's de_mfu grid
        for dom, ny, nx in cases:
            label = (f"K{4 if kind == 'de' else 5} {ny}x{nx}"
                     + ("" if dom == BOUNDARY_DOMAIN else " (padded domain)"))
            torch.cuda.synchronize()
            reset_launches()
            out_k = mc.mandelbrot_field(dom, nx, ny, max_iter, kind, escape_r, dev)
            torch.cuda.synchronize()
            launches = dict(mc.launches)
            check(launches[lib] == 1 and sum(launches.values()) == 1,
                  f"{label}: launches {launches}")
            out_t = twins[kind](dom, nx, ny, max_iter, escape_r, device=dev)
            check(out_k.shape == out_t.shape == (ny, nx), f"{label}: shape")
            n_diff, err = compare_twin(out_k, out_t, label)
            check(kind == "de" or n_diff == 0, f"{label}: {n_diff} pixels differ from the twin")
            cr, ci = mb.complex_grid(dom, nx, ny, dtype=torch.float64, device=dev)
            if kind == "de":
                f64 = mb.de_field_std(cr, ci, max_iter, escape_r)[1]
            else:
                f64 = mb.escape_potential_grid(cr, ci, max_iter, escape_r)
            tol, share = contract[kind]
            close = float(torch.isclose(out_k.double(), f64, **tol).double().mean())
            check(close > share, f"{label}: {close!r} of pixels within {tol} of f64, "
                                 f"not > {share}")
            lane = bench.escape_lane_steps(*mc._grid_coords(dom, nx, ny, dev), max_iter,
                                           float(escape_r * escape_r))
            steps = int(lane.sum(dtype=torch.int64))
            executed = bench.warp_executed_steps(lane, foots[kind])
            ms = cuda_ms(lambda: mc.mandelbrot_field(dom, nx, ny, max_iter, kind,
                                                     escape_r, dev), 3, 20, CHAIN)
            graph_ms = cuda_ms(lambda: mc.mandelbrot_field(dom, nx, ny, max_iter, kind,
                                                           escape_r, dev), 3, 20, CHAIN,
                               graph=True)
            plain_ms = cuda_ms(lambda: twins[kind](dom, nx, ny, max_iter,
                                                   escape_r, device=dev), 1, 3)
            bound, by = bound_ms(lib, steps, 4 * nx * ny)
            before = ""
            if lib in OPS_BEFORE:
                before_ms, _ = least_ms(steps * OPS_BEFORE[lib], 4 * nx * ny)
                before = (f", {mc.OPS_PER_STEP[lib]} operations a step; at the earlier "
                          f"design's {OPS_BEFORE[lib]}: {before_ms:.5f} ms")
            print(f"{label}: kernel vs twin differing pixels {n_diff}, max|kernel-twin| "
                  f"{err!r}, NaN pixels {int(torch.isnan(out_k).sum())}; within {tol} of "
                  f"the f64 counterpart on {close!r} (contract > {share}); kernel {ms:.4f} ms "
                  f"(median per launch, {CHAIN} back to back; {graph_ms:.4f} ms replayed from a "
                  f"CUDA graph), "
                  f"twin {plain_ms:.4f} ms (median, CUDA events); {steps} useful orbit steps, "
                  f"executed by the kernel's warps {int(executed)} (executed / useful "
                  f"{executed / steps:.4f}), bound {bound:.5f} ms ({by}{before})")
            if (dom, ny, nx) == cases[0]:
                result[lib] = dict(launches=launches[lib], max_abs_err=err, ms=graph_ms,
                                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                   chained_ms=ms)
            else:
                result[lib]["max_abs_err"] = max(result[lib]["max_abs_err"], err)
    for kind, lib in libs.items():
        result[lib]["max_abs_err"] = max(result[lib]["max_abs_err"], edge_err[kind])
    return result


def ms_straddle_cases():
    """(ny, nx, tile) of K6 cases whose tiles are no multiple of a block (a
    block of the footprint spans WARPS * PATCH_W columns and PATCH_H rows), so
    that blocks straddle tiles, and one whose tiles are smaller than a warp's
    patch."""
    return [(96, 480, (4, 8)), (96, 480, (12, 24)), (64, 64, (2, 2)), (40, 1000, (8, 40))]


def phase_dwell_ms(dev):
    """Phase 11: K6 through dwell_field_ms against K2 and its twin, on tiles
    that blocks straddle, and the two-pass time against K2's in turns."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import mandelbrot_cuda as mc

    ny, nx = MS_SHAPE
    max_iter, stride, (th, tw) = 500, MS_STRIDE, MS_TILE
    dom = BOUNDARY_DOMAIN
    torch.cuda.synchronize()
    reset_launches()
    out, stats = mc.dwell_field_ms(dom, nx, ny, max_iter, stride, MS_TILE, device=dev)
    torch.cuda.synchronize()
    launches = dict(mc.launches)
    check(launches["dwell"] == 1 and launches["dwell_ms"] == 1
          and sum(launches.values()) == 2, f"dwell_field_ms: launches {launches}")
    plain = mc.mandelbrot_field(dom, nx, ny, max_iter, device=dev)
    n_diff = int((out != plain).sum())
    print(f"K6 {ny}x{nx}, stride {stride}, tile {MS_TILE}: {stats}; pixels differing from "
          f"K2 {n_diff}")
    check(n_diff == 0, f"K6 differs from K2 at {n_diff} pixels")
    check(stats["filled"] > 0, f"K6: no tile filled ({stats})")

    cparams = mc._coarse_params(dom, nx, ny, stride)
    coarse = mc._dwell(cparams, nx // stride, ny // stride, max_iter, dev)
    fill = mc.fill_flags(coarse, th // stride, tw // stride)
    fine_k = mc.dwell_fill(dom, nx, ny, fill, MS_TILE, max_iter, device=dev)
    fine_t = mc.dwell_fill_torch(dom, nx, ny, fill, MS_TILE, max_iter, device=dev)
    n_twin, err = compare_twin(fine_k, fine_t, "K6 fine pass")
    check(n_twin == 0, f"K6 fine pass differs from its twin at {n_twin} pixels")

    # tiles that blocks straddle: flags drawn from a seed, half of them -1
    foot = mc.DWELL_MS_FOOTPRINT
    gen = torch.Generator().manual_seed(11)
    for sny, snx, tile in ms_straddle_cases():
        flags = torch.randint(0, max_iter + 1, (sny // tile[0], snx // tile[1]),
                              generator=gen).float()
        flags[torch.rand(flags.shape, generator=gen) < 0.5] = -1.0
        flags = flags.to(dev)
        k = mc.dwell_fill(dom, snx, sny, flags, tile, max_iter, device=dev)
        tw_ = mc.dwell_fill_torch(dom, snx, sny, flags, tile, max_iter, device=dev)
        n_s, e_s = compare_twin(k, tw_, f"K6 {sny}x{snx} tile {tile}")
        err = max(err, e_s)
        check(n_s == 0, f"K6 {sny}x{snx}, tile {tile}: {n_s} pixels differ from its twin")
    print(f"K6 on tiles that blocks straddle (footprint {foot}): "
          + ", ".join(f"{a}x{b} tile {c}" for a, b, c in ms_straddle_cases())
          + ": 0 differing pixels each")

    interior = mc._interior_mask_torch(*mc._grid_coords(dom, nx, ny, dev))
    filled_px = mc._fill_pixels(fill, MS_TILE) >= 0
    fine_lane = torch.where(interior | filled_px, 0.0,
                            (fine_k + 1.0).clamp(max=max_iter)).double()
    fine_steps = int(fine_lane.sum())
    executed = int(bench.warp_executed_steps(fine_lane, foot))
    executed_rows = int(bench.warp_executed_steps(fine_lane, bench.ROW_WARP))
    c_interior = mc._interior_mask_torch(*mc._coords(cparams, nx // stride, ny // stride, dev))
    coarse_steps = dwell_steps(coarse, c_interior, max_iter)
    k2_steps = dwell_steps(plain, interior, max_iter)
    nbytes = 4 * nx * ny + 4 * fill.numel()
    bound, by = bound_ms("dwell_ms", fine_steps, nbytes)
    bound_before, _ = least_ms(fine_steps * OPS_BEFORE["dwell_ms"], nbytes)

    def k2():
        mc.mandelbrot_field(dom, nx, ny, max_iter, device=dev)

    def two_pass():
        mc.dwell_field_ms(dom, nx, ny, max_iter, stride, MS_TILE, device=dev)

    turns = []
    for label, fn in (("K2", k2), ("K6 two-pass", two_pass), ("K6 two-pass", two_pass),
                      ("K2", k2)):
        turns.append((label, cuda_ms(fn, 3, 20, CHAIN)))
    coarse_ms = cuda_ms(lambda: mc._dwell(cparams, nx // stride, ny // stride, max_iter, dev),
                        3, 20, CHAIN)
    fill_ms = cuda_ms(lambda: mc.fill_flags(coarse, th // stride, tw // stride), 3, 20, CHAIN)

    def fine():
        mc.dwell_fill(dom, nx, ny, fill, MS_TILE, max_iter, device=dev)

    fine_ms = cuda_ms(fine, 3, 20, CHAIN)
    fine_graph_ms = cuda_ms(fine, 3, 20, CHAIN, graph=True)
    plain_ms = cuda_ms(lambda: mc.dwell_fill_torch(dom, nx, ny, fill, MS_TILE, max_iter,
                                                   device=dev), 1, 3)
    k2_ms = statistics.median(t for lab, t in turns if lab == "K2")
    two_ms = statistics.median(t for lab, t in turns if lab != "K2")
    print(f"  in turns (median ms per call, {CHAIN} back to back, CUDA events): "
          + ", ".join(f"{lab} {t:.4f}" for lab, t in turns))
    print(f"  coarse pass (K2 at {ny // stride}x{nx // stride}) {coarse_ms:.4f} ms, "
          f"{coarse_steps} steps; fill decision {fill_ms:.4f} ms; fine pass (K6) "
          f"{fine_ms:.4f} ms chained, {fine_graph_ms:.4f} ms replayed from a CUDA graph, "
          f"{fine_steps} useful steps, executed by its warps {executed} (executed / useful "
          f"{executed / fine_steps:.4f}; one-row warps with a test every step "
          f"{executed_rows / fine_steps:.4f}), twin {plain_ms:.4f} ms; K2 alone "
          f"{k2_steps} steps. Two-pass {two_ms:.4f} ms against K2 {k2_ms:.4f} ms: "
          f"{'faster' if two_ms < k2_ms else 'slower'} by "
          f"{abs(two_ms - k2_ms) / k2_ms * 100:.1f}%; fine pass bound {bound:.5f} ms ({by}, "
          f"{mc.OPS_PER_STEP['dwell_ms']} operations a step; at the earlier design's "
          f"{OPS_BEFORE['dwell_ms']}: {bound_before:.5f} ms)")
    return dict(launches=launches["dwell_ms"], max_abs_err=err, ms=fine_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by, graph_ms=fine_graph_ms)


def phase_tci(dev):
    """Phase 12: run_tci on the kernel path at 600² and 2400², twice each."""
    import numpy as np
    import torch

    from cmtci_torch.pipelines.analysis import TCIConfig, run_tci
    from cmtci_torch.utils.artifacts import StageTimer

    launches_k1 = None
    for grid in TCI_GRIDS:
        for run in ("first", "second"):
            timer = StageTimer(dev)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out, kls, _ = run_tci(TCIConfig(mandelbrot_grid=grid, de_impl="cuda"),
                                  plots=False, timer=timer, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launched(f"run_tci {grid}", {"tci_de": 1, "aberth": 1})
            launches_k1 = launches["tci_de"]
            label = f"run_tci {grid}x{grid} ({run} run)"
            check(bool(np.all(np.diff(kls) <= 1e-12)), f"{label}: KL not monotone")
            check(out["KL_final"] < 1e-5, f"{label}: KL_final {out['KL_final']!r} >= 1e-5")
            check(math.isnan(out["Spectral_L2"]), f"{label}: Spectral_L2 not NaN")
            for key in ("Hausdorff_before", "Curvature_corr", "KL_initial"):
                check(math.isfinite(out[key]), f"{label}: {key} not finite")
            if grid == 2400:
                for key, (want, rel) in TCI_4X.items():
                    check(abs(out[key] - want) <= rel * want,
                          f"{label}: {key} {out[key]!r} not within {rel:.0%} of {want}")
            print(f"{label}: {wall:.3f} s wall, {launches['tci_de']} K1 and "
                  f"{launches['aberth']} aberth launch; "
                  f"KL {out['KL_initial']!r} -> {out['KL_final']!r}, Hausdorff "
                  f"{out['Hausdorff_before']!r}, curvature corr {out['Curvature_corr']!r}; "
                  "layers (s): " + ", ".join(f"{k} {v:.4f}" for k, v in timer.times.items()))
    return launches_k1


def phase_tci_f64(dev):
    """Phase 13: the f64 parity path against the frozen reference numbers."""
    import numpy as np

    from cmtci_torch.pipelines.analysis import run_tci, tci_config_from_reference

    with open(TCI_REF) as f:
        ref = json.load(f)
    cfg = tci_config_from_reference(ref["config"])
    reset_launches()
    t0 = time.perf_counter()
    out, kls, _ = run_tci(cfg, plots=False, device=dev)
    wall = time.perf_counter() - t0
    launched("f64 run_tci", {"aberth": 1})
    want = np.asarray(ref["kls"])
    rel = np.abs(kls - want) / np.abs(want)
    check(rel[0] <= 1e-9, f"KL_initial {kls[0]!r} vs {want[0]!r}")
    check(rel[-1] <= 1e-6 and rel.max() <= 1e-6, f"KL trajectory off by rel {rel.max()!r}")
    devs = {}
    for key in ("Hausdorff_before", "Curvature_corr"):
        devs[key] = abs(out[key] - ref["out"][key]) / abs(ref["out"][key])
        check(devs[key] <= 1e-9, f"{key} {out[key]!r} vs {ref['out'][key]!r}")
    check(math.isnan(out["Spectral_L2"]), "f64 run_tci: Spectral_L2 not NaN")
    print(f"run_tci f64 (numpy sampler, 600x600): {wall:.3f} s wall; relative deviation "
          f"from tests/data/tci_default_numpy.json: KL start {float(rel[0])!r}, end "
          f"{float(rel[-1])!r}, "
          f"Hausdorff {devs['Hausdorff_before']!r}, curvature corr {devs['Curvature_corr']!r}")


def phase_fma(dev):
    """Phase 14: K7 against its twin and the expected constant at the
    bench's full size, and its time."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import _launch
    from cmtci_torch.kernels import fma_peak as fp

    n, k = fp.N_ELEMS, fp.K_STEPS
    torch.cuda.synchronize()
    reset_launches()
    out = fp.fma_chain(device=dev)
    torch.cuda.synchronize()
    launches = dict(_launch.launches)
    check(launches["fma_peak"] == 1 and sum(launches.values()) == 1,
          f"fma_chain: launches {launches}")
    check(out.shape == (n,) and out.dtype == torch.float32, f"K7 output {tuple(out.shape)}")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    twin = fp.fma_chain_torch(n, k, device=dev)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    n_const = int((out.view(torch.int32) != fp.FIXED_POINT_BITS).sum())
    n_twin = int((out != twin).sum())
    err = float((out - twin).abs().max())
    print(f"K7 {n} elements x {k} FMAs: elements that are not 0x{fp.FIXED_POINT_BITS:08X} "
          f"{n_const}, differing from the twin {n_twin}, max|kernel-twin| {err!r}; twin "
          f"{plain_ms:.2f} ms (one run of {2 * k} eager launches, CUDA events)")
    check(n_const == 0, f"K7: {n_const} elements are not the fixed point")
    check(n_twin == 0, f"K7: {n_twin} elements differ from the twin")

    flop = fp.FLOP_PER_STEP * k * n
    bound, by = least_ms(flop, 4 * n)
    ceiling = bench.fp32_fma_bound_tflops(dev)
    ms = cuda_ms(lambda: fp.fma_chain(device=dev), 1, 5)
    print(f"  kernel {ms:.4f} ms (median, CUDA events), {flop / ms / 1e9:.3f} TFLOP/s, "
          f"{bound / ms:.1%} of the bound {bound:.5f} ms ({by}) at 67 TFLOP/s; the card's "
          f"own ceiling (SMs x 128 x 2 x max clock) {ceiling:.3f} TFLOP/s, "
          f"{flop / ceiling / 1e9:.5f} ms")
    check(flop / ms / 1e9 <= ceiling, f"K7 measured above the card's ceiling {ceiling}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


#: the domain of tests/test_torch_boundary.py's window across the period-3
#: bulb: its bounded lanes are not analytically interior and cycle in f32
PERIOD3_WINDOW = (-0.26, 0.02, 0.66, 0.92)
#: a 3 x 3 grid that holds c = -2 and c = +-i exactly: their orbits are
#: periodic within two steps, so the first checkpoint (at step C) catches them
EXACT_CYCLES = (-2.0, 0.0, -1.0, 1.0)
#: a window around the centre of the period-3 bulb at -0.1226 + 0.7449i: its
#: orbits become periodic in f32 within a few steps, so the checkpoints of
#: the first moves catch them
PERIOD3_CENTRE = (-0.1326, -0.1126, 0.7349, 0.7549)


def periodic_schedule_cases(c: int, last_step_iters):
    """(label, domain, ny, nx, max_iter) around the periodic entry's
    schedule: the grid with exact cycles at max_iter below, at and above a
    chunk and around the first power of two past C; the period-3 window at
    2000 and 20,000 iterations; ragged grids at 500; and the ragged grid at
    iteration counts on which some of its pixels escape on the last step."""
    pow2 = 1 << c.bit_length()  # the least power of two above c
    cases = [("exact cycles", EXACT_CYCLES, 3, 3, it)
             for it in sorted(set(schedule_iters(c)) | {2 * c, pow2, pow2 + 1, pow2 + c + 1})]
    cases += [("period-3 window", PERIOD3_WINDOW, 26, 28, it) for it in (2000, 20000)]
    cases += [("period-3 centre", PERIOD3_CENTRE, 32, 32, it) for it in (2 * pow2 + 1, 500)]
    cases += [("ragged", BOUNDARY_DOMAIN, ny, nx, 500) for ny, nx in ((13, 37), (130, 1003))]
    cases += [("last step", BOUNDARY_DOMAIN, 130, 1003, it) for it in last_step_iters]
    return cases


def phase_periodic(dev):
    """Phase 15: K2's periodicity entry against plain K2 and its twin at the
    boundary's shapes and at cases around its schedule, then both timed in
    turns at max_iter 500 and 20,000, with the steps each needs."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import _launch
    from cmtci_torch.kernels import mandelbrot_cuda as mc

    dom = BOUNDARY_DOMAIN
    foot = mc.DWELL_PERIODIC_FOOTPRINT
    c = foot["c"]
    max_err = 0.0
    positions, checkpoints = set(), set()

    def caught_where(cdom, ny, nx, max_iter):
        """Record the chunk positions of the steps on which cycles are caught
        and the steps of the checkpoints they are caught against."""
        lane, caught = bench.periodic_lane_steps(*mc._grid_coords(cdom, nx, ny, dev),
                                                 max_iter, c)
        hit = caught > 0
        positions.update(((lane[hit] - 1) % c).tolist())
        checkpoints.update(caught[hit].unique().tolist())

    for ny, nx in DWELL_SHAPES:
        caught_where(dom, ny, nx, 500)
        torch.cuda.synchronize()
        reset_launches()
        per = mc.mandelbrot_field(dom, nx, ny, 500, device=dev, periodicity=True)
        torch.cuda.synchronize()
        launches = dict(_launch.launches)
        check(launches["dwell_periodic"] == 1 and sum(launches.values()) == 1,
              f"periodic K2 {ny}x{nx}: launches {launches}")
        plain = mc.mandelbrot_field(dom, nx, ny, 500, device=dev)
        twin = mc.dwell_field_torch(dom, nx, ny, 500, device=dev, periodicity=True)
        d_plain, d_twin = int((per != plain).sum()), int((per != twin).sum())
        max_err = max(max_err, float((per - twin).abs().max()))
        print(f"K2 periodic {ny}x{nx}, max_iter 500: pixels differing from plain K2 "
              f"{d_plain}, from its twin {d_twin}")
        check(d_plain == 0 and d_twin == 0, f"periodic K2 {ny}x{nx} differs")

    # iteration counts at which pixels of the ragged grid escape on the last
    # step: dwells d of the grid with (d + 1) mod C at 1 and at C - 1
    ragged = mc.dwell_field_torch(dom, 1003, 130, 500, device=dev)
    dwells = sorted(set(int(v) for v in ragged.unique().tolist()) - {500})
    last_step = [next(d + 1 for d in dwells if d > 2 * c and (d + 1) % c == r)
                 for r in sorted({1 % c, (c - 1) % c})]
    last_hits = 0
    cases = periodic_schedule_cases(c, last_step)
    for label, cdom, ny, nx, max_iter in cases:
        per = mc.mandelbrot_field(cdom, nx, ny, max_iter, device=dev, periodicity=True)
        plain = mc.mandelbrot_field(cdom, nx, ny, max_iter, device=dev)
        twin = mc.dwell_field_torch(cdom, nx, ny, max_iter, device=dev, periodicity=True)
        d_plain, d_twin = int((per != plain).sum()), int((per != twin).sum())
        check(d_plain == 0 and d_twin == 0, f"periodic K2, {label} {ny}x{nx} at max_iter "
                                            f"{max_iter}: {d_plain} pixels differ from plain "
                                            f"K2, {d_twin} from its twin")
        caught_where(cdom, ny, nx, max_iter)
        if label == "last step":
            last_hits += int((per == max_iter - 1).sum())
    first_past = -(-(1 << c.bit_length()) // c) * c  # the chunk end of the first power above C
    print(f"K2 periodic schedule cases (footprint {foot}): {len(cases)} grids and iteration "
          "counts, " + ", ".join(f"{lab} {ny}x{nx}@{it}" for lab, _, ny, nx, it in cases)
          + f": 0 differing pixels each; cycles caught on chunk positions {sorted(positions)}, "
          f"against checkpoints set at steps {sorted(checkpoints)[:12]}; {last_hits} pixels "
          f"escape on the last step (max_iter {last_step})")
    # caught on the last step of a chunk; against the first checkpoint (step
    # C), and against one that moved at or after the first chunk end past the
    # power of two above C (a compare once a chunk catches a cycle against a
    # checkpoint only if its period divides the distance, so a later one will
    # do)
    check(positions == {c - 1}, f"cycles caught on chunk positions {sorted(positions)}, "
                                f"not {c - 1}")
    check(c in checkpoints and max(checkpoints) >= first_past,
          f"cycles caught against checkpoints {sorted(checkpoints)}: none of step {c}, or "
          f"none of step {first_past} or later")
    check(last_hits > 0, "no pixel escapes on the last step")

    ny, nx = DWELL_SHAPES[0]
    cr, ci = mc._grid_coords(dom, nx, ny, dev)
    interior = mc._interior_mask_torch(cr, ci)
    result = None
    for max_iter in (500, 20000):
        def run(periodicity):
            return mc.mandelbrot_field(dom, nx, ny, max_iter, device=dev,
                                       periodicity=periodicity)

        torch.cuda.synchronize()
        reset_launches()
        per = run(True)
        launched = _launch.launches["dwell_periodic"]  # of this one call
        plain = run(False)
        check(bool(torch.equal(plain, per)), f"periodic K2 differs at max_iter {max_iter}")
        # the steps each entry's pixels need and what its warps burn for them:
        # the plain kernel's on its footprint; the periodic entry's under its
        # own checkpoint schedule on its footprint, and under the
        # step-by-step schedule of its earlier design on one-row warps
        steps = {}
        steps["plain"], executed = (int(v) for v in bench.dwell_step_counts(
            plain, interior, max_iter))
        lane, caught = bench.periodic_lane_steps(cr, ci, max_iter, c)
        plain_lane = torch.where(interior, 0.0, (plain + 1.0).clamp(max=max_iter)).int()
        check(bool(torch.equal(lane[caught == 0], plain_lane[caught == 0])),
              "the periodic steps of the lanes no cycle caught differ from plain K2's")
        steps["periodic"] = int(lane.sum(dtype=torch.int64))
        executed_p = int(bench.warp_executed_steps(lane, foot))
        old_lane, _ = bench.periodic_lane_steps(cr, ci, max_iter, 1)
        steps["before"] = int(old_lane.sum(dtype=torch.int64))
        executed_old = int(bench.warp_executed_steps(old_lane, bench.ROW_WARP))
        turns = [(flag, cuda_ms(lambda: run(flag), 2, 10, CHAIN if max_iter == 500 else 4))
                 for flag in (False, True, True, False)]
        t = {flag: statistics.median(ms for f, ms in turns if f == flag)
             for flag in (False, True)}
        print(f"K2 {ny}x{nx}, max_iter {max_iter}, in turns (median ms per launch, back to "
              "back, CUDA events): "
              + ", ".join(f"{'periodic' if f else 'plain'} {ms:.4f}" for f, ms in turns))
        print(f"  steps needed: plain {steps['plain']}, periodic {steps['periodic']} "
              f"({steps['periodic'] / steps['plain']:.4f} of plain; {int((caught > 0).sum())} "
              f"cycles caught), periodic under the earlier step-by-step schedule "
              f"{steps['before']}; executed by their warps: plain {executed}, periodic "
              f"{executed_p} ({executed_p / executed:.4f} of plain; executed / useful "
              f"{executed_p / steps['periodic']:.4f}), the earlier design's one-row warps "
              f"{executed_old}; bounded pixels outside the analytic interior "
              f"{int(((plain == max_iter) & ~interior).sum())}; periodic is "
              f"{'faster' if t[True] < t[False] else 'slower'} by "
              f"{abs(t[True] - t[False]) / t[False] * 100:.1f}%")
        bound, by = bound_ms("dwell_periodic", steps["periodic"], 4 * nx * ny)
        bound_before, _ = least_ms(steps["before"] * OPS_BEFORE["dwell_periodic"], 4 * nx * ny)
        print(f"  bound {bound:.5f} ms ({by}, {mc.OPS_PER_STEP['dwell_periodic']} operations "
              f"a step); as the earlier design counted it ({OPS_BEFORE['dwell_periodic']} a "
              f"step, step-by-step checkpoints) {bound_before:.5f} ms")
        if max_iter == 500:
            plain_ms = cuda_ms(lambda: mc.dwell_field_torch(dom, nx, ny, 500, device=dev,
                                                            periodicity=True), 1, 3)
            graph_ms = cuda_ms(lambda: run(True), 2, 10, CHAIN, graph=True)
            print(f"  twin {plain_ms:.4f} ms; periodic replayed from a CUDA graph "
                  f"{graph_ms:.4f} ms")
            result = dict(launches=launched, max_abs_err=max_err, ms=t[True], plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by, graph_ms=graph_ms)
    return result


def phase_variograms(dev):
    """Phase 16: run_variograms at the defaults, f32 twice and f64 once."""
    import numpy as np
    import torch

    from cmtci_torch.pipelines.variograms import VariogramConfig, run_variograms

    gammas = ("gamma_construct", "gamma_mandelbrot", "gamma_cross")
    counts = ("counts_construct", "counts_mandelbrot", "counts_cross")
    runs = {}
    for label, dtype in (("f32 first", "float32"), ("f32 second", "float32"),
                         ("f64", "float64")):
        cfg = VariogramConfig(vario_dtype=dtype, field_dtype=dtype)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = run_variograms(cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[label] = out
        # the cloud, the boundary proxy's DE field and U_M
        launched(f"run_variograms {label}", {"aberth": 1, "orbit_de_std": 1,
                                              "orbit_potential": 1})
        print(f"variograms ({label}): {wall:.3f} s wall, {out['n_construct']} C points, "
              f"{out['n_boundary']} boundary points; layers (s): "
              + ", ".join(f"{k} {v:.4f}" for k, v in out["stage_times"].items()))
        for key in gammas:
            check(bool(np.isfinite(out[key]).all()), f"variograms {label}: {key} not finite")
    for key in counts:
        check(np.array_equal(runs["f32 first"][key], runs["f32 second"][key]),
              f"variograms: {key} differs between two f32 runs")
    rep = max(float(np.max(np.abs(runs["f32 first"][k] - runs["f32 second"][k])))
              for k in gammas)
    print(f"  two f32 runs: counts equal, largest |gamma difference| {rep!r}")

    # the self-variograms' totals against an independent count of the
    # subsample pairs under rmax, on the locations the pipeline drew
    cfg = VariogramConfig()
    xs = np.linspace(cfg.domain[0], cfg.domain[1], cfg.grid_nx)
    ys = np.linspace(cfg.domain[2], cfg.domain[3], cfg.grid_ny)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    coords = np.column_stack([gx.ravel(), gy.ravel()])
    for label, dt in (("f32 first", torch.float32), ("f64", torch.float64)):
        rng = np.random.RandomState(cfg.seed)
        for key in counts[:2]:
            idx = rng.choice(coords.shape[0], size=cfg.m_target, replace=False)
            c = torch.as_tensor(coords[idx], dtype=dt, device=dev)
            rmax = torch.as_tensor(cfg.rmax, dtype=dt, device=dev)
            pairs = 0
            for i in range(0, len(c), 2048):
                dx = c[i : i + 2048, 0, None] - c[None, :, 0]
                dy = c[i : i + 2048, 1, None] - c[None, :, 1]
                under = torch.sqrt(dx * dx + dy * dy) < rmax
                pairs += int(torch.triu(under, diagonal=i + 1).sum())
            total = int(runs[label][key].sum())
            print(f"  {label} {key}: total {total}, pairs under rmax {pairs}")
            check(total == pairs, f"variograms {label} {key}: {total} != {pairs} pairs")
    worst = 0.0
    for key in gammas:
        g32, g64 = runs["f32 first"][key], runs["f64"][key]
        m = g64 != 0
        rel = float(np.max(np.abs(g32[m] - g64[m]) / np.abs(g64[m])))
        worst = max(worst, rel)
        print(f"  f32 against f64 {key}: largest relative deviation {rel!r}")
    check(worst <= 1e-3, f"variograms: f32 gamma {worst!r} from f64, beyond 1e-3")


def phase_pointstats(dev):
    """Phase 17: the 150,000-point statistics' f32 paths against f64 on
    subsets, and the f32 Hausdorff's memory at full size."""
    import numpy as np
    import torch

    from cmtci_torch import bench
    from cmtci_torch.stats import embeddings as em
    from cmtci_torch.stats import pointstats as ps

    c1, c2 = bench.bench_clouds(150_000)
    sub = c1[:20_000]
    r, n32, _, _ = ps._shell_counts(sub, 0.5, 0.02, dtype=torch.float32, device=dev)
    _, n64, _, _ = ps._shell_counts(sub, 0.5, 0.02, dtype=torch.float64, device=dev)
    # pairs whose f64 distance sits within 4e-7 of a shell edge (the f32
    # coordinates and distance round at about 1e-7 at these magnitudes)
    edges = torch.as_tensor(np.concatenate([r, [r[-1] + 0.02]]), device=dev)
    xy = torch.as_tensor(sub, dtype=torch.float64, device=dev)
    near = torch.zeros(len(edges), dtype=torch.int64, device=dev)
    for i in range(0, len(xy), 1024):
        dx = xy[i : i + 1024, 0, None] - xy[None, i:, 0]
        dy = xy[i : i + 1024, 1, None] - xy[None, i:, 1]
        d = torch.sqrt(dx * dx + dy * dy)
        d = d[torch.ones_like(d, dtype=torch.bool).triu(diagonal=1)]  # pairs j > i
        for k in range(len(edges)):
            near[k] += ((d - edges[k]).abs() <= 4e-7).sum()
    near = near.cpu().numpy()
    diff = np.abs(n32 - n64)
    print(f"shell counts, 20,000 points: f64 total {int(n64.sum())}, f32 total "
          f"{int(n32.sum())}; shells that differ {int((diff > 0).sum())}, largest "
          f"difference {int(diff.max())}; pairs within 4e-7 of an edge {int(near.sum())}")
    check(bool((diff <= near[:-1] + near[1:]).all()),
          f"f32 shell counts differ from f64 by more than the edge pairs: {diff.tolist()}")
    check(abs(n32.sum() - n64.sum()) <= near[-1],
          f"f32 total {n32.sum()} vs f64 {n64.sum()}, edge pairs {near[-1]}")

    sub = c1[:5_000]
    k32, s32 = em.build_sparse_kernel(sub, k=20, dtype=torch.float32, device=dev)
    k64, s64 = em.build_sparse_kernel(sub, k=20, dtype=torch.float64, device=dev)
    a, b = k32.tocsr(), k64.tocsr()
    a.sort_indices()
    b.sort_indices()
    same = np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
    print(f"kNN kernel, 5,000 points, k 20: f32 and f64 neighbour sets "
          f"{'equal' if same else 'DIFFER'}; sigma {s32!r} vs {s64!r}")
    check(same, "the f32 kNN kernel's neighbour sets differ from the f64 search's")
    check(abs(s32 - s64) <= 1e-12 * s64, f"kNN sigma {s32!r} vs {s64!r}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    h = ps.hausdorff(c1, c2, dtype=torch.float32, device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"Hausdorff, 150,000 x 150,000 in f32: {h!r} in {wall:.3f} s wall, peak device "
          f"memory {peak:.2f} GiB")
    check(0 < h < 1 and peak < 40, f"Hausdorff {h!r}, peak {peak:.2f} GiB")


BENCH_KEYS = ("value", "dwell_entry_ms", "dwell_tflops", "vpu_peak_tflops", "dwell_mfu",
              "dwell_mfu_useful", "de_tflops", "de_mfu", "fp32_fma_bound_tflops",
              "escape_grid_res4096_mpix_s", "escape_grid_res8192_mpix_s", "spatial_stats_150k_s",
              "knn_150k_s", "eigensweep_s", "tracker_warm_s", "equipotential_s", "variograms_s",
              "uniformize_green_s", "uniformize_fem_s", "tci_4x_s", "coupling_s")
#: the kernels a bench run must launch: K1 (tracker_warm_s, tci_4x_s), K2, K3
#: (equipotential_s), K4, K7, aberth (every key with a cloud), and the
#: orbit.cu entries of variograms_s (the boundary proxy's DE field, U_M) and
#: coupling_s (U_M)
BENCH_KERNELS = ("tci_de", "dwell", "cloud_green", "de_std", "fma_peak", "aberth",
                 "orbit_de_std", "orbit_potential")


def phase_bench(dev):
    """Phase 18: cmtci_torch.bench at full size; returns the launches of its
    run."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import _launch

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    result = bench.run(bench.BenchSizes(), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_launch.launches)
    print(f"bench: {wall:.2f} s wall; launches {launches}")
    print(json.dumps(result))
    errors = [k for k in result if k.endswith("_error")]
    check(not errors, f"bench keys failed: { {k: result[k] for k in errors} }")
    for key in BENCH_KEYS:
        check(key in result, f"bench: {key} is missing")
        check(math.isfinite(result[key]) and result[key] > 0, f"bench: {key} = {result[key]!r}")
    check(result["not_ported"] == [], f"bench: not_ported {result['not_ported']}")
    check(not [k for k in result if "_vs_" in k or k.startswith("vs_")],
          "bench printed a ratio key")
    check(result["vpu_peak_tflops"] <= result["fp32_fma_bound_tflops"],
          f"vpu_peak_tflops {result['vpu_peak_tflops']} above the card's ceiling "
          f"{result['fp32_fma_bound_tflops']}")
    # K2's executed steps are counted on the footprint dwell.cu is built with
    # (phase 2 checked the two agree), so the keys can neither pass 1 nor
    # fall below the useful share
    check(result["dwell_mfu_useful"] <= result["dwell_mfu"] <= 1.0,
          f"dwell_mfu_useful {result['dwell_mfu_useful']} <= dwell_mfu {result['dwell_mfu']} "
          "<= 1 does not hold")
    check(result["de_mfu"] <= 1.0, f"de_mfu {result['de_mfu']} above 1")
    for name in BENCH_KERNELS:
        check(launches[name] >= 1, f"the bench run never launched {name}: {launches}")
    return launches


def best_of(fn, n: int = 3):
    """(best wall in s over n calls, each ending in a synchronize; the last
    call's result)."""
    import torch

    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return min(walls), out


def read_summary(path) -> dict:
    """A curvature summary file (the reference's format) as a dict."""
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0] == "Local-Polynomial Curvature Summary", f"{path}: header {lines[0]!r}")
    return {k: float(v) for k, v in (line.split(": ") for line in lines[1:])}


def close_to(a, b, tol: float) -> float:
    """max |a - b| after checking the shapes agree and it is within tol."""
    import numpy as np

    check(a.shape == b.shape, f"shapes {a.shape} and {b.shape}")
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    check(err <= tol, f"max |difference| {err!r} beyond {tol}")
    return err


def phase_bus(dev):
    """Phase 19: stage1, construct-boundary, curvature and lucas-boundary at
    the CLI defaults on the card, held to the port's CPU run and the frozen
    files."""
    import filecmp

    import numpy as np

    from cmtci_torch.io.loaders import load_points
    from cmtci_torch.kernels import companion
    from cmtci_torch.pipelines import curvature, lucas_boundary, stage1
    from cmtci_torch.transport.sinkhorn import sinkhorn_log
    from cmtci_torch.utils.artifacts import StageTimer

    cfg = stage1.Stage1Config()
    with tempfile.TemporaryDirectory() as tmp:
        timers = []

        def card_stage1():
            timers.append(StageTimer(dev))
            reset_launches()
            return stage1.run_stage1(cfg, f"{tmp}/card", plots=False, device=dev,
                                     timer=timers[-1])

        wall, out = best_of(card_stage1)
        # the last run alone: its cloud, its band field and its Sinkhorn loop
        launched("stage1, one run", {"aberth": 1, "orbit_de_stage1": 1, "sinkhorn": 1})
        reset_launches()
        best = min(timers, key=lambda t: sum(t.times.values()))
        print(f"stage1: {wall:.4f} s best of 3 on the card; layers (s) of the best run: "
              + ", ".join(f"{k} {v:.4f}" for k, v in best.times.items()))
        cpu = stage1.run_stage1(cfg, f"{tmp}/cpu", plots=False, device="cpu")
        print(f"  C {out['C'].shape}, M {out['M'].shape}")
        err_c = close_to(load_points(f"{tmp}/card/construct_points.csv"),
                         load_points(f"{tmp}/cpu/construct_points.csv"), 1e-12)
        for name in ("mandel_boundary_sample.csv", "matches_indices.csv", "meta.txt"):
            check(filecmp.cmp(f"{tmp}/card/{name}", f"{tmp}/cpu/{name}", shallow=False),
                  f"stage1: {name} differs between the card and the CPU")
        err_a = close_to(load_points(f"{tmp}/card/construct_aligned.csv"),
                         load_points(f"{tmp}/cpu/construct_aligned.csv"), 1e-10)
        de_s, (_, _, d_card) = best_of(lambda: stage1.band_field(cfg, device=dev))
        _, _, d_cpu = stage1.band_field(cfg, device="cpu")
        band_card = (d_card > cfg.threshold_low) & (d_card < cfg.threshold_high)
        band_cpu = (d_cpu > cfg.threshold_low) & (d_cpu < cfg.threshold_high)
        check(np.array_equal(band_card, band_cpu), "stage1: the band differs from the CPU's")
        m = d_cpu != 0
        print(f"  band {int(band_card.sum())} pixels on both (equal masks); d card against "
              f"CPU largest relative {float(np.max(np.abs(d_card[m] - d_cpu[m]) / d_cpu[m]))!r}; "
              f"600 draws and matches equal; C {err_c!r}, C_aligned {err_a!r}")

        xa = np.hstack([stage1.orientation_features(out["C"], cfg.k_orientation), out["C"]])
        xb = np.hstack([stage1.orientation_features(out["M"], cfg.k_orientation), out["M"]])
        cost = stage1.feature_cost(xa, xb, device=dev)
        sk_s, plan = best_of(lambda: sinkhorn_log(cost, iters=stage1.SINKHORN_ITERS,
                                                  eps=cfg.sinkhorn_reg))
        plan = plan.cpu().numpy()
        check(np.array_equal(plan.argmax(axis=1), out["matches"]),
              "stage1: the plan's argmax is not the pipeline's matches")
        top = np.sort(plan, axis=1)[:, -2:]
        gap = float(np.min((top[:, 1] - top[:, 0]) / top[:, 1]))
        print(f"  Sinkhorn loop ({cost.shape[0]} x {cost.shape[1]}, "
              f"{stage1.SINKHORN_ITERS} iterations) {sk_s:.4f} s, DE field "
              f"({cfg.ny} x {cfg.nx}, {cfg.max_iter} iterations, with its grid and its copy "
              f"to the host) {de_s:.4f} s, best of 3; "
              f"argmax equal to the matches; smallest top-1 to top-2 gap {gap!r} relative")

        golden = load_points(CONSTRUCT_GOLDEN)
        summaries = {}
        for side, device in (("card", dev), ("cpu", "cpu")):
            pts = load_points(f"{tmp}/{side}/construct_points.csv")
            cb_s, (b, closed) = best_of(lambda: lucas_boundary.construct_boundary(
                pts, lucas_boundary.ConstructBoundaryConfig()))
            cv_s, res = best_of(lambda: curvature.run_curvature(
                b, curvature.CurvatureConfig(), plots=False, device=device))
            summaries[side] = (b, res)
            print(f"  construct-boundary ({side} bus) {cb_s:.4f} s, closed {closed}; "
                  f"curvature on {side} {cv_s:.4f} s, best of 3")
        (b_card, r_card), (b_cpu, r_cpu) = summaries["card"], summaries["cpu"]
        err_b = close_to(b_card, b_cpu, 1e-10)
        k_card, k_cpu = r_card[0], r_cpu[0]
        k_err = np.abs(k_card - k_cpu) - 1e-10 * np.abs(k_cpu)
        check(float(np.max(k_err)) <= 1e-10 * float(np.max(np.abs(k_cpu))),
              f"curvature: kappa on the card {float(np.max(np.abs(k_card - k_cpu)))!r} "
              "from the CPU's")
        h = hausdorff(b_card, golden)
        check(h <= 1e-4, f"construct boundary: Hausdorff {h!r} from the golden")
        ref = read_summary(CONSTRUCT_SUMMARY)
        got = r_card[4]
        check(got["n"] == ref["n"], f"construct curvature: n {got['n']} != {ref['n']}")
        rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ("mean", "std", "q95")}
        check(max(rel.values()) <= 0.02, f"construct curvature: {rel} beyond 2%")
        print(f"  construct boundary card against CPU {err_b!r}, kappa largest |difference| "
              f"{float(np.max(np.abs(k_card - k_cpu)))!r} of max {float(np.max(k_cpu))!r}; "
              f"Hausdorff to the golden {h!r}; summary {json.dumps(got)}; "
              f"relative to the golden {json.dumps(rel)}")

        mandel = load_points(GOLDEN)
        cv_s, res = best_of(lambda: curvature.run_curvature(
            mandel, curvature.CurvatureConfig(), f"{tmp}/mandel", plots=False, device=dev))
        ref = read_summary(MANDEL_SUMMARY)
        check(read_summary(f"{tmp}/mandel_summary.txt").keys() == ref.keys(),
              "mandel curvature: the summary file's keys differ from the frozen file's")
        rel = {k: abs(res[4][k] - v) / abs(v) for k, v in ref.items()}
        check(max(rel.values()) <= 1e-8, f"mandel curvature: {rel} beyond 1e-8")
        print(f"curvature (mandel golden, {len(mandel)} vertices, k 7): {cv_s:.4f} s best of 3; "
              f"largest relative deviation from the frozen summary "
              f"{max(rel.values())!r}")

        lcfg = lucas_boundary.LucasBoundaryConfig()
        lb_s, xy = best_of(lambda: lucas_boundary.export_lucas_boundary(
            lcfg, f"{tmp}/run_lucas_points.npy", device=dev))
        cloud_s, cloud = best_of(lambda: companion.inverse_cloud(
            list(range(lcfg.n_min, lcfg.n_max + 1)), lcfg.family, device=dev))
        xy_cpu = lucas_boundary.export_lucas_boundary(lcfg, device="cpu")
        err_l = close_to(xy, xy_cpu, 1e-10)
        check(np.array_equal(np.load(f"{tmp}/run_lucas_points.npy"), xy),
              "lucas-boundary: the npy is not the returned boundary")
        print(f"lucas-boundary: {lb_s:.4f} s best of 3 ({len(cloud)} cloud points, the cloud "
              f"alone {cloud_s:.4f} s), {xy.shape[0]} points, card against CPU {err_l!r}")
    # after stage1's runs: the clouds, the band field and the Sinkhorn loop;
    # nothing else
    got = launched("the file bus", {"aberth": None, "orbit_de_stage1": None, "sinkhorn": None})
    print(f"  launches on the card: {got}")


#: the two buses of phase 20: the stage-1 defaults, and the 6x bus (max_n 100,
#: 2000 boundary samples: the 5,049-point cloud and all 1,624 band pixels)
SUITE_BUSES = (("default", []), ("6x", ["--max-n", "100", "--boundary-samples", "2000"]))
#: warm suite runs a bus and a path, after a first one, and runs of each
#: bus's stage1 alone; a stage's wall is the best of them. The 6x bus's
#: parity suite runs once: its coupling stage is host bound (its walls swing
#: with the host) and takes most of the phase
SUITE_WARM = 2


def run_cli(argv, layers=None) -> str:
    """cmtci_torch.cli.main(argv) in this process; its last line of output.
    `layers` (a StageTimer) takes the spatial-stats and coupling stages'
    layer spans."""
    import contextlib
    import io

    from cmtci_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, layers=layers)
    check(rc == 0, f"cmtci-torch {' '.join(argv)} returned {rc}")
    return buf.getvalue().strip().splitlines()[-1]


def tokens_close(path_a, path_b, rtol: float) -> float:
    """The largest relative difference between the numbers of two text files
    of one layout (split at commas, '=' and white space); every other token
    must be equal."""
    import re

    def tokens(path):
        with open(path) as f:
            return re.split(r"[,=\s]+", f.read().strip())

    a, b = tokens(path_a), tokens(path_b)
    check(len(a) == len(b), f"{path_a}: {len(a)} tokens against {len(b)}")
    worst = 0.0
    for x, y in zip(a, b):
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            check(x == y, f"{path_a}: {x!r} against {y!r}")
            continue
        if math.isnan(fx) or math.isnan(fy):
            check(math.isnan(fx) and math.isnan(fy), f"{path_a}: {x} against {y}")
            continue
        rel = abs(fx - fy) / max(abs(fx), abs(fy)) if fx != fy else 0.0
        check(rel <= rtol, f"{path_a}: {x} against {y}, relative {rel!r} beyond {rtol}")
        worst = max(worst, rel)
    return worst


def localcorr_close(got, want, flip_share: float, flat=None) -> dict:
    """Two local-correlation maps: the share of pixels whose NaN support
    differs, under `flip_share`; where both are finite, the largest
    |difference| (max_abs) and their correlation. With `flat` (the pixels
    whose window sees a flat U_M, where r is the rounding noise of the box
    sums), the NaN supports may differ only there, and max_abs leaves them
    out (noise_max_abs is theirs)."""
    import numpy as np

    check(got.shape == want.shape, f"local maps {got.shape} against {want.shape}")
    flat = np.zeros(got.shape, dtype=bool) if flat is None else flat
    n_g, n_w = np.isnan(got), np.isnan(want)
    flips = n_g != n_w
    check(flips.mean() < flip_share, f"local maps: NaN supports differ on {flips.mean()!r} "
                                     f"of the pixels")
    ok = ~(n_g | n_w)
    check(ok.mean() > 0.5, f"local maps: {ok.mean()!r} of the pixels finite on both")
    diff = np.abs(got - want)
    return dict(flips=float(flips.mean()), flips_outside_flat=int((flips & ~flat).sum()),
                max_abs=float(diff[ok & ~flat].max(initial=0.0)),
                noise_max_abs=float(diff[ok & flat].max(initial=0.0)),
                corr=float(np.corrcoef(got[ok], want[ok])[0, 1]))


def flat_um_windows(bus, dev):
    """The pixels of the coupling's local map whose window sees a flat f64
    U_M (no variance: r is 0/0 there, and the box sums leave rounding noise
    or NaN), on the grid run_coupling builds from the bus."""
    import numpy as np
    import torch

    from cmtci_torch.cli import _load_bus
    from cmtci_torch.kernels import mandelbrot as mb
    from cmtci_torch.pipelines.coupling import CouplingConfig
    from cmtci_torch.stats import fields

    cfg = CouplingConfig()
    c, m, _, _ = _load_bus(bus)
    allp = np.vstack([c, m])
    lo, hi = allp.min(axis=0) - 0.5, allp.max(axis=0) + 0.5
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], cfg.grid_res),
                         np.linspace(lo[1], hi[1], cfg.grid_res))
    u_m = mb.escape_potential_grid(torch.as_tensor(gx, device=dev), torch.as_tensor(gy, device=dev),
                                   max_iter=cfg.max_iter_mb, escape_r=cfg.escape_rad,
                                   normalization="k_plus_1")
    k = 2 * cfg.win_local_corr
    w = u_m.unfold(0, k, 1).unfold(1, k, 1)[:-1, :-1]
    flat = (w.amax(dim=(-2, -1)) == w.amin(dim=(-2, -1))).cpu().numpy()
    return fields.framed(flat, u_m.shape, cfg.win_local_corr) == 1.0


def eigvecs_dot(got, want) -> float:
    """The smallest |cos| between matching columns of two eigenvector sets
    (an eigenvector's sign is arbitrary)."""
    import numpy as np

    check(got.shape == want.shape, f"eigenvectors {got.shape} against {want.shape}")
    dots = np.abs((got * want).sum(0)) / (np.linalg.norm(got, axis=0)
                                          * np.linalg.norm(want, axis=0))
    return float(dots.min())


def read_rows(path) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def suite_accel_against_parity(parity, accel, bus, device) -> dict:
    """The accel stage paths against the parity ones, at the thresholds the
    reference holds its f32 paths to; returns the deviations."""
    import numpy as np
    import torch

    from cmtci_torch.io.loaders import load_points
    from cmtci_torch.stats import multifractal as mf

    dev = {}
    for name in ("spectral_slopes.txt", "spectral_bootstrap.csv", "report_phase5_summary.csv"):
        check(tokens_close(f"{parity}/{name}", f"{accel}/{name}", 0.0) == 0.0,
              f"{name} differs between the paths, which run it alike")
    # multifractal: the f32 count grid floors (x - xmin) / eps in f32, and the
    # band pixels are grid nodes, many of them on a box edge, so tau moves by
    # up to 3.6% from f64 at the 6x bus, exactly as the reference's f32 grid
    # does (tests/test_torch_multifractal.py holds the two equal on the CPU):
    # the card's f32 run is held to the same f32 path on the CPU
    for name, f in (("construct", "construct_points.csv"), ("mandel",
                                                             "mandel_boundary_sample.csv")):
        p = np.loadtxt(f"{parity}/multifractal_{name}_multifractal.csv", delimiter=",", skiprows=1)
        a = np.loadtxt(f"{accel}/multifractal_{name}_multifractal.csv", delimiter=",", skiprows=1)
        cpu = mf.multifractal_spectrum(load_points(f"{bus}/{f}"), backend="device",
                                       dtype=torch.float32, device="cpu")["tau"]
        card = float(np.nanmax(np.abs(a[:, 1] - cpu) / np.abs(cpu)))
        check(card <= 1e-5, f"multifractal {name}: the card's f32 tau {card!r} from the CPU's")
        dev[f"multifractal_{name}_tau_card_cpu"] = card
        dev[f"multifractal_{name}_tau_f32_f64"] = float(np.nanmax(np.abs(a[:, 1] - p[:, 1])
                                                                  / np.abs(p[:, 1])))
    # embeddings: the f32 Lanczos against eigsh. The reference's own device
    # Lanczos, f64 or f32, leaves 6.3e-4 on the default bus's construct cloud
    # and 1.6e-3 to 1.7e-3 on the 1,624 band pixels (m = 160, its basis rule)
    for name in ("construct", "mandel"):
        p = np.loadtxt(f"{parity}/embeddings_eigenvalues_{name}.csv", delimiter=",")
        a = np.loadtxt(f"{accel}/embeddings_eigenvalues_{name}.csv", delimiter=",")
        err = float(np.max(np.abs(a - p)))
        check(err <= 4e-3, f"embeddings {name}: eigenvalues {err!r} from eigsh")
        dev[f"embeddings_{name}_eig"] = err
    # symmetry: the op table's fractions within 0.02 (test_stats_more.py:371);
    # the f32 grid refine never scores below the coarse scan, the f64 bounded
    # refine can, so the best axis may move
    rp = read_rows(f"{parity}/symmetry_symmetry_report_bestaxis.csv")
    ra = read_rows(f"{accel}/symmetry_symmetry_report_bestaxis.csv")
    frac = max(abs(float(x[k]) - float(y[k])) for x, y in zip(rp[:-1], ra[:-1])
               for k in ("preserved_construct_frac", "preserved_mandel_frac"))
    check(frac <= 0.02, f"symmetry: op fractions {frac!r} apart")

    def score(row):
        return float(row["preserved_construct_frac"]) + float(row["preserved_mandel_frac"])

    check(score(ra[-1]) >= score(rp[-1]) - 0.02,
          f"symmetry: best axis scores {score(ra[-1])} against {score(rp[-1])}")
    dev["symmetry_frac"] = frac
    dev["symmetry_best_deg"] = (float(rp[-1]["angle_deg"]), float(ra[-1]["angle_deg"]))
    # spatial-stats: the f32 Hausdorff
    hp = float(read_rows(f"{parity}/spatial-stats_spatial_stats.csv")[0]["hausdorff"])
    ha = float(read_rows(f"{accel}/spatial-stats_spatial_stats.csv")[0]["hausdorff"])
    check(abs(ha - hp) <= 1e-6 * hp, f"spatial-stats: Hausdorff {ha} against {hp}")
    dev["hausdorff_rel"] = abs(ha - hp) / hp
    # coupling: the f32 variogram moves the range by f32 rounding, so the
    # trajectory within 1e-6; corr_pot within 1e-4 and corr_lap within 5e-3
    # (tests/test_review_r4b.py:372)
    cp = read_rows(f"{parity}/coupling_summary_metrics.csv")
    ca = read_rows(f"{accel}/coupling_summary_metrics.csv")
    traj = max(abs(float(x[k]) - float(y[k])) / abs(float(x[k])) for x, y in zip(cp, ca)
               for k in ("vario_range_a", "d_mean", "d_median", "d_max"))
    pot = max(abs(float(x["corr_pot"]) - float(y["corr_pot"])) for x, y in zip(cp, ca))
    lap = max(abs(float(x["corr_lap"]) - float(y["corr_lap"])) for x, y in zip(cp, ca))
    check(traj <= 1e-6 and pot <= 1e-4 and lap <= 5e-3,
          f"coupling: trajectory {traj!r}, corr_pot {pot!r}, corr_lap {lap!r}")
    dev.update(coupling_trajectory_rel=traj, coupling_corr_pot=pot, coupling_corr_lap=lap)
    # the local-correlation maps as tests/test_review_r4b.py:372-434 holds the
    # f32 ones: NaN supports apart on under 8% of the pixels, the frame NaN,
    # within 5e-2 and correlated above 0.999 where both are finite. The 5e-2
    # holds where the f64 U_M has a variance in the window: where it is flat,
    # a pixel that escapes in f32 and not in f64 gives the f32 window a
    # variance of its own (one pixel of the 6x bus's map, r 0.157, in a CPU
    # run of the port)
    win = 12  # CouplingConfig.win_local_corr
    flat = flat_um_windows(bus, device)
    worst = {}
    for it in range(1, len(cp) + 1):
        lp = np.load(f"{parity}/coupling_{it}_localcorr.npy")
        la = np.load(f"{accel}/coupling_{it}_localcorr.npy")
        frame = np.ones(lp.shape, dtype=bool)
        frame[win:-win, win:-win] = False
        check(np.isnan(lp[frame]).all() and np.isnan(la[frame]).all(),
              f"coupling {it}: a local map is finite on its frame")
        d = localcorr_close(la, lp, 0.08, flat=None)
        d.update({k: v for k, v in localcorr_close(la, lp, 0.08, flat=flat).items()
                  if k in ("max_abs", "noise_max_abs")})
        check(d["max_abs"] < 5e-2 and d["corr"] > 0.999, f"coupling {it}: local maps {d}")
        worst = {k: max(worst.get(k, v), v) if k != "corr" else min(worst.get(k, v), v)
                 for k, v in d.items()}
    dev["coupling_localcorr"] = worst
    return dev


def phase_suite(dev):
    """Phase 20: `cmtci-torch suite` at the default and the 6x bus on the
    card, on the CUDA-session defaults and with --parity, with the coupling
    stage's layers; at the default bus the parity run against
    the CPU's, file for file, the local maps and eigenvectors included."""
    import numpy as np

    from cmtci_torch import sweep_schedules as sweep
    from cmtci_torch.cli import _SUITE_STAGES
    from cmtci_torch.io.loaders import load_points
    from cmtci_torch.pipelines import stage1
    from cmtci_torch.utils.artifacts import StageTimer

    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for label, args in SUITE_BUSES:
            bus = f"{tmp}/bus_{label}"
            run_cli(["stage1", "--no-plots", *args, "--out", bus])
            n_c = len(load_points(f"{bus}/construct_aligned.csv"))
            n_m = len(load_points(f"{bus}/mandel_boundary_sample.csv"))
            # the bus's stage1 alone, with its layers (match: the features on the
            # host, the cost, the Sinkhorn kernel and the argmax)
            cfg = stage1.Stage1Config(**sweep.SINKHORN_BUSES[label])
            timers = []

            def one_stage1():
                timers.append(StageTimer(dev))
                stage1.run_stage1(cfg, None, plots=False, device=dev, timer=timers[-1])

            wall, _ = best_of(one_stage1, SUITE_WARM)
            best = min(timers, key=lambda t: sum(t.times.values()))
            print(f"stage1, {label} bus: {wall:.4f} s best of {SUITE_WARM}; layers (s) of the "
                  "best run: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in best.times.items()))
            lines = {}
            for paths, extra in (("accel", []), ("parity", ["--parity"])):
                # the default bus's first run of each path warms the process;
                # at the 6x bus every run is a warm one
                cold = int(label == "default")
                warm = 1 if (label, paths) == ("6x", "parity") else SUITE_WARM
                runs, timers = [], []
                for i in range(cold + warm):
                    timers.append(StageTimer(dev))
                    runs.append(json.loads(run_cli(
                        ["suite", "--busdir", bus, "--no-plots", "--out",
                         f"{tmp}/{label}_{paths}_{i}", *extra], layers=timers[-1])))
                check(all(list(r["stages"]) == list(_SUITE_STAGES) for r in runs),
                      f"suite: stages {runs[0]['stages']}")
                best = {st: min(r["stages"][st] for r in runs[cold:]) for st in _SUITE_STAGES}
                walls = [r["wall_s"] for r in runs]
                how = f"best of {warm} warm" if warm > 1 else "one warm run"
                print(f"suite, {label} bus ({n_c} C_aligned, {n_m} M), {paths}: stage walls "
                      f"(s, {how}) {json.dumps(best)}; suite walls "
                      f"{walls}{' (the first cold)' if cold else ''}")
                summary = {k: v for k, v in runs[-1].items() if k != "stages"}
                print(f"  summary {json.dumps(summary)}")
                # where the coupling stage's wall goes, in the run that set its best
                i = min(range(cold, len(runs)), key=lambda i: runs[i]["stages"]["coupling"])
                print(f"  spatial-stats and coupling layers (s) of that run (coupling "
                      f"{runs[i]['stages']['coupling']} s): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in timers[i].times.items()))
                for key in ("spectral_distance", "hausdorff", "coupling_d_mean"):
                    check(isinstance(runs[-1][key], float) and math.isfinite(runs[-1][key]),
                          f"suite {label} {paths}: {key} = {runs[-1][key]!r}")
                lines[paths] = runs[0]
            dev_acc = suite_accel_against_parity(f"{tmp}/{label}_parity_0",
                                                 f"{tmp}/{label}_accel_0", bus, dev)
            print(f"  accel against parity ({label} bus): {json.dumps(dev_acc)}")
            if label == "default":
                cpu = json.loads(run_cli(["suite", "--device", "cpu", "--busdir", bus,
                                          "--no-plots", "--out", f"{tmp}/default_cpu"]))
                worst = 0.0
                for key, want in cpu.items():
                    if key in ("stages", "wall_s"):
                        continue
                    got = lines["parity"][key]
                    check(got == want or (not isinstance(want, str)
                                          and abs(got - want) <= 1e-9 * abs(want)),
                          f"suite: the card's {key} {got!r} against the CPU's {want!r}")
                names = sorted(f for f in os.listdir(f"{tmp}/default_cpu")
                               if f.endswith((".csv", ".txt")))
                for name in names:
                    worst = max(worst, tokens_close(f"{tmp}/default_parity_0/{name}",
                                                    f"{tmp}/default_cpu/{name}", 1e-9))
                # the local maps: the f64 cumulative box sums run in another
                # order on the card, so the windows over a flat U_M, whose r is
                # rounding noise, may flip (tests/test_torch_coupling.py
                # measured 2.9% of the pixels against the reference on the
                # CPU), and elsewhere r moves by the sums' rounding: on the
                # 300² grid the CPU's map is within 4.4e-9 of the exact
                # per-window r (a CPU run of the port at the 6x bus)
                flat = flat_um_windows(bus, dev)
                maps = {}
                for it in range(1, len(read_rows(f"{tmp}/default_cpu/"
                                                 "coupling_summary_metrics.csv")) + 1):
                    name = f"coupling_{it}_localcorr.npy"
                    d = localcorr_close(np.load(f"{tmp}/default_parity_0/{name}"),
                                        np.load(f"{tmp}/default_cpu/{name}"), 0.03, flat)
                    check(d["flips_outside_flat"] == 0 and d["max_abs"] <= 1e-7,
                          f"{name}: card against CPU {d}")
                    maps[name] = d
                dots = {}
                for name in ("construct", "mandel"):
                    npy = f"embeddings_eigenvectors_{name}.npy"
                    dots[name] = eigvecs_dot(np.load(f"{tmp}/default_parity_0/{npy}"),
                                             np.load(f"{tmp}/default_cpu/{npy}"))
                    check(dots[name] > 1 - 1e-6, f"{npy}: |cos| {dots[name]!r} card against CPU")
                print(f"  local maps, card against CPU: {json.dumps(maps)}; eigenvectors, "
                      f"smallest |cos| {json.dumps(dots)}")
                # the same host draws on both sides: the CI ends differ only by the
                # order of the resample sums
                ci_err = tokens_close(f"{tmp}/default_parity_0/spectral_bootstrap.csv",
                                      f"{tmp}/default_cpu/spectral_bootstrap.csv", 1e-12)
                ci = read_rows(f"{tmp}/default_cpu/spectral_bootstrap.csv")
                print(f"  parity on the card against the CPU run: {len(names)} files, largest "
                      f"relative difference {worst!r}; summary within 1e-9; spectral CI ends "
                      f"within {ci_err!r} relative "
                      f"({np.array([[r['ci_lo'], r['ci_hi']] for r in ci]).tolist()})")
    # the bus's stage1 runs (cloud, band, Sinkhorn), coupling's U_M and the
    # box counts of spatial-stats and report
    got = launched("the suite", {"aberth": None, "orbit_de_stage1": None,
                                 "orbit_potential": None, "sinkhorn": None, "boxcount": None})
    print(f"  launches on the card: {got}")


#: warm runs of each conformal-map path in phase 21; a stage's time is the
#: best of them
GREEN_WARM, FEM_WARM = 2, 2
#: diagnostics.csv columns held by an absolute 1e-12 in phase 21: the inverse
#: check's errors sit at rounding level, and the two others are 0 by
#: construction (the g_shift calibration; C's median recompute)
GREEN_ABS_COLUMNS = ("inverse_err_median", "inverse_err_p90", "inverse_err_max",
                     "g_bdy_in_median", "bdy_resid_median")
FEM_KEYS = ("K_median", "mu_L2", "angle_median")


def green_rows_close(got: dict, want: dict) -> float:
    """Largest relative difference of two diagnostics rows over the numeric
    columns held relatively; fails beyond 1e-9 (abs 1e-12 on
    GREEN_ABS_COLUMNS)."""
    check(list(got) == list(want), f"diagnostics columns {list(got)} != {list(want)}")
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if isinstance(w, str):
            check(g == w, f"diagnostics {key}: {g!r} != {w!r}")
        elif key in GREEN_ABS_COLUMNS:
            check(abs(g - w) <= 1e-12, f"diagnostics {key}: {g!r} against {w!r} beyond 1e-12")
        else:
            rel = abs(g - w) / max(abs(w), 1e-300)
            check(rel <= 1e-9, f"diagnostics {key}: {g!r} against {w!r}, relative {rel!r}")
            worst = max(worst, rel)
    return worst


def phase_conformal(dev):
    """Phase 21: uniformize-green at its defaults in f64 and f32 on the card,
    f64 against the port's CPU run; uniformize-fem's four levels on the
    device solver against SuperLU."""
    import numpy as np

    from cmtci_torch.pipelines import uniformize_fem as fem_pipe
    from cmtci_torch.pipelines import uniformize_green as green
    from cmtci_torch.pipelines.lucas_boundary import LucasBoundaryConfig, export_lucas_boundary
    from cmtci_torch.utils.artifacts import StageTimer

    reset_launches()
    pts = export_lucas_boundary(LucasBoundaryConfig(), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for dtype in ("float64", "float32"):
            cfg = green.GreenUniformizeConfig(map_dtype=dtype)
            timers = []

            def card_run():
                timers.append(StageTimer(dev))
                return green.run_green_uniformization(pts, cfg, f"{tmp}/{dtype}",
                                                      timer=timers[-1], device=dev)

            wall, out = best_of(card_run, GREEN_WARM)
            best = {k: min(t.times[k] for t in timers) for k in timers[0].times}
            runs[dtype] = out
            diag = out["diagnostics"]
            print(f"uniformize-green {dtype} ({cfg.n_bdy} boundary nodes, {diag['INTERIOR_N']} "
                  f"interior points): {wall:.4f} s best of {GREEN_WARM} (walls "
                  f"{[round(sum(t.times.values()), 4) for t in timers]}); stages (s, best) "
                  + ", ".join(f"{k} {v:.4f}" for k, v in best.items()))
            print(f"  bdy_mod median {diag['bdy_mod_median']!r} max {diag['bdy_mod_max']!r}, "
                  f"inverse_err_max {diag['inverse_err_max']!r}, g_shift {diag['g_shift']!r}")
        d64, d32 = runs["float64"]["diagnostics"], runs["float32"]["diagnostics"]
        check(abs(d64["bdy_mod_median"] - 1.0) <= 1e-3,
              f"f64 bdy_mod_median {d64['bdy_mod_median']!r}")
        check(d64["inverse_err_max"] <= 1e-12, f"f64 inverse_err_max {d64['inverse_err_max']!r}")
        check(0.99 < d32["bdy_mod_median"] < 1.01, f"f32 bdy_mod_median {d32['bdy_mod_median']!r}")
        cpu_s = time.perf_counter()
        cpu = green.run_green_uniformization(pts, green.GreenUniformizeConfig(), f"{tmp}/cpu",
                                             device="cpu")
        cpu_s = time.perf_counter() - cpu_s
        rows = {side: read_rows(f"{tmp}/{side}/diagnostics.csv")[0]
                for side in ("float64", "cpu")}
        check(list(rows["float64"]) == list(rows["cpu"]), "diagnostics.csv columns differ")
        worst = green_rows_close(d64, cpu["diagnostics"])
        for key in ("lucas_interior", "disk_points_raw", "cardioid_points"):
            a = np.load(f"{tmp}/float64/map_state.npz")[key]
            b = np.load(f"{tmp}/cpu/map_state.npz")[key]
            check(a.shape == b.shape and np.allclose(a, b, rtol=1e-9, atol=1e-12),
                  f"map_state {key}: card against CPU {float(np.max(np.abs(a - b)))!r}")
        z64 = np.load(f"{tmp}/float64/map_state.npz")
        z32 = np.load(f"{tmp}/float32/map_state.npz")
        check(np.array_equal(z64["lucas_interior"], z32["lucas_interior"]),
              "f32 and f64 sampled other interior points")
        w64, w32 = z64["disk_points_raw"], z32["disk_points_raw"]
        dphase = float(np.quantile(np.abs(np.angle(w32 / np.where(w64 == 0, 1.0, w64))), 0.99))
        dmod = float(np.quantile(np.abs(np.abs(w32) - np.abs(w64)), 0.99))
        check(dphase <= 1e-3 and dmod <= 1e-3,
              f"f32 against f64: phase p99 {dphase!r}, |f| p99 {dmod!r}")
        print(f"  f64 on the card against the CPU ({cpu_s:.2f} s): diagnostics within "
              f"{worst!r} relative, map state within 1e-9; f32 against f64 on the interior "
              f"points: phase p99 {dphase!r} rad, |f| p99 {dmod!r}")

        fem = {}
        for solver in ("device", "spsolve"):
            cfg = fem_pipe.FEMUniformizeConfig(solver=solver)
            fem_pipe.run_fem_uniformization(cfg, device=dev)  # meshes, operators, factors
            wall, res = best_of(lambda: fem_pipe.run_fem_uniformization(cfg, device=dev),
                                FEM_WARM)
            fem[solver] = res
            print(f"uniformize-fem, {solver}: {wall:.4f} s best of {FEM_WARM} warm; K_median "
                  f"{[r['all']['K_median'] for r in res]}")
        dev_res, ref_res = fem["device"], fem["spsolve"]
        check(len(dev_res) == len(ref_res) == 4, f"{len(dev_res)} levels")
        check(dev_res[-1]["all"]["K_median"] < dev_res[0]["all"]["K_median"],
              "K_median does not fall from L0 to L3")
        worst = 0.0
        for got, want in zip(dev_res, ref_res):
            check(got["tag"] == want["tag"], f"tags {got['tag']} {want['tag']}")
            pairs = [(got["all"][k], want["all"][k], k) for k in FEM_KEYS]
            pairs.append((got["cr"]["lucas"]["abs_med"], want["cr"]["lucas"]["abs_med"],
                          "cr.lucas.abs_med"))
            for g, w, k in pairs:
                check(np.isclose(g, w, rtol=1e-7, atol=0.0), f"{want['tag']} {k}: {g!r} {w!r}")
                worst = max(worst, abs(g - w) / abs(w))
            for side in ("lucas", "cardioid"):
                g, w = got["period_mismatch"][side], want["period_mismatch"][side]
                check(abs(g - w) <= 1e-9, f"{want['tag']} period_mismatch {side}: {g!r} {w!r}")
        print(f"  device against SuperLU: largest relative difference {worst!r} over "
              f"{', '.join(FEM_KEYS)} and cr.lucas.abs_med at 4 levels; period mismatch "
              "within 1e-9")
    # the Lucas clouds of both maps
    got = launched("the conformal maps", {"aberth": None})
    print(f"  launches on the card: {got}")


#: phase 22: the dense tracker's last stage, the size the two-rank matcher
#: and histogram run at (37,820 cloud points against as many M points, 512 bins)
LAST_STAGE_POINTS, LAST_STAGE_BINS = 37820, 512


def _host(v):
    """numpy of a head's result (tensors, tuples of them, arrays)."""
    import numpy as np
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (tuple, list)):
        return tuple(_host(a) for a in v)
    return np.asarray(v)


def _timed_heads(heads: dict, repeat: int) -> tuple:
    """({name: result}, {name: s of the last of `repeat` calls}), each call
    between two device synchronizes."""
    import torch

    out, times = {}, {}
    for name, fn in heads.items():
        for _ in range(repeat):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = fn()
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
        out[name] = _host(v)
    return out, times


def multidevice_rank(x: dict, repeat: int = 1, mesh=None) -> dict:
    """Phase 22's calls on one rank of a group: each sharded head at the
    size its pipeline gives it, on multidevice_inputs' `x`, `repeat` times,
    with the last call's wall under "times" and this rank's kernel launches
    under "launches" (parallel.launch imports this function by name on each
    rank)."""
    import dataclasses

    import torch

    from cmtci_torch.kernels import _launch
    from cmtci_torch.parallel import sharded
    from cmtci_torch.pipelines.boundary import BoundaryConfig, compute_dwell
    from cmtci_torch.transport.histogram import mollified_histogram

    entered = time.time()
    f64 = BoundaryConfig(backend="torch")
    heads = {
        "dwell64": lambda: compute_dwell(f64, mesh=mesh),
        "dwell32": lambda: compute_dwell(dataclasses.replace(f64, backend="cuda"), mesh=mesh),
        **{name: (lambda dt=dt: sharded.sharded_de_tci_field(
            DOMAIN, GRIDS[-1], mesh, max_iter=MAX_ITER, escape_r=ESCAPE_R, dtype=dt))
           for name, dt in (("de64", torch.float64), ("de32", torch.float32))},
        "match": lambda: sharded.sharded_argmax_match(
            torch.as_tensor(x["c"], dtype=torch.float32),
            torch.as_tensor(x["m"], dtype=torch.float32), 0.8, mesh),
        "hist": lambda: mollified_histogram(x["c"][:, 0] + 1j * x["c"][:, 1],
                                            LAST_STAGE_BINS, DOMAIN, 3.0, mesh=mesh),
        "shells": lambda: sharded.sharded_shell_counts(x["bus_c"], 1.5, 0.05, mesh),
        "vario": lambda: sharded.sharded_point_variogram(x["bus_c"], x["bus_d"], nbins=50,
                                                         mesh=mesh),
        "green": lambda: sharded.sharded_green_cloud(x["green"], max_iter=2000, mesh=mesh),
        "green32": lambda: sharded.sharded_green_cloud_f32(x["green"], max_iter=2000,
                                                           mesh=mesh),
    }
    _launch.reset_launches()
    out, times = _timed_heads(heads, repeat)
    return {**out, "times": times, "launches": dict(_launch.launches), "entered": entered,
            "left": time.time()}


def single_heads(x: dict, dev, repeat: int = 1) -> tuple:
    """The single-device counterparts of multidevice_rank's heads on `dev`:
    ({name: result}, {name: s of the last of `repeat` calls})."""
    import dataclasses

    import torch

    from cmtci_torch.kernels import mandelbrot as mb
    from cmtci_torch.kernels import mandelbrot_cuda as mc
    from cmtci_torch.pipelines.boundary import BoundaryConfig, compute_dwell
    from cmtci_torch.stats import pointstats as ps
    from cmtci_torch.stats import variogram as vg
    from cmtci_torch.transport.histogram import mollified_histogram
    from cmtci_torch.transport.sinkhorn import _match_fused

    f64 = BoundaryConfig(backend="torch")

    def de(dt):
        cr, ci = mb.complex_grid(DOMAIN, GRIDS[-1], GRIDS[-1], dtype=dt, device=dev)
        return mb.de_field_tci(cr, ci, max_iter=MAX_ITER, escape_r=ESCAPE_R)[:2]

    heads = {
        "dwell64": lambda: compute_dwell(f64, device=dev),
        "dwell32": lambda: compute_dwell(dataclasses.replace(f64, backend="cuda"), device=dev),
        "de64": lambda: de(torch.float64),
        "de32": lambda: de(torch.float32),
        "match": lambda: _match_fused(torch.as_tensor(x["c"], dtype=torch.float32, device=dev),
                                      torch.as_tensor(x["m"], dtype=torch.float32, device=dev),
                                      0.8),
        "hist": lambda: mollified_histogram(x["c"][:, 0] + 1j * x["c"][:, 1],
                                            LAST_STAGE_BINS, DOMAIN, 3.0),
        "shells": lambda: ps._shell_counts(x["bus_c"], 1.5, 0.05, device=dev),
        "vario": lambda: vg.point_variogram_device(x["bus_c"], x["bus_d"], nbins=50,
                                                   device=dev),
        "green": lambda: mb.green_potential_compacted(x["green"], max_iter=2000, device=dev),
        "green32": lambda: mc.green_cloud_f32(x["green"], max_iter=2000, device=dev),
    }
    return _timed_heads(heads, repeat)


def multidevice_inputs(dev) -> dict:
    """The inputs of phase 22's heads, made once and passed to every rank:
    random clouds of the last tracker stage's size in the tracker's domain,
    the default stage-1 bus's clouds (built on `dev`) with the coupling's
    first distances, and the inverse-eigenvalue cloud of n = 2..20."""
    import numpy as np

    from cmtci_torch.kernels import companion
    from cmtci_torch.pipelines.stage1 import Stage1Config, run_stage1

    rng = np.random.default_rng(22)
    lo, hi = np.array(DOMAIN[0::2]), np.array(DOMAIN[1::2])
    bus = run_stage1(Stage1Config(), None, plots=False, device=dev)
    c, m = np.asarray(bus["C"], float), np.asarray(bus["M"], float)
    d = np.linalg.norm(c - m[np.asarray(bus["matches"]) % len(m)], axis=1)
    return {"c": rng.uniform(lo, hi, size=(LAST_STAGE_POINTS, 2)),
            "m": rng.uniform(lo, hi, size=(LAST_STAGE_POINTS, 2)),
            "bus_c": c, "bus_d": d,
            "green": np.concatenate(companion.inverse_cloud_split(list(range(2, 21)),
                                                                  device=dev))}


def _same(a, b) -> bool:
    import numpy as np

    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(map(_same, a, b))
    return np.array_equal(a, b, equal_nan=np.asarray(a).dtype.kind in "fc")


def check_heads_against_single(got: dict, want: dict, label: str) -> None:
    """Hold multidevice_rank's results to single_heads' on the same inputs:
    every head bitwise (the dwell through K2 in f32, the Green cloud through
    K3 in f32) but the point variogram's gamma (within 1e-12, its counts
    exact) and the f64 Green cloud's g (within 1e-10, k exact)."""
    import numpy as np

    for name in ("dwell64", "dwell32", "de64", "de32", "match", "hist", "shells", "green32"):
        check(_same(got[name], want[name]), f"{label}: {name} differs from the single device")
    (centers, gamma, counts), (gc, gg, gn) = want["vario"], got["vario"]
    g_err = float(np.nanmax(np.abs(gg - gamma) / np.abs(gamma)))
    check(np.array_equal(gn, counts) and np.array_equal(gc, centers) and g_err <= 1e-12,
          f"{label}: the point variogram differs ({g_err!r})")
    (g, k, _), (gg, gk, _) = want["green"], got["green"]
    nz = g != 0
    green_err = float(np.max(np.abs(gg[nz] - g[nz]) / np.abs(g[nz]))) if nz.any() else 0.0
    check(np.array_equal(gk, k) and np.array_equal(gg == 0, ~nz) and green_err <= 1e-10,
          f"{label}: the f64 Green cloud differs ({green_err!r})")
    print(f"  {label} held to single device: dwell f64 and K2 f32, DE f64/f32, matcher and "
          f"histogram, shells, K3 Green cloud bitwise; point variogram gamma within "
          f"{g_err!r}, f64 Green cloud within {green_err!r}")


def print_head_times(single: dict, ranks: dict, label: str) -> None:
    print(f"  head times (s), one card | {label}: " + ", ".join(
        f"{k} {single[k]:.4f} | {ranks[k]:.4f}" for k in single))


def phase_multidevice(dev):
    """Phase 22: multi-device on torch.distributed on the one card, doctor
    and the traces, one after another. A one-rank NCCL group runs the dense
    tracker with field_dtype float32 and de_impl torch, rows bitwise the
    single-device run's; --devices 2 on the one card is refused; doctor
    --smoke launches K2 (its launches are counted) and its checksum equals
    the twin's; tracker --trace-dir writes a torch.profiler trace that holds
    K1's kernel; last, a two-rank gloo group (both ranks on cuda:0: NCCL
    refuses two ranks on one card; gloo stages through host memory) runs the
    sharded heads at their pipelines' sizes, K2's row entry and K3 among
    them, each held to the port's single-device function on the card.
    Returns K2's launches."""
    import contextlib
    import dataclasses
    import glob
    import io

    import torch
    import torch.distributed as dist

    from cmtci_torch import cli
    from cmtci_torch.kernels import _launch
    from cmtci_torch.kernels import mandelbrot_cuda as mc
    from cmtci_torch.parallel import launch, sharded
    from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"  {label}: {wall:.3f} s wall")
        return out, wall

    # a one-rank NCCL group: the dense tracker, mesh against single device
    cfg = TrackerConfig(**DENSE, field_dtype="float32", de_impl="torch")
    reset_launches()
    single, _ = timed("dense tracker, f32 torch DE, single device",
                      lambda: run_tracker(cfg, device=dev))
    mesh = sharded.device_mesh(1, device=dev)
    check(mesh.backend == "nccl" and mesh.size == 1, f"one-rank mesh {mesh}")
    meshed, _ = timed("the same on a one-rank NCCL mesh",
                      lambda: run_tracker(cfg, device=dev, mesh=mesh))
    dist.destroy_process_group()
    # each run: an aberth and an orbit_de_tci launch a stage
    launched("f32 torch-DE tracker, single and one-rank mesh",
             {"aberth": 8, "orbit_de_tci": 8})
    strip = [[{**dataclasses.asdict(r), "runtime_sec": 0.0} for r in rows[0]]
             for rows in (single, meshed)]
    check(len(strip[0]) == 4 and strip[0] == strip[1],
          "one-rank NCCL mesh: the tracker rows differ from the single-device run's")

    # --devices 2 on one card is refused, never run on CPU ranks
    try:
        cli.main(["tracker", "--devices", "2", "--de-impl", "torch", "--out", "/dev/null"])
        check(False, "tracker --devices 2 ran on one card")
    except SystemExit as e:
        check("needs 2 devices" in str(e), f"tracker --devices 2: {e}")
        print(f"  tracker --devices 2 refused: {e}")

    # doctor --smoke: K2 on 512², max_iter 200
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(["doctor", "--smoke"]) == 0, "doctor --smoke failed")
    report = json.loads(buf.getvalue())
    k2_launches = _launch.launches["dwell"]
    check(sum(_launch.launches.values()) == k2_launches == 2,
          f"doctor --smoke launches {_launch.launches}")
    errors = [k for k in report if k.endswith("_error")]
    check(not errors, f"doctor: {errors}: {[report[k] for k in errors]}")
    want = float(mc.dwell_field_torch((-2.1, 0.9, -1.5, 1.5), 512, 512, 200, device=dev)
                 .sum(dtype=torch.float64))
    smoke = report["smoke"]
    check(smoke["checksum"] == want, f"doctor checksum {smoke['checksum']} != {want}")
    print(f"  doctor --smoke: checksum {smoke['checksum']!r} (twin {want!r}), first call "
          f"{smoke['compile_and_run_s']} s, warm {smoke['warm_s']} s, {k2_launches} K2 "
          f"launches; card {report['card']}, nvcc {report['nvcc']}, "
          f"{len(report['build']['libraries'])} kernel libraries built")

    # tracker --trace-dir: a torch.profiler trace per stage, K1's kernel in it
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["tracker", "--sigma-bins", "3.0", "--t-fixed", "25", "--bins-start", "64",
                "--bins-max", "64"]

        def quiet(*extra):
            with contextlib.redirect_stdout(io.StringIO()):
                return cli.main([*argv, *extra])

        timed("tracker, the same stage untraced", lambda: quiet("--out", f"{tmp}/plain"))
        reset_launches()
        check(timed("tracker --trace-dir (one stage, K1)", lambda: quiet(
            "--trace-dir", f"{tmp}/tr", "--out", f"{tmp}/t"))[0] == 0, "traced tracker")
        for name in ("plain", "t"):
            with open(f"{tmp}/{name}.json") as f:
                print(f"  {name} stage times (s): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in json.load(f)["stage_times"].items()))
        traces = sorted(glob.glob(f"{tmp}/tr/*.json"))
        names = set()
        for t in traces:
            with open(t) as f:
                names |= {e.get("name", "") for e in json.load(f)["traceEvents"]
                          if e.get("cat") == "kernel"}
        k1 = sorted(n for n in names if "tci_de_kernel" in n)
        check(_launch.launches["tci_de"] == 1 and k1,
              f"trace: K1 launches {_launch.launches['tci_de']}, kernels {sorted(names)[:8]}")
        print(f"  {len(traces)} traces ({sum(os.path.getsize(t) for t in traces)} bytes), "
              f"{len(names)} kernel names, K1 as {k1[0]!r}")

    # a two-rank gloo group on the one card, the heads once on each rank
    x = multidevice_inputs(dev)
    t0 = time.time()
    ranks = launch.run(2, [launch.Call("chip_smoke:multidevice_rank", (x,))],
                       devices=[dev, dev], threads=1)
    wall = time.time() - t0
    got = ranks[0]["results"][0]
    print(f"  two-rank gloo group on cuda:0: {wall:.3f} s wall; rank 0 reached its call "
          f"{got['entered'] - t0:.3f} s after the spawn began, left it "
          f"{got['left'] - t0:.3f} s after")
    check_ranks(ranks, 1)
    want, single_times = single_heads(x, dev)
    check_heads_against_single(got, want, "two gloo ranks on one card")
    print_head_times(single_times, got["times"], "two gloo ranks on one card, first call")
    return k2_launches


def check_ranks(ranks: list, repeat: int) -> None:
    """Every rank holds no jax and went through K2's row entry and K3."""
    for r in ranks:
        res = r["results"][0]
        check(r["foreign_modules"] == [], f"rank {r['rank']} holds {r['foreign_modules']}")
        check(res["launches"]["dwell_rows"] == repeat and res["launches"]["cloud_green"] >= 1,
              f"rank {r['rank']}: kernel launches {res['launches']}")
    print("  kernel launches a rank: " + ", ".join(
        f"rank {r['rank']} K2 rows {r['results'][0]['launches']['dwell_rows']}, K3 "
        f"{r['results'][0]['launches']['cloud_green']}" for r in ranks))


def phase_cards(n: int) -> None:
    """`python3 chip_smoke.py --cards N`, on a machine with N cards: the
    sharded heads on an N-rank NCCL group, one card a rank, each called
    twice, held to the single device on cuda:0, with each head's warm time
    on N cards beside its warm time on one; then `tracker --devices N` (the
    CLI spawning its own ranks) against the single-device tracker, rows
    equal."""
    import csv

    import torch

    from cmtci_torch import cli
    from cmtci_torch.kernels import _build
    from cmtci_torch.parallel import launch

    check(torch.cuda.device_count() >= n, f"--cards {n}: {torch.cuda.device_count()} cards")
    print(f"{n} cards: {[torch.cuda.get_device_name(i) for i in range(n)]}")
    dev = torch.device("cuda", 0)
    for name in ("dwell", "cloud_green", "aberth", "orbit"):
        _build.library(name)  # built once here, not by every rank at once
    x = multidevice_inputs(dev)
    want, single_times = single_heads(x, dev, repeat=2)
    t0 = time.perf_counter()
    ranks = launch.run(n, [launch.Call("chip_smoke:multidevice_rank", (x, 2))], device="cuda")
    print(f"  {n} NCCL ranks (spawn and all heads twice): {time.perf_counter() - t0:.3f} s wall")
    check_ranks(ranks, 2)
    got = ranks[0]["results"][0]
    check_heads_against_single(got, want, f"{n} NCCL ranks")
    print_head_times(single_times, got["times"], f"{n} NCCL ranks, second call")
    print(json.dumps({"head_times_s": {k: {"one_card": single_times[k], f"{n}_cards":
                                           got["times"][k]} for k in single_times}}))

    def rows(path):
        with open(path) as f:
            return [{k: v for k, v in r.items() if k != "runtime_sec"}
                    for r in csv.DictReader(f)]

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["tracker", "--de-impl", "torch", "--field-dtype", "float32", "--sigma-bins",
                "3.0", "--t-fixed", "25", "--bins-start", "64", "--bins-max", "128"]
        walls = []
        for extra, out in (([], "one"), (["--devices", str(n)], "many")):
            t0 = time.perf_counter()
            check(cli.main([*argv, *extra, "--out", f"{tmp}/{out}"]) == 0, f"tracker {extra}")
            walls.append(time.perf_counter() - t0)
        check(rows(f"{tmp}/one.csv") == rows(f"{tmp}/many.csv"),
              f"tracker --devices {n}: rows differ from the single device's")
        print(f"  tracker (2 stages): one card {walls[0]:.3f} s, --devices {n} "
              f"{walls[1]:.3f} s (the ranks' spawn included); rows equal")


def same_bits(a, b) -> bool:
    """Bitwise equal, NaN equal to NaN, over nested tuples."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def aberth_twin(ns, family, dev, **returns):
    """inverse_cloud_padded's eigenvalues as its CPU path computes them
    (eigvals_bucketed where the buckets pay, else eigvals_batched), through
    the eager twin aberth_roots_torch on `dev`."""
    from cmtci_torch.kernels import companion

    sweep = (companion.eigvals_bucketed if companion._bucketing_pays(ns)
             else companion.eigvals_batched)
    return sweep(ns, family, device=dev, roots=companion.aberth_roots_torch, **returns)


def aberth_against(label, got, want) -> tuple:
    """(max relative, max abs error, step difference) of aberth.cu's (zr, zi,
    valid, steps) against the twin's; the parked lanes equal."""
    import torch

    zr, zi, valid, steps = got
    wr, wi, wvalid, wsteps = want[:4]
    check(bool(torch.equal(valid, wvalid)), f"aberth {label}: valid lanes differ")
    err = torch.hypot(zr - wr, zi - wi)[valid]
    rel = float((err / torch.hypot(wr, wi)[valid]).max())
    check(rel <= ABERTH_RTOL, f"aberth {label}: roots {rel!r} relative from the twin's")
    check(bool(torch.equal(zr[~valid], wr[~valid]) and torch.equal(zi[~valid], wi[~valid])),
          f"aberth {label}: the parked lanes differ from the twin's")
    dsteps = int((steps - wsteps).abs().max())
    check(dsteps <= 1, f"aberth {label}: step counts differ by {dsteps}")
    return rel, float(err.max()), dsteps


def aberth_above_one_cta(dev):
    """Phase 23, Aberth at ABERTH_ABOVE_ONE_CTA: one launch against the twin
    on the host (a card's eager twin would issue about 165,000 launches a
    step), run after every timing of the phase so that nothing timed shares
    the host with it. Returns (max abs error, max relative error)."""
    import torch

    from cmtci_torch.kernels import companion

    zr, zi, valid, steps = companion.eigvals_one_launch(
        [ABERTH_ABOVE_ONE_CTA], "lucas_all_ones", device=dev, return_steps=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wr, wi, _, wsteps = (t.to(dev) for t in companion.eigvals_batched(
        [ABERTH_ABOVE_ONE_CTA], "lucas_all_ones", device="cpu",
        roots=companion.aberth_roots_torch, return_steps=True))
    twin_s = time.perf_counter() - t0
    # at this degree a few lanes of the two schedules end on neighbouring roots
    # (2 pi / n apart): the f32 repulsion's sums differ in their last bits and
    # the Horner form's rounding is large, so the lanes' paths part. The two
    # root sets are held at 1e-12: each kernel root's nearest twin root, one
    # to one
    z = torch.complex(zr[0], zi[0])
    w = torch.complex(wr[0], wi[0])
    dist = (z[:, None] - w[None, :]).abs()
    near = dist.argmin(dim=1)
    check(int(torch.unique(near).numel()) == z.numel(),
          f"degree {ABERTH_ABOVE_ONE_CTA}: the roots do not pair one to one with the twin's")
    err = float(dist.min(dim=1).values.max())
    rel = float((dist.min(dim=1).values / w[near].abs()).max())
    check(rel <= ABERTH_RTOL, f"degree {ABERTH_ABOVE_ONE_CTA}: roots {rel!r} from the twin's")
    dsteps = int((steps - wsteps).abs().max())
    check(dsteps <= 1, f"degree {ABERTH_ABOVE_ONE_CTA}: step counts differ by {dsteps}")
    moved = int((near != torch.arange(z.numel(), device=dev)).sum())
    limit = companion.aberth_max_degree(False)
    print(f"aberth degree {ABERTH_ABOVE_ONE_CTA} (Horner form; one CTA took at most 4,842, the "
          f"cluster of {companion.ABERTH_CLUSTER} takes {limit}): 1 launch; as a set within "
          f"{rel:.3e} relative of the twin's roots on the host, one to one, {moved} lanes on "
          f"another lane's root; steps {int(steps[0])} (twin {int(wsteps[0])}); the twin "
          f"{twin_s:.1f} s on the host ({torch.get_num_threads()} threads)")
    return err, rel


def loop_aberth(dev):
    """Phase 23, Aberth at ABERTH_CLOUDS: the launch against the twin,
    against the build with one CTA a polynomial (ABERTH_C1) bitwise, and its
    times; the kernels-line fields of the eigensweep (tracker stage 4) with
    the four tracker launches summed."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch import sweep_schedules as sweep
    from cmtci_torch.kernels import companion

    worst_rel = worst_abs = 0.0
    ms_of = {}
    props = torch.cuda.get_device_properties(dev)
    sm_rate = PEAK_FP32 / props.multi_processor_count
    for label, fam, ns in ABERTH_CLOUDS:
        reset_launches()
        got = companion.eigvals_one_launch(ns, fam, device=dev, return_steps=True)
        torch.cuda.synchronize()
        launched(f"aberth {label}", {"aberth": 1})
        want = aberth_twin(ns, fam, dev, return_lane_steps=True)
        rel, err, dsteps = aberth_against(label, got, want)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
        lanes = want[4]
        # the launch alone, from the start roots each time: the committed
        # build and the one with one CTA a polynomial, bitwise the same
        plan = companion._one_launch_plan(ns, fam, True, dev)
        kr, ki, ks, go = companion._aberth_prepare(*plan[:6], fam, 200, 1e-13, torch.float32)
        z0 = (kr.clone(), ki.clone())
        c1_args, c1_task = sweep.aberth_variant_args(sweep.launch_args(go), plan, ABERTH_C1,
                                                     dev)
        c1_entry = sweep.entry(ABERTH_C1_LIB[0], "aberth")

        def committed(kr=kr, ki=ki, z0=z0, go=go):
            kr.copy_(z0[0])
            ki.copy_(z0[1])
            go()

        def one_cta(kr=kr, ki=ki, z0=z0, args=c1_args, task=c1_task):
            kr.copy_(z0[0])
            ki.copy_(z0[1])
            rc = c1_entry(*args, sweep.stream(dev))
            check(rc == 0, f"aberth with CLUSTER 1 returned cudaError {rc}")

        for name, call in (("the committed launch", committed), ("CLUSTER 1", one_cta)):
            call()
            torch.cuda.synchronize()
            check(bool(torch.equal(kr, got[0]) and torch.equal(ki, got[1])
                       and torch.equal(ks, got[3])),
                  f"aberth {label}: {name} differs from eigvals_one_launch's")
        ms = cuda_ms(committed, 2, 10, CHAIN)
        graph_ms = cuda_ms(committed, 2, 10, CHAIN, graph=True)
        c1_ms = cuda_ms(one_cta, 2, 10, CHAIN, graph=True)
        wrapper_ms = cuda_ms(lambda: companion.eigvals_one_launch(ns, fam, device=dev), 1, 5)

        def built_anew():
            companion._CACHE.clear()
            companion.eigvals_one_launch(ns, fam, device=dev)

        built_ms = cuda_ms(built_anew, 1, 5)
        plain_ms = cuda_ms(lambda: aberth_twin(ns, fam, dev), 0, 1)
        # the f32 repulsion of the lanes not yet frozen: over the card, over
        # the one SM and over the cluster's SMs of the largest polynomial
        pairs = lanes.cpu() * torch.as_tensor(ns)
        card, by = least_ms(float(pairs.sum()) * ABERTH_OPS_PER_PAIR, 16 * sum(ns) * 2)
        one_sm = float(pairs.max()) * ABERTH_OPS_PER_PAIR / sm_rate * 1e3
        parts = companion.aberth_parts(max(ns))
        ms_of[label] = dict(ms=graph_ms, chained_ms=ms, cluster1_ms=c1_ms, plain_ms=plain_ms,
                            bound_ms=card, bound_by=by, bound_one_sm_ms=one_sm,
                            bound_cluster_ms=one_sm / parts, wrapper_ms=wrapper_ms,
                            wrapper_built_ms=built_ms, cluster=companion.ABERTH_CLUSTER)
        print(f"aberth {label} (n {ns[0]}..{ns[-1]}, {len(ns)} polynomials): 1 launch, roots "
              f"within {rel:.3e} relative of the twin, steps {int(got[3].min())}.."
              f"{int(got[3].max())} (twin {int(want[3].min())}..{int(want[3].max())}, |diff| "
              f"<= {dsteps}), {int(lanes.sum())} lane updates, bitwise the CLUSTER 1 build's; kernel "
              f"{graph_ms:.4f} ms (graph, {companion.ABERTH_CLUSTER} CTAs a cluster; {ms:.4f} "
              f"chained), one CTA a polynomial {c1_ms:.4f}; inverse_cloud_padded's eigenvalues "
              f"{wrapper_ms:.4f} ms with the plan cached, {built_ms:.4f} built anew; twin "
              f"{plain_ms:.2f} ms; bound {card:.5f} ms over the card ({by}), {one_sm:.5f} ms on "
              f"one SM, {one_sm / parts:.5f} on the largest polynomial's {parts}")
    tracker = [ms_of[f"tracker stage {i}"]["ms"] for i in range(1, 5)]
    print(f"aberth: the tracker's four launches {sum(tracker):.4f} ms in all (graph), one CTA a "
          f"polynomial {sum(ms_of[f'tracker stage {i}']['cluster1_ms'] for i in range(1, 5)):.4f}")
    print(f"  SM clock {bench.max_sm_clock_mhz(dev)} MHz (max)")
    return dict(ms_of["tracker stage 4"], tracker_ms=sum(tracker), max_abs_err=worst_abs,
                max_rel_err=worst_rel)


def eigvals_library(dev) -> dict:
    """torch.linalg.eigvals on the card on the companion matrices of the
    eigensweep (n 20..1220), one call a degree, summed: the yardstick of
    aberth.cu, which the port never calls. On torch's cuSOLVER backend where
    it has one (2.0 s against the default's 3.0 s at n = 1220 on an H100),
    each call timed on the host clock ending in a synchronize (the call
    synchronizes anyway); n = 1220 alone is that call of the sweep."""
    import torch

    from cmtci_torch.kernels import companion

    sweep = ABERTH_CLOUDS[3][2]
    mats = {n: torch.as_tensor(companion.companion_matrix(companion.family_top_row(
        "lucas_all_ones", n)), device=dev) for n in sweep}

    def one(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.linalg.eigvals(mats[n])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    default = torch.backends.cuda.preferred_linalg_library()
    try:
        try:
            torch.backends.cuda.preferred_linalg_library("cusolver")
        except RuntimeError:  # a torch built without cuSOLVER
            pass
        lib = str(torch.backends.cuda.preferred_linalg_library())
        one(sweep[0])
        each = {n: one(n) for n in sweep}
    except RuntimeError as exc:  # a torch built without a CUDA eigensolver: no yardstick
        print(f"torch.linalg.eigvals on the card failed ({exc}); library_ms null")
        return dict(library_ms=None)
    finally:
        torch.backends.cuda.preferred_linalg_library(default)
    total = sum(each.values())
    print(f"torch.linalg.eigvals on the card ({lib}): the eigensweep's {len(sweep)} companion "
          f"matrices, one call each, {total:.2f} ms in all, n = {sweep[-1]} "
          f"{each[sweep[-1]]:.2f} ms of it")
    return dict(library_ms=total, library_1220_ms=each[sweep[-1]])


def tci_steps_needed(cr, ci, max_iter: int, escape_r: float) -> int:
    """The steps orbit_de_tci ran for these points before its redesign (the
    earlier count, kept beside the redesign's): every step, but a point
    stopped once it escaped and its dz was NaN in both parts."""
    import torch

    zr, zi = torch.zeros_like(cr), torch.zeros_like(ci)
    dzr, dzi = torch.ones_like(cr), torch.zeros_like(ci)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    done = torch.zeros_like(esc)
    steps = torch.zeros(cr.shape, dtype=torch.int64, device=cr.device)
    for _ in range(max_iter):
        steps += ~done
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = zr * zr - zi * zi + cr, zr * zi + zi * zr + ci
        esc = esc | (torch.sqrt(zr * zr + zi * zi) > escape_r)
        done = done | (esc & torch.isnan(dzr) & torch.isnan(dzi))
    return int(steps.sum())


def escape_steps_needed(cr, ci, max_iter: int, r2: float) -> int:
    """The steps a loop that stops at the first |z|^2 > r2 runs: the escape
    step (1-based) or max_iter, from orbit_potential's loop state."""
    import torch

    from cmtci_torch.kernels import mandelbrot as mb

    esc, k, _, _ = mb._potential_loop_cuda(cr, ci, max_iter, r2)
    return int(torch.where(esc, k.long() + 1, max_iter).sum())


def abs_err(a, b) -> tuple:
    """(max |a - b| over the entries finite in both, the count of positions
    NaN in both), over nested tuples; integer and bool outputs as integers."""
    import torch

    if isinstance(a, (tuple, list)):
        parts = [abs_err(x, y) for x, y in zip(a, b)]
        return max(p[0] for p in parts), sum(p[1] for p in parts)
    if not a.is_floating_point():
        return (float((a.long() - b.long()).abs().max()) if a.numel() else 0.0), 0
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a - b).abs()[fin].max()) if bool(fin.any()) else 0.0
    return err, int((torch.isnan(a) & torch.isnan(b)).sum())


#: per orbit.cu entry, the largest |kernel - twin| (abs_err) over every case
#: phase 23 held it to, and the NaN positions the two shared
ORBIT_ERR: dict = {}


#: instructions a second the card issues outside the tensor cores, by dtype
#: (SMs x FP64_LANES or FP32_LANES x the maximum SM clock; set by loop_orbits)
INSTR_PER_S: dict = {}


def loop_orbit(name, label, kernel, twin, steps, nbytes, dtype=None, loop=None,
               plain_ms=None, needed_ops=None):
    """One orbit.cu entry against its twin on the card: the public function
    `kernel` launches once and is bitwise `twin` (NaN equal to NaN); its
    max |kernel - twin| over the finite entries goes into ORBIT_ERR. With
    `loop` (the pipeline's size), the times of loop, the launch alone (the
    epilogue copies a host scalar, which a CUDA graph cannot capture), and
    of the twin (plain_ms where the caller timed it), and the bound: the
    loop's operations on `steps` (ORBIT_OPS_PER_STEP each) over the dtype's
    peak, or the bytes, with the instruction floor (the operations over
    INSTR_PER_S). For the redesigned entries `needed_ops` are the operations
    the redesign needs on these inputs: the bound and floor come from them,
    and the count on `steps` stands beside them as bound_before_ms and
    floor_before_ms."""
    import torch

    torch.cuda.synchronize()
    reset_launches()
    got = kernel()
    torch.cuda.synchronize()
    launched(f"{name} {label}", {name: 1})
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = twin()
    stop.record()
    stop.synchronize()
    check(same_bits(got, want), f"{name} {label}: differs from the twin")
    err, nans = abs_err(got, want)
    worst, shared = ORBIT_ERR.get(name, (0.0, 0))
    ORBIT_ERR[name] = (max(worst, err), shared + nans)
    if loop is None:
        return None
    ms = cuda_ms(loop, 3, 10, CHAIN)
    graph_ms = cuda_ms(loop, 3, 10, CHAIN, graph=True)
    # the twin's one call above, between two CUDA events
    plain_ms = start.elapsed_time(stop) if plain_ms is None else plain_ms
    peak = PEAK_FP64 if dtype == torch.float64 else PEAK_FP32
    ops = steps * ORBIT_OPS_PER_STEP[name]
    t_bytes = nbytes / PEAK_BYTES * 1e3
    floor = ops / INSTR_PER_S[dtype] * 1e3
    extra = {}
    if needed_ops is not None:
        extra = dict(bound_before_ms=max(ops / peak * 1e3, t_bytes), floor_before_ms=floor,
                     ops_needed=needed_ops)
        ops = needed_ops
        floor = ops / INSTR_PER_S[dtype] * 1e3
    t_ops = ops / peak * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    print(f"{name} {label}: bitwise equal to the twin (max |kernel - twin| {err!r} over the "
          f"finite entries, {nans} NaN positions in both), 1 launch; kernel {graph_ms:.4f} ms "
          f"(graph; {ms:.4f} chained), twin {plain_ms:.2f} ms; {steps} steps, bound "
          f"{bound:.5f} ms ({by})")
    if needed_ops is None:
        print(f"  {name} instruction floor: {floor:.5f} ms ({ops} instructions)")
    else:
        print(f"  {name} redesign: {needed_ops} operations on the steps it needs, bound "
              f"{bound:.5f} ms ({by}), instruction floor {floor:.5f} ms; on the {steps} steps "
              f"of the earlier count: bound {extra['bound_before_ms']:.5f} ms, floor "
              f"{extra['floor_before_ms']:.5f} ms")
    return dict(ms=graph_ms, chained_ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                floor_ms=floor, shape=label, **extra)


def tci_contract(label, cr, ci, it):
    """orbit_de_tci's loop state bitwise its contract against the twin's
    (mandelbrot._de_tci_contract: the finite dz at the same escapers), and
    its second passes, counted on the card, as many as the twin's late
    escapers. Returns bench.orbit_tci_lane_steps (first, second, late), the
    twin's de_field_tci outputs and the ms of its one call (CUDA events)."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import mandelbrot as mb

    count = torch.zeros(1, dtype=torch.int32, device=cr.device)
    state = mb._de_tci_loop_cuda(cr, ci, it, ESCAPE_R, second_passes=count)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    twin = mb._de_tci_loop_torch(cr, ci, it, ESCAPE_R)
    public = mb._de_tci_epilogue(*twin, 1e-12)  # de_field_tci_torch's
    stop.record()
    stop.synchronize()
    check(same_bits(state, mb._de_tci_contract(twin, ESCAPE_R)),
          f"orbit_de_tci {label}: the loop state breaks its contract")
    fin = state[0] & torch.isfinite(state[3]) & torch.isfinite(state[4])
    twin_fin = twin[0] & torch.isfinite(twin[3]) & torch.isfinite(twin[4])
    check(torch.equal(fin, twin_fin), f"orbit_de_tci {label}: finite dz elsewhere than the twin's")
    first, second, late = bench.orbit_tci_lane_steps(cr, ci, it, ESCAPE_R)
    check(int(count.item()) == int(late.sum()),
          f"orbit_de_tci {label}: {int(count.item())} second passes, the twin has "
          f"{int(late.sum())} late escapers")
    return first, second, late, public, start.elapsed_time(stop)


def stage1_state(label, cr, ci, it, radius):
    """orbit_de_stage1's loop state bitwise the twin's
    (_de_latched_loop_torch by hypot, NaN equal to NaN), and its calls of
    hypot, counted on the card, as many as the committed schedule makes
    (bench.orbit_de_stage1_hypot_calls). Returns the count, the twin's
    de_field_stage1 outputs and the ms of its one call (CUDA events)."""
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import mandelbrot as mb

    count = torch.zeros(1, dtype=torch.int32, device=cr.device)
    state = mb._de_latched_loop_cuda(cr, ci, it, radius, True, hypot_calls=count)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    twin = mb._de_latched_loop_torch(cr, ci, it, radius, True)
    public = mb._de_stage1_epilogue(*twin)  # de_field_stage1_torch's
    stop.record()
    stop.synchronize()
    check(same_bits(state, twin), f"orbit_de_stage1 {label}: the loop state differs from the "
          "twin's")
    want = int(bench.orbit_de_stage1_hypot_calls(cr, ci, it, radius).sum())
    calls = int(count.item())
    check(calls == want, f"orbit_de_stage1 {label}: {calls} calls of hypot, the schedule "
          f"makes {want}")
    return calls, public, start.elapsed_time(stop)


def orbit_constants() -> dict:
    """csrc/orbit.cu's `constexpr int` schedule constants, from its text."""
    import re

    with open(os.path.join(ROOT, "cmtci_torch", "csrc", "orbit.cu")) as f:
        return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", f.read())}


def special_grid(dtype, dev):
    """A 14 x 14 grid of special coordinates on `dev`: NaN, +-inf, huge and
    tiny values, the set's landmarks and points near the f64 mask's rim, in
    every pairing of a real and an imaginary part (more rows than a warp's
    patch, so the compact footprint runs it)."""
    import numpy as np
    import torch

    huge = 1e300 if dtype == torch.float64 else 3e38
    xs = [np.nan, np.inf, -np.inf, huge, -huge, 0.0, -2.0, 0.25, -0.75, -1.25, 1e-300, 2.0,
          -1.0, 0.2285]
    ys = [np.nan, np.inf, -np.inf, huge, -huge, 0.0, 1e-3, 0.5, -0.56, 1.0, 2.0, -2.0, 0.1,
          1e154]
    gx, gy = np.meshgrid(np.array(xs), np.array(ys))
    return (torch.as_tensor(gx).to(dtype).to(dev).contiguous(),
            torch.as_tensor(gy).to(dtype).to(dev).contiguous())


def potential_contract(label, cr, ci, it, r2):
    """orbit_potential's loop state, with the skip and without it, bitwise
    its contract against the twin's (mandelbrot._potential_contract: the
    twin's, lz (NaN, NaN) at the skipped f64 interior points), and no
    escaper among the skipped points."""
    import torch

    from cmtci_torch.kernels import mandelbrot as mb

    twin = mb._potential_loop_torch(cr, ci, it, r2)
    for skip in (True, False):
        state = mb._potential_loop_cuda(cr, ci, it, r2, skip)
        check(same_bits(state, mb._potential_contract(twin, cr, ci, r2, skip)),
              f"orbit_potential {label}: the loop state (skip {skip}) breaks its contract")
    if cr.dtype == torch.float64:
        check(not bool(twin[0][mb.interior_f64(cr, ci)].any()),
              f"orbit_potential {label}: an f64 interior point escapes in the twin")


def loop_orbits(dev):
    """Phase 23, orbit.cu: each entry bitwise its twin at its pipeline's size,
    at max_iter 1 and on ragged grids; returns the kernels-line fields."""
    import numpy as np
    import torch

    from cmtci_torch import bench
    from cmtci_torch.kernels import mandelbrot as mb
    from cmtci_torch.pipelines import stage1
    from cmtci_torch.pipelines.analysis import TCIConfig
    from cmtci_torch.pipelines.coupling import CouplingConfig
    from cmtci_torch.pipelines.equipotential import EquipotentialConfig
    from cmtci_torch.pipelines.variograms import VariogramConfig

    f64 = torch.float64
    out = {}
    clock_hz = bench.max_sm_clock_mhz(dev) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    INSTR_PER_S.update({f64: sms * FP64_LANES * clock_hz,
                        torch.float32: sms * FP32_LANES * clock_hz})

    def grid(dom, nx, ny, dtype=f64):
        return mb.complex_grid(dom, nx, ny, dtype=dtype, device=dev)

    def small_cases(name, run):
        # max_iter 1 and ragged grids on the tracker's domain, f64 and f32
        for dt in (f64, torch.float32):
            for (ny, nx), it in (((3, 5), 1), ((1, 7), 2), ((37, 61), 7), ((129, 33), 300)):
                cr, ci = grid(DOMAIN, nx, ny, dt)
                k, t = run(cr, ci, it)
                loop_orbit(name, f"{ny}x{nx} {dt} {it} it.", k, t, 0, 0)

    def dwell_ops(cr, ci, d, it):
        """The redesign's operations: a carried step for each step its points
        need outside the f64 interior."""
        return int(bench.orbit_dwell_lane_steps(cr, ci, d, it).sum()) * CARRIED_STEP_OPS

    # the boundary's f64 dwell: 2000 x 2000, 500 steps; beside it a row slice,
    # one row as a 1-D input, and the cardioid-bulb junction at 2,000 steps
    t_added = time.perf_counter()
    cr, ci = grid(BOUNDARY_DOMAIN, 2000, 2000)
    d = mb.dwell_grid(cr, ci, 500)
    steps = int(torch.where(d < 500, d.long() + 1, 500).sum())
    out["orbit_dwell"] = loop_orbit("orbit_dwell", "2000x2000 f64, 500 it.",
                                    lambda: mb.dwell_grid(cr, ci, 500),
                                    lambda: mb.dwell_grid_torch(cr, ci, 500), steps,
                                    2000 * 2000 * 20, f64,
                                    loop=lambda: mb._dwell_cuda(cr, ci, 500),
                                    needed_ops=dwell_ops(cr, ci, d, 500))
    small_cases("orbit_dwell", lambda cr, ci, it: (lambda: mb.dwell_grid(cr, ci, it),
                                                   lambda: mb.dwell_grid_torch(cr, ci, it)))
    for dt in (f64, torch.float32):
        cr, ci = grid(BOUNDARY_DOMAIN, 2000, 2000, dt)
        for label, a, b in ((f"rows 700..899 of 2000x2000 {dt}", cr[700:900], ci[700:900]),
                            (f"row 1000 of 2000x2000 {dt}, 1-D", cr[1000], ci[1000])):
            loop_orbit("orbit_dwell", label, lambda a=a, b=b: mb.dwell_grid(a, b, 500),
                       lambda a=a, b=b: mb.dwell_grid_torch(a, b, 500), 0, 0)
    cr, ci = grid(JUNCTION, 1000, 1000)
    d = mb.dwell_grid(cr, ci, 2000)
    loop_orbit("orbit_dwell", "1000x1000 f64 over the cardioid-bulb junction, 2000 it.",
               lambda: mb.dwell_grid(cr, ci, 2000), lambda: mb.dwell_grid_torch(cr, ci, 2000),
               int(torch.where(d < 2000, d.long() + 1, 2000).sum()), 1000 * 1000 * 20, f64,
               loop=lambda: mb._dwell_cuda(cr, ci, 2000), needed_ops=dwell_ops(cr, ci, d, 2000))
    dwell_added = time.perf_counter() - t_added

    # de_field_tci: the tracker's grids in f64 and f32, run_tci's domain at
    # 912, then a row slice, one row as a 1-D input and the junction; each
    # loop state held to its contract, its second passes counted
    t_added = time.perf_counter()
    tci = TCIConfig()
    cases = ([(DOMAIN, g, dt) for g in GRIDS for dt in (f64, torch.float32)]
             + [(tci.domain, 912, f64)])
    late_counts = {}
    for dom, g, dt in cases:
        cr, ci = grid(dom, g, g, dt)
        size = 8 if dt == f64 else 4
        label = f"{g}x{g} {dt}" + (" (run_tci's domain)" if dom != DOMAIN else "")
        first, second, late, public, twin_ms = tci_contract(label, cr, ci, MAX_ITER)
        late_counts[label] = int(late.sum())
        res = loop_orbit("orbit_de_tci", label,
                         lambda: mb.de_field_tci(cr, ci, MAX_ITER, ESCAPE_R), lambda: public,
                         tci_steps_needed(cr, ci, MAX_ITER, ESCAPE_R),
                         g * g * (2 * size + 1 + 4 * size), dt,
                         loop=lambda: mb._de_tci_loop_cuda(cr, ci, MAX_ITER, ESCAPE_R),
                         plain_ms=twin_ms, needed_ops=int(first.sum()) * CARRIED_STEP_OPS
                         + int(second.sum()) * LATE_STEP_OPS)
        print(f"  orbit_de_tci {label}: {int(first.sum())} z-only steps outside the mask, "
              f"{int(late.sum())} late escapers ({int(second.sum())} (z, dz) steps), the "
              "same count of second passes on the card; finite dz where the twin's")
        if (dom, g, dt) == (DOMAIN, GRIDS[1], f64):  # the f64 tracker's second stage
            out["orbit_de_tci"] = dict(res, late_escapers=late_counts[label])
    small_cases("orbit_de_tci", lambda cr, ci, it: (lambda: mb.de_field_tci(cr, ci, it),
                                                    lambda: mb.de_field_tci_torch(cr, ci, it)))
    for dt in (f64, torch.float32):
        for (ny, nx), it in (((3, 5), 1), ((1, 7), 2), ((37, 61), 7), ((129, 33), 300)):
            tci_contract(f"{ny}x{nx} {dt} {it} it.", *grid(DOMAIN, nx, ny, dt), it)
        cr, ci = grid(DOMAIN, 912, 912, dt)
        for label, a, b in ((f"rows 300..399 of 912x912 {dt}", cr[300:400], ci[300:400]),
                            (f"row 456 of 912x912 {dt}, 1-D", cr[456], ci[456])):
            public = tci_contract(label, a, b, MAX_ITER)[3]
            loop_orbit("orbit_de_tci", label,
                       lambda a=a, b=b: mb.de_field_tci(a, b, MAX_ITER, ESCAPE_R),
                       lambda public=public: public, 0, 0)
    cr, ci = grid(JUNCTION, 1000, 1000)
    label = "1000x1000 f64 over the cardioid-bulb junction, 2000 it."
    first, second, late, public, twin_ms = tci_contract(label, cr, ci, 2000)
    loop_orbit("orbit_de_tci", label, lambda: mb.de_field_tci(cr, ci, 2000, ESCAPE_R),
               lambda: public, tci_steps_needed(cr, ci, 2000, ESCAPE_R), 1000 * 1000 * 49, f64,
               loop=lambda: mb._de_tci_loop_cuda(cr, ci, 2000, ESCAPE_R), plain_ms=twin_ms,
               needed_ops=int(first.sum()) * CARRIED_STEP_OPS
               + int(second.sum()) * LATE_STEP_OPS)
    tci_added = time.perf_counter() - t_added
    print(f"phase 23's orbit_dwell cases {dwell_added:.1f} s, orbit_de_tci cases "
          f"{tci_added:.1f} s wall (checks and timings)")

    consts = orbit_constants()

    def std_ops(cr, ci, it):
        """The redesign's operations: a step for each step its points need
        outside the f64 interior, of z alone (CARRIED_STEP_OPS) with a (z,
        dz) step (STD_SECOND_STEP_OPS) for each step of the escapers' second
        pass, or of z and dz (STD_CARRIED_DZ_STEP_OPS) where orbit.cu carries
        dz in the first pass for the dtype."""
        first, second = bench.orbit_de_std_lane_steps(cr, ci, it, 4.0)
        if consts["STD_DZ_CARRIED_F64" if cr.dtype == f64 else "STD_DZ_CARRIED_F32"]:
            return int(first.sum()) * STD_CARRIED_DZ_STEP_OPS
        return int(first.sum()) * CARRIED_STEP_OPS + int(second.sum()) * STD_SECOND_STEP_OPS

    # de_field_std: the variograms' boundary proxy, 700 x 700, 600 steps, in
    # f64 and f32; the ragged grids, a special-values grid and the junction at
    # 2,000 steps
    t_added = time.perf_counter()
    vc = VariogramConfig()
    for dt in (f64, torch.float32):
        cr, ci = grid(vc.domain, vc.boundary_grid, vc.boundary_grid, dt)
        size = 8 if dt == f64 else 4
        res = loop_orbit("orbit_de_std", f"{vc.boundary_grid}^2 {dt}, "
                         f"{vc.boundary_max_iter} it.",
                         lambda: mb.de_field_std(cr, ci, vc.boundary_max_iter),
                         lambda: mb.de_field_std_torch(cr, ci, vc.boundary_max_iter),
                         escape_steps_needed(cr, ci, vc.boundary_max_iter, 16.0),
                         cr.numel() * (2 * size + 1 + 4 * size), dt,
                         loop=lambda: mb._de_latched_loop_cuda(cr, ci, vc.boundary_max_iter, 4.0,
                                                               False),
                         needed_ops=std_ops(cr, ci, vc.boundary_max_iter))
        if dt == f64:
            out["orbit_de_std"] = res
    small_cases("orbit_de_std", lambda cr, ci, it: (lambda: mb.de_field_std(cr, ci, it),
                                                    lambda: mb.de_field_std_torch(cr, ci, it)))
    for dt in (f64, torch.float32):
        cr, ci = special_grid(dt, dev)
        for it in (1, 7, vc.boundary_max_iter):
            loop_orbit("orbit_de_std", f"special values {tuple(cr.shape)} {dt}, {it} it.",
                       lambda cr=cr, ci=ci, it=it: mb.de_field_std(cr, ci, it),
                       lambda cr=cr, ci=ci, it=it: mb.de_field_std_torch(cr, ci, it), 0, 0)
    cr, ci = grid(JUNCTION, 1000, 1000)
    loop_orbit("orbit_de_std", "1000x1000 f64 over the cardioid-bulb junction, 2000 it.",
               lambda: mb.de_field_std(cr, ci, 2000), lambda: mb.de_field_std_torch(cr, ci, 2000),
               escape_steps_needed(cr, ci, 2000, 16.0), 1000 * 1000 * 49, f64,
               loop=lambda: mb._de_latched_loop_cuda(cr, ci, 2000, 4.0, False),
               needed_ops=std_ops(cr, ci, 2000))
    std_added = time.perf_counter() - t_added

    def s1_ops(cr, ci, it, radius):
        """The redesign's operations (as std_ops, on orbit_de_stage1's
        steps and S1_DZ_CARRIED_*) and the deepest lane's steps: the first
        pass's, with the second pass's where dz takes one."""
        first, second = bench.orbit_de_stage1_lane_steps(cr, ci, it, radius)
        if consts["S1_DZ_CARRIED_F64" if cr.dtype == f64 else "S1_DZ_CARRIED_F32"]:
            return int(first.sum()) * STD_CARRIED_DZ_STEP_OPS, int(first.max())
        return (int(first.sum()) * CARRIED_STEP_OPS + int(second.sum()) * STD_SECOND_STEP_OPS,
                int((first + second).max()))

    # de_field_stage1: stage1's band field, 80 x 120, 200 steps, R 1e6, in
    # f64 (the kernels line's) and f32; the ragged grids, the special-values
    # grid, two radii outside the band's range and the junction at 2,000
    # steps, each loop state held to the twin's and its hypot calls counted
    t_added = time.perf_counter()
    sc = stage1.Stage1Config()
    xs = np.linspace(stage1.BAND_DOMAIN[0], stage1.BAND_DOMAIN[1], sc.nx)
    ys = np.linspace(stage1.BAND_DOMAIN[2], stage1.BAND_DOMAIN[3], sc.ny)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    timed = [(f"{sc.ny}x{sc.nx} {dt}, {sc.max_iter} it., R {sc.bailout:g}",
              torch.as_tensor(gx, device=dev).to(dt), torch.as_tensor(gy, device=dev).to(dt),
              sc.max_iter) for dt in (f64, torch.float32)]
    timed.append(("1000x1000 f64 over the cardioid-bulb junction, 2000 it., R 1e+06",
                  *grid(JUNCTION, 1000, 1000), 2000))
    for label, cr, ci, it in timed:
        calls, public, twin_ms = stage1_state(label, cr, ci, it, sc.bailout)
        ops, deepest = s1_ops(cr, ci, it, sc.bailout)
        size = 8 if cr.dtype == f64 else 4
        res = loop_orbit("orbit_de_stage1", label,
                         lambda cr=cr, ci=ci, it=it: mb.de_field_stage1(cr, ci, it, sc.bailout),
                         lambda public=public: public,
                         escape_steps_needed(cr, ci, it, sc.bailout * sc.bailout),
                         cr.numel() * (2 * size + 1 + 4 * size), cr.dtype,
                         loop=lambda cr=cr, ci=ci, it=it: mb._de_latched_loop_cuda(
                             cr, ci, it, sc.bailout, True),
                         plain_ms=twin_ms, needed_ops=ops)
        # the chain of the deepest lane: 3 dependent instructions a step at
        # the dtype's measured latency
        cycles = FP64_DEPENDENT_CYCLES if cr.dtype == f64 else FP32_DEPENDENT_CYCLES
        chain = deepest * 3 * cycles / clock_hz * 1e3
        res.update(bound_chain_ms=chain, deepest_steps=deepest, hypot_calls=calls)
        print(f"  orbit_de_stage1 {label} chain bound: {deepest} steps x 3 dependent "
              f"instructions x {cycles} cycles at {clock_hz / 1e9:.3f} GHz = {chain:.5f} ms; "
              f"{calls} calls of hypot, the schedule's count")
        if label == timed[0][0]:
            out["orbit_de_stage1"] = res
    for dt in (f64, torch.float32):
        for (ny, nx), it in (((3, 5), 1), ((1, 7), 2), ((37, 61), 7), ((129, 33), 300)):
            label = f"{ny}x{nx} {dt} {it} it."
            cr, ci = grid(DOMAIN, nx, ny, dt)
            public = stage1_state(label, cr, ci, it, sc.bailout)[1]
            loop_orbit("orbit_de_stage1", label, lambda cr=cr, ci=ci, it=it:
                       mb.de_field_stage1(cr, ci, it, sc.bailout),
                       lambda public=public: public, 0, 0)
        sg = special_grid(dt, dev)
        small = grid(DOMAIN, 61, 37, dt)
        for (cr, ci), what, it, rad in ([(sg, "special values", it, sc.bailout)
                                         for it in (1, 7, sc.max_iter)]
                                        + [(g, what, it, rad) for rad in (1e-200, 1e300)
                                           for g, what, it in ((sg, "special values", 7),
                                                               (small, "37x61", 60))]):
            label = f"{what} {tuple(cr.shape)} {dt}, {it} it., R {rad:g}"
            public = stage1_state(label, cr, ci, it, rad)[1]
            loop_orbit("orbit_de_stage1", label, lambda cr=cr, ci=ci, it=it, rad=rad:
                       mb.de_field_stage1(cr, ci, it, rad), lambda public=public: public, 0, 0)
    stage1_added = time.perf_counter() - t_added

    # the Green loop on the equipotential's default cloud: the first and a
    # resumed stage; then the one launch over the whole budget the f64
    # equipotential runs, against the compacted loop on the twin and on the
    # kernel's stages
    ec = EquipotentialConfig()
    pts = default_cloud(dev)
    pr = torch.as_tensor(pts.real.copy(), device=dev)
    pi = torch.as_tensor(pts.imag.copy(), device=dev)
    zero = torch.zeros_like(pr)
    r2 = ec.escape_radius * ec.escape_radius
    first = mb._green_stage(zero, zero, pr, pi, 0, 512, r2, ec.max_iter)
    loop_orbit("orbit_green", f"{len(pts)} points f64, the first stage of 512",
               lambda: mb._green_stage(zero, zero, pr, pi, 0, 512, r2, ec.max_iter),
               lambda: mb._green_stage_torch(zero, zero, pr, pi, 0, 512, r2, ec.max_iter),
               0, 0)
    zr1, zi1 = first[0], first[1]
    loop_orbit("orbit_green", "resumed from the first stage's state, k0 512",
               lambda: mb._green_stage(zr1, zi1, pr, pi, 512, 512, r2, ec.max_iter),
               lambda: mb._green_stage_torch(zr1, zi1, pr, pi, 512, 512, r2, ec.max_iter),
               0, 0)
    small_cases("orbit_green", lambda cr, ci, it: (
        lambda: mb._green_stage(torch.zeros_like(cr), torch.zeros_like(ci), cr, ci, 0, it, 4.0,
                                it),
        lambda: mb._green_stage_torch(torch.zeros_like(cr), torch.zeros_like(ci), cr, ci, 0, it,
                                      4.0, it)))

    def as_tensors(arrays):
        """(g, k, phi) as tensors, phi as its real and imaginary parts."""
        g, k, phi = arrays
        return tuple(torch.as_tensor(a) for a in (g, k, phi.real.copy(), phi.imag.copy()))

    reset_launches()
    t0 = time.perf_counter()
    staged = mb.green_potential_compacted(pts, ec.max_iter, ec.escape_radius, device=dev)
    staged_s = time.perf_counter() - t0
    stages = launched("green_potential_compacted", {"orbit_green": None})["orbit_green"]
    t0 = time.perf_counter()
    twin = as_tensors(mb.green_potential_compacted(pts, ec.max_iter, ec.escape_radius,
                                                   device=dev,
                                                   stage_executor=mb._green_stage_torch))
    twin_ms = (time.perf_counter() - t0) * 1e3
    check(same_bits(as_tensors(staged), twin),
          "green_potential_compacted: the staged kernel run differs from the twin's")
    def one_stage():
        return as_tensors(mb.green_potential_compacted(pts, ec.max_iter, ec.escape_radius,
                                                       stage_iters=ec.max_iter, device=dev))

    reset_launches()
    t0 = time.perf_counter()
    one = one_stage()
    one_s = time.perf_counter() - t0
    launched("green_potential_compacted, one stage", {"orbit_green": 1})
    k = one[1].long()
    deepest = int(k.max())
    steps = int(k.sum())
    res = loop_orbit(
        "orbit_green", f"{len(pts)} points f64, {ec.max_iter} it., one stage (g, k, phi "
        "against the compacted twin)", one_stage, lambda: twin, steps,
        len(pts) * (32 + 32 + 1 + 4 + 16), f64,
        loop=lambda: mb._green_loop_cuda(zero, zero, pr, pi, 0, ec.max_iter, r2, ec.max_iter),
        plain_ms=twin_ms)
    check(same_bits(one, twin), "the one-stage Green potential differs from the compacted twin")
    # the chain of the deepest point: 3 dependent f64 instructions a step
    # (mul, sub, add) at FP64's measured latency
    chain = deepest * 3 * FP64_DEPENDENT_CYCLES / clock_hz * 1e3
    res.update(bound_chain_ms=chain, deepest_steps=deepest, staged_launches=stages,
               staged_s=staged_s, one_launch_s=one_s)
    out["orbit_green"] = res
    print(f"  orbit_green chain bound: {deepest} steps x 3 dependent f64 instructions x "
          f"{FP64_DEPENDENT_CYCLES} cycles at {clock_hz / 1e9:.3f} GHz = {chain:.5f} ms; "
          f"one stage {one_s:.4f} s (1 launch, one copy to the host), the "
          f"compacted loop {staged_s:.4f} s ({stages} launches), on the twin "
          f"{twin_ms / 1e3:.3f} s; g, k, phi bitwise equal, NaN equal to NaN")

    # escape_potential_grid: coupling's U_M (k_plus_1, R 10, 300 steps, on the
    # default bus's grid), the variograms' (two_pow_n, R 4, 600 steps) and the
    # junction (two_pow_n, R 4, 2,000 steps), each in all three normalizations,
    # the loop state with and without the skip held to its contract; the
    # ragged grids and the special-values grid
    t_added = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        bus = stage1.run_stage1(sc, f"{tmp}/bus", plots=False, device=dev)
    cc = CouplingConfig()
    allp = np.vstack([bus["C"], bus["M"]])
    lo, hi = allp.min(axis=0) - 0.5, allp.max(axis=0) + 0.5
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], cc.grid_res),
                         np.linspace(lo[1], hi[1], cc.grid_res))
    um_grids = [("coupling's U_M", torch.as_tensor(gx, device=dev),
                 torch.as_tensor(gy, device=dev), cc.max_iter_mb, cc.escape_rad, "k_plus_1")]
    cr, ci = grid(vc.domain, vc.grid_nx, vc.grid_ny)
    um_grids.append(("the variograms' U_M", cr, ci, vc.potential_max_iter, vc.potential_r,
                     "two_pow_n"))
    um_grids.append(("the cardioid-bulb junction", *grid(JUNCTION, 1000, 1000), 2000, 4.0,
                     "two_pow_n"))
    timed_um = {}
    for label, cr, ci, it, rad, own in um_grids:
        r2 = rad * rad
        potential_contract(label, cr, ci, it, r2)
        skip = mb._skips_interior(own)
        lane = bench.orbit_potential_lane_steps(cr, ci, it, r2, skip)
        for norm in mb.POTENTIAL_NORMALIZATIONS:
            res = loop_orbit(
                "orbit_potential", f"{label} {tuple(cr.shape)}, {it} it., R {rad}, {norm}",
                lambda: mb.escape_potential_grid(cr, ci, it, rad, norm),
                lambda: mb.escape_potential_grid_torch(cr, ci, it, rad, norm),
                escape_steps_needed(cr, ci, it, r2), cr.numel() * (16 + 8), f64,
                loop=(lambda: mb._potential_loop_cuda(cr, ci, it, r2, skip)) if norm == own
                else None, needed_ops=int(lane.sum()) * CARRIED_STEP_OPS)
            if norm == own:
                # the chain of the deepest lane: 3 dependent f64 instructions a
                # step at FP64's measured latency
                deepest = int(lane.max())
                chain = deepest * 3 * FP64_DEPENDENT_CYCLES / clock_hz * 1e3
                res.update(bound_chain_ms=chain, deepest_steps=deepest)
                print(f"  orbit_potential {label} chain bound: {deepest} steps x 3 dependent "
                      f"f64 instructions x {FP64_DEPENDENT_CYCLES} cycles at "
                      f"{clock_hz / 1e9:.3f} GHz = {chain:.5f} ms; "
                      f"{int((lane == it).sum())} lanes run all {it} steps")
                timed_um[label] = res
    out["orbit_potential"] = dict(timed_um["the variograms' U_M"])
    out["orbit_potential"]["coupling_u_m"] = {
        k: timed_um["coupling's U_M"][k] for k in ("shape", "ms", "chained_ms", "plain_ms",
                                                    "bound_ms", "bound_by", "floor_ms",
                                                    "bound_chain_ms", "ops_needed",
                                                    "bound_before_ms", "floor_before_ms")}
    small_cases("orbit_potential", lambda cr, ci, it: (
        lambda: mb.escape_potential_grid(cr, ci, it, 4.0, "two_pow_k_break"),
        lambda: mb.escape_potential_grid_torch(cr, ci, it, 4.0, "two_pow_k_break")))
    for dt in (f64, torch.float32):
        for (ny, nx), it in (((3, 5), 1), ((1, 7), 2), ((37, 61), 7), ((129, 33), 600)):
            cr, ci = grid(DOMAIN, nx, ny, dt)
            potential_contract(f"{ny}x{nx} {dt} {it} it.", cr, ci, it, 16.0)
            for norm in ("two_pow_n", "k_plus_1"):
                loop_orbit("orbit_potential", f"{ny}x{nx} {dt} {it} it., {norm}",
                           lambda cr=cr, ci=ci, it=it, norm=norm:
                           mb.escape_potential_grid(cr, ci, it, 4.0, norm),
                           lambda cr=cr, ci=ci, it=it, norm=norm:
                           mb.escape_potential_grid_torch(cr, ci, it, 4.0, norm), 0, 0)
        cr, ci = special_grid(dt, dev)
        for it in (1, 7, vc.potential_max_iter):
            potential_contract(f"special values {dt}, {it} it.", cr, ci, it, 16.0)
            for norm in mb.POTENTIAL_NORMALIZATIONS:
                loop_orbit("orbit_potential", f"special values {tuple(cr.shape)} {dt}, {it} it., "
                           f"{norm}", lambda cr=cr, ci=ci, it=it, norm=norm:
                           mb.escape_potential_grid(cr, ci, it, 4.0, norm),
                           lambda cr=cr, ci=ci, it=it, norm=norm:
                           mb.escape_potential_grid_torch(cr, ci, it, 4.0, norm), 0, 0)
    potential_added = time.perf_counter() - t_added
    print(f"phase 23's orbit_de_std cases {std_added:.1f} s, orbit_de_stage1 cases "
          f"{stage1_added:.1f} s, orbit_potential cases {potential_added:.1f} s wall (checks "
          "and timings, stage1's bus included)")
    for name in ORBIT_ENTRIES:
        out[name]["max_abs_err"], out[name]["nan_positions_equal"] = ORBIT_ERR[name]
    return out


#: stage1's Sinkhorn at the CLI defaults: the launches phase 23 holds to the
#: twin beside the plan's own (resident, one CTA an SM), at 0, 1, 3 and 1,000
#: steps: two other grids (97 CTAs in one pass a half step, 66 in two) and the
#: streaming mode on each (card_plan's overrides)
SINKHORN_CASES = (dict(ctas=97), dict(ctas=66), dict(streaming=True),
                  dict(ctas=97, streaming=True), dict(ctas=66, streaming=True))
#: ragged costs phase 23 also holds sinkhorn.cu to its twin at, at 0, 1 and 3
#: steps: lines shorter than a warp, shorter and longer than a CTA's 512
#: threads, more CTAs than lines; on each of SINKHORN_RAGGED_GRIDS
SINKHORN_RAGGED = ((5, 3), (31, 45), (45, 31), (3, 530), (530, 3), (37, 1000))
SINKHORN_RAGGED_GRIDS = (dict(), dict(ctas=4), dict(ctas=1), dict(streaming=True),
                         dict(ctas=4, streaming=True), dict(ctas=1, streaming=True))
#: the kernel of commit faa791d (one warp a line, each line read twice) at stage1's two
#: costs, ms per call on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md,
#: section 6): printed beside this run's times
SINKHORN_TWO_PASS_MS = {"default": 10.160, "6x": 101.877}


def sinkhorn_ragged(dev) -> float:
    """sinkhorn.cu torch.equal its twin at SINKHORN_RAGGED x
    SINKHORN_RAGGED_GRIDS x 0, 1 and 3 steps, one launch each; returns the
    largest |kernel - twin|."""
    import numpy as np
    import torch

    from cmtci_torch.transport import sinkhorn

    reset_launches()
    err, count = 0.0, 0
    for n, m in SINKHORN_RAGGED:
        rng = np.random.default_rng(n + m)
        a, b = rng.normal(size=(n, 4)), rng.normal(size=(m, 4))
        cost = torch.as_tensor(np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)),
                               device=dev)
        for iters in (0, 1, 3):
            want = sinkhorn.sinkhorn_log_torch(cost, iters, 0.1)
            for kw in SINKHORN_RAGGED_GRIDS:
                got = sinkhorn.sinkhorn_kernel(cost, iters, 0.1, **kw)
                count += 1
                check(bool(torch.equal(got, want)),
                      f"sinkhorn {n} x {m}, {iters} steps, {kw} "
                      f"({sinkhorn.card_plan(dev, n, m, **kw)}): the plan differs from the "
                      f"twin's by {abs_err(got, want)[0]!r}")
                err = max(err, abs_err(got, want)[0])
    torch.cuda.synchronize()
    launched("sinkhorn, ragged", {"sinkhorn": count})
    print(f"sinkhorn ragged: torch.equal the twin at {len(SINKHORN_RAGGED)} costs "
          f"({', '.join(f'{n} x {m}' for n, m in SINKHORN_RAGGED)}) x "
          f"{len(SINKHORN_RAGGED_GRIDS)} grids x 0, 1, 3 steps, {count} launches")
    return err


def sinkhorn_ops(n: int, m: int, iters: int, exp_ops: int, log_ops: int) -> int:
    """The f64 operations of sinkhorn.cu's loop on an n x m cost, one an
    instruction: a term of a half step an add and a max, then an add, a
    subtraction, its exp and an add to the sum; a line its log and 3 more;
    the plan's element the prologue's product, two adds and an exp."""
    return (iters * (2 * n * m * (5 + exp_ops) + (n + m) * (log_ops + 3))
            + n * m * (3 + exp_ops))


def loop_sinkhorn(dev):
    """Phase 23, Sinkhorn: csrc/sinkhorn.cu's plan torch.equal its twin's at
    stage1's two costs (the CLI defaults: the resident plan, two other grids
    and the streaming mode, at 0, 1, 3 and 1,000 steps; the 6x bus:
    streaming) and at the ragged costs (sinkhorn_ragged), one launch a call;
    the kernel's, the twin's and the graph yardstick's times, the bytes
    staged a step, the split of a half step, the barrier floor and the
    bounds. Returns the kernels-line fields at the defaults."""
    import torch

    from cmtci_torch import sweep_schedules as sweep
    from cmtci_torch.kernels import _build
    from cmtci_torch.pipelines import stage1
    from cmtci_torch.transport import sinkhorn

    sass = sweep.exp_log_sass()
    print(f"FP64 SASS instructions of one exp and one log: {json.dumps(sass)}")
    out = {}
    for label, over in sweep.SINKHORN_BUSES.items():
        cfg = stage1.Stage1Config(**over)
        cost = sweep.stage1_cost(cfg, dev)
        iters, eps = stage1.SINKHORN_ITERS, cfg.sinkhorn_reg
        n, m = cost.shape
        t0 = time.perf_counter()
        want = sinkhorn.sinkhorn_log_torch(cost, iters, eps)
        torch.cuda.synchronize()
        twin_ms = (time.perf_counter() - t0) * 1e3
        plan = sinkhorn.card_plan(dev, n, m)
        check(plan.resident == (label == "default"),
              f"sinkhorn {label}: plan {plan} (resident at the defaults only)")
        err = 0.0
        short = {it: sinkhorn.sinkhorn_log_torch(cost, it, eps) for it in (0, 1, 3)}
        for kw in ({},) + (SINKHORN_CASES if label == "default" else ()):
            reset_launches()
            got = sinkhorn.sinkhorn_kernel(cost, iters, eps, **kw)
            torch.cuda.synchronize()
            launched(f"sinkhorn_kernel {label} {kw}", {"sinkhorn": 1})
            check(bool(torch.equal(got, want)),
                  f"sinkhorn {label} {kw} ({sinkhorn.card_plan(dev, n, m, **kw)}): the plan "
                  f"differs from the twin's by {abs_err(got, want)[0]!r}")
            err = max(err, abs_err(got, want)[0])
            check(bool(torch.equal(got.argmax(dim=1), want.argmax(dim=1))), "sinkhorn: argmax")
            for it, plan_it in short.items():
                got = sinkhorn.sinkhorn_kernel(cost, it, eps, **kw)
                check(bool(torch.equal(got, plan_it)),
                      f"sinkhorn {label} {kw}, {it} steps: the plan differs from the twin's by "
                      f"{abs_err(got, plan_it)[0]!r}")
        ms = cuda_ms(lambda: sinkhorn.sinkhorn_kernel(cost, iters, eps), 1, 5)
        stream_ms = (cuda_ms(lambda: sinkhorn.sinkhorn_kernel(cost, iters, eps, streaming=True),
                             1, 5) if plan.resident else ms)
        stream_plan = sinkhorn.card_plan(dev, n, m, streaming=True)
        graph, static, gplan = sweep.sinkhorn_graph(cost, iters, eps)
        graph.replay()
        torch.cuda.synchronize()
        rel = float((gplan - want).abs().max() / want.abs().max())
        same = bool(torch.equal(gplan.argmax(dim=1), want.argmax(dim=1)))
        check(rel <= 1e-10 and same, f"sinkhorn {label}: the graph yardstick {rel!r} from the "
                                     f"twin, argmax equal {same}")
        # the 6x graph takes 0.4 s a replay: one timed replay after the check's
        graph_ms = cuda_ms(graph.replay, 1, 3) if label == "default" else cuda_ms(
            graph.replay, 0, 1)
        del graph, static, gplan
        floor_ms = sweep.barrier_floor_ms(dev, plan, 2 * iters)
        # the split of a half step: builds cut after each part, in turns with
        # the whole kernel, on this plan
        keep = []
        split = sweep.in_turns(sweep.stop_calls(
            cost, iters, eps, plan, {**SINKHORN_STOP_LIBS, "whole": _build.library("sinkhorn")},
            keep), rounds=3, chain=1, graphs=False)
        del keep
        labels = list(sweep.SINKHORN_STOPS.values()) + ["+ adds"]
        cut = [split[f"stop{k}"][0] for k in sweep.SINKHORN_STOPS] + [split["whole"][0]]
        # what each part adds to the cut before it, as a share of the whole
        shares = [(c - prev) / cut[-1] for c, prev in zip(cut, [0.0] + cut[:-1])]
        ops = sinkhorn_ops(n, m, iters, sass["exp"], sass["log"])
        t_ops = ops / PEAK_FP64 * 1e3
        t_ops4 = iters * 2 * n * m * 4 / PEAK_FP64 * 1e3
        t_bytes = 2 * n * m * 8 / PEAK_BYTES * 1e3
        t_stream = iters * 2 * n * m * 8 / PEAK_BYTES * 1e3
        bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        print(f"sinkhorn ({label} bus, {n} x {m}, {iters} steps, eps {eps}; plan {plan}): "
              f"torch.equal the twin on {1 + len(SINKHORN_CASES) if plan.resident else 1} "
              f"launches of {iters} steps and as many of 0, 1 and 3, one a call; kernel "
              f"{ms:.4f} ms (the two-pass kernel of commit faa791d: "
              f"{SINKHORN_TWO_PASS_MS[label]} ms, PERF.md)"
              + (f" (forced to stream {stream_ms:.4f}, {stream_plan.staged} B staged a step)"
                 if plan.resident else f", {plan.staged} B staged from HBM a step")
              + "; split of a half step, each build cut after a part (ms, single call in "
              "turns with the whole, and the share of the whole each part adds): "
              + ", ".join(f"{lab} {c:.4f} ({sh:.3f})" for lab, c, sh in zip(labels, cut, shares))
              + f"; twin {twin_ms:.1f} ms, graph yardstick {graph_ms:.4f} ms (within "
              f"{rel!r} of the twin, argmax equal), barrier floor ({2 * iters} barriers) "
              f"{floor_ms:.4f} ms; bound {bound:.4f} ms ({by}; operations {t_ops:.4f} at "
              f"{5 + sass['exp']} an element, {t_ops4:.4f} at 4; bytes in and out "
              f"{t_bytes:.4f}; mk and mkT from HBM every step {t_stream:.4f})")
        out[label] = dict(shape=[n, m], resident=plan.resident, ctas=plan.ctas,
                          max_abs_err=err, ms=ms, plain_ms=twin_ms, graph_ms=graph_ms,
                          streaming_ms=stream_ms, barrier_floor_ms=floor_ms, bound_ms=bound,
                          bound_by=by, bound_ops_4_ms=t_ops4, bound_streaming_ms=t_stream,
                          staged_bytes=(stream_plan if plan.resident else plan).staged,
                          split_ms=dict(zip(labels, cut)))
    ragged = sinkhorn_ragged(dev)
    return dict(out["default"], bus_6x=out["6x"],
                max_abs_err=max(out["default"]["max_abs_err"], out["6x"]["max_abs_err"],
                                ragged))


def phase_loops(dev):
    """Phase 23: the reference's compiled device loops on the card: aberth.cu
    at every pipeline cloud (1e-12 relative, steps within one), each orbit.cu
    entry bitwise at its pipeline's size and around it, sinkhorn.cu bitwise
    at stage1's two costs. Returns the kernels-line fields of the entries."""
    aberth = loop_aberth(dev)
    orbit = loop_orbits(dev)
    sink = loop_sinkhorn(dev)
    aberth.update(eigvals_library(dev))
    err, rel = aberth_above_one_cta(dev)
    aberth["max_abs_err"] = max(aberth["max_abs_err"], err)
    aberth["max_rel_err"] = max(aberth["max_rel_err"], rel)
    return {"aberth": aberth, "sinkhorn": sink, **orbit}


#: the pair cell's construct (n 2..547, 149,877 points) and band size
#: (benchmarks/configs/pairstats_lucas150k.json)
PAIR_NS, PAIR_M = range(2, 548), 150_000


def band_points(dev, n: int, seed: int = 24):
    """(n, 2) points of the Mandelbrot boundary band as the pair cell draws
    M: nodes of the 2000 x 2000 f64 grid of BOUNDARY_DOMAIN whose escape
    count k (|z|^2 > 4) is 8 <= k < 500, drawn without replacement, each
    moved by a uniform jitter of up to half a grid step."""
    import numpy as np
    import torch

    xmin, xmax, ymin, ymax = BOUNDARY_DOMAIN
    res, max_iter = 2000, 500
    xs = torch.linspace(xmin, xmax, res, dtype=torch.float64, device=dev)
    ys = torch.linspace(ymin, ymax, res, dtype=torch.float64, device=dev)
    cr, ci = xs[None, :].expand(res, res), ys[:, None].expand(res, res)
    zr, zi = torch.zeros_like(cr), torch.zeros_like(cr)
    k = torch.full(cr.shape, max_iter, dtype=torch.int32, device=dev)
    for step in range(max_iter):
        zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        k = torch.where((k == max_iter) & (zr * zr + zi * zi > 4.0), step + 1, k)
    nodes = torch.nonzero(((k >= 8) & (k < max_iter)).reshape(-1)).reshape(-1).cpu().numpy()
    rng = np.random.default_rng(seed)
    idx = rng.choice(nodes, n, replace=False)
    jitter = rng.random((n, 2)) - 0.5
    hx, hy = (xmax - xmin) / (res - 1), (ymax - ymin) / (res - 1)
    return np.column_stack([xmin + (idx % res + jitter[:, 0]) * hx,
                            ymin + (idx // res + jitter[:, 1]) * hy])


def edge_points():
    """Points on the box edges of every default scale, mins + (i, j) * step
    in f64, between two corners that fix mins and the extent (16,384
    points): their quotients are integers or round next to one."""
    import numpy as np

    lo, hi = np.array([-0.7, 0.3]), np.array([1.1, 2.9])
    pts = [lo[None], hi[None]]
    for s in np.logspace(-2, 0, 10, base=10.0):
        step = (hi - lo) * s
        i, j = np.meshgrid(*[np.arange(int(np.floor(1 / s)) + 1)] * 2, indexing="ij")
        pts.append(np.column_stack([lo[0] + i.ravel() * step[0], lo[1] + j.ravel() * step[1]]))
    return np.concatenate(pts)


def box_args(clouds, scales):
    """box_counts' arguments for `clouds` at `scales`, as
    pointstats.fractal_dimensions makes them."""
    import numpy as np

    from cmtci_torch.kernels import boxcount

    mins = np.array([xy.min(axis=0) for xy in clouds])
    col = np.asarray(scales, dtype=np.float64)[:, None]
    return (clouds, mins, np.array([(xy.max(axis=0) - lo) * col for xy, lo in zip(clouds, mins)]),
            boxcount.box_layout(scales))


def phase_boxcount(dev):
    """Phase 24: boxcount.cu bitwise its twin on the pair cell's clouds and
    on box edges, at the default and at fine scales; the counts against
    numpy's rows; run_spatial_stats' one launch and counter; the kernel's
    time against its bound by bytes. Returns the kernels-line fields."""
    import numpy as np
    import torch

    from cmtci_torch.kernels import _launch, boxcount, companion
    from cmtci_torch.pipelines.analysis import run_spatial_stats
    from cmtci_torch.stats import pointstats as ps
    from cmtci_torch.utils.artifacts import StageTimer

    z = companion.inverse_cloud(PAIR_NS, "lucas_all_ones", device=dev)
    c, m = np.column_stack([z.real, z.imag]), band_points(dev, PAIR_M)
    clouds = [c, m, edge_points()]
    default = np.logspace(-2, 0, 10, base=10.0)
    # the fine scales' bitmaps outgrow shared memory (boxcount.cu's
    # kSmemWords): the kernel's atomics in device memory
    fine = np.logspace(-3, 0, 12, base=10.0)
    err = 0.0
    for label, scales in (("default scales", default), ("12 scales to 1e-3", fine)):
        args = box_args(clouds, scales)
        torch.cuda.synchronize()
        reset_launches()
        got = boxcount.box_counts(*args, device=dev)
        torch.cuda.synchronize()
        launched(f"boxcount {label}", {"boxcount": 1})
        want = boxcount.box_counts_torch(*args, device=dev)
        check(same_bits(got, want), f"boxcount {label}: counts or bitmaps differ from the twin")
        err = max(err, abs_err(got, want)[0])
        words = int(boxcount._offsets(args[3])[-1])
        print(f"boxcount {label}: clouds of {', '.join(str(len(x)) for x in clouds)} points in "
              f"1 launch, {words} words a cloud's bitmaps: counts and bitmaps bitwise the "
              f"twin's; counts {got[0].tolist()}")
        for name, xy, row in zip("CM", clouds, got[0].tolist()):
            lo = xy.min(axis=0)
            rng = xy.max(axis=0) - lo
            rows = [len(np.unique(np.floor((xy - lo) / (rng * s)).astype(int), axis=0))
                    for s in scales]
            check(row == rows, f"boxcount {label} {name}: {row} against np.unique's {rows}")
        print("  C and M: the counts are numpy's np.unique rows")

    timer = StageTimer(dev)
    torch.cuda.synchronize()
    reset_launches()
    out = run_spatial_stats(c, m, r_max=1.5, dr=0.05, stat_dtype=torch.float32, plots=False,
                            device=dev, timer=timer)
    launched("run_spatial_stats", {"boxcount": 1})
    cards = out["counts"].get("spatial_stats.box_scales_card")
    twin = ps.fractal_dimensions((c, m), device="cpu")
    check(cards == 2 * len(default), f"spatial_stats.box_scales_card {cards}, expected 20")
    check(out["fractal_dim_construct"] == twin[0][0] and out["fractal_dim_mandel"] == twin[1][0],
          "run_spatial_stats: box dimensions differ from the twin's on the host")
    print(f"run_spatial_stats on C and M (f32 scans): 1 boxcount launch, box_scales_card "
          f"{cards}, dimensions {out['fractal_dim_construct']!r}, {out['fractal_dim_mandel']!r} "
          f"(the twin's on the host); stages (ms) "
          f"{ {k: round(v * 1e3, 3) for k, v in out['stage_times'].items()} }")

    args = box_args([c, m], default)
    prepared, _, buf, _inputs = boxcount.device_inputs(*args, dev)

    def one():
        buf.zero_()
        _launch.launch("boxcount", dev, *prepared)

    graph_ms = cuda_ms(one, 3, 10, CHAIN, graph=True)
    chained_ms = cuda_ms(one, 3, 10, CHAIN)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    boxcount.box_counts_torch(*args, device=dev)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ps.fractal_dimensions((c, m), device=dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    words = int(boxcount._offsets(args[3])[-1])
    nbytes = 16 * (len(c) + len(m)) + 2 * 4 * words + 4 * 2 * len(default)
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"boxcount, C and M at the default scales: kernel {graph_ms:.4f} ms (graph, the "
          f"bitmaps' zeroing included; {chained_ms:.4f} chained), twin {plain_ms:.2f} ms, bound "
          f"{bound:.5f} ms (bytes: {nbytes}); fractal_dimensions from numpy clouds "
          f"{statistics.median(walls):.3f} ms wall (median of 5)")
    return dict(max_abs_err=err, ms=graph_ms, chained_ms=chained_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", fractal_dimensions_wall_ms=statistics.median(walls),
                shape=f"C {len(c)} + M {len(m)} points, {len(default)} scales")


def main() -> int:
    card = card_line()
    print(card)
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    with open(ORACLE) as f:
        oracle = list(csv.DictReader(f))

    def timed(n, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {n} ({fn.__name__}): {time.perf_counter() - t0:.1f} s wall")
        return out

    timed(2, phase_build)
    k1_err, k1_timing = timed(3, phase_kernels, dev)
    results = timed(4, phase_tracker, dev, oracle)
    timed(5, phase_f64, dev, oracle)
    k2_err, k2_timing = timed(6, phase_dwell, dev)
    k2_launches = timed(7, phase_boundary, dev)
    k3_err, k3_ms, k3_plain_ms, k3_bound = timed(8, phase_cloud_green, dev)
    k3_launches = timed(9, phase_equipotential, dev)
    fields = timed(10, phase_fields, dev)
    k6 = timed(11, phase_dwell_ms, dev)
    tci_launches = timed(12, phase_tci, dev)
    timed(13, phase_tci_f64, dev)
    k7 = timed(14, phase_fma, dev)
    k2_periodic = timed(15, phase_periodic, dev)
    timed(16, phase_variograms, dev)
    timed(17, phase_pointstats, dev)
    bench_launches = timed(18, phase_bench, dev)
    timed(19, phase_bus, dev)
    timed(20, phase_suite, dev)
    timed(21, phase_conformal, dev)
    doctor_k2 = timed(22, phase_multidevice, dev)
    loops = timed(23, phase_loops, dev)
    box = timed(24, phase_boxcount, dev)

    k1_ms, k1_plain, k1_bound, k1_by, k1_graph_ms = k1_timing[("tracker", GRIDS[-1])]
    k2_ms, k2_plain, k2_bound, k2_by = k2_timing[DWELL_SHAPES[0]]
    print(f"K1 launches: {results[1][3]} per dense tracker run, {tci_launches} per run_tci")
    kernels = {
        "tci_de": dict(launches=results[1][3], max_abs_err=k1_err, ms=k1_graph_ms,
                       plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
                       chained_ms=k1_ms),
        "dwell": dict(launches=k2_launches + doctor_k2, max_abs_err=k2_err, ms=k2_ms,
                      plain_ms=k2_plain,
                      bound_ms=k2_bound, bound_by=k2_by),
        # K3's bound is by operations, but dependent ones: the chain of its
        # longest lane at the FP32 dependent-issue latency (phase 8)
        "cloud_green": dict(launches=k3_launches, max_abs_err=k3_err, ms=k3_ms,
                            plain_ms=k3_plain_ms, bound_ms=k3_bound, bound_by="operations",
                            bound_detail="dependent chain of the longest lane"),
        **fields,
        "dwell_ms": k6,
        "fma_peak": dict(launches=bench_launches["fma_peak"], **k7),
        "dwell_periodic": k2_periodic,
        **{name: dict(launches=LAUNCHED[MAIN_PATH[name]][name], **loops[name],
                      library_ms=None) for name in ORBIT_ENTRIES},
        **{name: dict(loops[name], launches=LAUNCHED[MAIN_PATH[name]][name])
           for name in ("aberth", "sinkhorn")},
        "boxcount": dict(box, launches=LAUNCHED[MAIN_PATH["boxcount"]]["boxcount"]),
    }
    print(card)
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": f"cmtci_torch/csrc/{SOURCE.get(n, n)}.cu",
         "replaces": REPLACES[n], "library_ms": None, **kernels[n]} for n in ENTRIES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--cards"]:
            print(card_line())
            phase_cards(int(sys.argv[2]))
            print("cards: ok")
            sys.exit(0)
        sys.exit(main())
    except Exception as exc:  # report the failed phase and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
