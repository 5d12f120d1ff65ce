// K1: TCI distance-estimator field, one thread per pixel, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmtci/kernels/mandelbrot_pallas.py:_tci_kernel
// (the Appendix-A tracker's boundary-band head). Same function: every output
// is bitwise that of the Pallas body's f32 op sequence and of the plain-torch
// twin (cmtci_torch/kernels/mandelbrot_cuda.py:tci_de_field_torch), which
// with -fmad=false the card confirms at every shape chip_smoke.py runs.
//
// What it computes, per pixel c = (xmin + col*dx, ymin + row*dy) in f32:
//   * analytically interior pixels (cardioid / period-2 bulb, 1e-5 margin)
//     start done and output -1;
//   * otherwise up to max_iter steps of  dz <- 2 z dz + 1  then  z <- z^2 + c
//     (both from the old z); z is latched at the first |z|^2 > R^2 (inf
//     counts as an escape); dz is NOT latched and keeps iterating, so it
//     overflows for all but the latest escapers and d = 0 there;
//   * d = log(max(|z_l|, 1)) |z_l| / max(|2 z_l dz|, 1e-12), non-finite -> 0;
//     output d (>= 0) where escaped, -1 where not.
//
// What bounds it on this card: the FP32 instruction rate. No load, one 4-byte
// store a pixel; a warp runs as long as its slowest pixel. The step-by-step
// loop spent 22 FP32 operations and a branch a step on (z, dz), yet dz
// decides the output of very few pixels: of the tracker's 912 x 912 grid 12
// have d > 0. The design computes dz only where it can matter.
//   * First pass, z alone: chunks of C unrolled steps of escape.cuh:bare_step
//     (no branch, a sticky flag hit |= (|z|^2 > R^2), the squares carried: 9
//     FP32 operations a step), with the tests once a chunk. z does not depend
//     on dz, so the pass finds exactly whether the pixel escapes within
//     max_iter steps. Whole chunks run only while n + C <= max_iter, the last
//     max_iter mod C steps one by one: no step is taken past max_iter.
//   * Not escaped: -1. Escaped, and z seen non-finite after s <= max_iter - 1
//     steps: d = 0 without dz. For the step-by-step loop either stopped
//     before step s + 1 because dz was non-finite already, or took step
//     s + 1 <= max_iter, whose dz <- 2 z dz + 1 has a non-finite half of z
//     times a half of dz in each half (inf or NaN, never finite), so dz is
//     non-finite at its end either way and stays so (the same argument with
//     dz). A non-finite half of dz makes 2 z_l dz non-finite (z_l is beyond
//     the radius, no NaN), den inf or NaN, and num / den +0 or NaN, which is
//     set to 0. After the escape |z| squares every step, so that takes five
//     or six steps more.
//   * The others, the late escapers whose z is still finite at step
//     max_iter - 1 (29 pixels of 912 x 912), are the only ones whose dz can
//     be finite at max_iter, i.e. the only ones with d > 0; they decide the
//     q25 band. Each runs the whole orbit again from z = 0, dz = 1 with the
//     step-by-step body: exactly min(max_iter, exit step) dz steps, the latch
//     at the first escape, the formula. A pixel takes that branch once.
//   * dz may overflow before z escapes (a bounded z with |2z| > 1 for 128
//     steps); the pixel then runs max_iter out and outputs -1, or escapes
//     with d = 0, by the first pass or by the second.
//   * A compact warp footprint: a warp's 32 threads tile PATCH_W x PATCH_H
//     pixels instead of 32 columns of one row; a block is WARPS such patches
//     side by side. No padding: the grid is exactly grid_n x grid_n.
//   * The card hands out blocks in the order of their index, so the rows of
//     blocks are numbered from the middle of the grid outwards: the rows that
//     cross the set, whose warps run max_iter out, start first, and the far
//     field's short rows fill in behind them at the end.
// Measured and not kept (PERF.md, K1, has the times): iterating dz in every
// step (chunks of a 17-operation step, z latched from snapshots or by a
// replay of the chunk's z steps, the formula only for a finite dz) ties at
// the tracker's 912 x 912 and loses a quarter at run_tci's 2400 x 2400; C =
// 6 beats 3 and 4 by a few percent, 1 and 2 pay for the tests; one-row warps
// lost to the 4 x 8 patch; warps that stay and walk over the patches with a
// fixed stride lost to the card's own handing out of blocks.
// tci_footprint reports C and the patch (mandelbrot_cuda.TCI_FOOTPRINT must
// equal it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
// Never --use_fast_math: it flushes denormals, approximates logf/division
// and re-enables contraction.

#include <cuda_runtime.h>
#include <math.h>

#include "escape.cuh"

namespace {

constexpr int C = 6;        // orbit steps between two exit tests
constexpr int PATCH_W = 4;  // pixels across a warp's patch
constexpr int PATCH_H = 8;  // pixels down a warp's patch
constexpr int WARPS = 4;    // warps a block, side by side along x

// The whole (z, dz) orbit of one pixel, step by step, and the formula: the
// second pass of a late escaper. max_nan (escape.cuh) propagates NaN:
// fmaxf(NaN, x) would turn a NaN dz lane into a huge finite d.
__device__ float late_escaper(float cr, float ci, int max_iter, float r2) {
    float zr = 0.0f, zi = 0.0f, dzr = 1.0f, dzi = 0.0f, lzr = 0.0f, lzi = 0.0f;
    bool esc = false;
    for (int n = 0; n < max_iter; ++n) {
        const float tr = 2.0f * zr;
        const float ti = 2.0f * zi;
        const float ndzr = tr * dzr - ti * dzi + 1.0f;
        const float ndzi = tr * dzi + ti * dzr;
        const float nzr = zr * zr - zi * zi + cr;
        const float nzi = 2.0f * zr * zi + ci;
        dzr = ndzr;
        dzi = ndzi;
        zr = nzr;
        zi = nzi;
        const float a2 = zr * zr + zi * zi;
        if (!esc && a2 > r2) {
            esc = true;
            lzr = zr;
            lzi = zi;
        }
        if (esc && !(isfinite(dzr) && isfinite(dzi))) break;
    }
    const float az = sqrtf(lzr * lzr + lzi * lzi);
    const float pr = 2.0f * lzr * dzr - 2.0f * lzi * dzi;
    const float pi = 2.0f * lzr * dzi + 2.0f * lzi * dzr;
    const float den = max_nan(sqrtf(pr * pr + pi * pi), 1e-12f);
    const float num = logf(max_nan(az, 1.0f)) * az;
    float d = num / den;
    if (!isfinite(d)) d = 0.0f;
    return esc ? d : -1.0f;
}

__global__ void __launch_bounds__(32 * WARPS)
tci_de_kernel(float* __restrict__ out, int grid_n, float xmin, float ymin, float dx,
              float dy, int max_iter, float r2) {
    // rows of blocks in the order middle of the grid, one below, one above, ...
    int col, row;
    patch_pixel<PATCH_W, PATCH_H, WARPS, true>(col, row);
    if (col >= grid_n || row >= grid_n) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;

    float d = -1.0f;
    if (!interior_mask(cr, ci)) {
        float zr = 0.0f, zi = 0.0f, zr2 = 0.0f, zi2 = 0.0f;
        bool hit = false;
        // steps after which an escaped z was seen non-finite; max_iter if never
        int dead_at = max_iter;
        int n = 0;
        // whole chunks
        for (; n + C <= max_iter; n += C) {
#pragma unroll
            for (int c = 0; c < C; ++c) bare_step(zr, zi, zr2, zi2, hit, cr, ci, r2);
            if (hit && !(isfinite(zr) && isfinite(zi))) {
                dead_at = n + C;
                n = max_iter;  // no step is left to take
                break;
            }
        }
        // the last max_iter mod C steps, one by one
        for (; n < max_iter; ++n) {
            bare_step(zr, zi, zr2, zi2, hit, cr, ci, r2);
            if (hit && !(isfinite(zr) && isfinite(zi))) {
                dead_at = n + 1;
                break;
            }
        }
        if (hit) d = dead_at < max_iter ? 0.0f : late_escaper(cr, ci, max_iter, r2);
    }
    out[(size_t)row * (size_t)grid_n + (size_t)col] = d;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// as an int; the caller raises when it is not 0. Allocates nothing and does
// not synchronize.
extern "C" int tci_de_launch(void* out, int grid_n, float xmin, float ymin, float dx,
                             float dy, int max_iter, float r2, void* stream) {
    const int block_cols = WARPS * PATCH_W;
    const dim3 grid((grid_n + block_cols - 1) / block_cols, (grid_n + PATCH_H - 1) / PATCH_H);
    tci_de_kernel<<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), grid_n, xmin, ymin, dx, dy, max_iter, r2);
    return static_cast<int>(cudaGetLastError());
}

// The schedule tci_de_launch is built with: {C, PATCH_W, PATCH_H}.
extern "C" void tci_footprint(int* out3) {
    out3[0] = C;
    out3[1] = PATCH_W;
    out3[2] = PATCH_H;
}
