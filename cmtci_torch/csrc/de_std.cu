// K4: standard distance-estimator field, one thread per pixel, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cmtci/kernels/mandelbrot_pallas.py:_de_kernel
// (reached through mandelbrot_field_pallas(kind="de"); bench's de_mfu key).
// Same function, same f32 op order as the Pallas body and as the plain-torch
// twin (cmtci_torch/kernels/mandelbrot_cuda.py:de_field_std_torch); with
// -fmad=false the kernel and the twin agree bitwise on the card.
//
// What it computes, per pixel c = (xmin + col*dx, ymin + row*dy) in f32:
//   * an analytically interior pixel (escape.cuh:interior_mask) counts as
//     escaped with zero latches (z = 0, dz = 1), so its d is 0: num 0 over
//     den = max(0, 1e-14); it skips the loop and the formula;
//   * otherwise up to max_iter steps of  dz <- 2 z dz + 1  then  z <- z^2 + c
//     (both from the old z); at the first |z|^2 > R^2 both z and dz are
//     latched and the orbit stops;
//   * d = log(max(|z_l|, 1)) |z_l| / max(|2 z_l dz_l|, 1e-14) with
//     |.| = sqrt of the sum of squares, in the reference's op order; a lane
//     that never escaped outputs 0. A dz that overflowed gives d = 0 (inf
//     den) or NaN (inf - inf), as in the reference: max_nan keeps a NaN.
//
// What bounds it on this card: the FP32 instruction rate. No load, one 4-byte
// store a pixel; a pixel needs 13 steps on average at 2048 x 2048, a warp
// runs as long as its slowest pixel, and a loop that compares and breaks in
// every step keeps the compare and the branch on the path of each step (a
// GPU does not speculate past a branch). The schedule, none of which enters
// the result:
//   * Chunks of C unrolled steps of de_bare_step below, which has no
//     branch and keeps a sticky flag hit |= (|z|^2 > R^2); the exit test
//     hit || n >= max_iter runs once a chunk. The squares zr*zr, zi*zi and
//     2*zr serve the radius test, the z update and the dz update at once:
//     17 FP32 operations a step where the step-by-step loop had 20.
//   * z and dz at the first escape come from snapshots: the state after each
//     step of the newest chunk stays in registers (the chunk is unrolled, so
//     no dynamic index and no move), and once after the loop a chain of C
//     compare-selects picks the state of the first step whose flag is up.
//     Steps after the first escape run on to inf and NaN and are never read.
//   * The loop may overshoot max_iter by up to C - 1 steps: a first escape
//     at a step index >= max_iter is no escape (output 0).
//   * A compact warp footprint: a warp's 32 threads tile PATCH_W x PATCH_H
//     pixels instead of 32 columns of one row, so the pixels a warp waits
//     for are neighbours with neighbouring escape steps; a block is WARPS
//     such patches side by side.
//   * The formula (two square roots, a log and a division, about 95
//     instructions, a quarter of what a warp's loop executes) runs only where a
//     pixel escaped; a warp of interior pixels leaves at once.
//   * The card hands out blocks in the order of their index, so the rows of
//     blocks are numbered from the middle of the grid outwards: on a domain
//     about the real axis the rows that cross the set, whose warps run
//     longest, start first, and the far field's short rows fill in behind
//     them at the end.
// Measured and not kept (PERF.md, K4, has the times): replaying the flagged
// chunk step by step from the state saved at its start, as cloud_green.cu
// does, costs a pixel up to C more steps of its 13 and lost to the snapshots
// at every C; C = 3 beats 2 and 4 (longer chunks overshoot more and hold
// more snapshots: 32 registers at C = 3 and 4, 40 at 6); one-row warps
// execute 2.0 times the useful steps, the 4 x 8 patch 1.57; numbering the
// blocks from the middle along x too changed nothing; warps that stay and
// walk over the patches with a fixed stride lost a third to the card's own
// handing out of blocks, which balances the load as it goes.
// de_footprint reports C and the patch, for the step accounting of
// cmtci_torch/bench.py (mandelbrot_cuda.DE_FOOTPRINT must equal it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

#include "escape.cuh"

namespace {

constexpr int C = 3;        // orbit steps between two exit tests
constexpr int PATCH_W = 4;  // pixels across a warp's patch
constexpr int PATCH_H = 8;  // pixels down a warp's patch
constexpr int WARPS = 4;    // warps a block, side by side along x

// One branch-free orbit step: dz <- 2 z dz + 1 and z <- z^2 + c, both from the
// old z, then the new squares and the sticky radius flag. zr2 and zi2 carry
// zr*zr and zi*zi from one step's radius test into the next step's update,
// and 2*zr*zi is (2*zr)*zi, the tr the dz update already has: the same
// products of the same values as the step-by-step loop of the plain twin, so
// the same bits. 9 mul, 7 add/sub, 1 compare. The first step over the radius
// raises the flag whatever later steps overflow to; a NaN |z|^2 does not
// raise it, an inf one does.
__device__ __forceinline__ void de_bare_step(float& zr, float& zi, float& zr2, float& zi2,
                                             float& dzr, float& dzi, bool& hit, float cr,
                                             float ci, float r2) {
    const float tr = 2.0f * zr;
    const float ti = 2.0f * zi;
    const float ndzr = tr * dzr - ti * dzi + 1.0f;
    const float ndzi = tr * dzi + ti * dzr;
    const float nzr = zr2 - zi2 + cr;
    const float nzi = tr * zi + ci;
    dzr = ndzr;
    dzi = ndzi;
    zr = nzr;
    zi = nzi;
    zr2 = nzr * nzr;
    zi2 = nzi * nzi;
    hit = hit || (zr2 + zi2 > r2);
}

__global__ void __launch_bounds__(32 * WARPS)
de_std_kernel(float* __restrict__ out, int nx, int ny, float xmin, float ymin, float dx,
              float dy, int max_iter, float r2) {
    // rows of blocks in the order middle of the grid, one below, one above, ...
    int col, row;
    patch_pixel<PATCH_W, PATCH_H, WARPS, true>(col, row);
    if (col >= nx || row >= ny) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;

    // 0 is the output of a pixel that never escaped, and of an analytically
    // interior one: it counts as escaped with zero latches (z = 0, dz = 1),
    // for which the formula below is log(1) * 0 / 1e-14 = +0
    float d = 0.0f;
    if (!interior_mask(cr, ci) && max_iter > 0) {
        float zr = 0.0f, zi = 0.0f, zr2 = 0.0f, zi2 = 0.0f, dzr = 1.0f, dzi = 0.0f;
        bool hit = false;
        // the state and the flag after each step of the newest chunk
        float szr[C], szi[C], sdr[C], sdi[C];
        bool up[C];
        int n = 0;
        do {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                de_bare_step(zr, zi, zr2, zi2, dzr, dzi, hit, cr, ci, r2);
                szr[c] = zr;
                szi[c] = zi;
                sdr[c] = dzr;
                sdi[c] = dzi;
                up[c] = hit;
            }
            n += C;
        } while (!hit && n < max_iter);
        // the first step of the chunk whose flag is up (the flag is sticky,
        // so walking down leaves the lowest); `first` stays C when none is
        float lzr = 0.0f, lzi = 0.0f, ldr = 1.0f, ldi = 0.0f;
        int first = C;
#pragma unroll
        for (int c = C - 1; c >= 0; --c) {
            if (up[c]) {
                first = c;
                lzr = szr[c];
                lzi = szi[c];
                ldr = sdr[c];
                ldi = sdi[c];
            }
        }
        // n - C + first is the 0-based index of that step
        if (hit && n - C + first < max_iter) {
            const float az = sqrtf(lzr * lzr + lzi * lzi);
            const float pr = 2.0f * (lzr * ldr - lzi * ldi);
            const float pi = 2.0f * (lzr * ldi + lzi * ldr);
            const float num = logf(max_nan(az, 1.0f)) * az;
            const float den = max_nan(sqrtf(pr * pr + pi * pi), 1e-14f);
            d = num / den;
        }
    }
    out[(size_t)row * (size_t)nx + (size_t)col] = d;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// as an int; the caller raises when it is not 0. Allocates nothing and does
// not synchronize.
extern "C" int de_std_launch(void* out, int nx, int ny, float xmin, float ymin, float dx,
                             float dy, int max_iter, float r2, void* stream) {
    const int block_cols = WARPS * PATCH_W;
    const dim3 grid((nx + block_cols - 1) / block_cols, (ny + PATCH_H - 1) / PATCH_H);
    de_std_kernel<<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), nx, ny, xmin, ymin, dx, dy, max_iter, r2);
    return static_cast<int>(cudaGetLastError());
}

// The schedule de_std_launch is built with: {C, PATCH_W, PATCH_H}.
extern "C" void de_footprint(int* out3) {
    out3[0] = C;
    out3[1] = PATCH_W;
    out3[2] = PATCH_H;
}
