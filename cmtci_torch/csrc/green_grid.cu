// K5: grid Green potential (the two_pow_n normalization), one thread per
// pixel, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmtci/kernels/mandelbrot_pallas.py:_green_kernel
// (reached through mandelbrot_field_pallas(kind="green")). Same function,
// same f32 op order as the Pallas body and as the plain-torch twin
// (cmtci_torch/kernels/mandelbrot_cuda.py:green_field_torch); with
// -fmad=false the kernel and the twin agree bitwise on the card.
//
// What it computes, per pixel c = (xmin + col*dx, ymin + row*dy) in f32:
//   * an analytically interior pixel (escape.cuh:interior_mask) outputs 0
//     and skips the loop;
//   * otherwise up to max_iter steps of z <- z^2 + c; at the first
//     |z|^2 > R^2, at 0-based step k, g = max(0.5 log(max(|z|^2, 1e-30))
//     2^-(k+1), 0) (the Pallas kernel latches |z|^2 and k there, so later
//     steps do not enter g); a pixel that never escaped outputs 0.
//   * 2^-(k+1) is ldexpf(1, -(k+1)): an exact power of two, subnormal for
//     k+1 > 126 and 0 for k+1 > 149, so deep escapers give g = 0 in f32 as
//     in the reference, and the twin (numpy's f32 ldexp) is the same number.
//
// What bounds it on this card: the FP32 instruction rate. No load, one 4-byte
// store a pixel; a pixel needs 13 steps on average at 2048 x 2048, a warp
// runs as long as its slowest pixel, and a loop that compares and breaks in
// every step keeps the compare and the branch on the path of each step. The
// schedule, none of which enters the result (K4's, de_std.cu, on the z-only
// step):
//   * Chunks of C unrolled steps of escape.cuh:bare_step, which has no branch
//     and keeps a sticky flag hit |= (|z|^2 > R^2); the exit test
//     hit || n >= max_iter runs once a chunk. The squares zr*zr and zi*zi are
//     carried from one step's radius test into the next step's update: 9
//     FP32 operations a step where the step-by-step loop had 11.
//   * |z|^2 at the first escape comes from snapshots: |z|^2 and the flag
//     after each step of the newest chunk stay in registers (the chunk is
//     unrolled, so no dynamic index and no move), and once after the loop a
//     chain of C compare-selects picks the first step whose flag is up.
//     Steps after the first escape run on to inf and NaN and are never read.
//   * The loop may overshoot max_iter by up to C - 1 steps: a first escape
//     at a step index >= max_iter is no escape (output 0).
//   * The log and the power of two run once, after the loop, and only where
//     a pixel escaped; a warp of interior pixels leaves at once.
//   * A compact warp footprint (escape.cuh:patch_pixel): a warp's 32 threads
//     tile PATCH_W x PATCH_H pixels, so the pixels a warp waits for are
//     neighbours with neighbouring escape steps; a block is WARPS such
//     patches side by side; the rows of blocks are handed out from the
//     middle of the grid outwards, so the rows that cross the set, whose
//     warps run longest, start first.
// Measured in turns at 2048 x 2048, max_iter 500, R 4 on an H100 80GB HBM3
// at 700 W (PERF.md, K5; ms per launch replayed from a CUDA graph): this
// kernel 0.0480 against 0.1001 for the earlier one (one pixel a thread on
// one-row warps, a compare and a break in every step, 11 operations a step).
// Measured and not kept: |z|^2 and k latched by a select in every step in
// place of the snapshots (0.0577 at C = 4, 0.0599 at 3); C = 2 / 3 / 6 / 8
// (0.0519 / 0.0495 / 0.0497 / 0.0527; 22 registers at C = 4, 26 at 6);
// one-row warps, 32 x 1 (0.0607), and 16 x 2, 8 x 4, 2 x 16 patches (0.0538 /
// 0.0494 / 0.0502); 1, 2 or 8 warps a block (0.0818 / 0.0541 / 0.0503); the
// rows of blocks in order (0.0514).
// green_footprint reports C and the patch, for the step accounting
// (mandelbrot_cuda.GREEN_FOOTPRINT must equal it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
// Never --use_fast_math: it flushes the subnormal scales to zero.

#include <cuda_runtime.h>
#include <math.h>

#include "escape.cuh"

namespace {

constexpr int C = 4;           // orbit steps between two exit tests
constexpr int PATCH_W = 4;     // pixels across a warp's patch
constexpr int PATCH_H = 8;     // pixels down a warp's patch
constexpr int WARPS = 4;       // warps a block, side by side along x

__global__ void __launch_bounds__(32 * WARPS)
green_grid_kernel(float* __restrict__ out, int nx, int ny, float xmin, float ymin, float dx,
                  float dy, int max_iter, float r2) {
    int col, row;
    patch_pixel<PATCH_W, PATCH_H, WARPS, true>(col, row);
    if (col >= nx || row >= ny) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;

    float g = 0.0f;
    if (!interior_mask(cr, ci) && max_iter > 0) {
        float zr = 0.0f, zi = 0.0f, zr2 = 0.0f, zi2 = 0.0f;
        bool hit = false;
        // |z|^2 and the flag after each step of the newest chunk
        float sa2[C];
        bool up[C];
        int n = 0;
        do {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                bare_step(zr, zi, zr2, zi2, hit, cr, ci, r2);
                sa2[c] = zr2 + zi2;
                up[c] = hit;
            }
            n += C;
        } while (!hit && n < max_iter);
        // the first step of the chunk whose flag is up (the flag is sticky,
        // so walking down leaves the lowest); `first` stays C when none is
        float a2 = 0.0f;
        int first = C;
#pragma unroll
        for (int c = C - 1; c >= 0; --c) {
            if (up[c]) {
                first = c;
                a2 = sa2[c];
            }
        }
        // k is the 0-based index of that step
        const int k = n - C + first;
        if (hit && k < max_iter) {
            const float val = 0.5f * logf(max_nan(a2, 1e-30f)) * ldexpf(1.0f, -(k + 1));
            g = max_nan(val, 0.0f);
        }
    }
    out[(size_t)row * (size_t)nx + (size_t)col] = g;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// as an int; the caller raises when it is not 0. Allocates nothing and does
// not synchronize.
extern "C" int green_grid_launch(void* out, int nx, int ny, float xmin, float ymin,
                                 float dx, float dy, int max_iter, float r2, void* stream) {
    const int block_cols = WARPS * PATCH_W;
    const dim3 grid((nx + block_cols - 1) / block_cols, (ny + PATCH_H - 1) / PATCH_H);
    green_grid_kernel<<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), nx, ny, xmin, ymin, dx, dy, max_iter, r2);
    return static_cast<int>(cudaGetLastError());
}

// The schedule green_grid_launch is built with: {C, PATCH_W, PATCH_H}.
extern "C" void green_footprint(int* out3) {
    out3[0] = C;
    out3[1] = PATCH_W;
    out3[2] = PATCH_H;
}
