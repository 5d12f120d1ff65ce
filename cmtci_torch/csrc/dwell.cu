// K2: escape-time dwell field for Hopper (sm_90a).
//
// Replaces the TPU kernel cmtci/kernels/mandelbrot_pallas.py:_dwell_kernel
// (the `cmtci boundary` head, reached through mandelbrot_field_pallas). Same
// function, same f32 op order as the Pallas body and as the plain-torch twin
// (cmtci_torch/kernels/mandelbrot_cuda.py:dwell_field_torch); with -fmad=false
// the kernel and the twin agree bitwise on the card.
//
// What it computes, per pixel c = (xmin + col*dx, ymin + row*dy) in f32: an
// analytically interior pixel (escape.cuh:interior_mask) outputs max_iter;
// otherwise, for n = 0..max_iter-1: z <- (zr*zr - zi*zi + cr, 2*zr*zi + ci);
// the output is the first n with !(|z_{n+1}|^2 <= 4) (so NaN counts as an
// escape), else max_iter, as a float.
//
// Two entry points:
//   * dwell_launch, the plain kernel, on every pipeline's path; its schedule
//     is described below.
//   * dwell_periodic_launch runs escape.cuh:dwell_count<true>, one pixel a
//     thread, with the Pallas kernel's optional Brent periodicity check
//     (public switch mandelbrot_field(periodicity=True)): a pixel whose orbit
//     returns bitwise to a checkpoint stops early with max_iter. Its output
//     is the plain kernel's for every input. The check costs two compares and
//     a checkpoint move per step and pays only where bounded, non-analytic
//     pixels would otherwise run a long max_iter out.
//
// What bounds the plain kernel on this card: FP32 issue. There is no load and
// one 4-byte store a pixel; a warp runs as long as its slowest pixel, while
// far-field pixels leave after a few steps and bounded ones run max_iter
// out, so the issue slots go to the steps its warps execute, not to the
// steps its pixels need. The schedule, none of which enters the result:
//   * A branch-free body with a latch, as the Pallas kernel has it:
//     inside &= (|z|^2 <= 4). A pixel that has left goes on iterating
//     harmlessly to inf/NaN with its latch down. The exit test runs once
//     every C steps, so the compare and the branch leave the z chain. The
//     loop may overshoot max_iter by up to C - 1 steps; min(dwell, max_iter)
//     at the end undoes that exactly, because dwell is the count of leading
//     steps that stayed inside.
//   * No counter in the loop. The latch only falls, so the dwell is the
//     steps before the newest chunk plus the latches still up inside it,
//     added up once after the loop.
//   * The squares zr*zr and zi*zi are computed once a step and serve both the
//     escape test and the next step's update (the same products of the same
//     values, so the same bits): 4 mul, 4 add/sub and 1 compare a step.
//   * A compact warp footprint: a warp's 32 threads tile PATCH_W x PATCH_H
//     pixels instead of 32 columns of one row, so the dwells a warp waits
//     for are neighbours'; a block is WARPS such patches side by side.
// One pixel a thread: on this card the kernel runs at full occupancy, and
// several interleaved orbits a thread (2 and 4 were measured) lose more to
// the larger patch a warp then waits for than the extra independent chains
// win. A warp that refills finished lanes from a strip of pixels loses too:
// its refill path runs in nearly every round (PERF.md, K2, has the times).
// dwell_footprint reports C and the patch, for the step accounting of
// cmtci_torch/bench.py (mandelbrot_cuda.DWELL_FOOTPRINT must equal it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "escape.cuh"

namespace {

constexpr int C = 4;        // orbit steps between two exit tests
constexpr int PATCH_W = 4;  // pixels across a warp's patch
constexpr int PATCH_H = 8;  // pixels down a warp's patch
constexpr int WARPS = 4;    // warps a block, side by side along x
static_assert(PATCH_W * PATCH_H == 32, "a warp's patch is 32 threads");

__global__ void __launch_bounds__(32 * WARPS)
dwell_kernel(float* __restrict__ out, int nx, int ny, float xmin, float ymin, float dx,
             float dy, int max_iter) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int col = (blockIdx.x * WARPS + warp) * PATCH_W + lane % PATCH_W;
    const int row = blockIdx.y * PATCH_H + lane / PATCH_W;
    if (col >= nx || row >= ny) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;
    int dwell = max_iter;
    if (!interior_mask(cr, ci) && max_iter > 0) {
        float zr = 0.0f, zi = 0.0f, zr2 = 0.0f, zi2 = 0.0f;
        bool inside = true;
        bool up[C];  // the latch after each step of the newest chunk
        int n = 0;
        do {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float nzr = zr2 - zi2 + cr;
                const float nzi = 2.0f * zr * zi + ci;
                zr = nzr;
                zi = nzi;
                zr2 = nzr * nzr;
                zi2 = nzi * nzi;
                inside = inside && (zr2 + zi2 <= 4.0f);
                up[c] = inside;
            }
            n += C;
        } while (inside && n < max_iter);
        int in_chunk = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) in_chunk += up[c] ? 1 : 0;
        dwell = min(n - C + in_chunk, max_iter);
    }
    out[(size_t)row * (size_t)nx + (size_t)col] = (float)dwell;
}

__global__ void dwell_periodic_kernel(float* __restrict__ out, int nx, int ny, float xmin,
                                      float ymin, float dx, float dy, int max_iter) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= nx || row >= ny) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;
    const int dwell = dwell_count<true>(cr, ci, max_iter);
    out[(size_t)row * (size_t)nx + (size_t)col] = (float)dwell;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Each returns
// cudaGetLastError() as an int; the caller raises when it is not 0. They
// allocate nothing and do not synchronize.
extern "C" int dwell_launch(void* out, int nx, int ny, float xmin, float ymin, float dx,
                            float dy, int max_iter, void* stream) {
    const int block_cols = WARPS * PATCH_W;
    const dim3 grid((nx + block_cols - 1) / block_cols, (ny + PATCH_H - 1) / PATCH_H);
    dwell_kernel<<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), nx, ny, xmin, ymin, dx, dy, max_iter);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int dwell_periodic_launch(void* out, int nx, int ny, float xmin, float ymin,
                                     float dx, float dy, int max_iter, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
    dwell_periodic_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), nx, ny, xmin, ymin, dx, dy, max_iter);
    return static_cast<int>(cudaGetLastError());
}

// The schedule dwell_launch is built with: {C, PATCH_W, PATCH_H}.
extern "C" void dwell_footprint(int* out3) {
    out3[0] = C;
    out3[1] = PATCH_W;
    out3[2] = PATCH_H;
}
