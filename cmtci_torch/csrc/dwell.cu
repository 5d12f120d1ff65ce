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
// Three entry points, all on the one loop escape.cuh:dwell_chunked:
//   * dwell_launch, the plain kernel, on every pipeline's path.
//   * dwell_rows_launch, the plain kernel on the rows [row0, row0 + ny) of a
//     taller grid: ci = ymin + (float)(row0 + row)*dy, so a block of rows is
//     bitwise those rows of the whole grid (a rank's block under
//     `--devices N`, parallel/sharded.py:sharded_dwell_field).
//   * dwell_periodic_launch adds the Pallas kernel's optional Brent
//     periodicity check (public switch mandelbrot_field(periodicity=True)):
//     a pixel whose orbit returns bitwise to a checkpoint stops early with
//     max_iter. Its output is the plain kernel's for every input. The check
//     pays only where bounded, non-analytic pixels would otherwise run a long
//     max_iter out. It has its own constants (P_*), so that either entry can
//     be tuned alone.
//
// What bounds both on this card: FP32 issue. There is no load and one 4-byte
// store a pixel; a warp runs as long as its slowest pixel, while far-field
// pixels leave after a few steps and bounded ones run max_iter out (or, in
// the periodic entry, until their cycle is caught), so the issue slots go to
// the steps its warps execute, not to the steps its pixels need. The
// schedule (escape.cuh:dwell_chunked says why none of it enters the result):
//   * a latched, branch-free step with the squares carried (4 mul, 4 add/sub,
//     1 compare), the exit test once every C steps, the dwell added up after
//     the loop and clamped;
//   * a compact warp footprint (escape.cuh:patch_pixel): a warp's 32 threads
//     tile PATCH_W x PATCH_H pixels instead of 32 columns of one row, so the
//     dwells a warp waits for are neighbours'; a block is WARPS such patches
//     side by side;
//   * the periodic entry moves its checkpoint only at chunk ends, and runs
//     chunks of P_C = 8 steps, compares z with its checkpoint once a chunk
//     and hands out the rows of blocks from the middle of the grid outwards.
//     Measured in turns at 2000^2 on an H100 80GB HBM3 at 700 W, ms per
//     launch of 20 chained at max_iter 500 / 20,000
//     (PERF.md, K2p): this schedule 0.0554 / 0.764; rows in order 0.0597 /
//     0.762; C = 4 with the compare in every step 0.0712 / 1.092 (it catches
//     a cycle a few steps sooner, which does not pay for its compares), once
//     a chunk 0.0639 / 0.910; C = 12 0.0599 / 0.650 (37 registers); the
//     earlier design, one pixel a thread on (32, 8) blocks with a compare
//     and a break in every step, 0.1496 / 2.671; the plain kernel 0.0496 /
//     1.224.
// One pixel a thread: on this card the kernel runs at full occupancy, and
// several interleaved orbits a thread (2 and 4 were measured) lose more to
// the larger patch a warp then waits for than the extra independent chains
// win. A warp that refills finished lanes from a strip of pixels loses too:
// its refill path runs in nearly every round (PERF.md, K2, has the times).
// dwell_footprint and dwell_periodic_footprint report C and the patch, for
// the step accounting of
// cmtci_torch/bench.py (mandelbrot_cuda.DWELL_FOOTPRINT and
// DWELL_PERIODIC_FOOTPRINT must equal them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "escape.cuh"

namespace {

// the plain kernel
constexpr int C = 4;        // orbit steps between two exit tests
constexpr int PATCH_W = 4;  // pixels across a warp's patch
constexpr int PATCH_H = 8;  // pixels down a warp's patch
constexpr int WARPS = 4;    // warps a block, side by side along x
// the periodic entry
constexpr int P_C = 8;
constexpr int P_PATCH_W = 4;
constexpr int P_PATCH_H = 8;
constexpr int P_WARPS = 4;

__global__ void __launch_bounds__(32 * WARPS)
dwell_kernel(float* __restrict__ out, int nx, int ny, int row0, float xmin, float ymin,
             float dx, float dy, int max_iter) {
    int col, row;
    patch_pixel<PATCH_W, PATCH_H, WARPS, false>(col, row);
    if (col >= nx || row >= ny) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)(row0 + row) * dy;
    const int dwell = dwell_chunked<C, false>(cr, ci, max_iter);
    out[(size_t)row * (size_t)nx + (size_t)col] = (float)dwell;
}

__global__ void __launch_bounds__(32 * P_WARPS)
dwell_periodic_kernel(float* __restrict__ out, int nx, int ny, float xmin, float ymin,
                      float dx, float dy, int max_iter) {
    int col, row;
    patch_pixel<P_PATCH_W, P_PATCH_H, P_WARPS, true>(col, row);
    if (col >= nx || row >= ny) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;
    const int dwell = dwell_chunked<P_C, true>(cr, ci, max_iter);
    out[(size_t)row * (size_t)nx + (size_t)col] = (float)dwell;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Each returns
// cudaGetLastError() as an int; the caller raises when it is not 0. They
// allocate nothing and do not synchronize.
extern "C" int dwell_rows_launch(void* out, int nx, int ny, int row0, float xmin,
                                 float ymin, float dx, float dy, int max_iter, void* stream) {
    const int block_cols = WARPS * PATCH_W;
    const dim3 grid((nx + block_cols - 1) / block_cols, (ny + PATCH_H - 1) / PATCH_H);
    dwell_kernel<<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), nx, ny, row0, xmin, ymin, dx, dy, max_iter);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int dwell_launch(void* out, int nx, int ny, float xmin, float ymin, float dx,
                            float dy, int max_iter, void* stream) {
    return dwell_rows_launch(out, nx, ny, 0, xmin, ymin, dx, dy, max_iter, stream);
}

extern "C" int dwell_periodic_launch(void* out, int nx, int ny, float xmin, float ymin,
                                     float dx, float dy, int max_iter, void* stream) {
    const int block_cols = P_WARPS * P_PATCH_W;
    const dim3 grid((nx + block_cols - 1) / block_cols, (ny + P_PATCH_H - 1) / P_PATCH_H);
    dwell_periodic_kernel<<<grid, 32 * P_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), nx, ny, xmin, ymin, dx, dy, max_iter);
    return static_cast<int>(cudaGetLastError());
}

// The schedule dwell_launch is built with: {C, PATCH_W, PATCH_H}.
extern "C" void dwell_footprint(int* out3) {
    out3[0] = C;
    out3[1] = PATCH_W;
    out3[2] = PATCH_H;
}

// The schedule dwell_periodic_launch is built with: {P_C, P_PATCH_W, P_PATCH_H}.
extern "C" void dwell_periodic_footprint(int* out3) {
    out3[0] = P_C;
    out3[1] = P_PATCH_W;
    out3[2] = P_PATCH_H;
}
