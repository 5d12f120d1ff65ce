// K6: the fine pass of the Mariani-Silver dwell field, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmtci/kernels/mandelbrot_pallas.py:_dwell_kernel
// with ms=True (launched by _dwell_ms, reached through dwell_field_ms). The
// host side (cmtci_torch/kernels/mandelbrot_cuda.py:dwell_field_ms) runs the
// coarse pass on K2 (dwell.cu) at every stride-th pixel and decides one f32
// fill flag per (th, tw) tile on the device; this kernel then writes
//   * the flag, where it is >= 0 (a tile whose coarse samples and one-sample
//     halo all have that dwell), for every pixel of the tile, interior ones
//     included, as the Pallas kernel does;
//   * escape.cuh:dwell_chunked, the loop K2 runs, where the flag is -1.
// With -fmad=false the output equals the plain twin
// (mandelbrot_cuda.dwell_fill_torch) bitwise, and equals K2 wherever the
// fill decision is right (tests/test_pallas_kernel.py holds the reference to
// K2 bitwise at its configs; chip_smoke.py does the same here).
//
// What bounds it on this card: as K2, FP32 issue and warp divergence, on the
// tiles that are not filled; a filled tile costs one 4-byte load (cached:
// the threads of a tile read the same flag) and one 4-byte store per pixel.
// Design: K2's schedule (dwell.cu): a latched, branch-free step with the
// squares carried (9 FP32 operations), the exit test once every C steps, a
// warp on a PATCH_W x PATCH_H patch, WARPS patches a block, the rows of
// blocks from the middle of the grid outwards (escape.cuh:patch_pixel). The
// TPU kernel's per-tile skip of its while_loop becomes a per-thread branch
// on the flag, read once a thread. A block lies inside one tile when th is
// a multiple of PATCH_H and tw of WARPS * PATCH_W (the default (32, 256)
// tile is), so a filled tile's warps never diverge; a block that straddles
// tiles is still right, each thread reading its own tile's flag. Measured in
// turns at 2048^2 on an H100 80GB HBM3 at 700 W, ms per launch of 20 chained
// (PERF.md, K6): this schedule 0.0570; rows in order 0.0593; C = 3 / 6 / 8
// 0.0577 / 0.0567 / 0.0601; the earlier design, one pixel a thread on
// (32, 8) blocks with a compare and a break in every step (11 operations),
// 0.1026. The TPU measured the two-pass scheme net-negative (VALIDATION.md,
// "Mariani-Silver"): the filled tiles are the ones whose pixels escape in a
// few steps or skip as interior anyway. dwell_ms_footprint reports C and the
// patch (mandelbrot_cuda.DWELL_MS_FOOTPRINT must equal it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "escape.cuh"

namespace {

constexpr int C = 4;           // orbit steps between two exit tests
constexpr int PATCH_W = 4;     // pixels across a warp's patch
constexpr int PATCH_H = 8;     // pixels down a warp's patch
constexpr int WARPS = 4;       // warps a block, side by side along x

__global__ void __launch_bounds__(32 * WARPS)
dwell_ms_kernel(const float* __restrict__ fill, float* __restrict__ out, int nx, int ny,
                float xmin, float ymin, float dx, float dy, int max_iter, int th, int tw) {
    int col, row;
    patch_pixel<PATCH_W, PATCH_H, WARPS, true>(col, row);
    if (col >= nx || row >= ny) return;

    const float fv = fill[(row / th) * (nx / tw) + col / tw];
    float v = fv;
    if (!(fv >= 0.0f)) {
        const float cr = xmin + (float)col * dx;
        const float ci = ymin + (float)row * dy;
        v = (float)dwell_chunked<C, false>(cr, ci, max_iter);
    }
    out[(size_t)row * (size_t)nx + (size_t)col] = v;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). fill holds (ny/th)*(nx/tw)
// f32 flags, row-major over the tile grid; ny and nx must be multiples of th
// and tw (the wrapper checks). Returns cudaGetLastError() as an int; the
// caller raises when it is not 0. Allocates nothing and does not synchronize.
extern "C" int dwell_ms_launch(const void* fill, void* out, int nx, int ny, float xmin,
                               float ymin, float dx, float dy, int max_iter, int th,
                               int tw, void* stream) {
    const int block_cols = WARPS * PATCH_W;
    const dim3 grid((nx + block_cols - 1) / block_cols, (ny + PATCH_H - 1) / PATCH_H);
    dwell_ms_kernel<<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(fill), static_cast<float*>(out), nx, ny, xmin, ymin, dx,
        dy, max_iter, th, tw);
    return static_cast<int>(cudaGetLastError());
}

// The schedule dwell_ms_launch is built with: {C, PATCH_W, PATCH_H}.
extern "C" void dwell_ms_footprint(int* out3) {
    out3[0] = C;
    out3[1] = PATCH_W;
    out3[2] = PATCH_H;
}
