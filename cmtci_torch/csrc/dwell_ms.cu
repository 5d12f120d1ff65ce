// K6: the fine pass of the Mariani-Silver dwell field, one thread per pixel,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel cmtci/kernels/mandelbrot_pallas.py:_dwell_kernel
// with ms=True (launched by _dwell_ms, reached through dwell_field_ms). The
// host side (cmtci_torch/kernels/mandelbrot_cuda.py:dwell_field_ms) runs the
// coarse pass on K2 (dwell.cu) at every stride-th pixel and decides one f32
// fill flag per (th, tw) tile on the device; this kernel then writes
//   * the flag, where it is >= 0 (a tile whose coarse samples and one-sample
//     halo all have that dwell), for every pixel of the tile, interior ones
//     included, as the Pallas kernel does;
//   * escape.cuh:dwell_count, the plain loop K2 runs, where the flag is -1.
// With -fmad=false the output equals the plain twin
// (mandelbrot_cuda.dwell_fill_torch) bitwise, and equals K2 wherever the
// fill decision is right (tests/test_pallas_kernel.py holds the reference to
// K2 bitwise at its configs; chip_smoke.py does the same here).
//
// What bounds it on this card: as K2, FP32 issue (11 FP32 operations per
// step) and warp divergence, on the tiles that are not filled; a filled tile
// costs one 4-byte load (cached: every thread of a tile reads the same flag)
// and one 4-byte store per pixel. Design: the TPU kernel's per-tile skip of
// its while_loop becomes a per-thread branch; a block of 32 x 8 threads lies
// inside one tile when th and tw are multiples of 8 and 32, so a filled
// tile's warps never diverge. The TPU measured the two-pass scheme
// net-negative (VALIDATION.md, "Mariani-Silver"): the filled tiles are the
// ones whose pixels escape in a few steps or skip as interior anyway.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "escape.cuh"

namespace {

__global__ void dwell_ms_kernel(const float* __restrict__ fill, float* __restrict__ out,
                                int nx, int ny, float xmin, float ymin, float dx,
                                float dy, int max_iter, int th, int tw) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= nx || row >= ny) return;

    const float fv = fill[(row / th) * (nx / tw) + col / tw];
    float v = fv;
    if (!(fv >= 0.0f)) {
        const float cr = xmin + (float)col * dx;
        const float ci = ymin + (float)row * dy;
        v = (float)dwell_count<false>(cr, ci, max_iter);
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
    const dim3 block(32, 8);
    const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
    dwell_ms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(fill), static_cast<float*>(out), nx, ny, xmin, ymin, dx,
        dy, max_iter, th, tw);
    return static_cast<int>(cudaGetLastError());
}
