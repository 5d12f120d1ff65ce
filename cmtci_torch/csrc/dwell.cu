// K2: escape-time dwell field, one thread per pixel, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmtci/kernels/mandelbrot_pallas.py:_dwell_kernel
// (the `cmtci boundary` head, reached through mandelbrot_field_pallas). Same
// function, same f32 op order as the Pallas body and as the plain-torch twin
// (cmtci_torch/kernels/mandelbrot_cuda.py:dwell_field_torch); with -fmad=false
// the kernel and the twin agree bitwise on the card.
//
// What it computes, per pixel c = (xmin + col*dx, ymin + row*dy) in f32:
//   * escape.cuh:dwell_count, shared with K6's fine pass (dwell_ms.cu): an
//     analytically interior pixel outputs max_iter and skips the loop;
//     otherwise, for n = 0..max_iter-1: z <- (zr*zr - zi*zi + cr,
//     2*zr*zi + ci); stop if !(|z|^2 <= 4) (so NaN counts as an escape);
//     else dwell += 1. The output is (float)dwell: the first n with
//     |z_{n+1}|^2 > 4, else max_iter.
//   * dwell_periodic_launch runs the same loop with the Pallas kernel's
//     optional Brent periodicity check (escape.cuh:dwell_count<true>; public
//     switch mandelbrot_field(periodicity=True)): a pixel whose orbit returns
//     bitwise to a checkpoint stops early with max_iter. Its output is the
//     plain kernel's for every input. The check costs two compares and a
//     checkpoint move per step and pays only where bounded, non-analytic
//     pixels would otherwise run a long max_iter out. The flag is a template
//     parameter, so the plain kernel keeps its registers.
//
// What bounds it on this card: FP32 issue (11 FP32 operations per step:
// 6 mul, 4 add/sub, 1 compare; no memory traffic but one 4-byte store a
// pixel), and warp divergence between
// far-field pixels (a few steps) and boundary and filament pixels (up to
// max_iter): a warp runs as long as its slowest lane. Design: the TPU
// kernel's per-tile while_loop exit became a per-thread break, which is
// exact (the Pallas `act` latch stops counting at the same step). No padding:
// the grid is exactly ny x nx. Making it fast is later work; the TPU record
// of the Mariani-Silver tile fill (K6) says tile-fill tricks do not help.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "escape.cuh"

namespace {

template <bool PERIODIC>
__global__ void dwell_kernel(float* __restrict__ out, int nx, int ny, float xmin,
                             float ymin, float dx, float dy, int max_iter) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= nx || row >= ny) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;
    const int dwell = dwell_count<PERIODIC>(cr, ci, max_iter);
    out[(size_t)row * (size_t)nx + (size_t)col] = (float)dwell;
}

template <bool PERIODIC>
int launch(void* out, int nx, int ny, float xmin, float ymin, float dx, float dy,
           int max_iter, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
    dwell_kernel<PERIODIC><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), nx, ny, xmin, ymin, dx, dy, max_iter);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Each returns
// cudaGetLastError() as an int; the caller raises when it is not 0. They
// allocate nothing and do not synchronize.
extern "C" int dwell_launch(void* out, int nx, int ny, float xmin, float ymin, float dx,
                            float dy, int max_iter, void* stream) {
    return launch<false>(out, nx, ny, xmin, ymin, dx, dy, max_iter, stream);
}

extern "C" int dwell_periodic_launch(void* out, int nx, int ny, float xmin, float ymin,
                                     float dx, float dy, int max_iter, void* stream) {
    return launch<true>(out, nx, ny, xmin, ymin, dx, dy, max_iter, stream);
}
