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
//     |z|^2 > R^2, at 0-based step n, g = max(0.5 log(max(|z|^2, 1e-30))
//     2^-(n+1), 0) and the orbit stops (the Pallas kernel's escape latch
//     makes later steps irrelevant, so the thread's break is exact); a lane
//     that never escaped outputs 0.
//   * 2^-(n+1) is ldexpf(1, -(n+1)): an exact power of two, subnormal for
//     n+1 > 126 and 0 for n+1 > 149, so deep escapers give g = 0 in f32 as
//     in the reference, and the twin (numpy's f32 ldexp) is the same number.
//
// What bounds it on this card: FP32 issue (11 FP32 operations per step:
// 6 mul, 4 add/sub, 1 compare; a logf once per pixel; one 4-byte store a
// pixel), and warp divergence between early and late escapers. Design: the
// TPU kernel's per-tile while_loop exit became a per-thread break; no
// padding, the grid is exactly ny x nx. Making it fast is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
// Never --use_fast_math: it flushes the subnormal scales to zero.

#include <cuda_runtime.h>
#include <math.h>

#include "escape.cuh"

namespace {

__global__ void green_grid_kernel(float* __restrict__ out, int nx, int ny, float xmin,
                                  float ymin, float dx, float dy, int max_iter, float r2) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= nx || row >= ny) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;

    float g = 0.0f;
    if (!interior_mask(cr, ci)) {
        float zr = 0.0f, zi = 0.0f;
        for (int n = 0; n < max_iter; ++n) {
            const float nzr = zr * zr - zi * zi + cr;
            const float nzi = 2.0f * zr * zi + ci;
            zr = nzr;
            zi = nzi;
            const float a2 = zr * zr + zi * zi;
            if (a2 > r2) {
                const float val = 0.5f * logf(max_nan(a2, 1e-30f)) * ldexpf(1.0f, -(n + 1));
                g = max_nan(val, 0.0f);
                break;
            }
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
    const dim3 block(32, 8);
    const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
    green_grid_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), nx, ny, xmin, ymin, dx, dy, max_iter, r2);
    return static_cast<int>(cudaGetLastError());
}
