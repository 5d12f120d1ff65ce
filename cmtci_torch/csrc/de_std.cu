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
//     den = max(0, 1e-14); it skips the loop;
//   * otherwise up to max_iter steps of  dz <- 2 z dz + 1  then  z <- z^2 + c
//     (both from the old z); at the first |z|^2 > R^2 both z and dz are
//     latched and the orbit stops (the Pallas kernel freezes it, so the
//     thread's break is exact);
//   * d = log(max(|z_l|, 1)) |z_l| / max(|2 z_l dz_l|, 1e-14) with
//     |.| = sqrt of the sum of squares, in the reference's op order; a lane
//     that never escaped outputs 0. A dz that overflowed gives d = 0 (inf
//     den) or NaN (inf - inf), as in the reference: max_nan keeps a NaN.
//
// What bounds it on this card: FP32 issue (20 FP32 operations per step:
// 12 mul, 7 add/sub, 1 compare; no memory traffic but one 4-byte store a
// pixel), and warp divergence between early and late escapers. Design: the
// TPU kernel's per-tile while_loop exit became a per-thread break; no
// padding, the grid is exactly ny x nx. Making it fast is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

#include "escape.cuh"

namespace {

__global__ void de_std_kernel(float* __restrict__ out, int nx, int ny, float xmin,
                              float ymin, float dx, float dy, int max_iter, float r2) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= nx || row >= ny) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;

    float lzr = 0.0f, lzi = 0.0f, ldr = 1.0f, ldi = 0.0f;
    bool esc = interior_mask(cr, ci);
    if (!esc) {
        float zr = 0.0f, zi = 0.0f, dzr = 1.0f, dzi = 0.0f;
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
            if (zr * zr + zi * zi > r2) {
                esc = true;
                lzr = zr;
                lzi = zi;
                ldr = dzr;
                ldi = dzi;
                break;
            }
        }
    }

    const float az = sqrtf(lzr * lzr + lzi * lzi);
    const float pr = 2.0f * (lzr * ldr - lzi * ldi);
    const float pi = 2.0f * (lzr * ldi + lzi * ldr);
    const float num = logf(max_nan(az, 1.0f)) * az;
    const float den = max_nan(sqrtf(pr * pr + pi * pi), 1e-14f);
    out[(size_t)row * (size_t)nx + (size_t)col] = esc ? num / den : 0.0f;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// as an int; the caller raises when it is not 0. Allocates nothing and does
// not synchronize.
extern "C" int de_std_launch(void* out, int nx, int ny, float xmin, float ymin, float dx,
                             float dy, int max_iter, float r2, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
    de_std_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), nx, ny, xmin, ymin, dx, dy, max_iter, r2);
    return static_cast<int>(cudaGetLastError());
}
