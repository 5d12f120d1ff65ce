// K1: TCI distance-estimator field, one thread per pixel, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmtci/kernels/mandelbrot_pallas.py:_tci_kernel
// (the Appendix-A tracker's boundary-band head). Same function, same f32 op
// order: the Pallas body, this kernel and the plain-torch twin
// (cmtci_torch/kernels/mandelbrot_cuda.py:tci_de_field_torch) evaluate each
// product and sum in the order written below, so with -fmad=false the
// kernel and the twin agree bitwise on the card.
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
// What bounds it on this card: FP32 issue (about 20 flops per step, no
// memory traffic but the one 4-byte store), and warp divergence between
// early and late escapers — a warp runs as long as its slowest lane.
// Design: the TPU kernel's tile-level early exit (a while_loop over chunks
// that stops when every lane of a tile is done) became per-thread exit: a
// thread breaks once it has escaped AND its dz is non-finite. That exit is
// exact, because a non-finite dz never becomes finite again and d is then 0
// whatever further steps would do. No padding: the grid is exactly
// grid_n x grid_n. Making it fast (lane compaction, warp-level
// rescheduling) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
// Never --use_fast_math: it flushes denormals, approximates logf/division
// and re-enables contraction.

#include <cuda_runtime.h>
#include <math.h>

#include "escape.cuh"

namespace {

// max that propagates NaN like jnp.maximum / torch.maximum (fmaxf(NaN, x)
// returns x, which would turn a NaN dz lane into a huge finite d).
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a) ? a : fmaxf(a, b);
}

__global__ void tci_de_kernel(float* __restrict__ out, int n, float xmin, float ymin,
                              float dx, float dy, int max_iter, float r2) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= n || row >= n) return;

    const float cr = xmin + (float)col * dx;
    const float ci = ymin + (float)row * dy;

    float zr = 0.0f, zi = 0.0f, dzr = 1.0f, dzi = 0.0f, lzr = 0.0f, lzi = 0.0f;
    bool esc = false;
    if (!interior_mask(cr, ci)) {
        for (int it = 0; it < max_iter; ++it) {
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
    }

    const float az = sqrtf(lzr * lzr + lzi * lzi);
    const float pr = 2.0f * lzr * dzr - 2.0f * lzi * dzi;
    const float pi = 2.0f * lzr * dzi + 2.0f * lzi * dzr;
    const float den = max_nan(sqrtf(pr * pr + pi * pi), 1e-12f);
    const float num = logf(max_nan(az, 1.0f)) * az;
    float d = num / den;
    if (!isfinite(d)) d = 0.0f;
    out[(size_t)row * (size_t)n + (size_t)col] = esc ? d : -1.0f;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// as an int; the caller raises when it is not 0. Allocates nothing and does
// not synchronize.
extern "C" int tci_de_launch(void* out, int grid_n, float xmin, float ymin, float dx,
                             float dy, int max_iter, float r2, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((grid_n + block.x - 1) / block.x, (grid_n + block.y - 1) / block.y);
    tci_de_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), grid_n, xmin, ymin, dx, dy, max_iter, r2);
    return static_cast<int>(cudaGetLastError());
}
