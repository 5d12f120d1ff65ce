// K3: resumable Green escape records of a point cloud, one thread per point,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel cmtci/kernels/mandelbrot_pallas.py:_cloud_green_kernel
// (the `cmtci equipotential` head, reached through green_cloud_f32). Same
// function, same f32 op order as the Pallas body and as the plain-torch twin
// (cmtci_torch/kernels/mandelbrot_cuda.py:cloud_green_torch); with
// -fmad=false the kernel and the twin agree bitwise on every output.
//
// What it computes, per point i of m, from c = (cr[i], ci[i]) and the resumed
// state z = (zr0[i], zi0[i]), all f32:
//   * act starts at 0 for an analytically interior c (escape.cuh), else 1;
//   * for n = 0..iters-1 while act: z <- (zr*zr - zi*zi + cr, 2*zr*zi + ci);
//     on |z|^2 > r2 (inf counts as an escape): k = n+1 (relative to this
//     launch, 1-based), latch z into (zer, zei), act = 0.
// Output: one f32 (6, m) buffer, rows k, zer, zei, zr, zi, act (k <= iters
// <= 20000 < 2^24 and act in {0, 1}, so both are exact in f32). One buffer
// means one copy to the host per stage.
//
// Difference from the TPU kernel, and why it is harmless: a thread breaks
// once act == 0, so an inactive lane's z state is frozen, where the TPU
// kernel goes on iterating it (mandelbrot_pallas.py:648-650). Only the zr/zi
// rows of inactive lanes differ. The host drops escaped lanes before it reads
// the state (mandelbrot_pallas.py:787-792), and an interior lane can never
// hit, so every output the host reads is the same. The twin freezes too, so
// kernel and twin compare bitwise on every row.
//
// What bounds it on this card: FP32 issue and warp divergence. Escape times
// in one warp range from 1 step to the full budget (the points that never
// escape run all 20000 steps). The host drops analytically interior points
// before the launch, as the reference does. Making it fast (sorting points by
// expected escape time, lane compaction) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "escape.cuh"

namespace {

__global__ void cloud_green_kernel(const float* __restrict__ cr_in,
                                   const float* __restrict__ ci_in,
                                   const float* __restrict__ zr0,
                                   const float* __restrict__ zi0, float* __restrict__ out,
                                   int m, int iters, float r2) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;

    const float cr = cr_in[i];
    const float ci = ci_in[i];
    float zr = zr0[i];
    float zi = zi0[i];
    float k = 0.0f, zer = 0.0f, zei = 0.0f;
    bool act = !interior_mask(cr, ci);
    for (int n = 0; act && n < iters; ++n) {
        const float nzr = zr * zr - zi * zi + cr;
        const float nzi = 2.0f * zr * zi + ci;
        zr = nzr;
        zi = nzi;
        if (zr * zr + zi * zi > r2) {
            k = (float)(n + 1);
            zer = zr;
            zei = zi;
            act = false;
        }
    }
    const size_t sm = (size_t)m;
    out[i] = k;
    out[sm + i] = zer;
    out[2 * sm + i] = zei;
    out[3 * sm + i] = zr;
    out[4 * sm + i] = zi;
    out[5 * sm + i] = act ? 1.0f : 0.0f;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Returns cudaGetLastError()
// as an int; the caller raises when it is not 0. Allocates nothing and does
// not synchronize. m must be >= 1.
extern "C" int cloud_green_launch(const void* cr, const void* ci, const void* zr0,
                                  const void* zi0, void* out, int m, int iters, float r2,
                                  void* stream) {
    const int block = 256;
    const int grid = (m + block - 1) / block;
    cloud_green_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cr), static_cast<const float*>(ci),
        static_cast<const float*>(zr0), static_cast<const float*>(zi0),
        static_cast<float*>(out), m, iters, r2);
    return static_cast<int>(cudaGetLastError());
}
