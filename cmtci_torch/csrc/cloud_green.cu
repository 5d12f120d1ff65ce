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
// Difference from the TPU kernel, and why it is harmless: a thread stops
// once act == 0, so an inactive lane's z state is frozen, where the TPU
// kernel goes on iterating it (mandelbrot_pallas.py:648-650). Only the zr/zi
// rows of inactive lanes differ. The host drops escaped lanes before it reads
// the state (mandelbrot_pallas.py:787-792), and an interior lane can never
// hit, so every output the host reads is the same. The twin freezes too, so
// kernel and twin compare bitwise on every row.
//
// What bounds it on this card: the dependent chain of the longest lane. The
// cloud's 3.7 M useful steps are nothing for the FP32 pipes and the points
// fill a quarter of the card's warp slots, so the launch lasts as long as
// the few lanes that never escape: iters steps, each a mul -> sub -> add on
// the z carried from the step before. A loop that tests the radius in every
// step puts the compare and the branch on that chain too, since a GPU does
// not speculate past a branch. The design does two things about it.
//   * Speculative chunks with exact replay. A thread saves z, runs S steps
//     of the bare update with no branch, and keeps one sticky flag
//     hit |= (|z|^2 > r2) off the z chain. The first step over the radius is
//     computed from the same values as in the step-by-step loop, so the flag
//     cannot miss it, whatever later steps of the chunk overflow to. No hit:
//     go on. Hit: restore the saved z and run the chunk again step by step
//     with the plain loop body, which yields the exact k, the latch and the
//     frozen z. The replay runs the same operations on the same values, so
//     the schedule does not enter the result. The squares zr*zr and zi*zi
//     serve both the radius test and the next update (the same products of
//     the same values). The last iters mod S steps run through the plain
//     body, which needs no replay.
//   * One long chain a scheduler. A bare step is 9 FP32 instructions on a
//     chain about 13 cycles long, so two long lanes in two warps of one
//     scheduler share its issue slots and both slow down (measured: 0.20 ms
//     with every block resident, 0.16 ms with one block an SM, on the default
//     cloud). The launcher therefore asks for dynamic shared memory the
//     kernel never touches, sized so that an SM holds few blocks (one, i.e.
//     one warp a scheduler, for a cloud of this size) and the others are
//     dispatched as blocks finish; for a larger cloud it lets an SM hold
//     more, so that the blocks pass in at most about WAVES rounds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "escape.cuh"

namespace {

constexpr int S = 64;       // steps of a speculative chunk
constexpr int BLOCK = 128;  // threads a block: one warp for each scheduler of an SM
constexpr int WAVES = 8;    // rounds of blocks an SM should at most see
constexpr int SMEM_KB = 224;  // dynamic shared memory shared out among an SM's blocks

__global__ void __launch_bounds__(BLOCK)
cloud_green_kernel(const float* __restrict__ cr_in, const float* __restrict__ ci_in,
                   const float* __restrict__ zr0, const float* __restrict__ zi0,
                   float* __restrict__ out, int m, int iters, float r2) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= m) return;

    const float cr = cr_in[i];
    const float ci = ci_in[i];
    float zr = zr0[i];
    float zi = zi0[i];
    float k = 0.0f, zer = 0.0f, zei = 0.0f;
    bool act = !interior_mask(cr, ci);
    if (act) {
        // whole chunks, speculatively; n counts the steps of this launch behind z
        int n = 0;
        float sr = zr, si = zi;
        bool hit = false;
        for (; n + S <= iters; n += S) {
            sr = zr;
            si = zi;
            float zr2 = zr * zr, zi2 = zi * zi;
#pragma unroll
            for (int s = 0; s < S; ++s) bare_step(zr, zi, zr2, zi2, hit, cr, ci, r2);
            if (hit) break;
        }
        // the flagged chunk again from the saved z, or the last iters mod S
        // steps, with the plain loop body
        if (hit) {
            zr = sr;
            zi = si;
        }
        const int stop = hit ? n + S : iters;
        for (; n < stop; ++n) {
            const float nzr = zr * zr - zi * zi + cr;
            const float nzi = 2.0f * zr * zi + ci;
            zr = nzr;
            zi = nzi;
            if (zr * zr + zi * zi > r2) {
                k = (float)(n + 1);
                zer = zr;
                zei = zi;
                act = false;
                break;
            }
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
    const int grid = (m + BLOCK - 1) / BLOCK;
    int device = 0, sms = 1;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    // blocks an SM holds at once; 2048 threads fill it whatever is asked for
    const int per_sm = (grid + WAVES * sms - 1) / (WAVES * sms);
    const int smem = per_sm >= 2048 / BLOCK ? 0 : SMEM_KB / per_sm * 1024;
    cudaFuncSetAttribute(cloud_green_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cloud_green_kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cr), static_cast<const float*>(ci),
        static_cast<const float*>(zr0), static_cast<const float*>(zi0),
        static_cast<float*>(out), m, iters, r2);
    return static_cast<int>(cudaGetLastError());
}
