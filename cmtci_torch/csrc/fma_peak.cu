// K7: chained-FMA ceiling microkernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel `kern` nested in bench.py:_bench_vpu_peak
// (bench.py:238-248): every output element is x0 after k chained steps
// x <- x*a + b, with no input. Its measured rate is the denominator of the
// bench's *_mfu keys (cmtci_torch/bench.py): what the card's FP32 pipes
// demonstrably sustain for a register-resident dependent chain, the regime of
// the escape-time kernels. The plain-torch twin is
// cmtci_torch/kernels/fma_peak.py:fma_chain_torch.
//
// The build compiles every kernel with -fmad=false, so that a product and a
// sum written apart stay apart. Here the step IS the fused operation: it is
// written as __fmaf_rn, one FP32 instruction and two floating-point
// operations. A plain x*a + b would compile to a multiply and an add under
// that flag and measure half the ceiling. With the bench's constants
// (a = f32(0.9999999) = 1 - 2^-23, b = f32(1e-7), x0 = f32(1.0000001) =
// 1 + 2^-23) the fused and the unfused step both map x0 to itself, so the
// kernel and the unfused twin are bitwise equal (every element 0x3F800001).
//
// What bounds it on this card: FP32 issue, nothing else. There is no load and
// one 4-byte store an element; the work is 2*k operations an element, and the
// least time is 2*k*n / (SMs * 128 lanes * 2 * clock). A warp's chain is
// dependent, each FMA waiting on the one before. Design: a thread runs
// kElems = 4 independent chains. Measured on an H100 at full occupancy (16
// resident warps a scheduler), one chain a thread reached half the FP32 rate,
// two chains two thirds and four chains 96% of it (PERF.md, K7), so four it
// is. The loop is unrolled 64 steps so
// that its counter and branch cost about 1/20 of the issue slots. a, b and x0
// are kernel arguments and the result is stored, so the compiler can neither
// fold the chain nor drop it; `spread` (0 from the wrapper) makes a thread's
// starting values differ in the compiler's eyes, so that it cannot merge the
// chains into one.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 4;  // independent chains a thread

__global__ void fma_peak_kernel(float* __restrict__ out, long long n, int k, float x0,
                                float a, float b, float spread) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float x[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) x[e] = x0 + (float)e * spread;
#pragma unroll 64
    for (int i = 0; i < k; ++i) {
#pragma unroll
        for (int e = 0; e < kElems; ++e) x[e] = __fmaf_rn(x[e], a, b);
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
        const long long j = first + (long long)e * stride;
        if (j < n) out[j] = x[e];
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream): out[0..n) <- k chained steps
// from x0, kElems elements a thread. Returns cudaGetLastError() as an int; the
// caller raises when it is not 0. Allocates nothing and does not synchronize.
extern "C" int fma_peak_launch(void* out, long long n, int k, float x0, float a, float b,
                               float spread, void* stream) {
    if (n <= 0) return 0;
    const long long threads = (n + kElems - 1) / kElems;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    fma_peak_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), n, k, x0, a, b, spread);
    return static_cast<int>(cudaGetLastError());
}
