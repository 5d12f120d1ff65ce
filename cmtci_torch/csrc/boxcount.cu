// Box counting for Hopper (sm_90a): the occupied boxes of every (cloud,
// scale) of cmtci_torch.stats.pointstats.fractal_dimensions, in one launch.
//
// Replaces no TPU kernel: the JAX reference counts boxes on the host, one
// np.unique sort of a cloud's integer rows a scale
// (cmtci/stats/pointstats.py:197), ten sorts a cloud at the default scales.
// Here every point of every cloud is keyed at every scale, and a box is a
// bit of its (cloud, scale) bitmap. The plain-torch twin is
// cmtci_torch/kernels/boxcount.py:box_counts_torch.
//
// Exactness. A point's box at scale k is (floor((x - mins_x) / step_x),
// floor((y - mins_y) / step_y)), with mins and step = rng * s computed on the
// host by numpy and passed as f64. The subtraction and the division are
// __dsub_rn and __ddiv_rn: IEEE round to nearest, no reciprocal multiply, so
// each key is bitwise numpy's. Both are monotone in x, so the wrapper bounds
// every key by the keys of the cloud's extreme points and refuses a layout
// that those overflow; the kernel clamps nothing.
//
// Layout (the wrapper's, boxcount.py:box_layout): scale k's bitmap is
// W_k x W_k bits, bit kx * W_k + ky, from word offset[k]; one cloud's
// bitmaps are `words` words, cloud c's from c * words. The int32 count of
// each (cloud, scale) is the popcount of its bitmap.
//
// What bounds it on this card: the bytes, 16 a point read once (2.4 MB for a
// 150,000-point cloud, 0.7 us at 3.35 TB/s; the bitmaps are 2 KB a cloud at
// the default scales), with the 20 f64 divisions a point close behind (each
// a reciprocal and Newton steps on the FP64 pipes). Design: a CTA takes
// kPointsPerCta consecutive points of one cloud and first copies its
// cloud's steps, the sides and the offsets into shared memory. When a
// cloud's bitmaps fit beside them in kSmemBytes, the CTA sets its bits in
// its own copy in shared memory, reading a word before it sets a bit so that
// the coarse scales' few words see few atomics, then ORs its non-zero words
// into device memory; larger bitmaps (caller-given fine scales) take
// atomicOr in device memory directly. The last CTA to finish (a ticket in
// device memory) popcounts every bitmap and writes the counts, so nothing
// else is launched.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kPointsPerCta = 2048;
// the most bytes of dynamic shared memory the per-scale table and a cloud's
// bitmaps may take for the bitmaps to go there: 32 KB, inside the 48 KB a
// launch takes without an opt-in (the default scales need 240 + 2,072)
constexpr long long kSmemBytes = 32768;

__device__ __forceinline__ void set_bit(unsigned* words, long long bit) {
    unsigned* w = words + (bit >> 5);
    const unsigned b = 1u << (bit & 31);
    if (!(*w & b)) atomicOr(w, b);
}

// iparams: pt_first[nclouds + 1], cta_first[nclouds + 1], width[nscales],
// offset[nscales + 1]; fparams: mins[2 * nclouds], then each cloud's
// (step_x, step_y) of each scale. Dynamic shared memory: the CTA's cloud's
// steps (2 * nscales doubles), the widths and the offsets (int), then, when
// kShared, the cloud's bitmaps. The table keeps few values live across the
// divisions' slow-path calls, which is what keeps the loop free of spills.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
boxcount_kernel(const double2* __restrict__ xy, const double* __restrict__ fparams,
                const long long* __restrict__ iparams, int nclouds, int nscales,
                long long words, unsigned* __restrict__ bitmaps, int* __restrict__ counts,
                unsigned* __restrict__ ticket) {
    extern __shared__ double table[];
    __shared__ bool last;
    __shared__ int partial[kThreads / 32];
    double* step = table;
    int* width = reinterpret_cast<int*>(step + 2 * nscales);
    int* offset = width + nscales;
    unsigned* shared_bits = reinterpret_cast<unsigned*>(offset + nscales + 1);
    const long long* pt_first = iparams;
    const long long* cta_first = pt_first + nclouds + 1;

    int c = 0;
    while (blockIdx.x >= cta_first[c + 1]) ++c;
    for (int k = threadIdx.x; k < nscales; k += kThreads) {
        step[2 * k] = fparams[2 * nclouds + 2LL * (c * nscales + k)];
        step[2 * k + 1] = fparams[2 * nclouds + 2LL * (c * nscales + k) + 1];
        width[k] = (int)cta_first[nclouds + 1 + k];
    }
    for (int k = threadIdx.x; k <= nscales; k += kThreads)
        offset[k] = (int)cta_first[nclouds + 1 + nscales + k];
    unsigned* bits = kShared ? shared_bits : bitmaps + c * words;
    if (kShared)
        for (long long i = threadIdx.x; i < words; i += kThreads) shared_bits[i] = 0u;
    __syncthreads();

    const double mx = fparams[2 * c], my = fparams[2 * c + 1];
    const long long first = pt_first[c] + (blockIdx.x - cta_first[c]) * kPointsPerCta;
    const double2* pts = xy + first;
    const int n = (int)(min(first + kPointsPerCta, pt_first[c + 1]) - first);
    for (int p = threadIdx.x; p < n; p += kThreads) {
        const double2 q = pts[p];
        const double dx = __dsub_rn(q.x, mx), dy = __dsub_rn(q.y, my);
        for (int k = 0; k < nscales; ++k) {
            const int kx = (int)floor(__ddiv_rn(dx, step[2 * k]));
            const int ky = (int)floor(__ddiv_rn(dy, step[2 * k + 1]));
            set_bit(bits + offset[k], (long long)kx * width[k] + ky);
        }
    }
    if (kShared) {
        __syncthreads();
        unsigned* mine = bitmaps + c * words;
        for (long long i = threadIdx.x; i < words; i += kThreads) {
            const unsigned w = shared_bits[i];
            if (w) atomicOr(mine + i, w);
        }
    }

    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int cs = 0; cs < nclouds * nscales; ++cs) {
        const int k = cs % nscales;
        const unsigned* m = bitmaps + (cs / nscales) * words + offset[k];
        int s = 0;
        for (int i = threadIdx.x; i < offset[k + 1] - offset[k]; i += kThreads)
            s += __popc(__ldcg(m + i));
        for (int o = 16; o; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
        if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = s;
        __syncthreads();
        if (threadIdx.x == 0) {
            int t = 0;
            for (int w = 0; w < kThreads / 32; ++w) t += partial[w];
            counts[cs] = t;
        }
        __syncthreads();
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) over `ctas` CTAs, the sum
// over the clouds of their points over kPointsPerCta, rounded up. bitmaps
// (nclouds * words) and ticket (one word) come zeroed; counts (nclouds *
// nscales) is written by the last CTA. Returns cudaGetLastError() as an int;
// the caller raises when it is not 0. Allocates nothing and does not
// synchronize.
extern "C" int boxcount_launch(const void* xy, const void* fparams, const void* iparams,
                               int nclouds, int nscales, long long words, int ctas,
                               void* bitmaps, void* counts, void* ticket, void* stream) {
    if (ctas <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    auto p = static_cast<const double2*>(xy);
    auto f = static_cast<const double*>(fparams);
    auto i = static_cast<const long long*>(iparams);
    auto b = static_cast<unsigned*>(bitmaps);
    auto n = static_cast<int*>(counts);
    auto t = static_cast<unsigned*>(ticket);
    const size_t table = 24 * (size_t)nscales + 8;
    if (table + 4 * (size_t)words <= kSmemBytes)
        boxcount_kernel<true><<<ctas, kThreads, table + 4 * (size_t)words, s>>>(
            p, f, i, nclouds, nscales, words, b, n, t);
    else
        boxcount_kernel<false><<<ctas, kThreads, table, s>>>(p, f, i, nclouds, nscales, words,
                                                              b, n, t);
    return static_cast<int>(cudaGetLastError());
}
