// Kernel-argmax matcher for Hopper (sm_90a): for clouds a (n points) and b
// (m points), the mean of the n x m pairwise distances, then for each row i of
// a the first j that maximises nan_to_num(exp(-(d_ij / mean) / eps)), for
// cmtci_torch.transport.sinkhorn._match_fused, in two launches a match.
//
// Replaces no TPU kernel: the matcher of cmtci/transport/sinkhorn.py
// (_blocked_mean_dist, _argmax_kernel_rows) is XLA ops. Its twin in the port
// is the blocked torch chain of cmtci_torch/transport/sinkhorn.py: a block of
// 2,048 rows writes dx, dy, their squares, the sum and d to HBM as rows x m
// tensors for the mean, and again for the argmax with d / mean, its negation,
// the product by 1 / eps, the exp and nan_to_num besides, about a dozen
// full-size tensors a block and pass.
//
// Exactness. A pair takes the chain's ops in the chain's order, in the dtype
// of the clouds (-fmad=false keeps every product and sum rounded apart, and
// -prec-div=true -prec-sqrt=true make the division and the square root the
// IEEE ones torch uses): dx, dy, dx * dx + dy * dy, its correctly rounded
// square root d; then q = d / mean, an IEEE division by the mean the wrapper
// left on the device; (-q) * inv_eps, which is what torch on the card computes
// for a division by the Python scalar eps (inv_eps = 1 / eps rounded in the
// dtype, argmax_match.py:inverse_eps); the accurate exp (expf, not __expf);
// nan_to_num, which on exp's range [+0, inf] and NaN is min(max(k, 0),
// the dtype's largest): a NaN goes to 0, +inf to the largest. The argmax
// keeps, per row, the larger k and, on a tie, the smaller j, as torch.argmax
// does: within a thread the columns come in increasing j and only a strictly
// larger k replaces the best, and the slabs (below) merge in increasing
// order by the same rule, after all of a row's slabs are written, so the
// result does not depend on the order in which CTAs run.
//
// The mean. Each pair's distance is widened to f64 and added in f64, as the
// chain does (torch.sum with dtype float64). A thread adds its rows' distances in column order, a
// CTA folds its threads by a fixed tree, and the last CTA to finish folds the
// CTAs' partials in a fixed order: the f64 total depends on the shapes alone.
// The wrapper takes the mean from it in torch (argmax_match.py:
// mean_from_total, the twin's epilogue too), on the device.
//
// Work. A CTA of 256 threads holds a tile of 1,024 rows of a in registers
// (thread t the rows i0 + t + r * 256, r < 4) and meets a slab of b's
// columns, which pass through shared memory 8 KB at a time and are read by
// every thread at once (a broadcast). The plan (argmax_match.py:launch_plan)
// cuts the columns into as many slabs as bring the grid to about 4,096 CTAs,
// each of at least 256 columns, so that the tracker's matches of 14,820 rows
// and more fill the 132 SMs for several waves (the two smallest, 2,400 and
// 6,000 rows, take 27 and 138 CTAs); both passes take the same grid,
// tile-major. With one slab a CTA writes its rows' indices; with more,
// each slab writes its (k, j) per row, and the last CTA of a tile to finish
// (a ticket) merges the tile's slabs in slab order into the int64 indices.
//
// What bounds it on this card: the instructions a pair issues, not the bytes
// (two clouds of at most 0.8 MB in f32, in L2). A pair of the argmax pass runs
// the distance (5), the correctly rounded square root, the IEEE division and
// the accurate exp (three MUFU operations and their refinements), the product
// by inv_eps, the clamp of nan_to_num (2) and the compare and selects; a pair
// of the mean pass the distance, the root, the widening and an f64 add.
// chip_smoke.py counts them in the SASS of the two inner loops: 42.5 and
// 18.25 instructions a pair. At the tracker's largest match, 97,020 x 97,020
// in f32, the two passes take 19.8 ms, 86% of that issue bound (an H100 80GB
// HBM3 at 700 W). Nothing of a pair is written to HBM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kWarps = kThreads / 32;
// the bytes of columns a CTA stages in shared memory at a time
constexpr int kStageBytes = 8192;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float exponential(float x) { return expf(x); }
__device__ __forceinline__ double exponential(double x) { return exp(x); }
// nan_to_num on exp's range: NaN to 0 (fmax returns the number), +inf to
// the largest finite value
__device__ __forceinline__ float clamp_k(float k) { return fminf(fmaxf(k, 0.0f), FLT_MAX); }
__device__ __forceinline__ double clamp_k(double k) { return fmin(fmax(k, 0.0), DBL_MAX); }

// the chain's distance: sqrt(dx * dx + dy * dy), each op rounded
template <typename T>
__device__ __forceinline__ T distance(T ax, T ay, T bx, T by) {
    const T dx = ax - bx;
    const T dy = ay - by;
    return root(dx * dx + dy * dy);
}

// this CTA's tile of rows and slab of columns [c0, c1)
struct Work {
    int tile, slab, i0, c0, c1;
};

__device__ __forceinline__ Work work(int m, int slabs) {
    Work w;
    w.tile = blockIdx.x / slabs;
    w.slab = blockIdx.x - w.tile * slabs;
    w.i0 = w.tile * kTile;
    w.c0 = (int)((long long)w.slab * m / slabs);
    w.c1 = (int)((long long)(w.slab + 1) * m / slabs);
    return w;
}

// this thread's rows of a (a row past n reads as the origin; it is never
// written or counted)
template <typename V, typename T>
__device__ __forceinline__ void load_rows(const V* __restrict__ a, int n, int i0,
                                          T (&x)[kRowsPerThread], T (&y)[kRowsPerThread]) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = i0 + threadIdx.x + r * kThreads;
        const V p = i < n ? a[i] : V{};
        x[r] = p.x;
        y[r] = p.y;
    }
}

// the sum of every thread's v in a fixed order (a butterfly in each warp,
// then the warps in order), in thread 0
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
    __syncthreads();
    double s = 0.0;
    if (threadIdx.x == 0)
        for (int k = 0; k < kWarps; ++k) s += warp_sums[k];
    return s;
}

// The mean pass: partials[c] the f64 sum of CTA c's distances; the last CTA
// to finish writes the sum of the partials to *total. ticket: one zeroed
// counter.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mean_kernel(const typename Vec2<T>::type* __restrict__ a,
            const typename Vec2<T>::type* __restrict__ b, int n, int m, int slabs,
            double* __restrict__ partials, unsigned* __restrict__ ticket,
            double* __restrict__ total) {
    using V = typename Vec2<T>::type;
    constexpr int kStage = kStageBytes / (int)sizeof(V);
    __shared__ V stage[kStage];
    __shared__ double warp_sums[kWarps];
    __shared__ bool last;
    const Work w = work(m, slabs);

    T x[kRowsPerThread], y[kRowsPerThread];
    load_rows(a, n, w.i0, x, y);
    double acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0;

    for (int j0 = w.c0; j0 < w.c1; j0 += kStage) {
        const int cnt = min(kStage, w.c1 - j0);
        __syncthreads();  // the previous piece is done with
        for (int k = threadIdx.x; k < cnt; k += kThreads) stage[k] = b[j0 + k];
        __syncthreads();
#pragma unroll 2
        for (int jj = 0; jj < cnt; ++jj) {
            const V q = stage[jj];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r)
                acc[r] += (double)distance(x[r], y[r], q.x, q.y);
        }
    }
    double mine = 0.0;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
        if (w.i0 + (int)threadIdx.x + r * kThreads < n) mine += acc[r];
    const double part = block_sum(mine, warp_sums);
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = part;
        __threadfence();
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    double s = 0.0;
    for (int c = threadIdx.x; c < (int)gridDim.x; c += kThreads) s += __ldcg(partials + c);
    const double sum = block_sum(s, warp_sums);
    if (threadIdx.x == 0) *total = sum;
}

// The argmax pass: for each row i of a, the first j of the maximal
// nan_to_num(exp((-(d_ij / *mean)) * inv_eps)) into out[i]. With more than
// one slab, kpart and jpart hold slabs x n values (slab-major) and tickets
// one zeroed counter a tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const typename Vec2<T>::type* __restrict__ a,
            const typename Vec2<T>::type* __restrict__ b, int n, int m, int slabs,
            const T* __restrict__ mean_ptr, T inv_eps, T* __restrict__ kpart,
            int* __restrict__ jpart, unsigned* __restrict__ tickets,
            long long* __restrict__ out) {
    using V = typename Vec2<T>::type;
    constexpr int kStage = kStageBytes / (int)sizeof(V);
    __shared__ V stage[kStage];
    __shared__ bool last;
    const Work w = work(m, slabs);
    const T mean = *mean_ptr;

    T x[kRowsPerThread], y[kRowsPerThread], best[kRowsPerThread];
    int arg[kRowsPerThread];
    load_rows(a, n, w.i0, x, y);
    const T inf = (T)__int_as_float(0x7f800000);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
        best[r] = -inf;  // every k is >= 0, so the slab's first column replaces it
        arg[r] = w.c0;
    }

    for (int j0 = w.c0; j0 < w.c1; j0 += kStage) {
        const int cnt = min(kStage, w.c1 - j0);
        __syncthreads();  // the previous piece is done with
        for (int k = threadIdx.x; k < cnt; k += kThreads) stage[k] = b[j0 + k];
        __syncthreads();
#pragma unroll 2
        for (int jj = 0; jj < cnt; ++jj) {
            const V q = stage[jj];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
                const T d = distance(x[r], y[r], q.x, q.y);
                const T k = clamp_k(exponential(-(d / mean) * inv_eps));
                if (k > best[r]) {
                    best[r] = k;
                    arg[r] = j0 + jj;
                }
            }
        }
    }

    if (slabs == 1) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
            const int i = w.i0 + threadIdx.x + r * kThreads;
            if (i < n) out[i] = arg[r];
        }
        return;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = w.i0 + threadIdx.x + r * kThreads;
        if (i < n) {
            kpart[(size_t)w.slab * n + i] = best[r];
            jpart[(size_t)w.slab * n + i] = arg[r];
        }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(tickets + w.tile, 1u) == (unsigned)slabs - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = w.i0 + threadIdx.x + r * kThreads;
        if (i >= n) continue;
        T k = __ldcg(kpart + i);
        int j = __ldcg(jpart + i);
        for (int s = 1; s < slabs; ++s) {
            const T ks = __ldcg(kpart + (size_t)s * n + i);
            if (ks > k) {
                k = ks;
                j = __ldcg(jpart + (size_t)s * n + i);
            }
        }
        out[i] = j;
    }
}

template <typename T>
int launch_mean(const void* a, const void* b, int n, int m, int slabs, void* partials,
                void* ticket, void* total, cudaStream_t stream) {
    using V = typename Vec2<T>::type;
    const int ctas = (n + kTile - 1) / kTile * slabs;
    mean_kernel<T><<<ctas, kThreads, 0, stream>>>(
        static_cast<const V*>(a), static_cast<const V*>(b), n, m, slabs,
        static_cast<double*>(partials), static_cast<unsigned*>(ticket),
        static_cast<double*>(total));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* a, const void* b, int n, int m, int slabs, const void* mean,
                double inv_eps, void* kpart, void* jpart, void* tickets, void* out,
                cudaStream_t stream) {
    using V = typename Vec2<T>::type;
    const int ctas = (n + kTile - 1) / kTile * slabs;
    rows_kernel<T><<<ctas, kThreads, 0, stream>>>(
        static_cast<const V*>(a), static_cast<const V*>(b), n, m, slabs,
        static_cast<const T*>(mean), (T)inv_eps, static_cast<T*>(kpart),
        static_cast<int*>(jpart), static_cast<unsigned*>(tickets),
        static_cast<long long*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The mean pass on `stream` (PyTorch's current stream): a (n, 2) and b (m, 2)
// contiguous in the dtype (is_double), 1 <= n, m; slabs the plan's
// (argmax_match.py:launch_plan), 1 <= slabs <= m; partials one double a CTA
// (ceil(n / 1024) * slabs), ticket one zeroed unsigned, total one double.
// Returns cudaGetLastError() as an int; the caller raises when it is not 0.
// Allocates nothing and does not synchronize.
extern "C" int argmax_mean_launch(const void* a, const void* b, int n, int m, int slabs,
                                  int is_double, void* partials, void* ticket, void* total,
                                  void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    return is_double ? launch_mean<double>(a, b, n, m, slabs, partials, ticket, total, s)
                     : launch_mean<float>(a, b, n, m, slabs, partials, ticket, total, s);
}

// The argmax pass on `stream`: a, b, n, m and slabs as above; mean one value
// of the dtype on the device; inv_eps 1 / eps in the dtype (exact as a
// double); out n int64. With slabs > 1, kpart slabs * n values of the dtype,
// jpart slabs * n ints and tickets ceil(n / 1024) zeroed unsigneds (null
// otherwise). Returns cudaGetLastError() as an int. Allocates nothing and
// does not synchronize.
extern "C" int argmax_rows_launch(const void* a, const void* b, int n, int m, int slabs,
                                  int is_double, const void* mean, double inv_eps, void* kpart,
                                  void* jpart, void* tickets, void* out, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    return is_double ? launch_rows<double>(a, b, n, m, slabs, mean, inv_eps, kpart, jpart,
                                           tickets, out, s)
                     : launch_rows<float>(a, b, n, m, slabs, mean, inv_eps, kpart, jpart,
                                          tickets, out, s);
}
