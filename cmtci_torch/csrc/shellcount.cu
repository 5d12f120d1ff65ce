// Shell counts for Hopper (sm_90a): the int64 histogram of the distances of
// the pairs (i, j), j > i, of one cloud into ascending shells, for
// cmtci_torch.stats.pointstats._pair_hist, in one launch a cloud.
//
// Replaces no TPU kernel: the shell scan of cmtci/stats/pointstats.py is XLA
// ops (blocked distances and masked reductions). Its twin in the port is the
// blocked torch chain, cmtci_torch/kernels/shellcount.py:shell_counts_torch:
// a block of 1,024 rows writes dx, dy, d^2, d and the j > i mask to HBM as
// rows x columns tensors, then bucketize and a global-atomic bincount over
// the block, about ten kernels a block.
//
// Exactness. A pair's d^2 = dx * dx + dy * dy is computed in the scan's dtype
// in the chain's op order (-fmad=false keeps the products and the sum
// rounded apart). The chain's bin is bucketize(sqrt(d^2), edges, right=True)
// - 1: the number of edges <= sqrt_rn(d^2), less one. A correctly rounded
// square root is monotone, so edges[k] <= sqrt_rn(s) exactly when s >=
// tau[k], the least non-negative value of the dtype whose square root is >=
// edges[k]. The wrapper finds each tau[k] once a call by a search over the
// dtype's bit patterns (shellcount.py:thresholds), and the kernel takes the
// bin as the number of tau[k] <= d^2, less one: bitwise the chain's. This
// route was chosen over a square root and the same comparisons on the edges
// because it takes no square root at all: a correctly rounded one is about a
// dozen instructions in f32 and several dozen in f64, a pair.
//
// Finding the count. An estimate from the approximate reciprocal square
// root, g = floor((d - edges[0]) * nbins / (edges[nbins] - edges[0])) + 1
// clamped to [0, nbins + 1], is within one of the count on even shells. One
// 8-byte (f32) or 16-byte (f64) load from shared memory gives g's bounds,
// (tau[g - 1], tau[g]), -inf and +inf past the ends, and in the common case
// tau[g - 1] <= d^2 < tau[g] settles g. Otherwise g walks down while its
// lower bound is above d^2 and up while its upper bound is at or below it,
// which makes it exact for any ascending edges. A NaN d^2 walks to nbins + 1
// and counts nowhere, as in the chain.
//
// Counting. Each thread keeps a 32-bit counter for each slot g in [0, nbins +
// 1] in shared memory, slot-major (slot g of thread t at g * threads + t), so
// the shared atomic adds of a warp fall in 32 different banks whatever the
// bins, and no two threads share a counter. Slots 1..nbins are the shells;
// slot 0 (below the first edge, and the masked pairs) and slot nbins + 1 (at
// or past the last edge, NaN) count nowhere. At the end a CTA sums each
// shell over its threads and adds it to the int64 counts with one 64-bit
// atomicAdd. A CTA's pairs, rows x columns, stay below 2^31 (the wrapper
// refuses a plan where they could not), so no counter and no sum of a CTA
// overflows.
//
// Work. A CTA takes one unit: a tile of threads * kRowsPerThread rows i
// (thread t holds rows i0 + t + r * threads in registers) against `cols`
// columns j from the tile's first row on; the columns pass through shared
// memory kStageBytes at a time. Only the first unit of a tile meets j <= i,
// and only the last tile of the row range holds rows past it: those units
// run the loop with the mask, the rest the loop without it. The triangle is
// ragged (tile a meets n - i0(a) columns), so it is cut into units of one
// size, all but a tile's last, thousands a cloud, launched as one grid in
// tile order: the 132 SMs finish within about one unit of each other,
// without pairing tiles or a persistent grid.
//
// What bounds it on this card: the operations, 5 FP32 a pair (two
// subtractions, two products and a sum) at 67 TFLOP/s, 1.7 ms for the pair
// cell's 2.25e10 pairs; not the bytes, two clouds of 1.2 MB (f32) that stay
// in L2. Besides those five, a pair runs the estimate (one MUFU and five
// ALU instructions), the load of its bounds and their two tests, the mask's
// test on masked units and the counter's shared atomic add: some 15
// instructions and 2-3 shared-memory wavefronts, so the instruction rate and the
// shared-memory pipe, not the FP32 units, set the time. An earlier form, two
// loads of single thresholds and the counter's load, add and store, took
// 31.6 ms for the pair cell's two clouds in f32 against this form's 19.2 (an
// H100 80GB HBM3 at 700 W). Nothing of a pair is written to HBM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 4;
// the bytes of columns a CTA stages in shared memory at a time
constexpr int kStageBytes = 8192;
// the dynamic shared memory a launch takes without an opt-in
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// round-to-nearest of 0 <= x < 2^22 as an int, on the ALU pipes: adding
// 1.5 * 2^23 leaves the integer in the low mantissa bits
__device__ __forceinline__ int round_small(float x) {
    return __float_as_int(x + 12582912.0f) - 0x4B400000;
}

// the estimate of the number of edges <= sqrt(s), clamped to [0, nedges],
// from the approximate reciprocal square root (one MUFU, no handling of
// subnormals); a NaN s (and s = 0 or inf, whose approximate root is NaN)
// gives 0
__device__ __forceinline__ int estimate(float s, float e0, float inv, int nedges) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
    const float x = fminf(fmaxf(__fmaf_rn(s * r, inv, 0.5f - e0 * inv), 0.0f), (float)nedges);
    return round_small(x);
}

// the pairs of rows (x, y, first) against the staged columns [0, m), whose
// first index is j0; a pair counts in slot g of this thread (mine[g *
// threads]), g the number of thresholds <= d^2 (bounds[g] = (tau[g - 1],
// tau[g])). With kMask, a pair counts only where j > first[r] (first[r] is
// INT_MAX for a row past the range).
template <bool kMask, typename T>
__device__ __forceinline__ void scan(const typename Vec2<T>::type* __restrict__ stage, int m,
                                     int j0, const T (&x)[kRowsPerThread],
                                     const T (&y)[kRowsPerThread],
                                     const int (&first)[kRowsPerThread],
                                     const typename Vec2<T>::type* __restrict__ bounds,
                                     int nedges, float e0, float inv, unsigned* mine,
                                     int threads) {
#pragma unroll 2
    for (int jj = 0; jj < m; ++jj) {
        const typename Vec2<T>::type q = stage[jj];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
            const T dx = x[r] - q.x;
            const T dy = y[r] - q.y;
            const T s = dx * dx + dy * dy;
            int g = estimate((float)s, e0, inv, nedges);
            typename Vec2<T>::type b = bounds[g];
            if (!(b.x <= s && s < b.y)) {
                while (g > 0 && !(b.x <= s)) b = bounds[--g];
                while (g < nedges && !(s < b.y)) b = bounds[++g];
            }
            if (kMask && !(j0 + jj > first[r])) g = 0;
            atomicAdd(mine + g * threads, 1u);
        }
    }
}

// xy: n points (x, y); rows [lo, hi); tau: the nbins + 1 thresholds;
// counts: nbins int64, zeroed by the caller. Dynamic shared memory: the
// staged columns (kStageBytes), the nbins + 2 bounds, then the counters
// ((nbins + 2) * threads words).
template <typename T>
__global__ void __launch_bounds__(256)
shellcount_kernel(const typename Vec2<T>::type* __restrict__ xy, int n, int lo, int hi,
                  const T* __restrict__ tau, int nbins, float e0, float inv, int cols,
                  unsigned long long* __restrict__ counts) {
    using V = typename Vec2<T>::type;
    extern __shared__ __align__(16) unsigned char smem[];
    V* stage = reinterpret_cast<V*>(smem);
    V* bounds = reinterpret_cast<V*>(smem + kStageBytes);
    unsigned* hist = reinterpret_cast<unsigned*>(bounds + nbins + 2);
    const int threads = blockDim.x, t = threadIdx.x;
    const int tile = threads * kRowsPerThread;
    const int nedges = nbins + 1;
    constexpr int kStage = kStageBytes / (int)sizeof(V);

    // this CTA's unit: the u-th chunk of `cols` columns of the tile from i0
    int u = blockIdx.x, i0 = lo;
    for (;;) {
        const int chunks = (n - i0 + cols - 1) / cols;
        if (u < chunks) break;
        u -= chunks;
        i0 += tile;
    }
    const int row_end = min(i0 + tile, hi);
    const int c0 = i0 + u * cols, c1 = min(c0 + cols, n);
    const bool masked = c0 < row_end || row_end - i0 < tile;

    T x[kRowsPerThread], y[kRowsPerThread];
    int first[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = i0 + t + r * threads;
        const bool in = i < row_end;
        const V p = in ? xy[i] : V{};
        x[r] = p.x;
        y[r] = p.y;
        first[r] = in ? i : INT_MAX;
    }
    const T inf = (T)__int_as_float(0x7f800000);
    for (int g = t; g < nedges + 1; g += threads) {
        V b;
        b.x = g == 0 ? -inf : tau[g - 1];
        b.y = g == nedges ? inf : tau[g];
        bounds[g] = b;
    }
    for (int k = t; k < (nbins + 2) * threads; k += threads) hist[k] = 0u;
    unsigned* mine = hist + t;

    for (int j0 = c0; j0 < c1; j0 += kStage) {
        const int m = min(kStage, c1 - j0);
        __syncthreads();  // the previous piece is done with (and the tables set)
        for (int k = t; k < m; k += threads) stage[k] = xy[j0 + k];
        __syncthreads();
        if (masked)
            scan<true, T>(stage, m, j0, x, y, first, bounds, nedges, e0, inv, mine, threads);
        else
            scan<false, T>(stage, m, j0, x, y, first, bounds, nedges, e0, inv, mine, threads);
    }

    __syncthreads();
    const int lane = t & 31, warps = threads >> 5;
    for (int k = t >> 5; k < nbins; k += warps) {
        const unsigned* h = hist + (k + 1) * threads;
        unsigned s = 0u;
        for (int i = lane; i < threads; i += 32) s += h[i];
        for (int o = 16; o; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
        if (lane == 0 && s) atomicAdd(counts + k, (unsigned long long)s);
    }
}

template <typename T>
int launch(const void* xy, int n, int lo, int hi, const void* tau, int nbins, float e0,
           float inv, int threads, int cols, int ctas, void* counts, cudaStream_t stream) {
    const size_t smem = kStageBytes + (nbins + 2) * sizeof(typename Vec2<T>::type) +
                        (size_t)(nbins + 2) * threads * sizeof(unsigned);
    if (smem > kDefaultSmem)
        cudaFuncSetAttribute(shellcount_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    shellcount_kernel<T><<<ctas, threads, smem, stream>>>(
        static_cast<const typename Vec2<T>::type*>(xy), n, lo, hi, static_cast<const T*>(tau),
        nbins, e0, inv, cols, static_cast<unsigned long long*>(counts));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) over `ctas` CTAs of `threads`
// threads (a multiple of 32, at most 256), the units of shellcount.py's
// launch_plan for n points, rows [lo, hi) and `cols` columns a unit. xy is
// (n, 2) contiguous in the dtype (is_double), tau the nbins + 1 thresholds
// (shellcount.py:thresholds), counts nbins int64, zeroed; e0 and inv are the
// estimate's edges[0] and nbins / (edges[nbins] - edges[0]). Returns
// cudaGetLastError() as an int; the caller raises when it is not 0.
// Allocates nothing and does not synchronize.
extern "C" int shellcount_launch(const void* xy, int n, int lo, int hi, const void* tau,
                                 int nbins, float e0, float inv, int threads, int cols,
                                 int ctas, int is_double, void* counts, void* stream) {
    if (ctas <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    return is_double ? launch<double>(xy, n, lo, hi, tau, nbins, e0, inv, threads, cols, ctas,
                                      counts, s)
                     : launch<float>(xy, n, lo, hi, tau, nbins, e0, inv, threads, cols, ctas,
                                     counts, s);
}
