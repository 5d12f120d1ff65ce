// Log-domain Sinkhorn with uniform marginals, the whole loop in one
// cooperative launch, for Hopper (sm_90a).
//
// Replaces the reference's device loop cmtci/transport/sinkhorn.py:sinkhorn_log
// (:148, the lax.scan of `iters` steps at :165, two logsumexps a step), which the
// port ran as a CUDA graph of some 16 torch kernels a step. The twin is
// cmtci_torch/transport/sinkhorn.py:sinkhorn_log_torch, whose arithmetic is
// this kernel's op for op; the plan is held to it bitwise on the card.
//
// What it computes, from the (n, m) f64 cost, with inv_eps = 1 / eps (a
// double the caller computes once) and -fmad=false:
//   * mk = (-cost) * inv_eps;
//   * `iters` times: the f half step, for every row i,
//       f_i = eps * (log_mu - lse_j(mk_ij + g_j * inv_eps)),
//     then the g half step, for every column j,
//       g_j = eps * (log_nu - lse_i(mk_ij + f_i * inv_eps));
//   * plan_ij = exp((mk_ij + f_i * inv_eps) + g_j * inv_eps).
// lse over a line of x_k (a row or a column): the line's max (exact in any
// order; an infinite max becomes 0, as torch.logsumexp does), then
// log(sum_k exp(x_k - max)) + max, the sum in one fixed order: lane l of the
// line's warp sums the terms l, l + 32, l + 64, ... in increasing order, and
// the 32 partial sums fold by a butterfly (__shfl_xor_sync at 16, 8, 4, 2, 1;
// lane 0 holds acc[0..s) + acc[s..2s) at each width s, every lane the same
// value). The order depends on the line alone, never on the CTA, the grid or
// the mode, so any grid and either mode give the same bits.
//
// The launch: one persistent CTA a slot of a cooperative grid (every CTA
// co-resident; the wrapper checks the occupancy and cudaLaunchCooperativeKernel
// refuses a grid that is not). CTA c owns the rows [c n / G, (c + 1) n / G) and
// the columns [c m / G, (c + 1) m / G) of a grid of G CTAs: a warp reduces one
// of its rows in the f half step and one of its columns in the g half step.
// f and g live in global memory; after each half step one grid.sync() makes
// them visible, and each CTA copies the vector it reads next into shared
// memory as f_i * inv_eps or g_j * inv_eps (2 barriers a step). The CTA keeps
// its rows of mk, and its columns as rows of the transpose mkT, so that both
// half steps read contiguous lines and each lane's loads coalesce:
//   * RESIDENT: in shared memory, for the whole loop. The cost is read once in
//     the prologue and the plan written once in the epilogue; at stage1's
//     819 x 600 a CTA of 132 holds 7 rows and 5 columns, 77,712 B with f and g.
//   * streaming: in global scratch the wrapper allocates, written by the CTA
//     itself in the prologue and read back every half step (the 6x bus's
//     5,049 x 1,624: 2 x 65.6 MB a step, past the L2 and the SMs' shared
//     memory).
//
// What bounds it on this card: at stage1's size the FP64 exps, one a term (two
// half steps of n m terms a step; chip_smoke.py counts the instructions of the
// libdevice exp and log in this build's SASS), and the 2 * iters grid
// barriers; streaming, the bytes of mk and mkT from HBM every step.
// sinkhorn_barriers_launch runs the barriers alone on the same grid: the
// floor beside the bound.
//
// f and g are written and read inside the launch: they are read with
// ld.global.cg (__ldcg, L2 only), never through the read-only path, which
// could serve a stale line across a barrier.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

namespace cg = cooperative_groups;

// threads a CTA (sweep_schedules rewrites it; 512 with UNROLL 8 was the
// fastest of 256-1024 x 1, 4, 8 x 1-2 CTAs an SM at both stage1 costs)
constexpr int THREADS = 512;
// CTAs a grid slot of each SM (transport/sinkhorn.SINKHORN_CTAS_PER_SM)
constexpr int CTAS_PER_SM = 1;
// a lane's terms loaded and exponentiated side by side (sweep_schedules
// rewrites it)
constexpr int UNROLL = 8;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
    const double* __restrict__ cost;  // (n, m)
    double* mk;                       // (n, m) scratch, streaming only
    double* mkT;                      // (m, n) scratch, streaming only
    double* f;                        // (n,) out
    double* g;                        // (m,) out
    double* plan;                     // (n, m) out
    int n, m, iters;
    double eps, inv_eps, log_mu, log_nu;
};

// first index of CTA c's block of `count` lines over `ctas` CTAs
__device__ __forceinline__ int split(int c, int count, int ctas) {
    return static_cast<int>(static_cast<long long>(c) * count / ctas);
}

// max that keeps a NaN, as torch.amax does
__device__ __forceinline__ double max_nan(double a, double b) {
    return (a > b || a != a) ? a : b;
}

// lse_k (line[k] + add[k]) over k < len, in the order the header states; the
// calling warp's 32 lanes all return it. A lane loads and exponentiates UNROLL
// of its terms side by side (a row holds only a few warps an SM, so a lane's
// own loads and exps must overlap), then adds them in increasing k.
__device__ __forceinline__ double line_lse(const double* line, const double* add, int len,
                                           int lane) {
    constexpr int STRIDE = UNROLL * WARP;
    double part[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) part[u] = -INFINITY;
    int k = lane;
    for (; k + (UNROLL - 1) * WARP < len; k += STRIDE) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            part[u] = max_nan(part[u], line[k + u * WARP] + add[k + u * WARP]);
    }
    for (; k < len; k += WARP) part[0] = max_nan(part[0], line[k] + add[k]);
    double mx = part[0];
#pragma unroll
    for (int u = 1; u < UNROLL; ++u) mx = max_nan(mx, part[u]);
    for (int s = WARP / 2; s > 0; s >>= 1) mx = max_nan(mx, __shfl_xor_sync(FULL, mx, s));
    if (fabs(mx) == INFINITY) mx = 0.0;
    double acc = 0.0;
    k = lane;
    for (; k + (UNROLL - 1) * WARP < len; k += STRIDE) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            part[u] = exp((line[k + u * WARP] + add[k + u * WARP]) - mx);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc += part[u];
    }
    for (; k < len; k += WARP) acc += exp((line[k] + add[k]) - mx);
    for (int s = WARP / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(FULL, acc, s);
    return log(acc) + mx;
}

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS) sinkhorn_kernel(const Args a) {
    extern __shared__ double smem[];
    cg::grid_group grid = cg::this_grid();
    const int n = a.n, m = a.m, ctas = gridDim.x, c = blockIdx.x;
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int r0 = split(c, n, ctas), r1 = split(c + 1, n, ctas);
    const int c0 = split(c, m, ctas), c1 = split(c + 1, m, ctas);
    double* fs = smem;     // f_i * inv_eps, n
    double* gs = fs + n;   // g_j * inv_eps, m
    // row i of mk at rows + (i - r0) m, column j at cols + (j - c0) n
    double* rows = RESIDENT ? gs + m : a.mk + static_cast<long long>(r0) * m;
    double* cols = RESIDENT ? rows + static_cast<long long>(r1 - r0) * m
                            : a.mkT + static_cast<long long>(c0) * n;

    // prologue: the CTA's rows of mk (coalesced) and its columns of mkT
    const long long row_elems = static_cast<long long>(r1 - r0) * m;
    for (long long k = threadIdx.x; k < row_elems; k += THREADS)
        rows[k] = (-a.cost[static_cast<long long>(r0) * m + k]) * a.inv_eps;
    const long long col_elems = static_cast<long long>(c1 - c0) * n;
    for (long long k = threadIdx.x; k < col_elems; k += THREADS) {
        const long long jj = k / n, i = k % n;
        cols[k] = (-a.cost[i * m + c0 + jj]) * a.inv_eps;
    }
    __syncthreads();

    // g starts at 0 (the first half step reads no g)
    for (int it = 0; it < a.iters; ++it) {
        for (int j = threadIdx.x; j < m; j += THREADS)
            gs[j] = (it == 0 ? 0.0 : __ldcg(a.g + j)) * a.inv_eps;
        __syncthreads();
        for (int i = r0 + warp; i < r1; i += WARPS) {
            const double lse = line_lse(rows + static_cast<long long>(i - r0) * m, gs, m, lane);
            if (lane == 0) a.f[i] = a.eps * (a.log_mu - lse);
        }
        grid.sync();
        for (int i = threadIdx.x; i < n; i += THREADS) fs[i] = __ldcg(a.f + i) * a.inv_eps;
        __syncthreads();
        for (int j = c0 + warp; j < c1; j += WARPS) {
            const double lse = line_lse(cols + static_cast<long long>(j - c0) * n, fs, n, lane);
            if (lane == 0) a.g[j] = a.eps * (a.log_nu - lse);
        }
        grid.sync();
    }

    // epilogue: the CTA's rows of the plan (f and g at 0 after no step)
    const bool none = a.iters <= 0;
    for (int j = threadIdx.x; j < m; j += THREADS)
        gs[j] = (none ? 0.0 : __ldcg(a.g + j)) * a.inv_eps;
    for (int i = r0 + threadIdx.x; i < r1; i += THREADS)
        fs[i] = (none ? 0.0 : __ldcg(a.f + i)) * a.inv_eps;
    __syncthreads();
    for (long long k = threadIdx.x; k < row_elems; k += THREADS) {
        const int i = r0 + static_cast<int>(k / m), j = static_cast<int>(k % m);
        a.plan[static_cast<long long>(r0) * m + k] = exp((rows[k] + fs[i]) + gs[j]);
    }
}

// the grid barriers alone, on the loop's grid: the floor of its 2 * iters
// barriers
__global__ void __launch_bounds__(THREADS) barrier_kernel(int count) {
    cg::grid_group grid = cg::this_grid();
    for (int k = 0; k < count; ++k) grid.sync();
}

// opt in to `smem` bytes of dynamic shared memory past 48 KB, once a kernel
// and size
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int* set) {
    if (smem <= *set) return cudaSuccess;
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc == cudaSuccess) *set = smem;
    return rc;
}

template <bool RESIDENT>
cudaError_t allow(int smem) {
    static int set = 48 * 1024;
    return allow_smem(sinkhorn_kernel<RESIDENT>, smem, &set);
}

cudaError_t cooperative(const void* kernel, int ctas, void** params, int smem, void* stream) {
    const cudaError_t rc = cudaLaunchCooperativeKernel(
        kernel, dim3(static_cast<unsigned>(ctas)), dim3(THREADS), params,
        static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
    const cudaError_t last = cudaGetLastError();
    return rc != cudaSuccess ? rc : last;
}

}  // namespace

// out4: the card's SM count, the dynamic shared memory a CTA may opt in to,
// THREADS and CTAS_PER_SM of this build. Returns a cudaError_t as an int.
extern "C" int sinkhorn_limits(int device, int* out4) {
    cudaError_t rc = cudaDeviceGetAttribute(&out4[0], cudaDevAttrMultiProcessorCount, device);
    if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&out4[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    out4[2] = THREADS;
    out4[3] = CTAS_PER_SM;
    return static_cast<int>(rc);
}

// *blocks: the CTAs of the resident (1) or streaming (0) loop an SM holds at
// once with `smem` bytes of dynamic shared memory each.
extern "C" int sinkhorn_occupancy(int resident, int smem, int* blocks) {
    cudaError_t rc = resident ? allow<true>(smem) : allow<false>(smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = resident ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sinkhorn_kernel<true>,
                                                                  THREADS, smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sinkhorn_kernel<false>,
                                                                  THREADS, smem);
    return static_cast<int>(rc);
}

// Launch the loop on `stream` (PyTorch's current stream) as one cooperative
// grid of `ctas` CTAs of THREADS threads and `smem` bytes of dynamic shared
// memory each: 8 (n + m) for the two vectors, plus 8 (rows m + cols n) for the
// largest blocks when `resident`. cost, plan: (n, m) f64; f (n,), g (m,) f64,
// the potentials out (read only after the launch wrote them); mk (n, m) and
// mkT (m, n) f64 scratch
// when not resident (may be null when resident). log_mu = -log(n), log_nu =
// -log(m). Returns the launch's error as an int (cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be co-resident); allocates nothing and does not
// synchronize.
extern "C" int sinkhorn_launch(const void* cost, void* mk, void* mkT, void* f, void* g,
                               void* plan, int n, int m, int iters, double eps, double inv_eps,
                               double log_mu, double log_nu, int ctas, int resident, int smem,
                               void* stream) {
    Args a = {static_cast<const double*>(cost), static_cast<double*>(mk),
              static_cast<double*>(mkT), static_cast<double*>(f), static_cast<double*>(g),
              static_cast<double*>(plan), n, m, iters, eps, inv_eps, log_mu, log_nu};
    void* params[] = {&a};
    const cudaError_t rc = resident ? allow<true>(smem) : allow<false>(smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return static_cast<int>(resident ? cooperative(
                                           reinterpret_cast<const void*>(&sinkhorn_kernel<true>),
                                           ctas, params, smem, stream)
                                     : cooperative(
                                           reinterpret_cast<const void*>(&sinkhorn_kernel<false>),
                                           ctas, params, smem, stream));
}

// `count` grid barriers and nothing else, on the grid the loop would take:
// `ctas` CTAs of THREADS threads with `smem` bytes each (for the same
// residency; the kernel touches none of it).
extern "C" int sinkhorn_barriers_launch(int ctas, int smem, int count, void* stream) {
    static int set = 48 * 1024;
    const cudaError_t rc = allow_smem(barrier_kernel, smem, &set);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    void* params[] = {&count};
    return static_cast<int>(
        cooperative(reinterpret_cast<const void*>(&barrier_kernel), ctas, params, smem, stream));
}
