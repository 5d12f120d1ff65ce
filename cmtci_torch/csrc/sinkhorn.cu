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
// log(sum_k exp(x_k - max)) + max, the sum in one fixed order: lane l of one
// warp sums the terms l, l + 32, l + 64, ... in increasing order from +0.0,
// and the 32 partial sums fold by a butterfly (__shfl_xor_sync at 16, 8, 4,
// 2, 1; lane 0 holds acc[0..s) + acc[s..2s) at each width s, every lane the
// same value). Only these adds depend on the order, and the order depends on
// the line alone, never on the CTA, the grid, the pass or the mode, so any
// launch gives the same bits. Each exp depends on its own term only, so any
// thread may compute it.
//
// The launch: one persistent CTA a slot of a cooperative grid (every CTA
// co-resident; the wrapper checks the occupancy and cudaLaunchCooperativeKernel
// refuses a grid that is not). CTA c owns the rows [c n / G, (c + 1) n / G) and
// the columns [c m / G, (c + 1) m / G) of a grid of G CTAs. f and g live in
// global memory; after each half step one grid.sync() makes them visible, and
// each CTA copies the vector it reads next into shared memory as f_i * inv_eps
// or g_j * inv_eps (2 barriers a step). The CTA keeps its rows of mk, and its
// columns as rows of the transpose mkT, so that both half steps read
// contiguous lines. A line's max is pooled as an integer key in the
// doubles' order (max_key), across lanes by redux.sync.
//   * RESIDENT: in shared memory, for the whole loop (the cost read once in
//     the prologue, the plan written once in the epilogue; at stage1's
//     819 x 600 a CTA of 132 holds 7 rows and 5 columns). A warp takes a
//     whole line (line_lse): its lanes' running maxima, then UNROLL exps of a
//     lane's terms side by side, added in the fixed order as they come.
//   * streaming: in global scratch the wrapper allocates, written by the CTA
//     itself in the prologue, each line padded to an even length (16 bytes,
//     as a bulk copy needs), and copied into a shared-memory ring once a half
//     step (the 6x bus's 5,049 x 1,624: 2 x 65.6 MB a step, past the L2 and
//     the SMs' shared memory). A half step takes the CTA's lines in passes of
//     up to `pass` lines (the launch plan's pass_rows and pass_cols, at most
//     WARPS), in three parts:
//       1. every warp takes a segment of one line (WARPS / lines segments a
//          line), each lane two running maxima through its strided terms, and
//          writes the warp's largest key to shared memory;
//       2. the warps compute the pass's exps in place over the ring's copy,
//          laid out over its lines as the maxima are;
//       3. one warp a line does only the ordered adds from shared memory, the
//          butterfly and the log, and writes f_i or g_j.
//     The passes overlap in rounds, one CTA barrier each: while the other
//     warps compute pass p's exps (2), a warp a line of pass p - 1 adds it up
//     (3), and then all warps take pass p + 1's maxima (1). The ring holds
//     RING passes: pass p's lines come in one bulk copy (cp.async.bulk,
//     completing on the mbarrier of slot p % RING), issued once pass p - RING
//     has been added up; the first RING passes of a half step are issued
//     before the grid barrier that precedes it. Each line of mk and mkT thus
//     crosses from HBM into shared memory once a step.
// (The exps of a resident line spread over all the CTA's warps, with the
// adds split off as in the streaming passes, measured 11.0-11.5 ms at
// stage1's defaults against 8.4 for a warp a line: the separate adds phase
// and its barrier cost more than the exps' parallelism saved.)
//
// What bounds it on this card: at stage1's size the FP64 exps, one a term (two
// half steps of n m terms a step; chip_smoke.py counts the instructions of the
// libdevice exp and log in this build's SASS), and the 2 * iters grid
// barriers; streaming, the bytes of mk and mkT from HBM every step.
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

// threads a CTA (transport/sinkhorn.SINKHORN_THREADS)
constexpr int THREADS = 512;
// CTAs a grid slot of each SM (transport/sinkhorn.SINKHORN_CTAS_PER_SM)
constexpr int CTAS_PER_SM = 1;
// passes the streaming ring holds (transport/sinkhorn.SINKHORN_RING): pass
// p's exps, pass p - 1's adds and pass p + 1's maxima read three slots at
// once, and the others are in flight
constexpr int RING = 3;
// a lane's terms loaded, maxed and exponentiated side by side when a warp
// takes a whole resident line
constexpr int UNROLL = 8;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr unsigned FULL = 0xffffffffu;
static_assert(RING >= 3, "a pass's slot is refilled two passes after its maxima were read");

struct Args {
    const double* __restrict__ cost;  // (n, m)
    double* mk;                       // (n, padded m) scratch, streaming only
    double* mkT;                      // (m, padded n) scratch, streaming only
    double* f;                        // (n,) out
    double* g;                        // (m,) out
    double* plan;                     // (n, m) out
    int n, m, iters, pass_rows, pass_cols;
    double eps, inv_eps, log_mu, log_nu;
};

// One half step's lines of a CTA: `count` lines of `len` terms, line l at
// src + l ld (RESIDENT: in shared memory; streaming: in the global scratch),
// taken `pass` at a time.
struct Lines {
    const double* src;
    int count, len, ld, pass;
};

// first index of CTA c's block of `count` lines over `ctas` CTAs
__device__ __forceinline__ int split(int c, int count, int ctas) {
    return static_cast<int>(static_cast<long long>(c) * count / ctas);
}

// a streamed line's stride: its length rounded up to even, 16 bytes
__device__ __forceinline__ int padded(int len) { return len + (len & 1); }

// A line's max as an unsigned key whose order is the doubles' order, so that
// the lanes pool it with integer reductions (redux.sync): negative doubles
// complemented, positive ones with the sign bit set; a NaN term is passed
// over as -inf (its exp is NaN and so are the sum and the line's lse, as with
// torch.amax's NaN max). The max is exact in any order; key 0 lies below
// every term's key.
__device__ __forceinline__ unsigned long long max_key(double v) {
    const unsigned long long u = static_cast<unsigned long long>(
        __double_as_longlong(v != v ? -INFINITY : v));
    return (u >> 63) ? ~u : u | 0x8000000000000000ull;
}

// the line's max from its key, an infinite one as 0 (as torch.logsumexp)
__device__ __forceinline__ double key_max(unsigned long long k) {
    const double v = __longlong_as_double(
        static_cast<long long>((k >> 63) ? k & 0x7fffffffffffffffull : ~k));
    return fabs(v) == INFINITY ? 0.0 : v;
}

// the largest key of the warp's lanes, in every lane: high words, then the
// low words of the lanes that hold the largest high word
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long k) {
    const unsigned hi = __reduce_max_sync(FULL, static_cast<unsigned>(k >> 32));
    const unsigned lo = __reduce_max_sync(
        FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k) : 0u);
    return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Wait until the mbarrier completes the phase of parity `parity`.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// Issue pass p of `ls` into its ring slot (one thread): one bulk copy of the
// pass's lines, which lie back to back in the scratch, completing on the
// slot's mbarrier. No pass past the last line.
__device__ __forceinline__ void stage(const Lines ls, int p, double* ring,
                                      unsigned long long* bars) {
    const int first = p * ls.pass;
    if (first >= ls.count) return;
    const int slot = p % RING;
    const unsigned bytes =
        static_cast<unsigned>(min(ls.pass, ls.count - first)) * static_cast<unsigned>(ls.ld) * 8u;
    const unsigned bar = smem_u32(bars + slot);
    // the slot's last reads and in-place writes (generic proxy) before the copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(ring + static_cast<long long>(slot) * ls.pass * ls.ld)),
        "l"(ls.src + static_cast<long long>(first) * ls.ld), "r"(bytes), "r"(bar)
        : "memory");
}

// (q / d, q % d) for q >= 0 and a small quotient, by subtraction: the
// callers divide a thread or warp index by a line's length or a segment
// count, a quotient of a few at most for lines of a warp or more
__device__ __forceinline__ int2 divmod_small(int q, int d) {
    int l = 0;
    while (q >= d) {
        q -= d;
        ++l;
    }
    return make_int2(l, q);
}

// 1. A pass's segment maxima (cnt lines of len terms at x0, stride ld), as
//    keys: warp w < cnt seg takes segment w % seg of line w / seg (seg =
//    WARPS / cnt, at least 1), its lanes strided by 32 through the segment
//    with two running maxima each, and writes the warp's largest key to
//    keys[w]; line l's max is then line_max(keys, l, seg).
__device__ __forceinline__ void partials(const double* x0, int cnt, int seg, int len, int ld,
                                         const double* add, unsigned long long* keys) {
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP, step = WARP * seg;
    if (warp >= cnt * seg) return;
    const int2 ls = divmod_small(warp, seg);
    const double* x = x0 + ls.x * ld;
    double m0 = -INFINITY, m1 = -INFINITY;
    int k = ls.y * WARP + lane;
    for (; k + step < len; k += 2 * step) {
        const double a0 = x[k] + add[k], a1 = x[k + step] + add[k + step];
        m0 = fmax(m0, a0);
        m1 = fmax(m1, a1);
    }
    if (k < len) m0 = fmax(m0, x[k] + add[k]);
    const unsigned long long key = warp_max_key(max(max_key(m0), max_key(m1)));
    if (lane == 0) keys[warp] = key;
}

// line l's max from its seg segment keys, an infinite one as 0
__device__ __forceinline__ double line_max(const unsigned long long* keys, int l, int seg) {
    unsigned long long k = 0;
    for (int s = 0; s < seg; ++s) k = max(k, keys[l * seg + s]);
    return key_max(k);
}

// 3. The exps of a pass's cnt * len terms (lines at x0, stride ld), in
//    place, by the warps w0 .. WARPS - 1, laid out as the maxima are:
//    warp w0 + u takes segment u % seg of line u / seg (seg = (WARPS - w0) /
//    cnt, at least 1; then u + WARPS - w0 while there are more lines than
//    warps), its lanes strided by 32 through the segment, with the line's
//    max line_max(keys, l, kseg) (kseg: the segments the maxima were taken
//    in).
__device__ __forceinline__ void exps(double* x0, int cnt, int len, int ld, const double* add,
                                     const unsigned long long* keys, int kseg, int w0) {
    const int lane = threadIdx.x % WARP, warps = WARPS - w0;
    const int seg = max(1, warps / cnt), step = WARP * seg;
    for (int u = threadIdx.x / WARP - w0; u >= 0 && u < cnt * seg; u += warps) {
        const int2 ls = divmod_small(u, seg);
        double* x = x0 + ls.x * ld;
        const double mx = line_max(keys, ls.x, kseg);
        for (int k = ls.y * WARP + lane; k < len; k += step) x[k] = exp((x[k] + add[k]) - mx);
    }
}

// dst[j] = src[j] * inv_eps for j < count: a vector the grid wrote before the
// barrier (ld.global.cg), two loads of a thread in flight at once
__device__ __forceinline__ void refill(double* dst, const double* src, int count,
                                       double inv_eps) {
    for (int j = threadIdx.x; j < count; j += 2 * THREADS) {
        const double v0 = __ldcg(src + j);
        const double v1 = j + THREADS < count ? __ldcg(src + j + THREADS) : 0.0;
        dst[j] = v0 * inv_eps;
        if (j + THREADS < count) dst[j + THREADS] = v1 * inv_eps;
    }
}

// 4. One line's ordered adds (its exps at e, its maximum mx) by the calling
//    warp, the butterfly and the log: *out = eps * (log_marg - lse).
__device__ __forceinline__ void add_up(const double* e, int len, double mx, double eps,
                                       double log_marg, double* out) {
    const int lane = threadIdx.x % WARP;
    // terms k = lane, lane + 32, ... in order, four at a time, the next four
    // loaded while these are added; a term past the line is +0.0, which
    // leaves a sum of exps (never negative) as it is
    double acc = 0.0, v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = lane + u * WARP < len ? e[lane + u * WARP] : 0.0;
    for (int k = lane; k < len; k += 4 * WARP) {
        double w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int kn = k + (4 + u) * WARP;
            w[u] = kn < len ? e[kn] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) acc += v[u];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = w[u];
    }
    for (int s = WARP / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(FULL, acc, s);
    if (lane == 0) *out = eps * (log_marg - (log(acc) + mx));
}

// RESIDENT: *out = eps * (log_marg - lse_k(x[k] + add[k])) for one line
// by the calling warp: each lane's UNROLL running maxima (fmax) of its terms
// k = lane, lane + 32, ..., the warp's largest key by redux.sync, then UNROLL
// exps of the lane's terms side by side, added in increasing k (the order of
// the header), the butterfly and the log.
__device__ __forceinline__ void line_lse(const double* x, const double* add, int len,
                                         double eps, double log_marg, double* out) {
    const int lane = threadIdx.x % WARP;
    constexpr int STRIDE = UNROLL * WARP;
    double part[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) part[u] = -INFINITY;
    int k = lane;
    for (; k + (UNROLL - 1) * WARP < len; k += STRIDE) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) part[u] = fmax(part[u], x[k + u * WARP] + add[k + u * WARP]);
    }
    for (; k < len; k += WARP) part[0] = fmax(part[0], x[k] + add[k]);
#pragma unroll
    for (int u = 1; u < UNROLL; ++u) part[0] = fmax(part[0], part[u]);
    const double mx = key_max(warp_max_key(max_key(part[0])));
    double acc = 0.0;
    k = lane;
    for (; k + (UNROLL - 1) * WARP < len; k += STRIDE) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) part[u] = exp((x[k + u * WARP] + add[k + u * WARP]) - mx);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc += part[u];
    }
    for (; k < len; k += WARP) acc += exp((x[k] + add[k]) - mx);
    for (int s = WARP / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(FULL, acc, s);
    if (lane == 0) *out = eps * (log_marg - (log(acc) + mx));
}

// Streaming: out[l] = eps * (log_marg - lse_k(line_l[k] + add[k])) for the
// CTA's lines, pass by pass, the parts overlapped in rounds: in round p,
// while the other warps compute pass p's exps, a warp a line of pass p - 1
// (at most WARPS / 2; all in the last round) adds it up; then every warp
// takes its segment of pass p + 1's maxima; one CTA barrier a round, rounds
// -1 to the last pass + 1, each part's code once. work is the ring, whose first RING
// passes were issued before, and pass p - 1's slot takes pass p - 1 + RING
// once it is added up; the exps go in place over a pass's lines. Pass p's
// segment maxima are keys[p % 3] (3 WARPS keys: written in round p - 1, read
// in rounds p and p + 1); `phases` holds each ring slot's mbarrier parity,
// the same in every thread.
__device__ __forceinline__ void half_step(const Lines ls, const double* add, double* out,
                                          double eps, double log_marg, double* work,
                                          unsigned long long* keys, unsigned long long* bars,
                                          unsigned& phases) {
    const int warp = threadIdx.x / WARP, len = ls.len, ld = ls.ld;
    if (ls.count == 0) return;
    // the segments of a line: in a full pass and in the last, shorter one
    const int last = ls.count - (ls.count - 1) / ls.pass * ls.pass;
    const int seg_full = max(1, WARPS / ls.pass), seg_last = max(1, WARPS / last);
    const auto count = [&](int p) { return min(ls.pass, ls.count - p * ls.pass); };
    const auto lines = [&](int p) { return work + (p % RING) * ls.pass * ld; };
    const auto maxima = [&](int p) { return keys + (p % 3) * WARPS; };
    const auto segs = [&](int p) { return count(p) == ls.pass ? seg_full : seg_last; };
    // round p: pass p - 1 exists while (p - 1) pass < count
    for (int p = -1; (p - 1) * ls.pass < ls.count; ++p) {
        const bool here = p >= 0 && p * ls.pass < ls.count, next = (p + 1) * ls.pass < ls.count;
        const int adders = p < 1 ? 0 : min(count(p - 1), here ? WARPS / 2 : WARPS);
        if (warp < adders) {
            for (int l = warp; l < count(p - 1); l += adders)
                add_up(lines(p - 1) + l * ld, len, line_max(maxima(p - 1), l, segs(p - 1)), eps,
                       log_marg, out + (p - 1) * ls.pass + l);
        } else if (here) {
            exps(lines(p), count(p), len, ld, add, maxima(p), segs(p), adders);
        }
        if (next) {
            const int slot = (p + 1) % RING;
            bar_wait(bars + slot, (phases >> slot) & 1u);
            phases ^= 1u << slot;
            partials(lines(p + 1), count(p + 1), segs(p + 1), len, ld, add, maxima(p + 1));
        }
        // the ring's in-place exps before a later bulk copy overwrites them
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (threadIdx.x == 0 && p >= 1) stage(ls, p - 1 + RING, work, bars);
    }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1) sinkhorn_kernel(const Args a) {
    extern __shared__ __align__(128) double smem[];
    cg::grid_group grid = cg::this_grid();
    const int n = a.n, m = a.m, ctas = gridDim.x, c = blockIdx.x;
    const int r0 = split(c, n, ctas), r1 = split(c + 1, n, ctas);
    const int c0 = split(c, m, ctas), c1 = split(c + 1, m, ctas);
    const int ldm = RESIDENT ? m : padded(m), ldn = RESIDENT ? n : padded(n);
    // row i of mk at rows + (i - r0) ldm, column j at cols + (j - c0) ldn
    double* rows = RESIDENT ? smem : a.mk + static_cast<long long>(r0) * ldm;
    double* cols = RESIDENT ? rows + static_cast<long long>(r1 - r0) * m
                            : a.mkT + static_cast<long long>(c0) * ldn;
    // RESIDENT: nothing past the blocks; streaming: the ring, first
    double* work = RESIDENT ? cols + static_cast<long long>(c1 - c0) * n : smem;
    const long long work_len = RESIDENT ? 0
                                        : RING * max(static_cast<long long>(a.pass_rows) * ldm,
                                                     static_cast<long long>(a.pass_cols) * ldn);
    double* fs = work + work_len;   // f_i * inv_eps, n
    double* gs = fs + n;            // g_j * inv_eps, m
    // three passes' segment maxima as keys (half_step), 3 WARPS; the ring's
    // mbarriers
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(gs + m);
    unsigned long long* bars = keys + 3 * WARPS;

    // prologue: the CTA's rows of mk (coalesced) and its columns of mkT
    for (int i = r0; i < r1; ++i)
        for (int j = threadIdx.x; j < m; j += THREADS)
            rows[static_cast<long long>(i - r0) * ldm + j] =
                (-a.cost[static_cast<long long>(i) * m + j]) * a.inv_eps;
    for (int j = c0; j < c1; ++j)
        for (int i = threadIdx.x; i < n; i += THREADS)
            cols[static_cast<long long>(j - c0) * ldn + i] =
                (-a.cost[static_cast<long long>(i) * m + j]) * a.inv_eps;
    const Lines row_lines{rows, r1 - r0, m, ldm, a.pass_rows};
    unsigned phases = 0;
    if (!RESIDENT) {
        // the scratch written above, before the bulk copies read it
        asm volatile("fence.proxy.async.global;" ::: "memory");
        if (threadIdx.x == 0) {
            for (int s = 0; s < RING; ++s)
                asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bars + s)),
                             "r"(1u)
                             : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
    }
    __syncthreads();
    if (!RESIDENT && threadIdx.x == 0 && a.iters > 0)
        for (int p = 0; p < RING; ++p) stage(row_lines, p, work, bars);

    // 2 iters half steps, the f one (rows, after g) even, the g one (columns,
    // after f) odd, through one copy of the code; g starts at 0 (the first
    // half step reads no g)
    for (int h = 0; h < 2 * a.iters; ++h) {
        const bool gstep = h & 1;
        double* vec = gstep ? fs : gs;
        if (h == 0)
            for (int j = threadIdx.x; j < m; j += THREADS) gs[j] = 0.0 * a.inv_eps;
        else
            refill(vec, gstep ? a.f : a.g, gstep ? n : m, a.inv_eps);
        __syncthreads();
        // this half step's lines and the next one's, field by field (registers)
        const Lines ls{gstep ? cols : rows, gstep ? c1 - c0 : r1 - r0, gstep ? n : m,
                       gstep ? ldn : ldm, gstep ? a.pass_cols : a.pass_rows};
        const Lines next{gstep ? rows : cols, gstep ? r1 - r0 : c1 - c0, gstep ? m : n,
                         gstep ? ldm : ldn, gstep ? a.pass_rows : a.pass_cols};
        double* out = gstep ? a.g + c0 : a.f + r0;
        const double log_marg = gstep ? a.log_nu : a.log_mu;
        if (RESIDENT) {
            for (int l = threadIdx.x / WARP; l < ls.count; l += WARPS)
                line_lse(ls.src + static_cast<long long>(l) * ls.ld, vec, ls.len, a.eps, log_marg,
                         out + l);
        } else {
            half_step(ls, vec, out, a.eps, log_marg, work, keys, bars, phases);
        }
        // the lines added up (half_step's last barrier): the ring takes the
        // next half step's
        if (!RESIDENT && threadIdx.x == 0 && h + 1 < 2 * a.iters)
            for (int p = 0; p < RING; ++p) stage(next, p, work, bars);
        grid.sync();
    }

    // epilogue: the CTA's rows of the plan (f and g at 0 after no step)
    const bool none = a.iters <= 0;
    for (int j = threadIdx.x; j < m; j += THREADS)
        gs[j] = (none ? 0.0 : __ldcg(a.g + j)) * a.inv_eps;
    for (int i = r0 + threadIdx.x; i < r1; i += THREADS)
        fs[i] = (none ? 0.0 : __ldcg(a.f + i)) * a.inv_eps;
    __syncthreads();
    for (int i = r0; i < r1; ++i)
        for (int j = threadIdx.x; j < m; j += THREADS)
            a.plan[static_cast<long long>(i) * m + j] =
                exp((rows[static_cast<long long>(i - r0) * ldm + j] + fs[i]) + gs[j]);
}

// opt in to `smem` bytes of dynamic shared memory past 48 KB, once a kernel
// and size
template <bool RESIDENT>
cudaError_t allow(int smem) {
    static int set = 48 * 1024;
    if (smem <= set) return cudaSuccess;
    const cudaError_t rc = cudaFuncSetAttribute(
        sinkhorn_kernel<RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc == cudaSuccess) set = smem;
    return rc;
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
// memory each (transport/sinkhorn.launch_plan: RESIDENT the CTA's largest
// blocks of rows and columns, streaming the ring of RING passes; then f, g,
// 3 WARPS keys and RING mbarriers), streaming `pass_rows` and `pass_cols`
// lines a pass (1 to WARPS; not read when resident). cost, plan: (n, m) f64; f (n,),
// g (m,) f64, the potentials out (read only after the launch wrote them); mk
// (n, m + m % 2) and mkT (m, n + n % 2) f64 scratch when not resident (may be
// null when resident). log_mu = -log(n), log_nu = -log(m). Returns the
// launch's error as an int (cudaErrorCooperativeLaunchTooLarge when the grid
// cannot be co-resident); allocates nothing and does not synchronize.
extern "C" int sinkhorn_launch(const void* cost, void* mk, void* mkT, void* f, void* g,
                               void* plan, int n, int m, int iters, double eps, double inv_eps,
                               double log_mu, double log_nu, int ctas, int resident, int smem,
                               int pass_rows, int pass_cols, void* stream) {
    Args a = {static_cast<const double*>(cost), static_cast<double*>(mk),
              static_cast<double*>(mkT), static_cast<double*>(f), static_cast<double*>(g),
              static_cast<double*>(plan), n, m, iters, pass_rows, pass_cols, eps, inv_eps,
              log_mu, log_nu};
    void* params[] = {&a};
    if (!resident && (pass_rows < 1 || pass_rows > WARPS || pass_cols < 1 || pass_cols > WARPS))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t rc = resident ? allow<true>(smem) : allow<false>(smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return static_cast<int>(resident ? cooperative(
                                           reinterpret_cast<const void*>(&sinkhorn_kernel<true>),
                                           ctas, params, smem, stream)
                                     : cooperative(
                                           reinterpret_cast<const void*>(&sinkhorn_kernel<false>),
                                           ctas, params, smem, stream));
}
