// Batched Aberth-Ehrlich root finder, the whole iteration in one launch, for
// Hopper (sm_90a): a polynomial too large for one CTA is split over a thread
// block cluster.
//
// Replaces the reference's device loop cmtci/kernels/companion.py:aberth_roots
// (the lax.while_loop at :437), which the eager port ran as a Python loop that
// launched every elementwise op from the host and read its convergence flag
// back every step. The twin is cmtci_torch/kernels/companion.py:
// aberth_roots_torch; the CPU tests hold a schedule model of this kernel (the
// twin with a per-polynomial exit and the repulsion summed in j's order) to it
// and to the reference.
//
// What it computes, per polynomial b of degree n = deg[b], from the start
// roots the caller wrote into zr/zi (rows of L lanes; lanes >= n are parked
// far away and never read or written):
//   * each step, for every lane i < n that is not frozen, in the twin's op
//     order with -fmad=false:
//       - the f64 Newton ratio w = p(z)/p'(z): the closed form of the family
//         (_newton_ratio_closed, _pow_int's binary powering, the branch switch
//         at r = min(1.25, 10^(140/n))) where closed[b], else the two-branch
//         Horner form over the row's width[b] + 1 padded coefficients
//         (_newton_ratio, switch at |z|^2 = 1.5625), then _safe_ratio;
//       - the repulsion s = sum over j < n with |z_i - z_j|^2 > 0 of
//         1/(z_i - z_j), in f32 on f32 copies of the roots (f64 with REP64),
//         one term after another in j's order inside the thread that owns i;
//       - corr = w / (1 - w s) with cplx.div's formula;
//       - the latch: a lane whose |corr|^2 <= tol^2 max(|z|^2, 1e-30) freezes
//         for good and keeps its z; every other lane takes z - corr. All
//         lanes move at once: the repulsion reads a copy of the roots of the
//         step before, and the new roots go to a second copy (double buffer).
//   * the polynomial stops when every lane is frozen (a vote; nothing is read
//     on the host) or after max_iters steps, and writes its step count. A
//     frozen lane's correction is zero, so the reference's global loop leaves
//     a finished polynomial unchanged: the per-polynomial exit gives the same
//     roots.
//
// The work: each CTA reads its task, (b, parts), from task[]. parts == 1: the
// CTA holds polynomial b alone. parts == CLUSTER, the cluster's size: the
// cluster's CTAs share polynomial b, rank r updating the contiguous lanes
// [r s, (r + 1) s), s = ceil(n / parts). Every CTA keeps a whole copy of the
// repulsion's roots (two, double-buffered) in its own shared memory; each
// step a thread writes its lanes' new roots into the next copy of every CTA
// of the cluster through distributed shared memory (map_shared_rank), each
// CTA's vote (__syncthreads_and over its lanes) goes to every CTA the same
// way, and one cluster.sync() a step makes both visible before the next step
// reads them. A lane's arithmetic does not depend on which thread or CTA owns
// it, so the cluster gives the one-CTA kernel's roots and step counts
// bitwise. A cluster whose CTAs each hold their own polynomial (the small
// ones, packed by the wrapper) never syncs across CTAs.
//
// What is not bitwise against the twin: the twin sums the repulsion with
// torch.sum over chunks of 128 lanes, this kernel one term after another in
// j. The f32 sums differ in their last bits; the fixed point is where the f64
// Newton ratio vanishes, so the roots agree within the 1e-13 freeze tolerance
// (held at 1e-12 relative) and the step counts within one.
//
// What bounds it on this card: the O(n^2) f32 repulsion, some 20 to 25
// instructions a pair with the correctly rounded reciprocal, issued by the
// SMs that hold the largest polynomials. One CTA a polynomial (the design
// before the cluster) left n = 1220's 1.49 M pair terms a step to one SM;
// a cluster of 8 spreads them over 8 CTAs, one lane a thread (4.5 times
// faster at the eigensweep; 16 CTAs gain nothing more). The
// O(log n) closed form costs a few hundred f64 operations a lane and step.
//
// Shared memory a CTA: the votes (2 CLUSTER ints, padded to 16 B), two copies
// of the n roots at 8 B a lane (16 with REP64), 16 B a lane it owns for its
// f64 roots, 8 a coefficient for a Horner row. The wrapper sizes it from the largest task
// and refuses what a CTA cannot hold (companion.ABERTH_SMEM_MAX), naming the
// largest degree it accepts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_THREADS = 256;
// the CTAs of a cluster (companion.ABERTH_CLUSTER; 1 to 16 were measured, and
// 16 needs cudaFuncAttributeNonPortableClusterSizeAllowed)
constexpr int CLUSTER = 8;
// the votes' bytes: two slots of CLUSTER ints, the roots after them aligned
constexpr int VOTE_BYTES = (2 * CLUSTER * 4 + 15) / 16 * 16;
// the repulsion's pair terms computed side by side (repulsion())
constexpr int REP_UNROLL = 2;

// a complex value as a (re, im) pair, rounded op by op as utils/cplx.py
struct C2 {
    double r, i;
};

__device__ __forceinline__ C2 cadd(C2 a, C2 b) { return {a.r + b.r, a.i + b.i}; }
__device__ __forceinline__ C2 csub(C2 a, C2 b) { return {a.r - b.r, a.i - b.i}; }
__device__ __forceinline__ C2 cmul(C2 a, C2 b) {
    return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}
__device__ __forceinline__ C2 cscale(C2 a, double s) { return {a.r * s, a.i * s}; }
__device__ __forceinline__ double cabs2(C2 a) { return a.r * a.r + a.i * a.i; }
__device__ __forceinline__ C2 cdiv(C2 a, C2 b) {
    const double d = b.r * b.r + b.i * b.i;
    return {(a.r * b.r + a.i * b.i) / d, (a.i * b.r - a.r * b.i) / d};
}
__device__ __forceinline__ C2 crecip(C2 a) {
    const double d = a.r * a.r + a.i * a.i;
    return {a.r / d, -a.i / d};
}

// _safe_ratio: num/den, 0 where |den|^2 is not > 0
__device__ __forceinline__ C2 safe_ratio(C2 num, C2 den) {
    double den2 = den.r * den.r + den.i * den.i;
    const bool safe = den2 > 0.0;
    den2 = safe ? den2 : 1.0;
    const C2 w = {(num.r * den.r + num.i * den.i) / den2, (num.i * den.r - num.r * den.i) / den2};
    return safe ? w : C2{0.0, 0.0};
}

// _pow_int: z^n by binary powering over n's 12 low bits. The twin squares the
// base all 11 times; a square no later bit reads is skipped here.
__device__ __forceinline__ C2 pow_int(C2 z, int n) {
    C2 acc = {1.0, 0.0};
    C2 base = z;
    for (int i = 0; i < 12; ++i) {
        if ((n >> i) & 1) acc = cmul(acc, base);
        if ((n >> (i + 1)) == 0) break;
        base = cmul(base, base);
    }
    return acc;
}

// the closed form of a family: q(u) = (P(u) + a u^(n+1)) / (1 - u), P's
// ascending coefficients c[0..nc-1]
struct ClosedForm {
    double c[4];
    int nc;
    double a;
};

// _poly_eval_small, Horner from the top: P (the family's c[nc-1], ..., c[0])
// or, reversed, the reversed polynomial (c[0], ..., c[nc-1])
__device__ __forceinline__ void poly_small(const ClosedForm& f, bool reversed, C2 z, C2& p,
                                           C2& d) {
    p = {0.0, 0.0};
    d = {0.0, 0.0};
    for (int t = 0; t < f.nc; ++t) {
        const double c = f.c[reversed ? t : f.nc - 1 - t];
        d = cadd(cmul(d, z), p);
        p = cadd(cmul(p, z), C2{c + 0.0, 0.0});
    }
}

// _newton_ratio_closed for one lane; r_sw2 is the row's switch radius squared
__device__ __forceinline__ C2 newton_closed(const ClosedForm& f, int n, double r_sw2, C2 z) {
    const double degf = (double)n;
    C2 num, den;
    if (cabs2(z) > r_sw2) {
        const C2 u = crecip(z);
        C2 p_u, dp_u;
        poly_small(f, false, u, p_u, dp_u);
        const C2 un = pow_int(u, n);
        const C2 un1 = cmul(un, u);
        const C2 m = cadd(p_u, cscale(un1, f.a));
        const C2 np1 = cadd(C2{degf, 0.0}, C2{1.0, 0.0});
        const C2 mp = cadd(dp_u, cscale(cmul(np1, un), f.a));
        const C2 one_mu = csub(C2{1.0, 0.0}, u);
        const C2 m_omu = cmul(m, one_mu);
        num = cmul(z, m_omu);
        den = csub(cmul(C2{degf, 0.0}, m_omu), cmul(u, cadd(cmul(mp, one_mu), m)));
    } else {
        C2 prev, dprev;
        poly_small(f, true, z, prev, dprev);
        const int k_exp = n + 1 - (f.nc - 1);
        const C2 zk = pow_int(z, k_exp > 0 ? k_exp : 0);
        const C2 n_big = cadd(cmul(zk, prev), C2{f.a, 0.0});
        const C2 kf = {(double)k_exp + 0.0, 0.0};
        const C2 zk1 = pow_int(z, k_exp - 1 > 0 ? k_exp - 1 : 0);
        C2 n_prime = cmul(zk1, cadd(cmul(kf, prev), cmul(z, dprev)));
        if (k_exp == 0) n_prime = dprev;
        const C2 zm1 = csub(z, C2{1.0, 0.0});
        num = cmul(n_big, zm1);
        den = csub(cmul(n_prime, zm1), n_big);
    }
    return safe_ratio(num, den);
}

// _horner_pair over the row's w + 1 coefficients: reverse evaluates
// q(u) = sum a_k u^k, otherwise the padded P(x) = sum a_k x^(w-k)
__device__ __forceinline__ void horner(const double* a, int w, bool reverse, C2 z, C2& p,
                                       C2& d) {
    p = {0.0, 0.0};
    d = {0.0, 0.0};
    for (int t = 0; t <= w; ++t) {
        const double ak = a[reverse ? w - t : t];
        d = cadd(cmul(d, z), p);
        p = cadd(cmul(p, z), C2{ak + 0.0, 0.0});
    }
}

// _newton_ratio for one lane of a row padded to width w
__device__ __forceinline__ C2 newton_horner(const double* a, int w, int n, C2 z) {
    const C2 degf = {(double)n, 0.0};
    C2 num, den;
    if (cabs2(z) > 1.5625) {  // _R_SWITCH2
        const C2 u = crecip(z);
        C2 q, qp;
        horner(a, w, true, u, q, qp);
        num = cmul(z, q);
        den = csub(cmul(degf, q), cmul(u, qp));
    } else {
        C2 p, pp;
        horner(a, w, false, z, p, pp);
        const C2 pad = {(double)w - degf.r, 0.0};
        num = cmul(z, p);
        den = csub(cmul(z, pp), cmul(pad, p));
    }
    return safe_ratio(num, den);
}

template <bool REP64>
struct Rep {
    using T = float2;
    static __device__ __forceinline__ T of(double r, double i) {
        return make_float2((float)r, (float)i);
    }
};
template <>
struct Rep<true> {
    using T = double2;
    static __device__ __forceinline__ T of(double r, double i) { return make_double2(r, i); }
};

// the repulsion of lane i from the n roots of `cur`: the terms of REP_UNROLL
// roots at a time computed side by side, then added one after another in
// j's order, so the sums are those of a loop of one term a step, bitwise
// (1 to 8 side by side measured within 2% of each other at the eigensweep;
// 4 spills)
template <typename V, typename S>
__device__ __forceinline__ void pair_term(V x, V o, S& tr, S& ti) {
    const S dr = x.x - o.x;
    const S di = x.y - o.y;
    const S d2 = dr * dr + di * di;
    S inv;
    if constexpr (sizeof(S) == 4)
        inv = d2 > 0.0f ? __frcp_rn(d2) : 0.0f;
    else
        inv = d2 > 0.0 ? 1.0 / d2 : 0.0;
    tr = dr * inv;
    ti = (-di) * inv;
}

template <typename V>
__device__ __forceinline__ C2 repulsion(const V* cur, int n, int i) {
    using S = decltype(V::x);
    const V x = cur[i];
    S sr = S(0), si = S(0);
    int j = 0;
    for (; j + REP_UNROLL <= n; j += REP_UNROLL) {
        S tr[REP_UNROLL], ti[REP_UNROLL];
#pragma unroll
        for (int u = 0; u < REP_UNROLL; ++u) pair_term(x, cur[j + u], tr[u], ti[u]);
#pragma unroll
        for (int u = 0; u < REP_UNROLL; ++u) {
            sr = sr + tr[u];
            si = si + ti[u];
        }
    }
    for (; j < n; ++j) {
        S tr, ti;
        pair_term(x, cur[j], tr, ti);
        sr = sr + tr;
        si = si + ti;
    }
    return {(double)sr, (double)si};
}

template <bool REP64>
__global__ void __launch_bounds__(MAX_THREADS)
aberth_kernel(double* __restrict__ zr, double* __restrict__ zi, int* __restrict__ steps,
              const int* __restrict__ task, const int* __restrict__ deg,
              const int* __restrict__ width, const unsigned char* __restrict__ closed,
              const double* __restrict__ coef, int coef_stride, int lanes, int max_iters,
              double tol2, ClosedForm fam) {
    using R = typename Rep<REP64>::T;
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = task[2 * blockIdx.x];
    const int parts = task[2 * blockIdx.x + 1];
    if (b < 0) return;  // a spare CTA of a cluster of one-CTA polynomials
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = parts > 1 ? (int)cluster.block_rank() : 0;
    const int n = deg[b];
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int span = (n + parts - 1) / parts;
    const int lo = min(n, rank * span);
    const int hi = min(n, lo + span);
    int* vote = reinterpret_cast<int*>(smem);  // [2][CLUSTER]
    R* rep0 = reinterpret_cast<R*>(smem + VOTE_BYTES);
    R* rep1 = rep0 + n;
    double2* z = reinterpret_cast<double2*>(rep1 + n);  // this CTA's lanes, from lo
    double* a = reinterpret_cast<double*>(z + span);
    const bool is_closed = closed[b] != 0;
    const int w = width[b];
    double* row_r = zr + (size_t)b * (size_t)lanes;
    double* row_i = zi + (size_t)b * (size_t)lanes;

    for (int i = tid; i < n; i += nt) rep0[i] = Rep<REP64>::of(row_r[i], row_i[i]);
    for (int i = lo + tid; i < hi; i += nt) z[i - lo] = make_double2(row_r[i], row_i[i]);
    if (!is_closed) {
        for (int k = tid; k <= w; k += nt) a[k] = coef[(size_t)b * (size_t)coef_stride + k];
    }
    // the row's switch radius: 140.0 / t is t.reciprocal() * 140.0 in torch
    double r_sw2 = 0.0;
    if (is_closed) {
        const double r_sw = fmin(pow(10.0, (1.0 / fmax((double)n, 1.0)) * 140.0), 1.25);
        r_sw2 = r_sw * r_sw;
    }
    // every CTA of the cluster runs before one writes another's shared memory
    if (parts > 1)
        cluster.sync();
    else
        __syncthreads();

    // this thread's lanes are lo + tid, lo + tid + nt, ...; bit m of a mask is
    // lane lo + tid + m nt
    const int own = hi - lo;
    const int mine = tid < own ? (own - tid + nt - 1) / nt : 0;
    const unsigned all = mine >= 32 ? ~0u : (1u << mine) - 1u;
    unsigned frozen = 0u;
    int it = 0;
    while (it < max_iters) {
        const R* cur = (it & 1) ? rep1 : rep0;
        R* nxt = (it & 1) ? rep0 : rep1;
        int m = 0;
        for (int i = lo + tid; i < hi; i += nt, ++m) {
            double2& own_z = z[i - lo];
            if (!((frozen >> m) & 1u)) {
                const C2 zc = {own_z.x, own_z.y};
                const C2 wr = is_closed ? newton_closed(fam, n, r_sw2, zc)
                                        : newton_horner(a, w, n, zc);
                const C2 s = repulsion(cur, n, i);
                const C2 denom = csub(C2{1.0, 0.0}, cmul(wr, s));
                const C2 corr = cdiv(wr, denom);
                const double moved2 = cabs2(corr);
                const double az2 = cabs2(zc);
                // torch.clamp(min=1e-30) keeps a NaN
                const double floor2 = az2 < 1e-30 ? 1e-30 : az2;
                if (moved2 <= tol2 * floor2) {
                    frozen |= 1u << m;
                } else {
                    const C2 next = csub(zc, corr);
                    own_z = make_double2(next.r, next.i);
                }
            }
            // only this thread reads its own f64 roots; the copies every CTA
            // reads are the next step's
            const R v = Rep<REP64>::of(own_z.x, own_z.y);
            if (parts > 1) {
                for (int k = 0; k < parts; ++k) cluster.map_shared_rank(nxt, k)[i] = v;
            } else {
                nxt[i] = v;
            }
        }
        int done = __syncthreads_and(frozen == all);
        ++it;
        if (parts > 1) {
            int* slot = vote + (it & 1) * CLUSTER;
            if (tid == 0) {
                for (int k = 0; k < parts; ++k) cluster.map_shared_rank(slot, k)[rank] = done;
            }
            cluster.sync();  // the next copies and the votes are everywhere
            for (int k = 0; k < parts; ++k) done &= slot[k];
        }
        if (done) break;
    }

    for (int i = lo + tid; i < hi; i += nt) {
        row_r[i] = z[i - lo].x;
        row_i[i] = z[i - lo].y;
    }
    if (rank == 0 && tid == 0) steps[b] = it;
}

template <bool REP64>
int launch(void* zr, void* zi, void* steps, const void* task, const void* deg, const void* width,
           const void* closed, const void* coef, int coef_stride, int ctas, int lanes,
           int max_iters, double tol2, const ClosedForm& fam, int threads, int smem,
           void* stream) {
    if (ctas % CLUSTER != 0 || threads > MAX_THREADS)
        return static_cast<int>(cudaErrorInvalidValue);
    // the attribute once, before the first launch that needs it (the
    // pipelines' clouds stay below 48 KB, so a launch captured into a CUDA
    // graph makes no other runtime call)
    static int smem_set = 48 * 1024;
    if (smem > smem_set) {
        cudaFuncSetAttribute(aberth_kernel<REP64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
        smem_set = smem;
    }
    if constexpr (CLUSTER > 8) {
        static const cudaError_t non_portable = cudaFuncSetAttribute(
            aberth_kernel<REP64>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        (void)non_portable;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)ctas);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(
        &cfg, aberth_kernel<REP64>, static_cast<double*>(zr), static_cast<double*>(zi),
        static_cast<int*>(steps), static_cast<const int*>(task), static_cast<const int*>(deg),
        static_cast<const int*>(width), static_cast<const unsigned char*>(closed),
        static_cast<const double*>(coef), coef_stride, lanes, max_iters, tol2, fam);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(rc != cudaSuccess ? rc : last);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) `ctas` CTAs of `threads`
// threads (<= MAX_THREADS) and `smem` bytes of dynamic shared memory, in
// clusters of CLUSTER (ctas a multiple of it, else cudaErrorInvalidValue).
// task: (ctas, 2) int32, each CTA's polynomial b (-1: none) and the CTAs that
// share it (1, or CLUSTER for the whole cluster, whose CTAs then name the
// same b). zr, zi: (batch,
// lanes) f64, the start roots in, the roots out (lanes >= deg[b] untouched);
// steps: (batch,) int32 out; deg, width: (batch,) int32; closed: (batch,)
// uint8; coef: (batch, coef_stride) f64 ascending coefficients, read only on
// rows that are not closed (may be null when every row is). Returns the
// launch's error (cudaLaunchKernelEx's, else cudaGetLastError()) as an int;
// the caller raises when it is not 0. Allocates nothing and does not
// synchronize.
extern "C" int aberth_launch(void* zr, void* zi, void* steps, const void* task, const void* deg,
                             const void* width, const void* closed, const void* coef,
                             int coef_stride, int ctas, int lanes, int max_iters, double tol2,
                             int rep64, double c0, double c1, double c2, double c3, int nc,
                             double a_const, int threads, int smem, void* stream) {
    const ClosedForm fam = {{c0, c1, c2, c3}, nc, a_const};
    if (rep64)
        return launch<true>(zr, zi, steps, task, deg, width, closed, coef, coef_stride, ctas,
                            lanes, max_iters, tol2, fam, threads, smem, stream);
    return launch<false>(zr, zi, steps, task, deg, width, closed, coef, coef_stride, ctas, lanes,
                         max_iters, tol2, fam, threads, smem, stream);
}
