// Batched Aberth-Ehrlich root finder, the whole iteration in one launch, for
// Hopper (sm_90a).
//
// Replaces the reference's device loop cmtci/kernels/companion.py:aberth_roots
// (the lax.while_loop at :437), which the eager port ran as a Python loop that
// launched every elementwise op from the host and read its convergence flag
// back every step. The twin is cmtci_torch/kernels/companion.py:
// aberth_roots_torch; the CPU tests hold a schedule model of this kernel (the
// twin with a per-polynomial exit and the repulsion summed in j's order) to it
// and to the reference.
//
// What it computes, per polynomial b (one CTA) of degree n = deg[b], from the
// start roots the caller wrote into zr/zi (rows of L lanes; lanes >= n are
// parked far away and never read or written):
//   * each step, for every lane i < n that is not frozen, in the twin's op
//     order with -fmad=false:
//       - the f64 Newton ratio w = p(z)/p'(z): the closed form of the family
//         (_newton_ratio_closed, _pow_int's binary powering, the branch switch
//         at r = min(1.25, 10^(140/n))) where closed[b], else the two-branch
//         Horner form over the row's width[b] + 1 padded coefficients
//         (_newton_ratio, switch at |z|^2 = 1.5625), then _safe_ratio;
//       - the repulsion s = sum over j < n with |z_i - z_j|^2 > 0 of
//         1/(z_i - z_j), in f32 on f32 copies of the roots (f64 with REP64);
//       - corr = w / (1 - w s) with cplx.div's formula;
//       - the latch: a lane whose |corr|^2 <= tol^2 max(|z|^2, 1e-30) freezes
//         for good and keeps its z; every other lane takes z - corr. All
//         lanes move at once: the new roots go to a second buffer and are
//         copied over after a barrier.
//   * the CTA stops when every lane of its polynomial is frozen (a block vote,
//     __syncthreads_and; nothing is read on the host) or after max_iters
//     steps, and writes its step count. A frozen lane's correction is zero,
//     so the reference's global loop leaves a finished polynomial unchanged:
//     the per-polynomial exit gives the same roots.
//
// What is not bitwise: the twin sums the repulsion with torch.sum over chunks
// of 128 lanes, this kernel one term after another in j. The f32 sums differ
// in their last bits; the fixed point is where the f64 Newton ratio vanishes,
// so the roots agree within the 1e-13 freeze tolerance (held at 1e-12
// relative) and the step counts within one.
//
// What bounds it on this card: the O(n^2) f32 repulsion of the largest
// polynomial, alone on one SM (at n = 1220, 1.49 M pair terms a step of about
// 20 instructions with the correctly rounded reciprocal). Splitting a large
// polynomial over a cluster of CTAs is left for later. The O(log n) closed
// form costs a few hundred f64 operations a lane and step.
//
// Shared memory a CTA: 16 B a lane for the roots, 16 for the next roots, 8 for
// the f32 copies (not with REP64), 8 a coefficient for a Horner row. The
// wrapper sizes it from the largest row and refuses what one CTA cannot hold
// (companion.ABERTH_SMEM_MAX).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 256;

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
__device__ C2 newton_closed(const ClosedForm& f, int n, double r_sw2, C2 z) {
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
__device__ C2 newton_horner(const double* a, int w, int n, C2 z) {
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
__global__ void __launch_bounds__(MAX_THREADS)
aberth_kernel(double* __restrict__ zr, double* __restrict__ zi, int* __restrict__ steps,
              const int* __restrict__ deg, const int* __restrict__ width,
              const unsigned char* __restrict__ closed, const double* __restrict__ coef,
              int coef_stride, int lanes, int max_iters, double tol2, ClosedForm fam) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    const int n = deg[b];
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    double2* z = reinterpret_cast<double2*>(smem);
    double2* zn = z + n;
    float2* zf = reinterpret_cast<float2*>(zn + n);
    double* a = reinterpret_cast<double*>(zf + (REP64 ? 0 : n));
    const bool is_closed = closed[b] != 0;
    const int w = width[b];
    double* row_r = zr + (size_t)b * (size_t)lanes;
    double* row_i = zi + (size_t)b * (size_t)lanes;

    for (int i = tid; i < n; i += nt) {
        z[i] = make_double2(row_r[i], row_i[i]);
        if (!REP64) zf[i] = make_float2((float)row_r[i], (float)row_i[i]);
    }
    if (!is_closed) {
        for (int k = tid; k <= w; k += nt) a[k] = coef[(size_t)b * (size_t)coef_stride + k];
    }
    // the row's switch radius: 140.0 / t is t.reciprocal() * 140.0 in torch
    double r_sw2 = 0.0;
    if (is_closed) {
        const double r_sw = fmin(pow(10.0, (1.0 / fmax((double)n, 1.0)) * 140.0), 1.25);
        r_sw2 = r_sw * r_sw;
    }
    __syncthreads();

    // this thread's lanes are tid, tid + nt, ...; bit m of a mask is lane tid + m nt
    const int mine = tid < n ? (n - tid + nt - 1) / nt : 0;
    const unsigned all = mine >= 32 ? ~0u : (1u << mine) - 1u;
    unsigned frozen = 0u;
    int it = 0;
    while (it < max_iters) {
        int m = 0;
        for (int i = tid; i < n; i += nt, ++m) {
            if ((frozen >> m) & 1u) continue;
            const C2 zc = {z[i].x, z[i].y};
            const C2 wr = is_closed ? newton_closed(fam, n, r_sw2, zc)
                                    : newton_horner(a, w, n, zc);
            C2 s;
            if (REP64) {
                double sr = 0.0, si = 0.0;
                for (int j = 0; j < n; ++j) {
                    const double2 o = z[j];
                    const double dr = zc.r - o.x;
                    const double di = zc.i - o.y;
                    const double d2 = dr * dr + di * di;
                    const double inv = d2 > 0.0 ? 1.0 / d2 : 0.0;
                    sr = sr + dr * inv;
                    si = si + (-di) * inv;
                }
                s = {sr, si};
            } else {
                const float xr = zf[i].x, xi = zf[i].y;
                float sr = 0.0f, si = 0.0f;
                for (int j = 0; j < n; ++j) {
                    const float2 o = zf[j];
                    const float dr = xr - o.x;
                    const float di = xi - o.y;
                    const float d2 = dr * dr + di * di;
                    const float inv = d2 > 0.0f ? __frcp_rn(d2) : 0.0f;
                    sr = sr + dr * inv;
                    si = si + (-di) * inv;
                }
                s = {(double)sr, (double)si};
            }
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
                zn[i] = make_double2(next.r, next.i);
            }
        }
        __syncthreads();  // every lane has read the roots of this step
        m = 0;
        for (int i = tid; i < n; i += nt, ++m) {
            if ((frozen >> m) & 1u) continue;
            z[i] = zn[i];
            if (!REP64) zf[i] = make_float2((float)zn[i].x, (float)zn[i].y);
        }
        ++it;
        if (__syncthreads_and(frozen == all)) break;
    }

    for (int i = tid; i < n; i += nt) {
        row_r[i] = z[i].x;
        row_i[i] = z[i].y;
    }
    if (tid == 0) steps[b] = it;
}

template <bool REP64>
int launch(void* zr, void* zi, void* steps, const void* deg, const void* width,
           const void* closed, const void* coef, int coef_stride, int batch, int lanes,
           int max_iters, double tol2, const ClosedForm& fam, int threads, int smem,
           void* stream) {
    // above the default 48 KB only (the pipelines' clouds stay below it, so a
    // launch captured into a CUDA graph makes no other runtime call)
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(aberth_kernel<REP64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    aberth_kernel<REP64><<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<double*>(zr), static_cast<double*>(zi), static_cast<int*>(steps),
        static_cast<const int*>(deg), static_cast<const int*>(width),
        static_cast<const unsigned char*>(closed), static_cast<const double*>(coef),
        coef_stride, lanes, max_iters, tol2, fam);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream): one CTA of `threads` threads
// (<= 256) and `smem` bytes of dynamic shared memory a polynomial. zr, zi:
// (batch, lanes) f64, the start roots in, the roots out (lanes >= deg[b]
// untouched); steps: (batch,) int32 out; deg, width: (batch,) int32; closed:
// (batch,) uint8; coef: (batch, coef_stride) f64 ascending coefficients, read
// only on rows that are not closed (may be null when every row is). Returns
// cudaGetLastError() as an int; the caller raises when it is not 0.
// Allocates nothing and does not synchronize.
extern "C" int aberth_launch(void* zr, void* zi, void* steps, const void* deg, const void* width,
                             const void* closed, const void* coef, int coef_stride, int batch,
                             int lanes, int max_iters, double tol2, int rep64, double c0,
                             double c1, double c2, double c3, int nc, double a_const,
                             int threads, int smem, void* stream) {
    const ClosedForm fam = {{c0, c1, c2, c3}, nc, a_const};
    if (rep64)
        return launch<true>(zr, zi, steps, deg, width, closed, coef, coef_stride, batch, lanes,
                            max_iters, tol2, fam, threads, smem, stream);
    return launch<false>(zr, zi, steps, deg, width, closed, coef, coef_stride, batch, lanes,
                         max_iters, tol2, fam, threads, smem, stream);
}
