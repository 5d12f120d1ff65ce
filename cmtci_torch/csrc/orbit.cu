// The per-point escape-time loops of cmtci_torch/kernels/mandelbrot.py, one
// thread a point, for Hopper (sm_90a), in f32 or f64 (the tensors' dtype).
//
// Replaces the reference's compiled device loops in cmtci/kernels/mandelbrot.py
// (the eager port ran each as a Python loop that launched every elementwise op
// from the host, a few per step):
//   orbit_dwell      dwell_grid              fori_loop at :83
//   orbit_de_tci     de_field_tci            :115
//   orbit_de_std     de_field_std            :163
//   orbit_green      _green_stage            :204
//   orbit_de_stage1  de_field_stage1         :326
//   orbit_potential  escape_potential_grid   :380
// Each entry writes the loop state its twin's loop leaves behind (the
// *_loop_torch functions of mandelbrot.py): the latched z (and dz), the
// escape flag and the step or dwell. The epilogue after the loop (hypot, log,
// exp2, atan2, the clamps, the division by 2^k) is torch code that both
// paths share, so the kernel is bitwise its twin when its loop state is
// (orbit_de_tci and orbit_potential: where their contracts below say so, and
// the epilogue's d or g everywhere).
//
// Bitwise: every step runs in the twin's op order (z^2 + c as
// zr*zr - zi*zi + cr and zr*zi + zi*zr + ci, dz <- (2 z) dz + 1 before z) with
// -fmad=false, IEEE division and square root, and the radius tests the twin
// writes (|z|^2 > r^2; sqrt(|z|^2) > R, as the exact squared threshold
// |z|^2 > t of de_tci_kernel; hypot(zr, zi) > R, CUDA's hypot being what
// torch's CUDA kernel calls). The threshold is rounded to the dtype as
// torch rounds a Python scalar. Two rewrites of a step keep its bits: the
// squares of one step's radius test are the next step's zr*zr and zi*zi (the
// same products of the same values), and zr*zi + zi*zr is p + p with
// p = zr*zi (IEEE multiplication commutes; the sum is the same sum). A thread
// leaves its loop where nothing it writes can change any more:
//   * green latches its state at the first escape and freezes the orbit; the
//     thread leaves there and writes the zeroed z its twin carries on. It
//     runs GREEN_CHUNK steps between two branches and replays a chunk in
//     which its point escaped, and packs a block's running points into its
//     first warps every GREEN_EPOCH steps (green_kernel), so that its one
//     launch over the whole budget of the f64 equipotential runs its deepest
//     points in full warps, each step a dependent chain of three f64
//     instructions;
//   * dwell, de_tci, de_std, de_stage1 and potential: the designs below
//     (dwell_of, tci_first_pass, first_escape).
//
// de_stage1's radius test hypot(zr, zi) > R as a band around R^2
// (HypotBand, mandelbrot.hypot_band). hypot is not a function of the rounded
// |z|^2, so no single squared threshold is exact; a band is. Let x, y be
// the dtype's zr and zi, h = sqrt(x^2 + y^2) exactly, and s = x*x + y*y as
// the carried squares give it (each product and the sum rounded to nearest,
// -fmad=false). With u the unit roundoff (2^-53 in f64, 2^-24 in f32) and no
// overflow, |s - h^2| <= 3u h^2 + 3 eta, eta the largest error of a product
// that underflows (half the smallest subnormal). CUDA's Math API documents
// hypot to 2 ulp and hypotf to 3 ulp, so H = hypot(x, y) is within
// e h of h with e < 2^-50 (f64), 2^-20 (f32). The wrapper passes
// t_hi >= R^2 (1 + d) and t_lo <= R^2 (1 - d) in the dtype, rounded outwards
// from the exact R^2 of the dtype's R, with the half-width d = 2^-30 (f64),
// 2^-12 (f32): orders of magnitude above 3u + e, so that nothing hinges on
// the exact ulp counts. Then:
//   * 3 eta (eta 2^-1075, 2^-150) is below d R^2 / 8 for R >= 2^-400 (f64),
//     2^-40 (f32), and R^2 (1 + d) stays finite for R <= 2^400, 2^40;
//   * s > t_hi then gives h > R (1 + d/3), and H >= h (1 - e) > R: hypot
//     passes;
//   * s < t_lo gives h < R (1 - d/3), and H <= h (1 + e) < R: hypot fails
//     (R is a value of the dtype, so H > R is the real comparison);
//   * overflow: a square or the sum that rounds to +inf means h^2 above
//     about 2^1023 (2^127), so H > R; an infinite x or y gives s = +inf
//     (or NaN with a NaN part) and hypot +inf, which passes;
//   * a NaN s fails both comparisons and takes hypot itself, as hypot(inf,
//     NaN) = +inf escapes in the twin and hypot(NaN, y) = NaN does not.
// Outside that range of R, and for a NaN, infinite, zero or negative R, the
// band is (-inf, +inf): every step takes hypot, as a test a step would. On
// stage1's grid no step of a point still running comes within 1.33e-3 of R^2
// (relative), so at the defaults no step calls hypot.
//
// What bounds it on this card: the FP64 (or FP32) instruction rate; no point
// reads another, the bytes are a few loads and stores a point. With
// -fmad=false every operation is one instruction, and the FP64 pipes issue
// 64 instructions a clock on an SM (about 16.7e12 a second on the card, half
// the 33.5 TFLOP/s that counts an FMA as two). The steps are data dependent:
// a warp runs as long as its slowest point.
//
// orbit_dwell, orbit_de_tci, orbit_de_std, orbit_de_stage1 and
// orbit_potential run fewer steps and cheaper ones:
//   * Analytic interior, f64 only (skips_interior). A point that the cardioid
//     or period-2 bulb test of the reference's _interior_mask
//     (cmtci/kernels/mandelbrot_pallas.py:148) accepts, evaluated in f64 with
//     the same 1e-5 margins (interior_f64), takes no step: dwell writes
//     max_iter, de_tci, de_std, de_stage1 and potential an unescaped point
//     (potential only where its caller asks, below). The twin runs every
//     step for it, and this is bitwise because such an orbit never escapes
//     in f64: every
//     accepted c lies a margin inside a hyperbolic component (the fixed
//     point's multiplier |1 - sqrt(1 - 4c)| < 1, or the 2-cycle's
//     |4(c + 1)| < 1), so the orbit of 0 stays in the attracting cycle's
//     basin, near the cycle, with |z|^2 at most about 1.61 (1.608 over 5,000
//     f64 steps of 4,000 seeded points just inside the mask's rim, where the
//     multiplier is nearest 1 and the orbit slowest). A rounding of about 1e-16 a step is
//     absorbed by the contraction towards the cycle and cannot carry |z|^2
//     from 1.6 past 4, the dwell's radius, or past any squared threshold
//     t >= 4 of de_tci, de_std or potential (which skip only then), and
//     keeps hypot below about 1.27, under any R >= 2 of de_stage1 (which
//     skips only then).
//     tests/test_torch_orbit_redesign.py iterates rim points 5,000 steps;
//     chip_smoke.py holds the five entries bitwise to their twins (their
//     contracts) on a grid over the cardioid-bulb junction at 2,000 steps.
//     f32 points run every step: the argument is made for f64 rounding.
//   * Branch-free chunks of DWELL_C (TCI_C, STD_C, S1_C, POT_C) steps, as
//     escape.cuh's dwell_chunked and bare_step run them in f32: the squares
//     carried from one step's test into the next step's update, p + p, a
//     sticky flag or a latch, and the exit test once a chunk. A step is 9
//     FP64 instructions (3 mul, 5 add/sub, 1 compare) against the twin's 12.
//   * A compact warp footprint on a 2-D grid: the wrapper passes the (ny, nx)
//     of the contiguous input (a 1-D input is one row), a warp's 32 threads
//     tile PATCH_W x PATCH_H points (de_std, de_stage1 and potential: their
//     own patches), a block is WARPS patches side by side along x, and the
//     rows of blocks are handed out from the middle of the grid outwards, so
//     the rows that cross the set start first. A grid of fewer rows than a
//     patch, or of more rows than 65,535 rows of blocks hold, runs as one row
//     of 32-point warps. No result depends on the footprint.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int BLOCK = 256;
// the Green loop's steps between two branches on its escape test, and
// between two repacks of a block's running points
constexpr int GREEN_CHUNK = 64;
constexpr int GREEN_EPOCH = 512;
// orbit_dwell's, orbit_de_tci's, orbit_de_std's and orbit_potential's
// schedule
constexpr int DWELL_C = 8;          // dwell steps between two exit tests
constexpr int TCI_C = 6;            // de_tci's first-pass steps between two exit tests
constexpr int STD_C = 8;            // de_std's first-pass steps between two exit tests
constexpr int POT_C = 8;            // potential's steps between two exit tests
constexpr int S1_C = 8;             // de_stage1's steps between two exit tests
constexpr int PATCH_W = 4;          // points across a warp's patch (dwell, de_tci)
constexpr int PATCH_H = 8;          // points down a warp's patch
constexpr int ESC_PATCH_W = 8;      // de_std's and potential's patch
constexpr int ESC_PATCH_H = 4;
constexpr int WARPS = 4;            // warps a block, side by side along x
constexpr int POT_WARPS = 2;        // potential's warps a block
constexpr int S1_PATCH_W = 8;       // de_stage1's patch
constexpr int S1_PATCH_H = 4;
constexpr int S1_WARPS = 1;         // de_stage1's warps a block
constexpr int LATCH_BY_REPLAY = 1;  // de_tci, de_std, potential: the first escape latched by a
                                    // replay of the flagged chunk (1) or a select every step (0)
constexpr int STD_DZ_CARRIED_F64 = 1;  // de_std in f64: dz carried in the first pass and
                                       // latched with z (1) or by a second pass of the escapers (0)
constexpr int STD_DZ_CARRIED_F32 = 0;  // the same in f32
constexpr int S1_DZ_CARRIED_F64 = 1;   // de_stage1: the same choice, in f64
constexpr int S1_DZ_CARRIED_F32 = 1;   // and in f32

// _zsq_add_c: z <- z*z + c, both parts from the old z
template <typename T>
__device__ __forceinline__ void zsq_add_c(T& zr, T& zi, T cr, T ci) {
    const T nr = zr * zr - zi * zi + cr;
    const T ni = zr * zi + zi * zr + ci;
    zr = nr;
    zi = ni;
}

// dz <- 2 z dz + 1 from the old z (numpy's order: t = 2 z, then t dz, then + 1)
template <typename T>
__device__ __forceinline__ void dz_step(T zr, T zi, T& dzr, T& dzi) {
    const T tr = T(2) * zr;
    const T ti = T(2) * zi;
    const T nr = tr * dzr - ti * dzi + T(1);
    const T ni = tr * dzi + ti * dzr;
    dzr = nr;
    dzi = ni;
}

__device__ __forceinline__ long long point_index() {
    return (long long)blockIdx.x * BLOCK + threadIdx.x;
}

// The point of the calling thread on the compact footprint (escape.cuh's
// patch_pixel with 64-bit columns): p = row * nx + col of a (ny, nx) grid,
// false past its edge. A warp tiles PW x PH points, a block is NW patches
// side by side along x; blockIdx.y is the rank of the row of blocks in the
// order middle, one below, one above, ...
template <int PW, int PH, int NW = WARPS>
__device__ __forceinline__ bool patch_point(long long ny, long long nx, long long& p) {
    static_assert(PW * PH == 32, "a warp's patch is 32 threads");
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long col = ((long long)blockIdx.x * NW + warp) * PW + lane % PW;
    const int r = blockIdx.y;
    const int by = (int)(gridDim.y - 1) / 2 + ((r & 1) ? (r + 1) / 2 : -(r / 2));
    const long long row = (long long)by * PH + lane / PW;
    p = row * nx + col;
    return col < nx && row < ny;
}

// _interior_mask's cardioid and period-2 bulb tests in f64, the reference's
// op order and 1e-5 margins (0.0625 - 1e-5 folded in double, as the
// reference folds it), for |cr|, |ci| <= 2 only: a ci whose square
// overflows (|ci| > 1.3e154, or inf) would pass the cardioid test as
// inf <= inf, and no point the tests accept without overflow lies farther
// out. A NaN coordinate fails.
__device__ __forceinline__ bool interior_f64(double cr, double ci) {
    const double xm = cr - 0.25;
    const double q = xm * xm + ci * ci;
    const bool in_cardioid = q * (q + xm) <= 0.25 * ci * ci - 1e-5;
    const double xp = cr + 1.0;
    const bool in_bulb = xp * xp + ci * ci <= 0.0625 - 1e-5;
    return fabs(cr) <= 2.0 && fabs(ci) <= 2.0 && (in_cardioid || in_bulb);
}

template <typename T>
__device__ __forceinline__ bool skips_interior(T cr, T ci) {
    if constexpr (std::is_same<T, double>::value)
        return interior_f64(cr, ci);
    return false;
}

// One branch-free step from the carried squares: z <- z^2 + c as the twin
// computes it (zr*zr - zi*zi + cr; zr*zi + zi*zr + ci as p + p + ci), then
// the new squares, which the radius test reads and the next step reuses.
// 3 mul and 4 add/sub; the caller's test adds an add and a compare.
template <typename T>
__device__ __forceinline__ void carried_step(T& zr, T& zi, T& zr2, T& zi2, T cr, T ci) {
    const T p = zr * zi;
    const T nzr = zr2 - zi2 + cr;
    const T nzi = p + p + ci;
    zr = nzr;
    zi = nzi;
    zr2 = nzr * nzr;
    zi2 = nzi * nzi;
}

// dwell_grid's loop: the first n (0-based) with |z_{n+1}|^2 > 4, else
// max_iter (max_iter for max_iter <= 0). The twin tests zr*zr + zi*zi > 4,
// so a NaN |z|^2 never escapes (escape.cuh's K2 latch !(|z|^2 <= 4) would
// count it), and freezes an escaped orbit, which no later step can then
// change. Here a latch `inside` falls at the first |z|^2 > 4 and only falls;
// the orbit runs on past it harmlessly, to inf or NaN, until the chunk ends.
// No counter in the loop: the dwell is the steps before the newest chunk
// plus the latches still up inside it, min'd with max_iter, which undoes the
// up to DWELL_C - 1 steps the last chunk may take past max_iter exactly
// (the dwell is the count of leading steps that stayed inside).
template <typename T>
__device__ __forceinline__ int dwell_of(T cr, T ci, int max_iter) {
    if (max_iter <= 0 || skips_interior(cr, ci)) return max_iter;
    T zr = T(0), zi = T(0), zr2 = T(0), zi2 = T(0);
    bool inside = true;
    bool up[DWELL_C];  // the latch after each step of the newest chunk
    long long n = 0;
    do {
#pragma unroll
        for (int s = 0; s < DWELL_C; ++s) {
            carried_step(zr, zi, zr2, zi2, cr, ci);
            inside = inside && !(zr2 + zi2 > T(4));
            up[s] = inside;
        }
        n += DWELL_C;
    } while (inside && n < max_iter);
    int in_chunk = 0;
#pragma unroll
    for (int s = 0; s < DWELL_C; ++s) in_chunk += up[s] ? 1 : 0;
    return (int)min(n - DWELL_C + in_chunk, (long long)max_iter);
}

template <typename T, int PW, int PH>
__global__ void __launch_bounds__(32 * WARPS)
dwell_kernel(const T* __restrict__ cr, const T* __restrict__ ci, int* __restrict__ dwell,
             long long ny, long long nx, int max_iter) {
    long long p;
    if (!patch_point<PW, PH>(ny, nx, p)) return;
    dwell[p] = dwell_of(cr[p], ci[p], max_iter);
}

// de_field_tci. The twin runs (z, dz) for every step and returns
// (esc, lr, li, dzr, dzi): z latched at the first sqrt(|z|^2) > R, and the
// FINAL dz, which runs on past the escape to inf and NaN. Almost no point
// needs that dz (of the f64 tracker's 690^2 grid 22 escapers keep a finite
// z up to step max_iter - 1), so the kernel follows K1 (tci_de.cu) in f32
// and f64 alike:
//   * The radius test as a squared threshold: IEEE sqrt is correctly
//     rounded, hence monotone, so sqrt(s) > R holds exactly when s > t, t the
//     largest value of the dtype with sqrt(t) <= R (the wrapper finds it on
//     the host with the dtype's correctly rounded sqrt; t = 62500 for R = 250
//     in f64). NaN fails both tests and +inf passes both; no R gives
//     another t (R < 0: t = -inf; R NaN: t = +inf).
//   * First pass, z alone (tci_first_pass): TCI_C-step chunks of
//     carried_step with a sticky flag, the z of the first escape latched
//     bitwise by running the flagged chunk again step by step from its start
//     (LATCH_BY_REPLAY; a select every step instead was a fifth slower at
//     the f64 tracker's 690^2, PERF.md), the exit test once a chunk. Whole
//     chunks only up to step max_iter - 1, the rest one by one: no step past
//     max_iter. It stops once the point has escaped and its z is non-finite,
//     or at max_iter.
//   * Late escapers: escaped, and z still finite after step max_iter - 1.
//     Only their final dz can be finite. Each reruns the twin's (z, dz) body
//     from z = 0, dz = 1 for max_iter steps (tci_second_pass): its dz is the
//     twin's, bit for bit.
//   * Every other escaper, every point that does not escape, and every
//     interior point skipped in f64 write dz = (NaN, NaN).
//
// The loop-state contract of orbit_de_tci (mandelbrot._de_tci_loop_cuda):
// (esc, lr, li) are the twin's bits; at an escaper whose twin's final dz is
// finite in both parts, dz is the twin's bits; every other point has
// dz = (NaN, NaN), except that for R < 2 (t < 4) every escaper takes the
// second pass and gets the twin's final dz, finite or not. The epilogue's d
// is the twin's all the same:
//   * A non-late escaper's twin dz is non-finite: its z is non-finite after
//     some s <= max_iter - 1 steps, and step s + 1 <= max_iter computes
//     dz <- 2 z dz + 1 with a non-finite half of z times each half of dz in
//     each half of dz (inf times anything is inf or NaN, never finite). A
//     non-finite half of dz makes both halves non-finite at the next step
//     and for ever (each new half holds a product of a half of 2z with it).
//   * d reads dz only through den = max(hypot(pr, pi), eps), pr and pi the
//     parts of 2 z_l dz. A non-finite half of dz makes pr or pi non-finite
//     (0 * inf is NaN), so den is +inf or NaN. num = log(max(|z_l|, 1e-300))
//     |z_l| is > 0 for R >= 2 (|z_l| > 2) or NaN, so num / den is +0.0 or
//     NaN, and nan_to_num gives +0.0: the twin's d. The NaN dz gives den NaN
//     and d = +0.0 too. (For R < 2 num can be negative and num / +inf -0.0,
//     hence the second pass for every escaper there.)
//   * A point that does not escape has d = 0 by the epilogue's where.
//   * The f64 interior is skipped only for R >= 2: its |z|^2 stays below
//     about 1.61 (above), so it never passes t >= 4.
template <typename T>
__device__ __forceinline__ T quiet_nan() {
    if constexpr (std::is_same<T, double>::value)
        return __longlong_as_double(0x7ff8000000000000LL);
    else
        return __int_as_float(0x7fc00000);
}

template <typename T>
__device__ __forceinline__ void latch_on_first(bool h, bool hit, T zr, T zi, T& l_r, T& l_i) {
    l_r = (h && !hit) ? zr : l_r;
    l_i = (h && !hit) ? zi : l_i;
}

// The first pass of a point that is not skipped, max_iter >= 1. Returns
// whether it escaped within max_iter steps, (l_r, l_i) the z of its first
// escape; late whether it escaped and z was finite after max_iter - 1 steps.
template <typename T>
__device__ __forceinline__ bool tci_first_pass(T cr, T ci, int max_iter, T t, T& l_r, T& l_i,
                                               bool& late) {
    T zr = T(0), zi = T(0), zr2 = T(0), zi2 = T(0);
    bool hit = false;
    late = false;
    const int last = max_iter - 1;  // the steps after which late is decided
    int n = 0;
    // whole chunks, none past step `last`
    for (; n + TCI_C <= last; n += TCI_C) {
        if constexpr (LATCH_BY_REPLAY != 0) {
            const T sr = zr, si = zi, sr2 = zr2, si2 = zi2;
            const bool was = hit;
#pragma unroll
            for (int s = 0; s < TCI_C; ++s) {
                carried_step(zr, zi, zr2, zi2, cr, ci);
                hit = hit || (zr2 + zi2 > t);
            }
            if (hit && !was) {
                // the flagged chunk again, from its start, up to its first escape
                T rr = sr, ri = si, rr2 = sr2, ri2 = si2;
                for (int s = 0; s < TCI_C; ++s) {
                    carried_step(rr, ri, rr2, ri2, cr, ci);
                    if (rr2 + ri2 > t) {
                        l_r = rr;
                        l_i = ri;
                        break;
                    }
                }
            }
        } else {
#pragma unroll
            for (int s = 0; s < TCI_C; ++s) {
                carried_step(zr, zi, zr2, zi2, cr, ci);
                const bool h = zr2 + zi2 > t;
                latch_on_first(h, hit, zr, zi, l_r, l_i);
                hit = hit || h;
            }
        }
        if (hit && !(isfinite(zr) && isfinite(zi))) return true;
    }
    // the steps up to `last`, one by one
    for (; n < last; ++n) {
        carried_step(zr, zi, zr2, zi2, cr, ci);
        const bool h = zr2 + zi2 > t;
        latch_on_first(h, hit, zr, zi, l_r, l_i);
        hit = hit || h;
        if (hit && !(isfinite(zr) && isfinite(zi))) return true;
    }
    // z after max_iter - 1 steps is finite, or the point has not escaped:
    // the last step decides the latter
    if (!hit) {
        carried_step(zr, zi, zr2, zi2, cr, ci);
        const bool h = zr2 + zi2 > t;
        latch_on_first(h, hit, zr, zi, l_r, l_i);
        hit = h;
    }
    late = hit;
    return hit;
}

// The twin's (z, dz) body from z = 0, dz = 1 for max_iter steps: the final
// dz of a late escaper (of every escaper when !fast), kept only where it is
// finite in both parts when fast.
template <typename T>
__device__ __forceinline__ void tci_second_pass(T cr, T ci, int max_iter, bool fast, T& d_r,
                                                T& d_i) {
    T zr = T(0), zi = T(0), dzr = T(1), dzi = T(0);
    for (int k = 0; k < max_iter; ++k) {
        dz_step(zr, zi, dzr, dzi);
        zsq_add_c(zr, zi, cr, ci);
    }
    if (!fast || (isfinite(dzr) && isfinite(dzi))) {
        d_r = dzr;
        d_i = dzi;
    }
}

template <typename T, int PW, int PH>
__global__ void __launch_bounds__(32 * WARPS)
de_tci_kernel(const T* __restrict__ cr, const T* __restrict__ ci, unsigned char* __restrict__ esc,
              T* __restrict__ lr, T* __restrict__ li, T* __restrict__ dr, T* __restrict__ di,
              long long ny, long long nx, int max_iter, T t, int* __restrict__ second_passes) {
    long long p;
    if (!patch_point<PW, PH>(ny, nx, p)) return;
    const T c_r = cr[p], c_i = ci[p];
    // R >= 2: the interior may be skipped and a non-late escaper's dz dropped
    const bool fast = t >= T(4);
    T l_r = T(0), l_i = T(0), d_r = quiet_nan<T>(), d_i = quiet_nan<T>();
    bool e = false;
    if (max_iter > 0 && !(fast && skips_interior(c_r, c_i))) {
        bool late;
        e = tci_first_pass(c_r, c_i, max_iter, t, l_r, l_i, late);
        if (e && (late || !fast)) {
            if (second_passes != nullptr) atomicAdd(second_passes, 1);
            tci_second_pass(c_r, c_i, max_iter, fast, d_r, d_i);
        }
    }
    esc[p] = e;
    lr[p] = l_r;
    li[p] = l_i;
    dr[p] = d_r;
    di[p] = d_i;
}

// A walk from z = 0 (dz = 1) for the first-escape entries: z with its
// carried squares, and dz when WITH_DZ. step() runs one step in the twin's
// order (dz <- 2 z dz + 1 from the old z, then z as carried_step).
template <typename T, bool WITH_DZ>
struct Walk {
    T zr = T(0), zi = T(0), zr2 = T(0), zi2 = T(0), dzr = T(1), dzi = T(0);

    __device__ __forceinline__ void step(T cr, T ci) {
        if constexpr (WITH_DZ) dz_step(zr, zi, dzr, dzi);
        carried_step(zr, zi, zr2, zi2, cr, ci);
    }
};

// The radius tests of first_escape on a walk's state: flag() the test a
// chunk folds into its sticky flag, exact() a step's own test. flag() is
// true wherever exact() is (it may also be true where exact() is not: a
// false alarm, which the replay below absorbs). interior_never_passes():
// no orbit of the f64 analytic interior passes exact() (the rim argument
// above), so such a point may take no step.
//   SquaredTest: |z|^2 > t on the carried squares (de_std, potential); the
//   flag is the exact test.
template <typename T>
struct SquaredTest {
    T t;

    template <bool D>
    __device__ __forceinline__ bool flag(const Walk<T, D>& w) const {
        return w.zr2 + w.zi2 > t;
    }
    template <bool D>
    __device__ __forceinline__ bool exact(const Walk<T, D>& w) const {
        return flag(w);
    }
    __device__ __forceinline__ bool interior_never_passes() const { return t >= T(4); }
};

//   HypotBand: de_stage1's hypot(zr, zi) > r through the band (t_lo, t_hi)
//   around r^2 (the argument above): s > t_hi passes, s < t_lo fails, and
//   only an s inside the band, or a NaN s, calls hypot, adding one to
//   *hypot_calls where that is not null (a check's count; nothing else reads
//   it). The flag is !(s < t_lo): true inside the band and for a NaN s.
template <typename T>
struct HypotBand {
    T r, t_lo, t_hi;
    int* hypot_calls;

    template <bool D>
    __device__ __forceinline__ bool flag(const Walk<T, D>& w) const {
        return !(w.zr2 + w.zi2 < t_lo);
    }
    template <bool D>
    __device__ __forceinline__ bool exact(const Walk<T, D>& w) const {
        const T s = w.zr2 + w.zi2;
        if (s > t_hi) return true;
        if (s < t_lo) return false;
        if (hypot_calls != nullptr) atomicAdd(hypot_calls, 1);
        return hypot(w.zr, w.zi) > r;
    }
    __device__ __forceinline__ bool interior_never_passes() const { return r >= T(2); }
};

// The first escape of walk w within max_iter steps under `test`: returns k,
// its 1-based step, with w the state there; or 0, with w the state after
// max_iter steps (after none for max_iter <= 0). Chunks of C steps, the
// flags folded into one with one branch a chunk, none past max_iter; with
// LATCH_BY_REPLAY a flagged chunk is run again from its start one step at a
// time with the exact test, and every later step too (green_steps' design
// without its stages: a false alarm costs the point its chunks, not its
// bits), else the state of the first escape is kept by a select on the
// exact test every step. The remaining max_iter mod C steps run one by one.
// Each step is the same steps in the same op order as a test a step, so the
// state is bitwise that of a loop that stops at the first exact test: a NaN
// |z|^2 fails a squared flag as it fails the test (and raises the band's
// flag, whose exact test then decides), and the steps a flagged chunk takes
// past the escape (to inf or NaN) are undone or never read.
template <int C, typename T, bool WITH_DZ, typename Test>
__device__ __forceinline__ int first_escape(Walk<T, WITH_DZ>& w, T cr, T ci, int max_iter,
                                            const Test& test) {
    int n = 0;
    if constexpr (LATCH_BY_REPLAY != 0) {
        for (; n + C <= max_iter; n += C) {
            const Walk<T, WITH_DZ> start = w;
            bool hit = false;
#pragma unroll
            for (int s = 0; s < C; ++s) {
                w.step(cr, ci);
                hit = hit || test.flag(w);
            }
            if (hit) {
                w = start;  // the flagged chunk again, one step at a time below
                break;
            }
        }
    } else {
        Walk<T, WITH_DZ> at;
        int k = 0;
        for (; n + C <= max_iter; n += C) {
#pragma unroll
            for (int s = 0; s < C; ++s) {
                w.step(cr, ci);
                const bool first = k == 0 && test.exact(w);
                at.zr = first ? w.zr : at.zr;
                at.zi = first ? w.zi : at.zi;
                at.dzr = first ? w.dzr : at.dzr;
                at.dzi = first ? w.dzi : at.dzi;
                k = first ? n + s + 1 : k;
            }
            if (k != 0) {
                w = at;
                return k;
            }
        }
    }
    for (; n < max_iter; ++n) {
        w.step(cr, ci);
        if (test.exact(w)) return n + 1;
    }
    return 0;
}

// de_field_std and de_field_stage1, one loop (the twin of both is
// _de_latched_loop_torch). The twin runs (z, dz) every step and latches both
// at the first |z| > R (de_std: sqrt(|z|^2); de_stage1: hypot(zr, zi)), then
// freezes the orbit: (esc, lz, ld), lz = (0, 0) and ld = (1, 0) where it
// does not escape. Here, bitwise everywhere, with no contract:
//   * the radius test (Test): de_std's as de_tci's squared threshold s > t
//     (SquaredTest, mandelbrot.radius_threshold: sqrt is monotone, NaN fails
//     both tests); de_stage1's through the band around R^2 (HypotBand,
//     mandelbrot.hypot_band, the argument above);
//   * the f64 analytic interior, for t >= 4 (R >= 2) only, takes no step and
//     writes the twin's unescaped point: it never passes the test;
//   * a first pass of z alone finds the escape step k (first_escape, C steps
//     a chunk): the z sequence is the twin's bit for bit (the carried squares
//     are its zr*zr and zi*zi), so k is the twin's;
//   * dz either in a second pass that only the escapers take: the twin's
//     (dz, z) body from z = 0, dz = 1 for exactly k steps, which ends on the
//     twin's latched z and dz (most escapers leave within a few steps; a
//     point that never escapes takes no dz step); or carried in the first
//     pass and latched with z (CARRIED: STD_DZ_CARRIED_*, S1_DZ_CARRIED_*).
//     de_std carries it in f64: with the interior skipped few points run
//     long, and dz's instructions issue beside z's dependent chain, where a
//     second pass would add its own chain; in f32 it takes the second pass:
//     no point is skipped, and every interior point would carry dz through
//     all max_iter steps (both measured, PERF.md). de_stage1 carries it in
//     both dtypes (S1_DZ_*): its grid is resident at once and its deepest
//     lanes never escape, so a second pass only lengthens the late
//     escapers' chains (measured, PERF.md);
//   * PW x PH patches, NW warps a block: de_std 8 x 4 (ESC_PATCH_*),
//     measured faster there than dwell's 4 x 8, WARPS; de_stage1 8 x 4
//     (S1_PATCH_*) in blocks of one warp (S1_WARPS): its 80 x 120 grid is
//     resident at once, so where its 158 deep lanes fall sets the time, as
//     for the potential below, and one-warp blocks spread them best.
template <typename T, int PW, int PH, int NW, int C, bool CARRIED, typename Test>
__global__ void __launch_bounds__(32 * NW)
de_latched_kernel(const T* __restrict__ cr, const T* __restrict__ ci,
                  unsigned char* __restrict__ esc, T* __restrict__ lzr, T* __restrict__ lzi,
                  T* __restrict__ ldr, T* __restrict__ ldi, long long ny, long long nx,
                  int max_iter, Test test) {
    long long p;
    if (!patch_point<PW, PH, NW>(ny, nx, p)) return;
    const T c_r = cr[p], c_i = ci[p];
    Walk<T, true> w;
    int k = 0;
    if (!(test.interior_never_passes() && skips_interior(c_r, c_i))) {
        if constexpr (CARRIED) {
            k = first_escape<C>(w, c_r, c_i, max_iter, test);
        } else {
            Walk<T, false> z;
            k = first_escape<C>(z, c_r, c_i, max_iter, test);
            for (int s = 0; s < k; ++s) w.step(c_r, c_i);
        }
    }
    const bool e = k > 0;
    esc[p] = e;
    lzr[p] = e ? w.zr : T(0);
    lzi[p] = e ? w.zi : T(0);
    ldr[p] = e ? w.dzr : T(1);
    ldi[p] = e ? w.dzi : T(0);
}

// the Green loop's steps from z: `steps` of them, the test |z|^2 > r2 of
// each folded into the returned flag (no branch a step, so a step's z update
// overlaps the test of the step before)
template <typename T, int STEPS>
__device__ __forceinline__ bool green_chunk(T& zr, T& zi, T c_r, T c_i, T r2) {
    bool out = false;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
        zsq_add_c(zr, zi, c_r, c_i);
        out = out | (zr * zr + zi * zi > r2);
    }
    return out;
}

// the Green loop of one point from step i up to step `stop` (< iters only at
// an epoch's end): GREEN_CHUNK steps at a time with the tests folded into a
// flag; a chunk that flags an escape is run again from its start, a test and
// a branch a step, and stops at the escape. The same steps in the same op
// order as a test a step, so the state is bitwise the step-by-step loop's
// for any r2 (the flag reads every step's test, and a NaN fails it as it
// fails the step-by-step test). Returns whether the point escaped; then
// k = k0 + its 1-based step, (l_r, l_i) the latched z and z zeroed.
template <typename T>
__device__ __forceinline__ bool green_steps(T& zr, T& zi, int& i, int stop, T c_r, T c_i, T r2,
                                            int k0, int& k, T& l_r, T& l_i) {
    for (; i + GREEN_CHUNK <= stop; i += GREEN_CHUNK) {
        const T sr = zr, si = zi;
        if (green_chunk<T, GREEN_CHUNK>(zr, zi, c_r, c_i, r2)) {
            zr = sr;
            zi = si;
            stop = i + GREEN_CHUNK;
            break;
        }
    }
    for (; i < stop; ++i) {
        zsq_add_c(zr, zi, c_r, c_i);
        if (zr * zr + zi * zi > r2) {
            k = k0 + i + 1;
            l_r = zr;
            l_i = zi;
            zr = T(0);
            zi = T(0);
            return true;
        }
    }
    return false;
}

// one stage of the Green loop from the state (zr0, zi0): k is k0 + the 1-based
// step of the first |z|^2 > r2 (kmax if none), z latched there and zeroed.
// After every GREEN_EPOCH steps a block moves the points still running into
// its first threads (a warp ballot and shared memory): the points that never
// escape (6,471 of the f64 equipotential's 80,395 in 20,000 steps) would
// otherwise keep a warp each busy at a lane or two, and the FP64 pipes, not
// their dependent chains, would set the time. A point's arithmetic does not
// depend on the thread that runs it.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
green_kernel(const T* __restrict__ zr0, const T* __restrict__ zi0, const T* __restrict__ cr,
             const T* __restrict__ ci, T* __restrict__ zr_out, T* __restrict__ zi_out,
             unsigned char* __restrict__ esc, int* __restrict__ kk, T* __restrict__ lzr,
             T* __restrict__ lzi, long long n, int k0, int iters, T r2, int kmax) {
    __shared__ long long s_p[BLOCK];
    __shared__ T s_zr[BLOCK], s_zi[BLOCK];
    __shared__ int s_i[BLOCK];
    __shared__ int s_live[BLOCK / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    long long p = point_index();
    bool live = p < n;
    T c_r = T(0), c_i = T(0), zr = T(0), zi = T(0);
    int i = 0;
    if (live) {
        c_r = cr[p];
        c_i = ci[p];
        zr = zr0[p];
        zi = zi0[p];
    }
    while (true) {
        if (live) {
            int k = kmax;
            T l_r = T(0), l_i = T(0);
            const bool e = green_steps(zr, zi, i, min(iters, i + GREEN_EPOCH), c_r, c_i, r2, k0,
                                       k, l_r, l_i);
            if (e || i >= iters) {
                zr_out[p] = zr;
                zi_out[p] = zi;
                esc[p] = e;
                kk[p] = k;
                lzr[p] = l_r;
                lzi[p] = l_i;
                live = false;
            }
        }
        // the block's live points, in order, into its first threads
        const unsigned mask = __ballot_sync(0xffffffffu, live);
        if (lane == 0) s_live[warp] = __popc(mask);
        __syncthreads();
        int base = 0, total = 0;
        for (int w = 0; w < BLOCK / 32; ++w) {
            base += w < warp ? s_live[w] : 0;
            total += s_live[w];
        }
        if (total == 0) break;
        if (live) {
            const int slot = base + __popc(mask & ((1u << lane) - 1u));
            s_p[slot] = p;
            s_zr[slot] = zr;
            s_zi[slot] = zi;
            s_i[slot] = i;
        }
        __syncthreads();
        live = (int)threadIdx.x < total;
        if (live) {
            p = s_p[threadIdx.x];
            zr = s_zr[threadIdx.x];
            zi = s_zi[threadIdx.x];
            i = s_i[threadIdx.x];
            c_r = cr[p];
            c_i = ci[p];
        }
        __syncthreads();
    }
}

// escape_potential_grid's loop. The twin writes (esc, k, lz): k the 0-based
// step of the first |z|^2 > r2 (0 where none), lz the z there, or the last z
// of a point that never escapes. Here first_escape (POT_C steps a chunk; its
// test is the twin's, zr*zr + zi*zi > r2 on the same squares), and, where
// the caller passes skip (the normalizations whose epilogue writes g = 0 at
// every point that does not escape: two_pow_n and k_plus_1, not
// two_pow_k_break, which reads the last z), the f64 analytic interior for
// r2 >= 4 takes no step. Its contract (mandelbrot._potential_contract):
// (esc, k) are the twin's bits; lz is the twin's at every escaper and at
// every point that was not skipped; a skipped point, which the twin never
// lets escape (the rim argument above), has esc 0, k 0 and lz (NaN, NaN).
// g is the twin's bits for the normalization that asked for the skip: its
// epilogue reads lz only where esc. 8 x 4 patches as de_std, in blocks of
// POT_WARPS warps: the variograms' 256^2 is 512 blocks of 4 warps, all
// resident at once, and with 4 warps a block its launch read either about
// 0.016 or 0.024 ms on an H100 from one machine to the next (the boundary's
// deep lanes crowding some SMs' FP64 pipes, as the blocks happened to
// fall); with 1 or 2 warps a block it read about 0.016 every time (PERF.md).
template <typename T, int PW, int PH>
__global__ void __launch_bounds__(32 * POT_WARPS)
potential_kernel(const T* __restrict__ cr, const T* __restrict__ ci,
                 unsigned char* __restrict__ esc, int* __restrict__ kk, T* __restrict__ lzr,
                 T* __restrict__ lzi, long long ny, long long nx, int max_iter, T r2, int skip) {
    long long p;
    if (!patch_point<PW, PH, POT_WARPS>(ny, nx, p)) return;
    const T c_r = cr[p], c_i = ci[p];
    Walk<T, false> w;
    int k = 0;
    if (skip != 0 && r2 >= T(4) && skips_interior(c_r, c_i)) {
        w.zr = quiet_nan<T>();
        w.zi = quiet_nan<T>();
    } else {
        k = first_escape<POT_C>(w, c_r, c_i, max_iter, SquaredTest<T>{r2});
    }
    esc[p] = k > 0;
    kk[p] = k > 0 ? k - 1 : 0;
    lzr[p] = w.zr;
    lzi[p] = w.zi;
}

inline dim3 grid_of(long long n) { return dim3((unsigned)((n + BLOCK - 1) / BLOCK)); }
inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }
inline int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each entry launches on `stream` (PyTorch's current stream) over n points
// (orbit_green; the others ny x nx) in
// contiguous buffers of the dtype (is_double 1: f64, 0: f32); escape flags
// are bytes 0/1 (torch.bool), steps int32. A threshold arrives as a double
// and is rounded to the dtype.
// Returns cudaGetLastError() as an int; the caller raises when it is not 0.
// Allocates nothing and does not synchronize.

// Every entry but orbit_green takes the (ny, nx) of the points' grid
// (row-major, ny * nx points).
// kernel<PW, PH> over the compact footprint of the entry's patch, NW warps
// a block (PATCH_* and WARPS; de_std ESC_PATCH_* and WARPS; de_stage1
// S1_PATCH_* and S1_WARPS; potential ESC_PATCH_* and POT_WARPS), or
// kernel<32, 1> over the points as one row
// when the grid has fewer than PH rows or more than the 65,535 rows of
// blocks a launch can have.
template <int PW = PATCH_W, int PH = PATCH_H, int NW = WARPS, typename Launch>
static void on_footprint(long long ny, long long nx, Launch&& go) {
    const long long block_rows = (ny + PH - 1) / PH;
    if (ny < PH || block_rows > 65535) {
        const long long n = ny * nx;
        go(std::integral_constant<int, 32>(), std::integral_constant<int, 1>(),
           dim3((unsigned)((n + 32 * NW - 1) / (32 * NW))), 1LL, n);
    } else {
        const long long cols = (long long)NW * PW;
        go(std::integral_constant<int, PW>(), std::integral_constant<int, PH>(),
           dim3((unsigned)((nx + cols - 1) / cols), (unsigned)block_rows), ny, nx);
    }
}

template <typename T>
static void dwell_on(const void* cr, const void* ci, void* dwell, long long ny, long long nx,
                     int max_iter, cudaStream_t stream) {
    on_footprint(ny, nx, [&](auto pw, auto ph, dim3 grid, long long gy, long long gx) {
        dwell_kernel<T, decltype(pw)::value, decltype(ph)::value>
            <<<grid, 32 * WARPS, 0, stream>>>((const T*)cr, (const T*)ci, (int*)dwell, gy, gx,
                                              max_iter);
    });
}

extern "C" int orbit_dwell_launch(const void* cr, const void* ci, void* dwell, long long ny,
                                  long long nx, int max_iter, int is_double, void* stream) {
    if (is_double)
        dwell_on<double>(cr, ci, dwell, ny, nx, max_iter, as_stream(stream));
    else
        dwell_on<float>(cr, ci, dwell, ny, nx, max_iter, as_stream(stream));
    return last_error();
}

// t: the squared threshold of de_tci's radius (mandelbrot.radius_threshold),
// a value of the dtype. second_passes: null, or an int on the card that each
// point adds one to as it starts its second pass (a check's count of the
// late escapers; nothing else reads it)
template <typename T>
static void de_tci_on(const void* cr, const void* ci, void* esc, void* lr, void* li, void* dr,
                      void* di, long long ny, long long nx, int max_iter, T t,
                      void* second_passes, cudaStream_t stream) {
    on_footprint(ny, nx, [&](auto pw, auto ph, dim3 grid, long long gy, long long gx) {
        de_tci_kernel<T, decltype(pw)::value, decltype(ph)::value>
            <<<grid, 32 * WARPS, 0, stream>>>((const T*)cr, (const T*)ci, (unsigned char*)esc,
                                              (T*)lr, (T*)li, (T*)dr, (T*)di, gy, gx, max_iter,
                                              t, (int*)second_passes);
    });
}

extern "C" int orbit_de_tci_launch(const void* cr, const void* ci, void* esc, void* lr, void* li,
                                   void* dr, void* di, long long ny, long long nx, int max_iter,
                                   double t, void* second_passes, int is_double, void* stream) {
    if (is_double)
        de_tci_on<double>(cr, ci, esc, lr, li, dr, di, ny, nx, max_iter, t, second_passes,
                          as_stream(stream));
    else
        de_tci_on<float>(cr, ci, esc, lr, li, dr, di, ny, nx, max_iter, (float)t,
                         second_passes, as_stream(stream));
    return last_error();
}

// de_latched_kernel over the footprint of PW x PH patches, NW warps a block
template <int PW, int PH, int NW, int C, bool CARRIED, typename T, typename Test>
static void de_latched_on(const void* cr, const void* ci, void* esc, void* lzr, void* lzi,
                          void* ldr, void* ldi, long long ny, long long nx, int max_iter,
                          Test test, cudaStream_t stream) {
    on_footprint<PW, PH, NW>(ny, nx, [&](auto pw, auto ph, dim3 grid, long long gy,
                                         long long gx) {
        de_latched_kernel<T, decltype(pw)::value, decltype(ph)::value, NW, C, CARRIED>
            <<<grid, 32 * NW, 0, stream>>>((const T*)cr, (const T*)ci, (unsigned char*)esc,
                                           (T*)lzr, (T*)lzi, (T*)ldr, (T*)ldi, gy, gx, max_iter,
                                           test);
    });
}

// t: de_std's squared threshold (mandelbrot.radius_threshold), a value of
// the dtype
extern "C" int orbit_de_std_launch(const void* cr, const void* ci, void* esc, void* lzr,
                                   void* lzi, void* ldr, void* ldi, long long ny, long long nx,
                                   int max_iter, double t, int is_double, void* stream) {
    if (is_double)
        de_latched_on<ESC_PATCH_W, ESC_PATCH_H, WARPS, STD_C, STD_DZ_CARRIED_F64 != 0, double>(
            cr, ci, esc, lzr, lzi, ldr, ldi, ny, nx, max_iter, SquaredTest<double>{t},
            as_stream(stream));
    else
        de_latched_on<ESC_PATCH_W, ESC_PATCH_H, WARPS, STD_C, STD_DZ_CARRIED_F32 != 0, float>(
            cr, ci, esc, lzr, lzi, ldr, ldi, ny, nx, max_iter, SquaredTest<float>{(float)t},
            as_stream(stream));
    return last_error();
}

// radius: de_stage1's R; (t_lo, t_hi): its band in the dtype
// (mandelbrot.hypot_band, values of the dtype). hypot_calls: null, or an int
// on the card that a point adds one to each time it calls hypot (a check's
// count; nothing else reads it)
extern "C" int orbit_de_stage1_launch(const void* cr, const void* ci, void* esc, void* lzr,
                                      void* lzi, void* ldr, void* ldi, long long ny, long long nx,
                                      int max_iter, double radius, double t_lo, double t_hi,
                                      void* hypot_calls, int is_double, void* stream) {
    int* calls = (int*)hypot_calls;
    if (is_double)
        de_latched_on<S1_PATCH_W, S1_PATCH_H, S1_WARPS, S1_C, S1_DZ_CARRIED_F64 != 0, double>(
            cr, ci, esc, lzr, lzi, ldr, ldi, ny, nx, max_iter,
            HypotBand<double>{radius, t_lo, t_hi, calls}, as_stream(stream));
    else
        de_latched_on<S1_PATCH_W, S1_PATCH_H, S1_WARPS, S1_C, S1_DZ_CARRIED_F32 != 0, float>(
            cr, ci, esc, lzr, lzi, ldr, ldi, ny, nx, max_iter,
            HypotBand<float>{(float)radius, (float)t_lo, (float)t_hi, calls}, as_stream(stream));
    return last_error();
}

extern "C" int orbit_green_launch(const void* zr0, const void* zi0, const void* cr,
                                  const void* ci, void* zr, void* zi, void* esc, void* kk,
                                  void* lzr, void* lzi, long long n, int k0, int iters, double r2,
                                  int kmax, int is_double, void* stream) {
    if (is_double)
        green_kernel<double><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const double*)zr0, (const double*)zi0, (const double*)cr, (const double*)ci,
            (double*)zr, (double*)zi, (unsigned char*)esc, (int*)kk, (double*)lzr, (double*)lzi,
            n, k0, iters, r2, kmax);
    else
        green_kernel<float><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const float*)zr0, (const float*)zi0, (const float*)cr, (const float*)ci,
            (float*)zr, (float*)zi, (unsigned char*)esc, (int*)kk, (float*)lzr, (float*)lzi, n,
            k0, iters, (float)r2, kmax);
    return last_error();
}

// skip_interior: 1 where the caller's epilogue reads no last z of a point
// that does not escape (potential_kernel's contract)
template <typename T>
static void potential_on(const void* cr, const void* ci, void* esc, void* kk, void* lzr,
                         void* lzi, long long ny, long long nx, int max_iter, T r2,
                         int skip_interior, cudaStream_t stream) {
    on_footprint<ESC_PATCH_W, ESC_PATCH_H, POT_WARPS>(ny, nx, [&](auto pw, auto ph, dim3 grid,
                                                                  long long gy, long long gx) {
        potential_kernel<T, decltype(pw)::value, decltype(ph)::value>
            <<<grid, 32 * POT_WARPS, 0, stream>>>((const T*)cr, (const T*)ci, (unsigned char*)esc,
                                              (int*)kk, (T*)lzr, (T*)lzi, gy, gx, max_iter, r2,
                                              skip_interior);
    });
}

extern "C" int orbit_potential_launch(const void* cr, const void* ci, void* esc, void* kk,
                                      void* lzr, void* lzi, long long ny, long long nx,
                                      int max_iter, double r2, int skip_interior, int is_double,
                                      void* stream) {
    if (is_double)
        potential_on<double>(cr, ci, esc, kk, lzr, lzi, ny, nx, max_iter, r2, skip_interior,
                             as_stream(stream));
    else
        potential_on<float>(cr, ci, esc, kk, lzr, lzi, ny, nx, max_iter, (float)r2,
                            skip_interior, as_stream(stream));
    return last_error();
}
