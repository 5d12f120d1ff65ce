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
// paths share, so the kernel is bitwise its twin when its loop state is.
//
// Bitwise: every step runs in the twin's op order (z^2 + c as
// zr*zr - zi*zi + cr and zr*zi + zi*zr + ci, dz <- (2 z) dz + 1 before z) with
// -fmad=false, IEEE division and square root, and the radius tests the twin
// writes (|z|^2 > r^2; sqrt(|z|^2) > R; hypot(zr, zi) > R, CUDA's hypot being
// what torch's CUDA kernel calls). The threshold is rounded to the dtype as
// torch rounds a Python scalar. A thread leaves its loop where nothing it
// writes can change any more:
//   * dwell, de_std, de_stage1, green and potential latch their state at the
//     first escape and freeze the orbit; the thread leaves there (green
//     writes the zeroed z its twin carries on). green runs GREEN_CHUNK steps
//     between two branches and replays a chunk in which its point escaped,
//     and packs a block's running points into its first warps every
//     GREEN_EPOCH steps (green_kernel), so that its one launch over the
//     whole budget of the f64 equipotential runs its deepest points in full
//     warps, each step a dependent chain of three f64 instructions;
//   * de_tci reads the FINAL dz, which runs on after the escape to inf and
//     NaN: the thread runs every step but leaves once the point has escaped
//     and both parts of dz are NaN, a fixed point of the dz update.
//
// What bounds it on this card: the FP64 (or FP32) instruction rate; no point
// reads another, the bytes are a few loads and stores a point. The steps are
// data dependent: a warp runs as long as its slowest point.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 256;
// the Green loop's steps between two branches on its escape test, and
// between two repacks of a block's running points
constexpr int GREEN_CHUNK = 64;
constexpr int GREEN_EPOCH = 512;

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

template <typename T>
__global__ void __launch_bounds__(BLOCK)
dwell_kernel(const T* __restrict__ cr, const T* __restrict__ ci, int* __restrict__ dwell,
             long long n, int max_iter) {
    const long long p = point_index();
    if (p >= n) return;
    const T c_r = cr[p], c_i = ci[p];
    T zr = T(0), zi = T(0);
    int d = max_iter;
    for (int k = 0; k < max_iter; ++k) {
        zsq_add_c(zr, zi, c_r, c_i);
        if (zr * zr + zi * zi > T(4)) {
            d = k;
            break;
        }
    }
    dwell[p] = d;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
de_tci_kernel(const T* __restrict__ cr, const T* __restrict__ ci, unsigned char* __restrict__ esc,
              T* __restrict__ lr, T* __restrict__ li, T* __restrict__ dr, T* __restrict__ di,
              long long n, int max_iter, T radius) {
    const long long p = point_index();
    if (p >= n) return;
    const T c_r = cr[p], c_i = ci[p];
    T zr = T(0), zi = T(0), dzr = T(1), dzi = T(0), l_r = T(0), l_i = T(0);
    bool e = false;
    for (int k = 0; k < max_iter; ++k) {
        dz_step(zr, zi, dzr, dzi);
        zsq_add_c(zr, zi, c_r, c_i);
        if (!e && sqrt(zr * zr + zi * zi) > radius) {
            l_r = zr;
            l_i = zi;
            e = true;
        }
        if (e && isnan(dzr) && isnan(dzi)) break;
    }
    esc[p] = e;
    lr[p] = l_r;
    li[p] = l_i;
    dr[p] = dzr;
    di[p] = dzi;
}

// de_field_std (RADIUS_BY_HYPOT false: sqrt(|z|^2) > R) and de_field_stage1
// (true: hypot(zr, zi) > R): z and dz latched at the first escape
template <typename T, bool RADIUS_BY_HYPOT>
__global__ void __launch_bounds__(BLOCK)
de_latched_kernel(const T* __restrict__ cr, const T* __restrict__ ci,
                  unsigned char* __restrict__ esc, T* __restrict__ lzr, T* __restrict__ lzi,
                  T* __restrict__ ldr, T* __restrict__ ldi, long long n, int max_iter, T radius) {
    const long long p = point_index();
    if (p >= n) return;
    const T c_r = cr[p], c_i = ci[p];
    T zr = T(0), zi = T(0), dzr = T(1), dzi = T(0);
    T l_zr = T(0), l_zi = T(0), l_dr = T(1), l_di = T(0);
    bool e = false;
    for (int k = 0; k < max_iter; ++k) {
        dz_step(zr, zi, dzr, dzi);
        zsq_add_c(zr, zi, c_r, c_i);
        const T r = RADIUS_BY_HYPOT ? hypot(zr, zi) : sqrt(zr * zr + zi * zi);
        if (r > radius) {
            l_zr = zr;
            l_zi = zi;
            l_dr = dzr;
            l_di = dzi;
            e = true;
            break;
        }
    }
    esc[p] = e;
    lzr[p] = l_zr;
    lzi[p] = l_zi;
    ldr[p] = l_dr;
    ldi[p] = l_di;
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

// escape_potential_grid's loop: k the 0-based step of the first |z|^2 > r2,
// lz the z there, or the last z of a point that never escapes
template <typename T>
__global__ void __launch_bounds__(BLOCK)
potential_kernel(const T* __restrict__ cr, const T* __restrict__ ci,
                 unsigned char* __restrict__ esc, int* __restrict__ kk, T* __restrict__ lzr,
                 T* __restrict__ lzi, long long n, int max_iter, T r2) {
    const long long p = point_index();
    if (p >= n) return;
    const T c_r = cr[p], c_i = ci[p];
    T zr = T(0), zi = T(0);
    int k = 0;
    bool e = false;
    for (int i = 0; i < max_iter; ++i) {
        zsq_add_c(zr, zi, c_r, c_i);
        if (zr * zr + zi * zi > r2) {
            k = i;
            e = true;
            break;
        }
    }
    esc[p] = e;
    kk[p] = k;
    lzr[p] = zr;
    lzi[p] = zi;
}

inline dim3 grid_of(long long n) { return dim3((unsigned)((n + BLOCK - 1) / BLOCK)); }
inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }
inline int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each entry launches on `stream` (PyTorch's current stream) over n points in
// contiguous buffers of the dtype (is_double 1: f64, 0: f32); escape flags
// are bytes 0/1 (torch.bool), steps int32. A threshold arrives as a double
// and is rounded to the dtype. Returns cudaGetLastError() as an int; the
// caller raises when it is not 0. Allocates nothing and does not synchronize.

extern "C" int orbit_dwell_launch(const void* cr, const void* ci, void* dwell, long long n,
                                  int max_iter, int is_double, void* stream) {
    if (is_double)
        dwell_kernel<double><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const double*)cr, (const double*)ci, (int*)dwell, n, max_iter);
    else
        dwell_kernel<float><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const float*)cr, (const float*)ci, (int*)dwell, n, max_iter);
    return last_error();
}

extern "C" int orbit_de_tci_launch(const void* cr, const void* ci, void* esc, void* lr, void* li,
                                   void* dr, void* di, long long n, int max_iter, double radius,
                                   int is_double, void* stream) {
    if (is_double)
        de_tci_kernel<double><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const double*)cr, (const double*)ci, (unsigned char*)esc, (double*)lr, (double*)li,
            (double*)dr, (double*)di, n, max_iter, radius);
    else
        de_tci_kernel<float><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const float*)cr, (const float*)ci, (unsigned char*)esc, (float*)lr, (float*)li,
            (float*)dr, (float*)di, n, max_iter, (float)radius);
    return last_error();
}

template <bool RADIUS_BY_HYPOT>
static int de_latched(const void* cr, const void* ci, void* esc, void* lzr, void* lzi, void* ldr,
                      void* ldi, long long n, int max_iter, double radius, int is_double,
                      void* stream) {
    if (is_double)
        de_latched_kernel<double, RADIUS_BY_HYPOT><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const double*)cr, (const double*)ci, (unsigned char*)esc, (double*)lzr,
            (double*)lzi, (double*)ldr, (double*)ldi, n, max_iter, radius);
    else
        de_latched_kernel<float, RADIUS_BY_HYPOT><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const float*)cr, (const float*)ci, (unsigned char*)esc, (float*)lzr, (float*)lzi,
            (float*)ldr, (float*)ldi, n, max_iter, (float)radius);
    return last_error();
}

extern "C" int orbit_de_std_launch(const void* cr, const void* ci, void* esc, void* lzr,
                                   void* lzi, void* ldr, void* ldi, long long n, int max_iter,
                                   double escape_r, int is_double, void* stream) {
    return de_latched<false>(cr, ci, esc, lzr, lzi, ldr, ldi, n, max_iter, escape_r, is_double,
                             stream);
}

extern "C" int orbit_de_stage1_launch(const void* cr, const void* ci, void* esc, void* lzr,
                                      void* lzi, void* ldr, void* ldi, long long n, int max_iter,
                                      double bailout, int is_double, void* stream) {
    return de_latched<true>(cr, ci, esc, lzr, lzi, ldr, ldi, n, max_iter, bailout, is_double,
                            stream);
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

extern "C" int orbit_potential_launch(const void* cr, const void* ci, void* esc, void* kk,
                                      void* lzr, void* lzi, long long n, int max_iter, double r2,
                                      int is_double, void* stream) {
    if (is_double)
        potential_kernel<double><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const double*)cr, (const double*)ci, (unsigned char*)esc, (int*)kk, (double*)lzr,
            (double*)lzi, n, max_iter, r2);
    else
        potential_kernel<float><<<grid_of(n), BLOCK, 0, as_stream(stream)>>>(
            (const float*)cr, (const float*)ci, (unsigned char*)esc, (int*)kk, (float*)lzr,
            (float*)lzi, n, max_iter, (float)r2);
    return last_error();
}
