// Shared device helpers of the escape-time kernels: interior_mask (all six
// of them), max_nan (tci_de.cu, de_std.cu, green_grid.cu), patch_pixel
// (dwell.cu, dwell_ms.cu, de_std.cu, tci_de.cu, green_grid.cu), dwell_chunked
// (dwell.cu's two entries and dwell_ms.cu), bare_step (cloud_green.cu,
// tci_de.cu, green_grid.cu).
#pragma once

#include <math.h>

// _interior_mask of cmtci/kernels/mandelbrot_pallas.py:148: c in the main
// cardioid or the period-2 bulb, each with a 1e-5 margin, evaluated in f32 in
// the reference's op order. Every literal is f32. 0.06249f is the f32 value of
// the reference's constant 0.0625 - 1e-5 (folded in double, then cast). The
// twin is mandelbrot_cuda._interior_mask_torch.
__device__ __forceinline__ bool interior_mask(float cr, float ci) {
    const float xm = cr - 0.25f;
    const float q = xm * xm + ci * ci;
    const bool in_cardioid = q * (q + xm) <= 0.25f * ci * ci - 1e-5f;
    const float xp = cr + 1.0f;
    const bool in_bulb = xp * xp + ci * ci <= 0.06249f;
    return in_cardioid || in_bulb;
}

// max that propagates NaN like jnp.maximum / torch.maximum (fmaxf(NaN, x)
// returns x, which would turn a NaN lane into a finite value).
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a) ? a : fmaxf(a, b);
}

// The pixel of the calling thread on the compact warp footprint of the dwell,
// K4, K1 and K5 kernels: a warp's 32 threads tile PATCH_W x PATCH_H pixels (so the
// dwells a warp waits for are neighbours'), a block is WARPS such patches
// side by side along x. With MIDDLE_OUT the rows of blocks are handed out
// middle of the grid first, then one below, one above, ... (blockIdx.y is the
// rank in that order). The launch's grid is
// ceil(nx / (WARPS * PATCH_W)) x ceil(ny / PATCH_H) blocks of 32 * WARPS.
template <int PATCH_W, int PATCH_H, int WARPS, bool MIDDLE_OUT>
__device__ __forceinline__ void patch_pixel(int& col, int& row) {
    static_assert(PATCH_W * PATCH_H == 32, "a warp's patch is 32 threads");
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    col = (blockIdx.x * WARPS + warp) * PATCH_W + lane % PATCH_W;
    int by = blockIdx.y;
    if constexpr (MIDDLE_OUT) {
        const int r = blockIdx.y;
        by = (int)(gridDim.y - 1) / 2 + ((r & 1) ? (r + 1) / 2 : -(r / 2));
    }
    row = by * PATCH_H + lane / PATCH_W;
}

// The dwell loop of K2's two entries (dwell.cu) and of K6's fine pass
// (dwell_ms.cu), kept here so the three cannot drift. The dwell of c is
// max_iter for an analytically interior c (and for max_iter <= 0);
// otherwise, for n = 0..max_iter-1, z <- (zr*zr - zi*zi + cr, 2*zr*zi + ci),
// the first n with !(|z_{n+1}|^2 <= 4) (NaN counts as an escape), else
// max_iter. The twin is mandelbrot_cuda._dwell_torch. The schedule, none of
// which enters the result:
//   * A branch-free body with a latch, as the Pallas kernel has it:
//     inside &= (|z|^2 <= 4). A pixel that has left goes on iterating
//     harmlessly to inf/NaN with its latch down. The exit test runs once
//     every C steps, so the compare and the branch leave the z chain. The
//     loop may overshoot max_iter by up to C - 1 steps; min(dwell, max_iter)
//     at the end undoes that exactly, because dwell is the count of leading
//     steps that stayed inside.
//   * No counter in the loop. The latch only falls, so the dwell is the
//     steps before the newest chunk plus the latches still up inside it,
//     added up once after the loop.
//   * The squares zr*zr and zi*zi are computed once a step and serve both the
//     escape test and the next step's update (the same products of the same
//     values, so the same bits): 4 mul, 4 add/sub and 1 compare a step.
//
// PERIODIC adds the Pallas kernel's optional Brent cycle check
// (mandelbrot_pallas.py:94-133): a checkpoint of z, and a z that is still
// inside and bitwise equal to it has entered a true f32 cycle. The latch
// only falls, so every step up to that z was inside, the checkpoint's too;
// the next state is a function of z alone (the squares are zr*zr and
// zi*zi), so the orbit repeats the cycle for ever, inside, and the plain
// loop would count up to max_iter: the dwell is max_iter, whatever step the
// check catches it on. Neither where the checkpoint moves nor how often it
// is compared enters the result, only the steps iterated:
//   * The checkpoint starts at (1e30, 0), which no z with |z|^2 <= 4 equals,
//     and moves to z only at a chunk end: at the first chunk end at or past
//     each power of two (C, then the first multiple of C at or past the next
//     power of two above the last move), so the gaps double, as in Brent's
//     method, and the step has no counter to test.
//   * The compare runs once a chunk, before the move, and catches a cycle of
//     period p at the first chunk end whose distance from the checkpoint is a
//     multiple of p. It is ANDed with the latch: a pixel that has left can
//     come back inside the radius on a later step of its chunk. (A compare in
//     every step, into a sticky flag, catches a cycle a few steps sooner and
//     lost all the same: PERF.md, K2p.)
//   * The loop also ends on a caught cycle, and the dwell is then max_iter.
template <int C, bool PERIODIC>
__device__ __forceinline__ int dwell_chunked(float cr, float ci, int max_iter) {
    int dwell = max_iter;
    if (!interior_mask(cr, ci) && max_iter > 0) {
        float zr = 0.0f, zi = 0.0f, zr2 = 0.0f, zi2 = 0.0f;
        float pr = 1e30f, pi = 0.0f;  // the checkpoint (PERIODIC only)
        unsigned next = 1u;           // it moves at the first chunk end >= next
        bool inside = true;
        bool cyc = false;
        bool up[C];  // the latch after each step of the newest chunk
        int n = 0;
        do {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float nzr = zr2 - zi2 + cr;
                const float nzi = 2.0f * zr * zi + ci;
                zr = nzr;
                zi = nzi;
                zr2 = nzr * nzr;
                zi2 = nzi * nzi;
                inside = inside && (zr2 + zi2 <= 4.0f);
                up[c] = inside;
            }
            n += C;
            if constexpr (PERIODIC) {
                cyc = inside && zr == pr && zi == pi;
                if ((unsigned)n >= next) {
                    pr = zr;
                    pi = zi;
                    next = 2u << (31 - __clz(n));  // the least power of two above n
                }
            }
        } while (inside && !cyc && n < max_iter);
        int in_chunk = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) in_chunk += up[c] ? 1 : 0;
        dwell = cyc ? max_iter : min(n - C + in_chunk, max_iter);
    }
    return dwell;
}

// One branch-free orbit step of the speculative chunks of K3
// (cloud_green.cu), of K1's first pass (tci_de.cu) and of K5's chunks
// (green_grid.cu), kept here so the three cannot drift: the z update from the
// carried squares, the new squares, and the sticky radius flag. zr2 and zi2
// carry zr*zr and zi*zi from one step's radius test into the next step's
// update (the same products of the same values as the step-by-step loops, so
// the same bits): 4 mul, 4 add/sub, 1 compare. The first step over the
// radius raises the flag whatever later steps overflow to; a NaN |z|^2 does
// not raise it, an inf one does.
__device__ __forceinline__ void bare_step(float& zr, float& zi, float& zr2, float& zi2,
                                          bool& hit, float cr, float ci, float r2) {
    const float nzr = zr2 - zi2 + cr;
    const float nzi = 2.0f * zr * zi + ci;
    zr = nzr;
    zi = nzi;
    zr2 = nzr * nzr;
    zi2 = nzi * nzi;
    hit = hit || (zr2 + zi2 > r2);
}
