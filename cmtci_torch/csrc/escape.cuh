// Shared device helpers of the escape-time kernels (tci_de.cu, dwell.cu,
// dwell_ms.cu, de_std.cu, green_grid.cu, cloud_green.cu).
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

// The dwell loop of K6's fine pass (dwell_ms.cu) and of K2's periodic entry
// (dwell.cu), one pixel a thread with an exit test in every step, kept here
// so the two cannot drift; K2's plain kernel (dwell.cu) computes the same
// count on its own schedule. It is max_iter for an analytically interior c
// (the loop is skipped); otherwise, for n = 0..max_iter-1,
// z <- (zr*zr - zi*zi + cr, 2*zr*zi + ci), stop if !(|z|^2 <= 4) (NaN counts
// as an escape), else dwell += 1. The twin is mandelbrot_cuda._dwell_torch.
//
// PERIODIC adds the Pallas kernel's optional Brent cycle check
// (mandelbrot_pallas.py:94-133): the thread keeps a checkpoint of z, moved to
// the current z when the number of steps taken is a power of two, and a z
// that is still inside and bitwise equal to the checkpoint has entered a
// true f32 cycle: the orbit can never escape, so the thread stops with
// max_iter. The result is the plain loop's for every c (a lane in a cycle
// would have counted up to max_iter); only the steps iterated differ. The
// Pallas kernel moves its checkpoint at chunk ends (a tile iterates in chunks
// of 32); the schedule does not enter the result. The checkpoint starts at
// (1e30, 0), which no z with |z|^2 <= 4 equals.
template <bool PERIODIC>
__device__ __forceinline__ int dwell_count(float cr, float ci, int max_iter) {
    int dwell = max_iter;
    if (!interior_mask(cr, ci)) {
        float zr = 0.0f, zi = 0.0f;
        float pr = 1e30f, pi = 0.0f;
        unsigned next = 1u;
        dwell = 0;
        for (int n = 0; n < max_iter; ++n) {
            const float nzr = zr * zr - zi * zi + cr;
            const float nzi = 2.0f * zr * zi + ci;
            zr = nzr;
            zi = nzi;
            if (!(zr * zr + zi * zi <= 4.0f)) break;
            ++dwell;
            if constexpr (PERIODIC) {
                if (zr == pr && zi == pi) {
                    dwell = max_iter;
                    break;
                }
                if ((unsigned)(n + 1) == next) {
                    pr = zr;
                    pi = zi;
                    next <<= 1;
                }
            }
        }
    }
    return dwell;
}

// One branch-free orbit step of the speculative chunks of K3
// (cloud_green.cu) and of K1's first pass (tci_de.cu), kept here so the two
// cannot drift: the z update from the carried squares, the new squares, and
// the sticky radius flag. zr2 and zi2 carry zr*zr and zi*zi from one step's
// radius test into the next step's update (the same products of the same
// values as the step-by-step loops, so the same bits): 4 mul, 4 add/sub, 1
// compare. The first step over the radius raises the flag whatever later
// steps overflow to; a NaN |z|^2 does not raise it, an inf one does.
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
