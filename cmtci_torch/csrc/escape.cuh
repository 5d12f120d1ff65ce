// Shared device helpers of the escape-time kernels (tci_de.cu, dwell.cu,
// cloud_green.cu).
#pragma once

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
