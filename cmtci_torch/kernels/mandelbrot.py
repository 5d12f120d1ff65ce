"""Mandelbrot dwell grid, Green potential, the TCI and standard
distance-estimator fields, the grid escape potentials, the 5-point smoother
and the boundary-band and threshold samplers.

Port of the tracker, boundary, equipotential, TCI, variogram and stage-1
subset of ``cmtci/kernels/mandelbrot.py``; ``de_field_std`` and
``escape_potential_grid`` are the f64 contracts of the K4 and K5 kernels. Complex values are (re, im) tensor pairs,
and the op order is the reference's (``de_field_tci``: dz is updated BEFORE
z each step, z is latched at the first |z| > escape_r, dz is not latched and
overflows to inf for early escapers, so d == 0 there).

The per-point loops (the reference's ``fori_loop``s) are split into the loop
state and an epilogue in torch that both paths share. On CUDA tensors the
loop is one launch of a ``csrc/orbit.cu`` entry (``_green_stage``: one a
stage); on CPU tensors it is the plain twin, the eager loop of the
``*_loop_torch`` functions, which the ``*_torch`` functions run on any
device. The kernel's loop state is bitwise the twin's (``de_field_tci``'s
and ``escape_potential_grid``'s under the contracts ``_de_tci_loop_cuda``
and ``_potential_loop_cuda`` state, which keep their outputs bitwise).
Nothing falls back.

Grids are built from ``np.linspace`` — the oracle's grid. ``jnp.linspace``
and ``torch.linspace`` each differ from it in the last ulp, and a grid node
that moves by an ulp can flip a borderline escape.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from cmtci_torch.kernels._launch import launch as _launch
from cmtci_torch.utils.artifacts import fetch
from cmtci_torch.utils.device import resolve_device


def complex_grid(domain, nx: int, ny: int, dtype=torch.float64, device="cuda"):
    """(cr, ci) meshgrid matching np.meshgrid(xs, ys) indexing='xy', shape
    (ny, nx), with np.linspace nodes cast to `dtype` on `device`."""
    dev = resolve_device(device)
    xmin, xmax, ymin, ymax = domain
    xs = torch.as_tensor(np.linspace(xmin, xmax, nx), dtype=dtype, device=dev)
    ys = torch.as_tensor(np.linspace(ymin, ymax, ny), dtype=dtype, device=dev)
    cr, ci = torch.meshgrid(xs, ys, indexing="xy")
    return cr.contiguous(), ci.contiguous()


def _zsq_add_c(zr, zi, cr, ci):
    """z <- z*z + c, componentwise like numpy's complex multiply."""
    return zr * zr - zi * zi + cr, zr * zi + zi * zr + ci


def _orbit(entry: str, ins, outs, *scalars, grid: bool = False):
    """Launch csrc/orbit.cu's `entry` over the points of `ins` (CUDA tensors of
    one shape, f32 or f64) into `outs` (fresh tensors of that shape); the
    scalars follow the point count (with `grid`, the (ny, nx) of
    _grid_shape), then the dtype flag. Returns outs."""
    first = ins[0]
    if first.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{entry}: the kernel takes float32 or float64, got {first.dtype}")
    for t in ins[1:]:
        if t.device != first.device or t.dtype != first.dtype or t.shape != first.shape:
            raise ValueError(f"{entry}: inputs differ in device, dtype or shape: "
                             f"{[(str(a.device), a.dtype, tuple(a.shape)) for a in ins]}")
    ins = [t.contiguous() for t in ins]
    n = first.numel()
    if n:
        size = _grid_shape(first) if grid else (n,)
        _launch(entry, first.device, *(t.data_ptr() for t in ins),
                *(t.data_ptr() for t in outs), *size, *scalars,
                int(first.dtype == torch.float64))
    return outs


def _grid_shape(t) -> tuple:
    """(ny, nx) of t's points laid out row-major as a grid: its last dim
    across, the others down; a 0-D or 1-D tensor is one row."""
    if t.dim() < 2:
        return 1, t.numel()
    nx = t.shape[-1]
    return (t.numel() // nx if nx else 0), nx


def _loop(twin, kernel, *args):
    """twin(*args) when the first argument, a tensor, lies on the CPU;
    kernel(*args) when it lies on a CUDA device; raise otherwise."""
    dev = args[0].device
    if dev.type == "cpu":
        return twin(*args)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return kernel(*args)


def _out(like, dtype=None):
    """A contiguous buffer of like's shape on its device (the kernel's output)."""
    return torch.empty(like.shape, dtype=dtype or like.dtype, device=like.device)


def dwell_grid_torch(cr, ci, max_iter: int = 500) -> torch.Tensor:
    """Plain twin of dwell_grid: the eager loop, on the tensors' device."""
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    dwell = torch.full(cr.shape, max_iter, dtype=torch.int32, device=cr.device)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    for n in range(max_iter):
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = (zr * zr + zi * zi > 4.0) & ~esc
        dwell.masked_fill_(hit, n)
        esc = esc | hit
        # where(esc, where(hit, z, 0), z): escaped before this step -> 0
        old = esc & ~hit
        zr = torch.where(old, 0.0, zr)
        zi = torch.where(old, 0.0, zi)
    return dwell


def _dwell_cuda(cr, ci, max_iter: int):
    """orbit_dwell: bitwise dwell_grid_torch. In f64 the analytic interior
    (the reference's cardioid and bulb tests with their 1e-5 margins, in
    f64) writes max_iter without a step: such an orbit never escapes in f64
    (the argument is in orbit.cu)."""
    return _orbit("orbit_dwell", (cr, ci), (_out(cr, torch.int32),), int(max_iter),
                  grid=True)[0]


def dwell_grid(cr, ci, max_iter: int = 500) -> torch.Tensor:
    """Escape-time dwell counts (mandelbrot_boundary_sample.py:22-30) on the
    tensors' device and dtype: int32, the first n (0-based) with
    |z_{n+1}|^2 > 4, else max_iter. Escaped orbits are frozen, as in the
    reference. CUDA: orbit.cu's orbit_dwell; CPU: dwell_grid_torch."""
    return _loop(dwell_grid_torch, _dwell_cuda, cr, ci, max_iter)


def _green_loop_torch(zr, zi, cr, ci, k0: int, iters: int, r2: float, dtype_max_iter: int):
    """The Green stage's eager loop: (zr, zi, esc, k, lzr, lzi), z latched at
    the first |z|^2 > r2 (k = k0 + its 1-based step) and zeroed after it."""
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    kk = torch.full(cr.shape, dtype_max_iter, dtype=torch.int32, device=cr.device)
    lzr = torch.zeros_like(cr)
    lzi = torch.zeros_like(ci)
    for i in range(iters):
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = ~esc & (zr * zr + zi * zi > r2)
        kk.masked_fill_(hit, k0 + i + 1)
        lzr = torch.where(hit, zr, lzr)
        lzi = torch.where(hit, zi, lzi)
        esc = esc | hit
        zr = torch.where(esc, 0.0, zr)
        zi = torch.where(esc, 0.0, zi)
    return zr, zi, esc, kk, lzr, lzi


def _green_loop_cuda(zr, zi, cr, ci, k0: int, iters: int, r2: float, dtype_max_iter: int):
    outs = (_out(cr), _out(cr), _out(cr, torch.bool), _out(cr, torch.int32), _out(cr),
            _out(cr))
    return _orbit("orbit_green", (zr, zi, cr, ci), outs, int(k0), int(iters), float(r2),
                  int(dtype_max_iter))


def _green_epilogue(zr, zi, esc, kk, lzr, lzi):
    scale = torch.exp2(-kk.to(lzr.dtype))
    logr = 0.5 * torch.log(torch.clamp(lzr * lzr + lzi * lzi, min=1e-300))
    gg = logr * scale
    gg = torch.where(torch.isfinite(gg) & (gg >= 0.0), gg, 0.0)
    g = torch.where(esc, gg, 0.0)
    lpr = torch.where(esc, logr * scale, 0.0)
    lpi = torch.where(esc, torch.atan2(lzi, lzr) * scale, 0.0)
    return zr, zi, esc, g, kk, lpr, lpi


def _green_stage_torch(zr, zi, cr, ci, k0: int, iters: int, r2: float, dtype_max_iter: int):
    """Plain twin of _green_stage: the eager loop, on the tensors' device."""
    return _green_epilogue(*_green_loop_torch(zr, zi, cr, ci, k0, iters, r2, dtype_max_iter))


def _green_stage(zr, zi, cr, ci, k0: int, iters: int, r2: float, dtype_max_iter: int):
    """Run `iters` Green iterations from state (zr, zi) with k offset k0, on
    the tensors' device and dtype (the reference's ``_green_stage``; CUDA:
    one launch of orbit.cu's orbit_green; CPU: the eager twin).

    Returns (zr, zi, esc, g, k, lpr, lpi); points that do not escape in this
    stage carry k = dtype_max_iter and g = lpr = lpi = 0. The loop latches z
    at the first |z|^2 > r2; g = max(log|z_k| 2^-k, 0) and log phi =
    (log|z_k|, arg z_k)·2^-k are then evaluated once per point from the
    latched z, with the same elementwise ops the reference runs at the hit.
    """
    return _green_epilogue(*_loop(_green_loop_torch, _green_loop_cuda, zr, zi, cr, ci, k0,
                                  iters, r2, dtype_max_iter))


def green_potential_compacted(points, max_iter: int = 20000, escape_r: float = 2.0,
                              stage_iters: int = 512, device="cuda", stage_executor=None):
    """Parameter-plane Green function g_M(c) and Phi(c)
    (lucas_equipotential_test_v3.py:124-162) for a complex cloud in f64 on
    `device`, with compaction of the survivors between stages (the
    reference's ``green_potential_compacted``): at first escape k (1-based),
    log_phi = log(z)·2^-k, g = Re log_phi clamped to >= 0, phi =
    exp(log_phi); else (0, max_iter, nan).

    After each `stage_iters` chunk the escaped points' records go to the
    host and the rest are compacted, so the deep interior no longer drags
    every escaped point along. No power-of-two padding: that only let the
    reference's stages share XLA compiles. `stage_executor` (default
    ``_green_stage``) runs each stage with _green_stage's arguments and
    results: ``parallel.sharded.green_stage_executor`` shards the stage's
    points over a mesh. With stage_iters >= max_iter there is one stage: on
    a card one orbit_green launch over every point (a thread leaves the
    kernel when its point escapes), read by the host once; z is carried
    exactly across stages, so the records are bitwise those of any other
    stage_iters. Returns (g, k, phi) numpy arrays.
    """
    dev = resolve_device(device)
    if stage_iters < 1:
        raise ValueError(f"stage_iters must be >= 1, got {stage_iters}")
    f64 = torch.float64
    pts = np.asarray(points, dtype=complex).ravel()
    n = len(pts)
    g = np.zeros(n)
    kk = np.full(n, max_iter, dtype=np.int32)
    phi = np.full(n, np.nan + 1j * np.nan, dtype=complex)
    idx = np.arange(n)
    cr = torch.as_tensor(pts.real.copy(), dtype=f64, device=dev)
    ci = torch.as_tensor(pts.imag.copy(), dtype=f64, device=dev)
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    r2 = escape_r * escape_r
    k0 = 0
    while k0 < max_iter and len(idx):
        iters = min(stage_iters, max_iter - k0)
        zr, zi, esc, gs, ks, lpr, lpi = (stage_executor or _green_stage)(
            zr, zi, cr, ci, k0, iters, r2, max_iter)
        esc_h = esc.cpu().numpy()
        if esc_h.any():
            rec = torch.stack([gs[esc], ks[esc].to(f64), lpr[esc], lpi[esc]]).cpu().numpy()
            hit_idx = idx[esc_h]
            g[hit_idx] = rec[0]
            kk[hit_idx] = rec[1].astype(np.int32)
            phi[hit_idx] = np.exp(rec[2]) * np.exp(1j * rec[3])
            keep = ~esc
            idx = idx[~esc_h]
            zr, zi, cr, ci = zr[keep], zi[keep], cr[keep], ci[keep]
        k0 += iters
    return g, kk, phi


def _de_tci_loop_torch(cr, ci, max_iter: int, escape_r: float):
    """de_field_tci's eager loop: (esc, lr, li, dzr, dzi), z latched at the
    first |z| > escape_r, the FINAL dz."""
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    dzr = torch.ones_like(cr)
    dzi = torch.zeros_like(ci)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    lr = torch.zeros_like(cr)
    li = torch.zeros_like(ci)
    for _ in range(max_iter):
        # dz = 2*z*dz + 1 (numpy op order: t = 2*z, then t*dz, then +1)
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = (torch.sqrt(zr * zr + zi * zi) > escape_r) & ~esc
        lr = torch.where(hit, zr, lr)
        li = torch.where(hit, zi, li)
        esc = esc | hit
    return esc, lr, li, dzr, dzi


@functools.lru_cache(maxsize=None)
def radius_threshold(escape_r: float, double: bool) -> float:
    """The squared threshold t of the radius test sqrt(s) > escape_r in the
    dtype (f64 if `double`, else f32, escape_r rounded to it as torch rounds
    a Python scalar): the largest value of the dtype whose correctly
    rounded square root is <= escape_r, so that for every s of the dtype,
    NaN and inf included, sqrt(s) > escape_r exactly when s > t (sqrt is
    correctly rounded, hence monotone). +inf when no s passes (escape_r
    NaN or +inf), -inf when every s but NaN does (escape_r < 0). Found by
    bisection over the bit patterns of [0, inf]."""
    ft, it = (np.float64, np.uint64) if double else (np.float32, np.uint32)
    with np.errstate(over="ignore"):
        r = ft(escape_r)  # a radius past the dtype's range rounds to inf
    if np.isnan(r) or r == np.inf:
        return float("inf")
    if r < 0:
        return float("-inf")

    def value(bits: int):
        return np.array([bits], dtype=it).view(ft)[0]

    lo, hi = 0, int(np.array([np.inf], dtype=ft).view(it)[0])  # sqrt(0) <= r < sqrt(inf)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if np.sqrt(value(mid)) <= r:
            lo = mid
        else:
            hi = mid
    return float(value(lo))


#: orbit.cu's band around R^2 for de_stage1's hypot(zr, zi) > R, by dtype (f64
#: if True): the half-width d and the smallest and largest R it holds for
HYPOT_BAND = {True: (2.0**-30, 2.0**-400, 2.0**400), False: (2.0**-12, 2.0**-40, 2.0**40)}


def _rounded_out(x: Fraction, ft, down: bool) -> float:
    """A value of the dtype ft on the outer side of the exact x: the nearest
    one at or below it (down), or at or above it."""
    v = ft(float(x))
    step = ft(-np.inf if down else np.inf)
    while (Fraction(float(v)) > x) if down else (Fraction(float(v)) < x):
        v = np.nextafter(v, step)
    return float(v)


@functools.lru_cache(maxsize=None)
def hypot_band(bailout: float, double: bool) -> tuple:
    """(t_lo, t_hi), values of the dtype (f64 if `double`, else f32, the
    radius rounded to it as torch rounds a Python scalar) around R^2, such
    that for the s = zr*zr + zi*zi of any dtype values zr, zi (rounded as
    computed) s > t_hi implies hypot(zr, zi) > R and s < t_lo implies that
    it does not (orbit.cu states the argument): t_hi at or above R^2 (1 + d),
    t_lo at or below R^2 (1 - d), d from HYPOT_BAND. (-inf, +inf) for an R
    outside HYPOT_BAND's range, NaN, infinite, zero or negative: every step
    then takes hypot."""
    ft = np.float64 if double else np.float32
    with np.errstate(over="ignore"):
        r = ft(bailout)  # a radius past the dtype's range rounds to inf
    d, smallest, largest = HYPOT_BAND[double]
    if not smallest <= r <= largest:
        return float("-inf"), float("inf")
    r2 = Fraction(float(r)) ** 2
    return (_rounded_out(r2 * (1 - Fraction(d)), ft, True),
            _rounded_out(r2 * (1 + Fraction(d)), ft, False))


def _count_arg(count, cr, name: str):
    """The pointer of a check's counter: None, or an int32 tensor of one
    element on cr's device."""
    if count is None:
        return None
    if count.dtype != torch.int32 or count.device != cr.device or count.numel() < 1:
        raise ValueError(f"{name}: an int32 tensor of one element on {cr.device}, got "
                         f"{count.dtype} on {count.device} with {count.numel()} elements")
    return count.data_ptr()


def _de_tci_loop_cuda(cr, ci, max_iter: int, escape_r: float, second_passes=None):
    """orbit_de_tci's loop state (esc, lr, li, dzr, dzi). Its contract
    (argued in orbit.cu): esc, lr and li are _de_tci_loop_torch's bits; at
    an escaper whose twin's final dz is finite in both parts, dz is the
    twin's bits; every other point has dz = (NaN, NaN) (points that do not
    escape, f64 points of the analytic interior, which take no step, and
    escapers whose z overflowed before step max_iter - 1), except that for
    escape_r < 2 every escaper gets the twin's final dz, finite or not.
    _de_tci_epilogue gives the twin's (esc, d, last_r, last_i) from either
    state: d reads dz only through den, which a non-finite dz makes +inf or
    NaN, so d is +0.0 both ways; a point that does not escape has d = 0.
    second_passes (a check's): None, or an int32 tensor of one element on the
    card, to which each point that runs the second pass adds one."""
    outs = (_out(cr, torch.bool), _out(cr), _out(cr), _out(cr), _out(cr))
    t = radius_threshold(float(escape_r), cr.dtype == torch.float64)
    count = _count_arg(second_passes, cr, "second_passes")
    return _orbit("orbit_de_tci", (cr, ci), outs, int(max_iter), t, count, grid=True)


def _de_tci_contract(state, escape_r: float):
    """The loop state _de_tci_loop_cuda gives under its contract, from the
    twin's loop state `state` (_de_tci_loop_torch's): the twin's dz kept at
    the escapers where it is finite in both parts (for escape_r < 2 in the
    dtype, at every escaper), (NaN, NaN) everywhere else."""
    esc, lr, li, dzr, dzi = state
    keep = esc
    if radius_threshold(float(escape_r), lr.dtype == torch.float64) >= 4.0:
        keep = esc & torch.isfinite(dzr) & torch.isfinite(dzi)
    nan = torch.full_like(dzr, float("nan"))
    return esc, lr, li, torch.where(keep, dzr, nan), torch.where(keep, dzi, nan)


def _de_tci_epilogue(esc, lr, li, dzr, dzi, eps: float):
    az = torch.hypot(lr, li)
    # 2*z*dz with the latched z and FINAL dz (possibly inf/nan); hypot as
    # numpy's complex abs (no premature overflow)
    pr, pi = 2.0 * lr * dzr - 2.0 * li * dzi, 2.0 * lr * dzi + 2.0 * li * dzr
    # torch.maximum propagates NaN, like jnp.maximum
    den = torch.maximum(torch.hypot(pr, pi), pr.new_tensor(eps))
    d = torch.where(esc, torch.log(torch.maximum(az, az.new_tensor(1e-300))) * az / den,
                    torch.zeros_like(az))
    d = torch.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)
    return esc, d, lr, li


def de_field_tci_torch(cr, ci, max_iter: int = 250, escape_r: float = 250.0,
                       eps: float = 1e-12):
    """Plain twin of de_field_tci: the eager loop, on the tensors' device."""
    return _de_tci_epilogue(*_de_tci_loop_torch(cr, ci, max_iter, escape_r), eps)


def de_field_tci(cr, ci, max_iter: int = 250, escape_r: float = 250.0,
                 eps: float = 1e-12):
    """TCI distance estimator (tci_construct_mandelbrot_v002_fixed.py:35-47)
    on the tensors' device and dtype (CUDA: orbit.cu's orbit_de_tci; CPU:
    the eager twin). Returns (esc, d, last_r, last_i)."""
    return _de_tci_epilogue(*_loop(_de_tci_loop_torch, _de_tci_loop_cuda, cr, ci, max_iter,
                                   escape_r), eps)


def _de_latched_loop_torch(cr, ci, max_iter: int, radius: float, by_hypot: bool):
    """The eager loop of de_field_std (|z| as sqrt of the squares) and
    de_field_stage1 (by_hypot: torch.hypot): (esc, lzr, lzi, ldr, ldi), z and
    dz latched at the first |z| > radius, then the orbit frozen."""
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    dzr = torch.ones_like(cr)
    dzi = torch.zeros_like(ci)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    lzr, lzi = torch.zeros_like(cr), torch.zeros_like(ci)
    ldr, ldi = torch.ones_like(cr), torch.zeros_like(ci)
    for _ in range(max_iter):
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        r = torch.hypot(zr, zi) if by_hypot else torch.sqrt(zr * zr + zi * zi)
        hit = ~esc & (r > radius)
        lzr = torch.where(hit, zr, lzr)
        lzi = torch.where(hit, zi, lzi)
        ldr = torch.where(hit, dzr, ldr)
        ldi = torch.where(hit, dzi, ldi)
        esc = esc | hit
        zr = torch.where(esc, 0.0, zr)
        zi = torch.where(esc, 0.0, zi)
        dzr = torch.where(esc, 1.0, dzr)
        dzi = torch.where(esc, 0.0, dzi)
    return esc, lzr, lzi, ldr, ldi


def _de_latched_loop_cuda(cr, ci, max_iter: int, radius: float, by_hypot: bool,
                          hypot_calls=None):
    """orbit_de_stage1 (by_hypot) or orbit_de_std: bitwise
    _de_latched_loop_torch, on the (ny, nx) of the grid. orbit_de_std takes
    the squared threshold radius_threshold(radius) and skips the f64
    analytic interior for a threshold >= 4; orbit_de_stage1 takes the radius
    and its band hypot_band(radius), calls hypot only for an |z|^2 inside
    the band or NaN, and skips the f64 interior for R >= 2 (the arguments
    are in orbit.cu). hypot_calls (a check's): None, or an int32 tensor of
    one element on the card, to which orbit_de_stage1 adds one at each call
    of hypot."""
    outs = (_out(cr, torch.bool), _out(cr), _out(cr), _out(cr), _out(cr))
    double = cr.dtype == torch.float64
    if by_hypot:
        return _orbit("orbit_de_stage1", (cr, ci), outs, int(max_iter), float(radius),
                      *hypot_band(float(radius), double),
                      _count_arg(hypot_calls, cr, "hypot_calls"), grid=True)
    t = radius_threshold(float(radius), double)
    return _orbit("orbit_de_std", (cr, ci), outs, int(max_iter), t, grid=True)


def _de_std_epilogue(esc, lzr, lzi, ldr, ldi, eps: float):
    az = torch.hypot(lzr, lzi)
    pr, pi = 2.0 * (lzr * ldr - lzi * ldi), 2.0 * (lzr * ldi + lzi * ldr)
    num = torch.log(torch.maximum(az, az.new_tensor(1.0))) * az
    den = torch.maximum(torch.hypot(pr, pi), pr.new_tensor(eps))
    dist = torch.where(esc, torch.nan_to_num(num / den, nan=0.0, posinf=0.0, neginf=0.0),
                       torch.zeros_like(az))
    return esc, dist, (lzr, lzi), (ldr, ldi)


def de_field_std_torch(cr, ci, max_iter: int = 500, escape_r: float = 4.0,
                       eps: float = 1e-14):
    """Plain twin of de_field_std: the eager loop, on the tensors' device."""
    return _de_std_epilogue(*_de_latched_loop_torch(cr, ci, max_iter, escape_r, False), eps)


def de_field_std(cr, ci, max_iter: int = 500, escape_r: float = 4.0, eps: float = 1e-14):
    """Standard distance estimator (variograms_construct_mandelbrot.py:61-88)
    on the tensors' device and dtype (CUDA: orbit.cu's orbit_de_std; CPU: the
    eager twin): z and dz are latched at the first |z| > escape_r, then the
    orbit is frozen; num = log(max(|z|, 1))·|z|, den = max(|2 z dz|, eps),
    non-finite d -> 0. Returns (esc, dist, (lzr, lzi), (ldr, ldi)) like the
    reference."""
    return _de_std_epilogue(*_loop(_de_latched_loop_torch, _de_latched_loop_cuda, cr, ci,
                                   max_iter, escape_r, False), eps)


def green_potential(cr, ci, max_iter: int = 20000, escape_r: float = 2.0):
    """Parameter-plane Green function g_M(c) and Phi(c)
    (lucas_equipotential_test_v3.py:124-162) on the tensors' device and
    dtype: one ``_green_stage`` over the whole iteration budget. At first
    escape k (1-based) log_phi = log(z)·2^-k, g = Re log_phi clamped to
    >= 0, phi = exp(log_phi); else (0, max_iter, nan). Returns (g, k,
    phi_r, phi_i)."""
    _, _, esc, g, kk, lpr, lpi = _green_stage(torch.zeros_like(cr), torch.zeros_like(ci),
                                              cr, ci, 0, max_iter, escape_r * escape_r,
                                              max_iter)
    er = torch.exp(lpr)
    phi_r = torch.where(esc, er * torch.cos(lpi), torch.nan)
    phi_i = torch.where(esc, er * torch.sin(lpi), torch.nan)
    return g, kk, phi_r, phi_i


def _de_stage1_epilogue(esc, lzr, lzi, ldr, ldi):
    az = torch.hypot(lzr, lzi)
    adz = torch.maximum(torch.hypot(ldr, ldi), ldr.new_tensor(1e-16))
    d = torch.where(esc, az * torch.log(torch.maximum(az, az.new_tensor(1e-300))) / adz,
                    torch.zeros_like(az))
    return esc, d


def de_field_stage1_torch(cr, ci, max_iter: int = 200, bailout: float = 1e6):
    """Plain twin of de_field_stage1: the eager loop, on the tensors' device."""
    return _de_stage1_epilogue(*_de_latched_loop_torch(cr, ci, max_iter, bailout, True))


def de_field_stage1(cr, ci, max_iter: int = 200, bailout: float = 1e6):
    """Stage-1 distance estimator (construct_stage1_clean.py:50-58) on the
    tensors' device and dtype (CUDA: orbit.cu's orbit_de_stage1; CPU: the
    eager twin): |z|·log|z| / max(|dz|, 1e-16) at the FIRST |z| > bailout
    (|z| by hypot; z and dz latched there, then the orbit is frozen), else 0.
    No factor 2 in the denominator, unlike the other DE variants. Returns
    (esc, d)."""
    return _de_stage1_epilogue(*_loop(_de_latched_loop_torch, _de_latched_loop_cuda, cr, ci,
                                      max_iter, bailout, True))


#: escape_potential_grid's normalizations
POTENTIAL_NORMALIZATIONS = ("two_pow_n", "two_pow_k_break", "k_plus_1")


def _check_normalization(normalization: str):
    if normalization not in POTENTIAL_NORMALIZATIONS:
        raise ValueError(f"unknown normalization {normalization!r}; expected one of "
                         f"{POTENTIAL_NORMALIZATIONS}")


def _potential_loop_torch(cr, ci, max_iter: int, r2: float):
    """escape_potential_grid's eager loop: (esc, k, lzr, lzi), k the 0-based
    step of the first |z|^2 > r2, lz the z there, or the last z of a point
    that never escapes."""
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    k = torch.zeros(cr.shape, dtype=torch.int32, device=cr.device)
    lzr, lzi = torch.zeros_like(cr), torch.zeros_like(ci)
    for i in range(max_iter):
        zr, zi = _zsq_add_c(zr, zi, cr, ci)
        hit = ~esc & (zr * zr + zi * zi > r2)
        k.masked_fill_(hit, i)
        # the last unescaped z, then the z at the hit
        lzr = torch.where(esc, lzr, zr)
        lzi = torch.where(esc, lzi, zi)
        esc = esc | hit
        zr = torch.where(esc, 0.0, zr)
        zi = torch.where(esc, 0.0, zi)
    return esc, k, lzr, lzi


def _potential_loop_cuda(cr, ci, max_iter: int, r2: float, skip_interior: bool = False):
    """orbit_potential's loop state (esc, k, lzr, lzi) on the (ny, nx) of the
    grid. With skip_interior, f64 points of the analytic interior take no
    step for r2 >= 4. Its contract (argued in orbit.cu; _potential_contract):
    esc and k are _potential_loop_torch's bits, lz too at every escaper and
    at every point that was not skipped; a skipped point has lz = (NaN, NaN).
    _potential_epilogue gives the twin's g from either state where it reads
    lz only at escapers: two_pow_n and k_plus_1, the normalizations that ask
    for the skip (_skips_interior)."""
    outs = (_out(cr, torch.bool), _out(cr, torch.int32), _out(cr), _out(cr))
    return _orbit("orbit_potential", (cr, ci), outs, int(max_iter), float(r2),
                  int(bool(skip_interior)), grid=True)


def interior_f64(cr, ci) -> torch.Tensor:
    """csrc/orbit.cu's interior_f64 on f64 tensors: the points the redesigned
    entries send away without a step, the reference's cardioid and period-2
    bulb tests with their 1e-5 margins, in f64, for |cr|, |ci| <= 2."""
    xm = cr - 0.25
    q = xm * xm + ci * ci
    in_cardioid = q * (q + xm) <= 0.25 * ci * ci - 1e-5
    xp = cr + 1.0
    in_bulb = xp * xp + ci * ci <= 0.0625 - 1e-5
    return (cr.abs() <= 2.0) & (ci.abs() <= 2.0) & (in_cardioid | in_bulb)


def _potential_contract(state, cr, ci, r2: float, skip_interior: bool):
    """The loop state _potential_loop_cuda gives under its contract, from the
    twin's loop state `state` (_potential_loop_torch's) on the points
    (cr, ci): the twin's, with lz = (NaN, NaN) at the points it skips (with
    skip_interior, in f64, for r2 >= 4: interior_f64)."""
    esc, k, lzr, lzi = state
    if not (skip_interior and lzr.dtype == torch.float64 and r2 >= 4.0):
        return state
    skipped = interior_f64(cr, ci)
    nan = torch.full_like(lzr, float("nan"))
    return esc, k, torch.where(skipped, nan, lzr), torch.where(skipped, nan, lzi)


def _skips_interior(normalization: str) -> bool:
    """Whether escape_potential_grid's kernel may skip the f64 interior: its
    epilogue writes g = 0 at every point that does not escape, except under
    two_pow_k_break, which reads the last z there."""
    return normalization != "two_pow_k_break"


def _potential_epilogue(esc, k, lzr, lzi, max_iter: int, normalization: str):
    """g from the loop state: log|z_k| over 2^(k+1), 2^k or k+1 at the hit,
    divided (not multiplied by a reciprocal) as the reference does at each
    step; "two_pow_k_break" gives a point that never escapes log|z_end| /
    2^(max_iter-1), 0 where |z_end| == 0."""
    a2 = lzr * lzr + lzi * lzi
    logr = 0.5 * torch.log(torch.clamp(a2, min=1e-300))
    with np.errstate(over="ignore"):
        pow2 = np.ldexp(1.0, np.arange(max_iter + 1))
    if normalization == "k_plus_1":
        div = (k + 1).to(lzr.dtype)
    else:
        # cast like a Python scalar: 2^n past the dtype's range is inf
        p2 = torch.as_tensor(pow2, dtype=lzr.dtype, device=lzr.device)
        div = p2[(k + 1).clamp(max=max_iter) if normalization == "two_pow_n" else k]
    g = torch.where(esc, logr / div, torch.zeros_like(logr))
    if normalization == "two_pow_k_break":
        tail = logr / float(pow2[max_iter - 1])
        g = torch.where(esc, g, torch.where(a2 > 0.0, tail, torch.zeros_like(g)))
    return g


def escape_potential_grid_torch(cr, ci, max_iter: int = 500, escape_r: float = 4.0,
                                normalization: str = "two_pow_n"):
    """Plain twin of escape_potential_grid: the eager loop, on the tensors'
    device."""
    _check_normalization(normalization)
    state = _potential_loop_torch(cr, ci, max_iter, escape_r * escape_r)
    return _potential_epilogue(*state, max_iter, normalization)


def escape_potential_grid(cr, ci, max_iter: int = 500, escape_r: float = 4.0,
                          normalization: str = "two_pow_n"):
    """Grid escape potential with the reference's three normalizations, on
    the tensors' device and dtype (CUDA: orbit.cu's orbit_potential; CPU: the
    eager twin):
      * "two_pow_n": g = log|z_n| / 2^n at first escape, n 1-based, else 0
        (variograms_construct_mandelbrot.py:148-166);
      * "two_pow_k_break": Potentials.py:32-47 — k is the 0-based loop index
        at break (or max_iter-1 without escape); U = log|z_end| / 2^k, 0
        where |z_end| == 0;
      * "k_plus_1": U = log|z_k| / (k+1) at first escape (0-based k), else 0
        (Laplacian_C-M.py:27-43).
    The powers of two are exact (np.ldexp; inf past the dtype's range, as
    2^n overflows in the reference)."""
    _check_normalization(normalization)
    kernel = functools.partial(_potential_loop_cuda,
                               skip_interior=_skips_interior(normalization))
    state = _loop(_potential_loop_torch, kernel, cr, ci, max_iter, escape_r * escape_r)
    return _potential_epilogue(*state, max_iter, normalization)


def smooth5(g: torch.Tensor) -> torch.Tensor:
    """Interior 5-point average (variograms_construct_mandelbrot.py:168-173);
    the edge rows and columns are kept."""
    out = g.clone()
    out[1:-1, 1:-1] = (g[1:-1, 1:-1] + g[:-2, 1:-1] + g[2:, 1:-1] + g[1:-1, :-2]
                       + g[1:-1, 2:]) / 5.0
    return out


def boundary_points_threshold(domain=(-2.25, 1.25, -1.75, 1.75), grid_n: int = 600,
                              dist_thresh: float = 0.002, max_iter: int = 500,
                              escape_r: float = 4.0, dtype=torch.float64,
                              device="cuda") -> np.ndarray:
    """Threshold boundary proxy (variograms_construct_mandelbrot.py:90-104):
    the complex128 nodes of a grid_n x grid_n grid that escape with a
    standard distance estimate <= dist_thresh, in row-major order. The DE
    field runs in `dtype` on `device` (de_field_std); only the selected
    nodes' coordinates, the grid's own values in `dtype`, reach the host."""
    cr, ci = complex_grid(domain, grid_n, grid_n, dtype=dtype, device=device)
    esc, dist, _, _ = de_field_std(cr, ci, max_iter=max_iter, escape_r=escape_r)
    mask = esc & (dist <= dist_thresh)
    pts = torch.stack([cr[mask], ci[mask]]).cpu().numpy().astype(np.float64)
    return pts[0] + 1j * pts[1]


def de_field_tci_numpy(c: np.ndarray, max_iter: int = 250, escape_r: float = 250.0,
                       eps: float = 1e-12):
    """Host-numpy TCI DE with the reference's exact op order and IEEE
    overflow (parity runs). Bitwise-identical to
    tci_construct_mandelbrot_v002_fixed.py:35-47."""
    z = np.zeros_like(c)
    dz = np.ones_like(c)
    esc = np.zeros(c.shape, bool)
    last = np.zeros_like(c)
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(max_iter):
            dz = 2 * z * dz + 1
            z = z * z + c
            mask = (np.abs(z) > escape_r) & (~esc)
            esc |= mask
            last[mask] = z[mask]
    d = np.zeros(c.shape)
    z_, dz_ = last[esc], dz[esc]
    with np.errstate(over="ignore", invalid="ignore"):
        d[esc] = np.log(np.abs(z_)) * np.abs(z_) / np.maximum(np.abs(2 * z_ * dz_), eps)
    return esc, np.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)


#: sampler implementations: host numpy (parity), plain torch on the device,
#: and the hand-written CUDA kernel (the CPU takes its plain twin)
SAMPLE_IMPLS = ("numpy", "torch", "cuda")


def sample_boundary_quantile(domain, grid_n: int, n_samples: int, max_iter: int = 250,
                             escape_r: float = 250.0, eps: float = 1e-12,
                             rng: np.random.RandomState | None = None,
                             dtype=torch.float64, impl: str = "torch", device="cuda",
                             mesh=None):
    """TCI boundary sampler (tci_construct_mandelbrot_v002_fixed.py:49-59).

    Keep escaped points with d <= 25%-quantile of escaped d, then subsample
    to n_samples. The host RNG stream is consumed as in the reference:

      * impl="numpy": numpy DE on the np.linspace grid, np.quantile, and
        rng.choice (bitwise oracle parity);
      * impl="torch": the plain-torch DE in `dtype` on `device`, then the
        quantile and rng.choice on the host;
      * impl="cuda": the f32 K1 kernel with the q25 band and the subsample
        on the device, seeded by ONE draw from `rng`
        (mandelbrot_cuda.tci_boundary_sample).

    With impl="torch" and a `mesh` the DE grid's rows are sharded over its
    ranks (parallel.sharded.sharded_de_tci_field, bitwise the single-device
    field); the quantile and the subsample stay on the host, so the RNG
    stream is the single-device one. impl="cuda" is a single-device head and
    refuses a mesh, as the reference's impl="pallas" does; impl="numpy"
    ignores it.
    """
    if impl not in SAMPLE_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {SAMPLE_IMPLS}")
    if impl == "cuda":
        if mesh is not None:
            raise ValueError(
                "impl='cuda' is a single-device kernel head; it cannot be combined "
                "with mesh= (use impl='torch' for the sharded path)")
        if eps != 1e-12:
            # the kernel's denominator floor is baked in (as in the reference)
            raise ValueError(
                "impl='cuda' hardcodes the 1e-12 DE denominator floor; "
                f"eps={eps} is not representable there — use impl='torch'")
        from cmtci_torch.kernels.mandelbrot_cuda import tci_boundary_sample

        r = rng if rng is not None else np.random
        seed = int(r.randint(0, 2**31 - 1))
        return tci_boundary_sample(domain, grid_n, n_samples, seed,
                                   max_iter=max_iter, escape_r=escape_r, device=device)
    xs = np.linspace(domain[0], domain[1], grid_n)
    ys = np.linspace(domain[2], domain[3], grid_n)
    crn, cin = np.meshgrid(xs, ys)
    if impl == "numpy":
        esc, d = de_field_tci_numpy(crn + 1j * cin, max_iter=max_iter,
                                    escape_r=escape_r, eps=eps)
        c = crn + 1j * cin
    elif mesh is not None:
        from cmtci_torch.parallel.sharded import sharded_de_tci_field

        cr, ci = complex_grid(domain, grid_n, grid_n, dtype=dtype, device=mesh.device)
        esc, d = sharded_de_tci_field(domain, grid_n, mesh, max_iter=max_iter,
                                      escape_r=escape_r, eps=eps, dtype=dtype, grid=(cr, ci))
        c = fetch(cr).astype(np.float64) + 1j * fetch(ci).astype(np.float64)
    else:
        cr, ci = complex_grid(domain, grid_n, grid_n, dtype=dtype, device=device)
        esc, d, _, _ = de_field_tci(cr, ci, max_iter=max_iter, escape_r=escape_r, eps=eps)
        esc, d = fetch(esc), fetch(d)
        c = fetch(cr).astype(np.float64) + 1j * fetch(ci).astype(np.float64)
    if not esc.any():
        raise RuntimeError("No escape points")
    q = np.quantile(d[esc], 0.25)
    pts = c[esc & (d <= q)].ravel()
    return _subsample(pts, n_samples, rng)


def _subsample(pts, n_samples: int, rng):
    """Reference subsample (tci_..._v002_fixed.py:56-59): numpy RNG choice
    without replacement only when the pool exceeds the target."""
    if pts.size > n_samples:
        r = rng if rng is not None else np.random
        pts = r.choice(pts, n_samples, replace=False)
    return pts
