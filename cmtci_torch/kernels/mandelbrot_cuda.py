"""The escape-time kernels K1 (TCI distance estimator), K2 (dwell), K3
(cloud Green records), K4 (standard distance estimator), K5 (grid Green
potential) and K6 (the Mariani-Silver dwell's fine pass), with their plain
twins and wrappers.

Port of ``cmtci/kernels/mandelbrot_pallas.py``: ``_tci_kernel`` with its
hosts (``tci_de_field_pallas``, ``_tci_selection_core``,
``_tci_sample_padded``, ``tci_boundary_sample``, ``tci_boundary_selection``),
``_dwell_kernel``, ``_de_kernel`` and ``_green_kernel`` with
``mandelbrot_field_pallas``, ``_dwell_kernel(ms=True)`` with
``dwell_field_ms``, and ``_cloud_green_kernel`` with ``green_cloud_f32``. The
kernels are ``csrc/{tci_de,dwell,cloud_green,de_std,green_grid,dwell_ms}.cu``,
built with nvcc (``_build.py``) and called through ctypes (``_launch.py``).

A wrapper given a CPU device runs the kernel's plain twin; given a CUDA
device it launches the kernel or raises. Nothing falls back. The q25 band and
the subsample around K1 are plain torch on the same device, as the reference
left them to XLA; the 2^-k scaling around K3 is numpy f64 on the host, as in
the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.kernels._launch import launch as _launch
from cmtci_torch.kernels._launch import launches  # noqa: F401  (callers read the counts here)
from cmtci_torch.utils.device import resolve_device

#: FP32 operations per orbit step of each kernel's loop body, each mul, add,
#: sub and compare counted once (the build's -fmad=false keeps them apart):
#: de_std.cu's de_bare_step 9 mul, 7 add/sub, 1 compare (the squares zr*zr,
#: zi*zi and 2*zr are carried); escape.cuh:bare_step, the z-only step of
#: cloud_green.cu's chunks, of tci_de.cu's first pass and of green_grid.cu's
#: chunks, 4 mul, 4 add/sub, 1 compare (green_grid.cu's snapshot of |z|^2 is
#: the sum the radius test already takes), as escape.cuh:dwell_chunked, the
#: step of dwell.cu's two entries and of dwell_ms.cu (tci_de.cu's two
#: finiteness tests run once a chunk and are not counted, nor are the
#: periodic entry's compares with its checkpoint, which run once a chunk);
#: "tci_de_late", the step-by-step (z, dz) loop of tci_de.cu's second pass,
#: 12 mul, 7 add/sub, 3 compares.
OPS_PER_STEP = {"tci_de": 9, "tci_de_late": 22, "dwell": 9, "dwell_periodic": 9,
                "cloud_green": 9, "de_std": 17, "green_grid": 9, "dwell_ms": 9}

#: the schedule csrc/dwell.cu's plain kernel is built with (its constexpr C,
#: PATCH_W, PATCH_H; dwell_footprint() returns the same on the card): a thread
#: iterates one pixel and tests for its exit every `c` steps; a warp is a
#: patch of patch_w columns x patch_h rows of pixels
DWELL_FOOTPRINT = {"c": 4, "patch_w": 4, "patch_h": 8}
#: the same of dwell.cu's periodic entry (P_C, P_PATCH_W, P_PATCH_H;
#: dwell_periodic_footprint()), of csrc/dwell_ms.cu
#: (dwell_ms_footprint()), csrc/de_std.cu (de_footprint()), csrc/tci_de.cu
#: (tci_footprint()) and csrc/green_grid.cu (green_footprint())
DWELL_PERIODIC_FOOTPRINT = {"c": 8, "patch_w": 4, "patch_h": 8}
DWELL_MS_FOOTPRINT = {"c": 4, "patch_w": 4, "patch_h": 8}
DE_FOOTPRINT = {"c": 3, "patch_w": 4, "patch_h": 8}
TCI_FOOTPRINT = {"c": 6, "patch_w": 4, "patch_h": 8}
GREEN_FOOTPRINT = {"c": 4, "patch_w": 4, "patch_h": 8}

#: (library, C entry) that reports each footprint on the card
FOOTPRINT_ENTRY = {"DWELL_FOOTPRINT": ("dwell", "dwell_footprint"),
                   "DWELL_PERIODIC_FOOTPRINT": ("dwell", "dwell_periodic_footprint"),
                   "DWELL_MS_FOOTPRINT": ("dwell_ms", "dwell_ms_footprint"),
                   "DE_FOOTPRINT": ("de_std", "de_footprint"),
                   "TCI_FOOTPRINT": ("tci_de", "tci_footprint"),
                   "GREEN_FOOTPRINT": ("green_grid", "green_footprint")}


def _params(domain, nx: int, ny: int | None = None) -> np.ndarray:
    """f32 (xmin, ymin, dx, dy): spacings computed in f64 on the host, then
    cast, as the reference's wrappers do."""
    ny = nx if ny is None else ny
    if nx < 2 or ny < 2:
        raise ValueError(f"grid must be at least 2 x 2, got {ny} x {nx}")
    xmin, xmax, ymin, ymax = domain
    dx = (xmax - xmin) / (nx - 1)
    dy = (ymax - ymin) / (ny - 1)
    return np.asarray([xmin, ymin, dx, dy], dtype=np.float32)


def _grid_coords(domain, nx: int, ny: int, dev: torch.device):
    """f32 (cr, ci) of shape (ny, nx), built as the kernels build them:
    xmin + (float)col*dx and ymin + (float)row*dy (``_tile_coords``)."""
    return _coords(_params(domain, nx, ny), nx, ny, dev)


def _coords(params: np.ndarray, nx: int, ny: int, dev: torch.device, row0: int = 0):
    """_grid_coords from f32 (xmin, ymin, dx, dy) params; with row0, the
    grid's rows [row0, row0 + ny) (ymin + (float)(row0 + row)*dy)."""
    f32 = torch.float32
    p = torch.as_tensor(params, device=dev)
    xmin, ymin, dx, dy = p[0], p[1], p[2], p[3]
    cr = (xmin + torch.arange(nx, dtype=f32, device=dev) * dx)[None, :].expand(ny, nx)
    rows = torch.arange(row0, row0 + ny, dtype=f32, device=dev)
    ci = (ymin + rows * dy)[:, None].expand(ny, nx)
    return cr, ci


def _interior_mask_torch(cr, ci):
    """``_interior_mask`` in f32, in the kernels' op order (csrc/escape.cuh):
    c in the main cardioid or the period-2 bulb, each with a 1e-5 margin."""
    xm = cr - 0.25
    q = xm * xm + ci * ci
    in_cardioid = q * (q + xm) <= 0.25 * ci * ci - 1e-5
    xp = cr + 1.0
    # the reference folds 0.0625 - 1e-5 in double and compares in f32
    in_bulb = xp * xp + ci * ci <= float(np.float32(0.0625 - 1e-5))
    return in_cardioid | in_bulb


# ---------------------------------------------------------------------------
# K1: TCI distance estimator (the tracker's boundary band)
# ---------------------------------------------------------------------------


def tci_de_field_torch(domain, grid_n: int, max_iter: int = 250,
                       escape_r: float = 250.0, device="cpu") -> torch.Tensor:
    """Plain-torch twin of the K1 kernel: the same f32 op sequence, as a
    masked loop over the whole grid. Returns the raw f32 (grid_n, grid_n)
    field: d (>= 0) where escaped, -1 where not.

    A lane stops updating once it is analytically interior, or escaped with
    a non-finite dz. The kernel iterates dz only for the few late escapers
    whose dz can still be finite at max_iter; its output is the same
    (csrc/tci_de.cu says why).
    """
    dev = resolve_device(device)
    f32 = torch.float32
    cr, ci = _grid_coords(domain, grid_n, grid_n, dev)
    active = ~_interior_mask_torch(cr, ci)

    zero = torch.zeros((grid_n, grid_n), dtype=f32, device=dev)
    zr, zi, dzr, dzi, lzr, lzi = zero, zero, zero + 1.0, zero, zero, zero
    esc = torch.zeros((grid_n, grid_n), dtype=torch.bool, device=dev)
    r2 = float(np.float32(escape_r * escape_r))
    for _ in range(max_iter):
        tr, ti = 2.0 * zr, 2.0 * zi
        ndzr = tr * dzr - ti * dzi + 1.0
        ndzi = tr * dzi + ti * dzr
        nzr = zr * zr - zi * zi + cr
        nzi = 2.0 * zr * zi + ci
        dzr = torch.where(active, ndzr, dzr)
        dzi = torch.where(active, ndzi, dzi)
        zr = torch.where(active, nzr, zr)
        zi = torch.where(active, nzi, zi)
        a2 = zr * zr + zi * zi
        hit = active & ~esc & (a2 > r2)
        lzr = torch.where(hit, zr, lzr)
        lzi = torch.where(hit, zi, lzi)
        esc = esc | hit
        dz_dead = ~(torch.isfinite(dzr) & torch.isfinite(dzi))
        active = active & ~(esc & dz_dead)

    az = torch.sqrt(lzr * lzr + lzi * lzi)
    pr = 2.0 * lzr * dzr - 2.0 * lzi * dzi
    pi = 2.0 * lzr * dzi + 2.0 * lzi * dzr
    # torch.maximum propagates NaN like jnp.maximum (a NaN dz must give d=0)
    den = torch.maximum(torch.sqrt(pr * pr + pi * pi), zero.new_tensor(1e-12))
    num = torch.log(torch.maximum(az, zero.new_tensor(1.0))) * az
    d = num / den
    d = torch.where(torch.isfinite(d), d, zero)
    return torch.where(esc, d, zero - 1.0)


def _tci_field(domain, grid_n: int, max_iter: int, escape_r: float,
               dev: torch.device) -> torch.Tensor:
    """Raw K1 field on `dev`: the kernel on CUDA, the twin on the CPU."""
    if dev.type == "cpu":
        return tci_de_field_torch(domain, grid_n, max_iter, escape_r, device=dev)
    xmin, ymin, dx, dy = (float(v) for v in _params(domain, grid_n))
    r2 = float(np.float32(escape_r * escape_r))
    out = torch.empty((grid_n, grid_n), dtype=torch.float32, device=dev)
    _launch("tci_de", dev, out.data_ptr(), int(grid_n), xmin, ymin, dx, dy, int(max_iter), r2)
    return out


def tci_de_field(domain, grid_n: int, max_iter: int = 250, escape_r: float = 250.0,
                 device="cuda"):
    """(esc bool, d f32) of the TCI DE over a grid_n x grid_n np.linspace-style
    grid, on `device` (CUDA: the K1 kernel; CPU: its twin)."""
    out = _tci_field(domain, grid_n, max_iter, escape_r, resolve_device(device))
    return out >= 0.0, torch.clamp(out, min=0.0)


def band_selection(esc: torch.Tensor, d: torch.Tensor):
    """q25 boundary band on the device (``_tci_selection_core``):
    esc & (d <= q) with q the linear interpolation over the sorted escaped
    d at position 0.25·(cnt-1), all in f32. Returns (sel, cnt, q) tensors."""
    df = d.reshape(-1)
    escf = esc.reshape(-1)
    v, _ = torch.sort(torch.where(escf, df, torch.full_like(df, float("inf"))))
    cnt = escf.sum()
    pos = 0.25 * (cnt - 1).to(df.dtype)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), min=0)
    hi = torch.clamp(torch.ceil(pos).to(torch.int64), min=0)
    frac = pos - lo.to(df.dtype)
    q = v[lo] * (1.0 - frac) + v[hi] * frac
    return esc & (d <= q), cnt, q


def tci_boundary_selection(domain, grid_n: int, max_iter: int = 250,
                           escape_r: float = 250.0, device="cuda"):
    """(sel bool numpy (grid_n, grid_n), n_escaped) of the TCI boundary band,
    computed on `device` (tci_construct_mandelbrot_v002_fixed.py:49-55)."""
    esc, d = tci_de_field(domain, grid_n, max_iter, escape_r, device=device)
    sel, cnt, _ = band_selection(esc, d)
    return sel.cpu().numpy(), int(cnt)


def tci_boundary_sample(domain, grid_n: int, n_samples: int, seed: int,
                        max_iter: int = 250, escape_r: float = 250.0, device="cuda"):
    """Boundary-band subsample drawn on `device`. Returns complex (m,) with
    m = min(n_samples, band size), points on the host np.linspace grid.

    The band and a uniform subsample without replacement run on the device:
    a Gumbel top-k with equal weights, from a torch.Generator seeded with
    `seed`. With equal weights the Gumbel keys -log(-log u) are a monotone
    map of the uniforms u, so the top-k of u itself is the same subset; the
    kernel draws u directly. Only the k indices and two counts cross to the
    host, in one copy. This is a new realization: its draws cannot equal
    jax.random's. Raises like the host path when no pixel escapes.
    """
    dev = resolve_device(device)
    esc, d = tci_de_field(domain, grid_n, max_iter, escape_r, device=dev)
    sel, cnt, _ = band_selection(esc, d)
    selv = sel.reshape(-1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    u = torch.rand(selv.shape, generator=gen, dtype=torch.float32, device=dev)
    score = torch.where(selv, u, torch.full_like(u, -1.0))
    k = min(int(n_samples), grid_n * grid_n)
    _, idx = torch.topk(score, k)
    packed = torch.cat([torch.stack([selv.sum(), cnt]), idx]).cpu().numpy()
    n_band, n_esc = int(packed[0]), int(packed[1])
    if n_esc == 0:
        raise RuntimeError("No escape points")
    take = min(int(n_samples), n_band)
    idx = packed[2 : 2 + take]
    xs = np.linspace(domain[0], domain[1], grid_n)
    ys = np.linspace(domain[2], domain[3], grid_n)
    return xs[idx % grid_n] + 1j * ys[idx // grid_n]


# ---------------------------------------------------------------------------
# K2: dwell field (the boundary pipeline's grid); K4/K5: the "de" and "green"
# fields of mandelbrot_field
# ---------------------------------------------------------------------------

#: mandelbrot_field's kinds and the kernel library each launches
FIELD_KINDS = {"dwell": "dwell", "de": "de_std", "green": "green_grid"}


def _dwell_torch(params: np.ndarray, nx: int, ny: int, max_iter: int, dev: torch.device,
                 fill_px: torch.Tensor | None = None,
                 periodicity: bool = False, row0: int = 0) -> torch.Tensor:
    """Twin of escape.cuh:dwell_chunked over the grid of f32 `params`, the
    loop K2's two entries and K6's fine pass share, step by step. fill_px
    (f32 (ny, nx), optional) is K6's per-pixel fill flag: where it is >= 0
    the pixel takes it and skips the loop, as K6's thread does.

    A lane's z is frozen where it escapes, and its count with it (the kernels
    iterate an escaped pixel on with its latch down; the count is the same).

    periodicity adds the Brent cycle check of K2's periodic entry: a
    checkpoint of z, moved here when the steps taken are a power of two (the
    kernel moves it at chunk ends only; the schedule does not enter the
    result); a lane still inside whose z equals its checkpoint bitwise stops
    and gets max_iter.

    row0 runs the grid's rows [row0, row0 + ny), as K2's row entry does.
    """
    cr, ci = _coords(params, nx, ny, dev, row0)
    interior = _interior_mask_torch(cr, ci)
    act = ~interior
    dwell = torch.where(interior, float(max_iter), 0.0).to(torch.float32)
    if fill_px is not None:
        filled = fill_px >= 0.0
        act = act & ~filled
        dwell = torch.where(filled, fill_px, dwell)
    zr = torch.zeros((ny, nx), dtype=torch.float32, device=dev)
    zi = torch.zeros_like(zr)
    if periodicity:
        pr = torch.full_like(zr, 1e30)  # no z with |z|^2 <= 4 equals it
        pi = torch.zeros_like(zr)
        cyc = torch.zeros_like(act)
    for n in range(max_iter):
        if n % 32 == 0 and not bool(act.any()):
            break
        nzr = zr * zr - zi * zi + cr
        nzi = 2.0 * zr * zi + ci
        zr = torch.where(act, nzr, zr)
        zi = torch.where(act, nzi, zi)
        act = act & (zr * zr + zi * zi <= 4.0)  # NaN -> False: an escape
        if periodicity:
            hit = act & (zr == pr) & (zi == pi)
            cyc = cyc | hit
            act = act & ~hit
            if (n + 1) & n == 0:  # n + 1 steps taken, a power of two
                pr, pi = zr, zi
        dwell = dwell + act.to(torch.float32)
    if periodicity:
        dwell = torch.where(cyc, float(max_iter), dwell)
    return dwell


def dwell_field_torch(domain, nx: int, ny: int, max_iter: int = 500,
                      device="cpu", periodicity: bool = False) -> torch.Tensor:
    """Plain-torch twin of the K2 kernel: f32 (ny, nx) dwell, the first n
    (0-based) with |z_{n+1}|^2 > 4, else max_iter, in K2's f32 op order;
    with periodicity, the twin of K2's periodic entry point."""
    return _dwell_torch(_params(domain, nx, ny), nx, ny, max_iter, resolve_device(device),
                        periodicity=periodicity)


def _dwell(params: np.ndarray, nx: int, ny: int, max_iter: int, dev: torch.device,
           periodicity: bool = False) -> torch.Tensor:
    """K2 over the grid of f32 `params` on `dev` (its twin on the CPU);
    with periodicity, K2's entry point with the cycle check."""
    if dev.type == "cpu":
        return _dwell_torch(params, nx, ny, max_iter, dev, periodicity=periodicity)
    xmin, ymin, dx, dy = (float(v) for v in params)
    out = torch.empty((ny, nx), dtype=torch.float32, device=dev)
    _launch("dwell_periodic" if periodicity else "dwell", dev, out.data_ptr(), int(nx),
            int(ny), xmin, ymin, dx, dy, int(max_iter))
    return out


def dwell_rows(domain, nx: int, ny: int, row0: int, rows: int, max_iter: int = 500,
               device="cuda") -> torch.Tensor:
    """f32 (rows, nx): the rows [row0, row0 + rows) of mandelbrot_field(domain,
    nx, ny, max_iter, kind="dwell"), bitwise. A CUDA device launches K2's row
    entry (dwell_rows_launch), a CPU device runs its twin."""
    if not 0 <= row0 <= row0 + rows <= ny:
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside a grid of {ny} rows")
    dev = resolve_device(device)
    params = _params(domain, nx, ny)
    if dev.type == "cpu":
        return _dwell_torch(params, nx, rows, max_iter, dev, row0=row0)
    out = torch.empty((rows, nx), dtype=torch.float32, device=dev)
    if rows:
        xmin, ymin, dx, dy = (float(v) for v in params)
        _launch("dwell_rows", dev, out.data_ptr(), int(nx), int(rows), int(row0), xmin, ymin,
                dx, dy, int(max_iter))
    return out


def footprint_built(name: str) -> dict:
    """The footprint `name` (a key of FOOTPRINT_ENTRY) as the built library
    reports it (needs nvcc)."""
    import ctypes

    from cmtci_torch.kernels._build import library

    lib, entry = FOOTPRINT_ENTRY[name]
    fn = getattr(library(lib), entry)
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    vals = (ctypes.c_int * 3)()
    fn(vals)
    return dict(zip(("c", "patch_w", "patch_h"), (int(v) for v in vals)))


def de_field_std_torch(domain, nx: int, ny: int, max_iter: int = 500,
                       escape_r: float = 4.0, device="cpu") -> torch.Tensor:
    """Plain-torch twin of the K4 kernel: the f32 (ny, nx) standard
    distance estimator in K4's op order (``_de_kernel``).

    z and dz are latched at the first |z|^2 > R^2 and the lane stops there
    (the kernel's thread reads them from the snapshots of the chunk it stops
    in); an analytically interior lane counts as escaped with zero latches
    (d = 0); a lane that never escapes gives 0.
    """
    dev = resolve_device(device)
    cr, ci = _grid_coords(domain, nx, ny, dev)
    esc = _interior_mask_torch(cr, ci)
    active = ~esc
    zero = torch.zeros((ny, nx), dtype=torch.float32, device=dev)
    zr, zi, dzr, dzi = zero, zero, zero + 1.0, zero
    lzr, lzi, ldr, ldi = zero, zero, zero + 1.0, zero
    r2 = float(np.float32(escape_r * escape_r))
    for n in range(max_iter):
        if n % 32 == 0 and not bool(active.any()):
            break
        tr, ti = 2.0 * zr, 2.0 * zi
        ndzr = tr * dzr - ti * dzi + 1.0
        ndzi = tr * dzi + ti * dzr
        nzr = zr * zr - zi * zi + cr
        nzi = 2.0 * zr * zi + ci
        dzr = torch.where(active, ndzr, dzr)
        dzi = torch.where(active, ndzi, dzi)
        zr = torch.where(active, nzr, zr)
        zi = torch.where(active, nzi, zi)
        hit = active & (zr * zr + zi * zi > r2)
        lzr = torch.where(hit, zr, lzr)
        lzi = torch.where(hit, zi, lzi)
        ldr = torch.where(hit, dzr, ldr)
        ldi = torch.where(hit, dzi, ldi)
        esc = esc | hit
        active = active & ~hit
    az = torch.sqrt(lzr * lzr + lzi * lzi)
    pr = 2.0 * (lzr * ldr - lzi * ldi)
    pi = 2.0 * (lzr * ldi + lzi * ldr)
    # torch.maximum propagates NaN like jnp.maximum (an overflowed dz keeps
    # its NaN d, as in the reference)
    num = torch.log(torch.maximum(az, zero.new_tensor(1.0))) * az
    den = torch.maximum(torch.sqrt(pr * pr + pi * pi), zero.new_tensor(1e-14))
    return torch.where(esc, num / den, zero)


def _pow2_f32(k: int) -> float:
    """2^-k as the f32 value K5 computes (ldexpf(1, -k)): exact, subnormal
    for k > 126, 0 for k > 149."""
    return float(np.ldexp(np.float32(1.0), -k))


def green_field_torch(domain, nx: int, ny: int, max_iter: int = 500,
                      escape_r: float = 4.0, device="cpu") -> torch.Tensor:
    """Plain-torch twin of the K5 kernel: f32 (ny, nx) g = max(0.5
    log(max(|z|^2, 1e-30)) 2^-(n+1), 0) at the first |z|^2 > R^2 (0-based
    step n), else 0, in K5's op order (``_green_kernel``). An escaped lane
    stops here (the kernel's thread runs its chunk on and reads |z|^2 at the
    first escape from its snapshots); interior lanes skip."""
    dev = resolve_device(device)
    cr, ci = _grid_coords(domain, nx, ny, dev)
    active = ~_interior_mask_torch(cr, ci)
    g = torch.zeros((ny, nx), dtype=torch.float32, device=dev)
    zr, zi = torch.zeros_like(g), torch.zeros_like(g)
    r2 = float(np.float32(escape_r * escape_r))
    floor = g.new_tensor(1e-30)
    for n in range(max_iter):
        if n % 32 == 0 and not bool(active.any()):
            break
        nzr = zr * zr - zi * zi + cr
        nzi = 2.0 * zr * zi + ci
        zr = torch.where(active, nzr, zr)
        zi = torch.where(active, nzi, zi)
        a2 = zr * zr + zi * zi
        hit = active & (a2 > r2)
        val = 0.5 * torch.log(torch.maximum(a2, floor)) * _pow2_f32(n + 1)
        g = torch.where(hit, torch.maximum(val, g.new_tensor(0.0)), g)
        active = active & ~hit
    return g


def mandelbrot_field(domain, nx: int, ny: int, max_iter: int = 500, kind: str = "dwell",
                     escape_r: float = 4.0, device="cuda",
                     periodicity: bool = False) -> torch.Tensor:
    """f32 (ny, nx) escape-time field over an np.linspace-style grid on
    `device` (``mandelbrot_field_pallas``). domain = (xmin, xmax, ymin,
    ymax), layout (ny, nx) like complex_grid(); the kernel covers exactly
    ny x nx, with no tile-multiple restriction. kind:
      * "dwell": iteration counts, max_iter where not escaped (K2; escape_r
        is not read, the radius is 2 as in the reference);
      * "de": the standard distance estimator, radius escape_r (K4);
      * "green": g = log|z_k| 2^-k at the first |z| > escape_r, else 0 (K5).
    A CUDA device launches the kind's kernel, a CPU device runs its twin.
    periodicity (kind "dwell" only, as in the reference, where the other
    kinds ignore it) runs K2 with the Brent cycle check: the same output,
    bounded orbits that enter an f32 cycle stop early. It pays at a high
    max_iter only.
    """
    if kind not in FIELD_KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {tuple(FIELD_KINDS)}")
    dev = resolve_device(device)
    params = _params(domain, nx, ny)
    if kind == "dwell":
        return _dwell(params, nx, ny, max_iter, dev, periodicity)
    if dev.type == "cpu":
        twin = de_field_std_torch if kind == "de" else green_field_torch
        return twin(domain, nx, ny, max_iter, escape_r, device=dev)
    xmin, ymin, dx, dy = (float(v) for v in params)
    r2 = float(np.float32(escape_r * escape_r))
    out = torch.empty((ny, nx), dtype=torch.float32, device=dev)
    _launch(FIELD_KINDS[kind], dev, out.data_ptr(), int(nx), int(ny), xmin, ymin, dx, dy,
            int(max_iter), r2)
    return out


# ---------------------------------------------------------------------------
# K6: Mariani-Silver dwell (coarse pass on K2, fill flags, fine pass on K6)
# ---------------------------------------------------------------------------


def _coarse_params(domain, nx: int, ny: int, stride: int) -> np.ndarray:
    """f32 (xmin, ymin, dx*stride, dy*stride) with the products taken in f64
    before the cast, as the reference's coarse pass does: f32(dx*stride)*col
    and f32(dx)*(col*stride) can differ by an ulp, and with them a flag."""
    xmin, xmax, ymin, ymax = domain
    dx = (xmax - xmin) / (nx - 1)
    dy = (ymax - ymin) / (ny - 1)
    return np.asarray([xmin, ymin, dx * stride, dy * stride], dtype=np.float32)


def fill_flags(coarse: torch.Tensor, rs: int, cs: int) -> torch.Tensor:
    """Per-tile fill flags from the coarse dwell (the reference's host loop,
    vectorized on the coarse tensor's device): f32 (cyn // rs, cxn // cs),
    the tile's common value where every coarse sample on the tile
    (rs x cs of them) and a one-sample halo around it are equal, else -1.
    Tiles on the grid's edge have no halo and are never filled."""
    cyn, cxn = coarse.shape
    n_ty, n_tx = cyn // rs, cxn // cs
    fill = torch.full((n_ty, n_tx), -1.0, dtype=torch.float32, device=coarse.device)
    if n_ty >= 3 and n_tx >= 3:
        # window k along an axis starts at (k+1)*rs - 1: tile k+1 and its halo
        w = coarse[rs - 1 :, cs - 1 :].unfold(0, rs + 2, rs).unfold(1, cs + 2, cs)
        v = w[..., 0, 0]
        uniform = (w == v[..., None, None]).flatten(2).all(dim=2)
        fill[1:-1, 1:-1] = torch.where(uniform, v, fill[1:-1, 1:-1])
    return fill


def _fill_pixels(fill: torch.Tensor, tile) -> torch.Tensor:
    th, tw = tile
    return fill.repeat_interleave(th, dim=0).repeat_interleave(tw, dim=1)


def dwell_fill_torch(domain, nx: int, ny: int, fill: torch.Tensor, tile,
                     max_iter: int = 500, device="cpu") -> torch.Tensor:
    """Plain-torch twin of the K6 kernel (the fine pass): a pixel of a
    filled tile (flag >= 0) takes the flag, the others run K2's loop."""
    dev = resolve_device(device)
    return _dwell_torch(_params(domain, nx, ny), nx, ny, max_iter, dev,
                        _fill_pixels(fill.to(dev), tile))


def dwell_fill(domain, nx: int, ny: int, fill: torch.Tensor, tile, max_iter: int = 500,
               device="cuda") -> torch.Tensor:
    """K6 on `device` (CUDA: the kernel; CPU: its twin). fill is the f32
    (ny // th, nx // tw) flag array of fill_flags; ny and nx must be
    multiples of the tile (th, tw)."""
    dev = resolve_device(device)
    th, tw = tile
    if ny % th or nx % tw or tuple(fill.shape) != (ny // th, nx // tw):
        raise ValueError(f"fill {tuple(fill.shape)} does not tile ({ny}, {nx}) by {tile}")
    if dev.type == "cpu":
        return dwell_fill_torch(domain, nx, ny, fill, tile, max_iter, device=dev)
    fill = fill.to(device=dev, dtype=torch.float32).contiguous()
    xmin, ymin, dx, dy = (float(v) for v in _params(domain, nx, ny))
    out = torch.empty((ny, nx), dtype=torch.float32, device=dev)
    _launch("dwell_ms", dev, fill.data_ptr(), out.data_ptr(), int(nx), int(ny), xmin, ymin,
            dx, dy, int(max_iter), int(th), int(tw))
    return out


def dwell_field_ms(domain, nx: int, ny: int, max_iter: int = 500, stride: int = 8,
                   tile: tuple = (32, 256), device="cuda"):
    """Dwell field with Mariani-Silver tile fills (the reference's opt-in
    ``dwell_field_ms``). Returns (out, stats).

    Pass 1 is K2 at every `stride`-th pixel (the coarse samples ARE fine
    pixels, at the reference's coarse spacing f32(dx*stride)). A fine
    (th, tw) tile is filled with v iff every coarse sample on the tile plus a
    one-sample halo equals v (fill_flags, on the device); grid-edge tiles
    always compute. The fine pass is K6. stats = {"filled": tiles filled,
    "tiles": total, "coarse_px": coarse pass pixels}. The fill criterion is
    a heuristic at pixel resolution, as in the reference: equal to K2 where
    no sub-stride sliver threads between the samples.
    """
    th, tw = tile
    if th % stride or tw % stride:
        raise ValueError(f"stride {stride} must divide the tile {tile}")
    if ny % (th * stride) or nx % (tw * stride):
        raise ValueError(f"(ny, nx) = {(ny, nx)} must be a multiple of "
                         f"tile*stride = {(th * stride, tw * stride)}")
    dev = resolve_device(device)
    cyn, cxn = ny // stride, nx // stride
    coarse = _dwell(_coarse_params(domain, nx, ny, stride), cxn, cyn, max_iter, dev)
    fill = fill_flags(coarse, th // stride, tw // stride)
    out = dwell_fill(domain, nx, ny, fill, tile, max_iter, device=dev)
    stats = {"filled": int((fill >= 0).sum()), "tiles": fill.numel(), "coarse_px": cyn * cxn}
    return out, stats


# ---------------------------------------------------------------------------
# K3: Green escape records of a point cloud (the equipotential pipeline)
# ---------------------------------------------------------------------------


def cloud_green_torch(cr, ci, zr0, zi0, iters: int, escape_r: float = 2.0,
                      device="cpu") -> torch.Tensor:
    """Plain-torch twin of the K3 kernel. Returns the f32 (6, m) buffer the
    kernel writes: rows k (1-based first escape in this launch, 0 if none),
    zer, zei (z at escape), zr, zi (state), act (1 while not escaped).

    An inactive lane's z is frozen, as in the kernel (whose thread breaks).
    """
    dev = resolve_device(device)
    cr, ci, zr, zi = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in (cr, ci, zr0, zi0))
    act = ~_interior_mask_torch(cr, ci)
    k = torch.zeros_like(cr)
    zer, zei = torch.zeros_like(cr), torch.zeros_like(cr)
    r2 = float(np.float32(escape_r * escape_r))
    for n in range(iters):
        if n % 64 == 0 and not bool(act.any()):
            break
        nzr = zr * zr - zi * zi + cr
        nzi = 2.0 * zr * zi + ci
        zr = torch.where(act, nzr, zr)
        zi = torch.where(act, nzi, zi)
        hit = act & (zr * zr + zi * zi > r2)  # inf -> True
        k = torch.where(hit, float(n + 1), k)
        zer = torch.where(hit, zr, zer)
        zei = torch.where(hit, zi, zei)
        act = act & ~hit
    return torch.stack([k, zer, zei, zr, zi, act.to(torch.float32)])


def cloud_green(cr, ci, zr0, zi0, iters: int, escape_r: float = 2.0,
                device="cuda") -> torch.Tensor:
    """K3 on `device` (CUDA: the kernel; CPU: its twin). Inputs are (m,)
    arrays or tensors, cast to contiguous f32 on the device. Returns the f32
    (6, m) buffer of cloud_green_torch."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return cloud_green_torch(cr, ci, zr0, zi0, iters, escape_r, device=dev)
    cr, ci, zr0, zi0 = (torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
                        for a in (cr, ci, zr0, zi0))
    m = cr.numel()
    if not (cr.shape == ci.shape == zr0.shape == zi0.shape == (m,)):
        raise ValueError("cr, ci, zr0, zi0 must be 1-D of one length, got "
                         f"{[tuple(a.shape) for a in (cr, ci, zr0, zi0)]}")
    out = torch.empty((6, m), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    r2 = float(np.float32(escape_r * escape_r))
    _launch("cloud_green", dev, cr.data_ptr(), ci.data_ptr(), zr0.data_ptr(),
            zi0.data_ptr(), out.data_ptr(), int(m), int(iters), r2)
    return out


def exact_interior(pts: np.ndarray) -> np.ndarray:
    """Host f64 cardioid/bulb test of complex points with exact inequalities
    and no margin: a point misclassified by f64 rounding sits within ~1e-14
    of the boundary, whose escape time exceeds any configured max_iter."""
    xr, xi = pts.real, pts.imag
    q = (xr - 0.25) ** 2 + xi * xi
    return (q * (q + (xr - 0.25)) <= 0.25 * xi * xi) | ((xr + 1.0) ** 2 + xi * xi <= 0.0625)


def green_cloud_f32(points, max_iter: int = 20000, escape_r: float = 2.0,
                    stage_iters: int | None = None, device="cuda"):
    """(g, k, phi) of a complex cloud with the f32 K3 head (the reference's
    ``green_cloud_f32``).

    Drop-in for mandelbrot.green_potential_compacted (g = max(log|z_k| 2^-k,
    0) at first escape else 0, k = max_iter where never escaped, phi =
    exp(2^-k log z_k) else nan), with the trajectory run in f32 on `device`.
    g and phi are computed on the host in f64 from the unscaled (k, z_k)
    records, so deep escapers with k in (126, 1074] keep their tiny positive
    g. stage_iters=None runs the whole budget in one launch; otherwise the
    survivors are compacted on the host between stages (identical results:
    the resumed state replays the same f32 op sequence).
    """
    dev = resolve_device(device)
    stage_iters = max_iter if stage_iters is None else stage_iters
    if stage_iters < 1:
        raise ValueError(f"stage_iters must be >= 1, got {stage_iters}")
    pts = np.asarray(points, dtype=complex).ravel()
    n = pts.size
    g = np.zeros(n)
    kk = np.full(n, max_iter, dtype=np.int32)
    phi = np.full(n, np.nan + 1j * np.nan, dtype=complex)
    # analytically interior points never escape: their final record is
    # known up front
    interior = exact_interior(pts)
    idx = np.arange(n)[~interior]
    cr_h = pts.real[~interior].astype(np.float32)
    ci_h = pts.imag[~interior].astype(np.float32)
    zr_h = np.zeros(len(idx), np.float32)
    zi_h = np.zeros(len(idx), np.float32)
    k0 = 0
    while k0 < max_iter and len(idx):
        iters = min(stage_iters, max_iter - k0)
        final = iters >= max_iter - k0
        out = cloud_green(cr_h, ci_h, zr_h, zi_h, iters, escape_r, device=dev)
        # one copy to the host per stage; the final stage needs no state rows
        packed = (out[:3] if final else out[:5]).cpu().numpy()
        k_rel = packed[0].astype(np.float64)
        esc = k_rel > 0
        if esc.any():
            zer = packed[1][esc].astype(np.float64)
            zei = packed[2][esc].astype(np.float64)
            k_abs = k0 + k_rel[esc]
            scale = np.exp2(-k_abs)  # f64: no underflow until k > 1074
            logr = 0.5 * np.log(np.maximum(zer * zer + zei * zei, 1e-300))
            gg = logr * scale
            hit_idx = idx[esc]
            g[hit_idx] = np.where(np.isfinite(gg) & (gg >= 0.0), gg, 0.0)
            kk[hit_idx] = k_abs.astype(np.int32)
            phi[hit_idx] = (np.exp(logr * scale)
                            * np.exp(1j * np.arctan2(zei, zer) * scale))
        keep = ~esc
        idx = idx[keep]
        cr_h, ci_h = cr_h[keep], ci_h[keep]
        if not final:
            zr_h, zi_h = packed[3][keep], packed[4][keep]
        k0 += iters
    return g, kk, phi
