"""The escape-time kernels K1 (TCI distance estimator), K2 (dwell) and K3
(cloud Green records), with their plain twins and wrappers.

Port of ``cmtci/kernels/mandelbrot_pallas.py``: ``_tci_kernel`` with its
hosts (``tci_de_field_pallas``, ``_tci_selection_core``,
``_tci_sample_padded``, ``tci_boundary_sample``, ``tci_boundary_selection``),
``_dwell_kernel`` with ``mandelbrot_field_pallas``, and
``_cloud_green_kernel`` with ``green_cloud_f32``. The kernels are
``csrc/tci_de.cu``, ``csrc/dwell.cu`` and ``csrc/cloud_green.cu``, built with
nvcc and called through ctypes (``_build.py``).

A wrapper given a CPU device runs the kernel's plain twin; given a CUDA
device it launches the kernel or raises. Nothing falls back. The q25 band and
the subsample around K1 are plain torch on the same device, as the reference
left them to XLA; the 2^-k scaling around K3 is numpy f64 on the host, as in
the reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cmtci_torch.utils.device import resolve_device

#: kernel launches per library, counted where the wrapper launches; read and
#: reset by callers that need to show a run went through the kernels
launches = {"tci_de": 0, "dwell": 0, "cloud_green": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "tci_de": [_P, _I, _F, _F, _F, _F, _I, _F, _P],
    "dwell": [_P, _I, _I, _F, _F, _F, _F, _I, _P],
    "cloud_green": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
}


def _launch(name: str, dev: torch.device, *args) -> None:
    """Launch csrc/<name>.cu's entry point on dev's current stream and
    count it; raise on a non-zero cudaGetLastError()."""
    from cmtci_torch.kernels._build import library

    fn = getattr(library(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launches[name] += 1


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
    f32 = torch.float32
    p = torch.as_tensor(_params(domain, nx, ny), device=dev)
    xmin, ymin, dx, dy = p[0], p[1], p[2], p[3]
    cr = (xmin + torch.arange(nx, dtype=f32, device=dev) * dx)[None, :].expand(ny, nx)
    ci = (ymin + torch.arange(ny, dtype=f32, device=dev) * dy)[:, None].expand(ny, nx)
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

    A lane stops updating where the kernel's thread breaks (analytically
    interior, or escaped with a non-finite dz), so the state each lane ends
    with is the kernel's.
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
# K2: dwell field (the boundary pipeline's grid)
# ---------------------------------------------------------------------------


def dwell_field_torch(domain, nx: int, ny: int, max_iter: int = 500,
                      device="cpu") -> torch.Tensor:
    """Plain-torch twin of the K2 kernel: f32 (ny, nx) dwell, the first n
    (0-based) with |z_{n+1}|^2 > 4, else max_iter, in K2's f32 op order.

    A lane's z is frozen where the kernel's thread breaks (escaped), so
    every lane ends with the kernel's state and count.
    """
    dev = resolve_device(device)
    cr, ci = _grid_coords(domain, nx, ny, dev)
    interior = _interior_mask_torch(cr, ci)
    act = ~interior
    dwell = torch.where(interior, float(max_iter), 0.0).to(torch.float32)
    zr = torch.zeros((ny, nx), dtype=torch.float32, device=dev)
    zi = torch.zeros_like(zr)
    for n in range(max_iter):
        if n % 32 == 0 and not bool(act.any()):
            break
        nzr = zr * zr - zi * zi + cr
        nzi = 2.0 * zr * zi + ci
        zr = torch.where(act, nzr, zr)
        zi = torch.where(act, nzi, zi)
        act = act & (zr * zr + zi * zi <= 4.0)  # NaN -> False: an escape
        dwell = dwell + act.to(torch.float32)
    return dwell


def mandelbrot_field(domain, nx: int, ny: int, max_iter: int = 500,
                     device="cuda") -> torch.Tensor:
    """f32 (ny, nx) dwell over an np.linspace-style grid on `device`
    (``mandelbrot_field_pallas(kind="dwell")``): iteration counts, max_iter
    where not escaped. domain = (xmin, xmax, ymin, ymax), layout (ny, nx)
    like complex_grid(); the kernel covers exactly ny x nx, with no
    tile-multiple restriction. A CUDA device launches K2, a CPU device runs
    its twin. The reference's other kinds come with their kernels (ROADMAP
    Queue 2, K4/K5).
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dwell_field_torch(domain, nx, ny, max_iter, device=dev)
    xmin, ymin, dx, dy = (float(v) for v in _params(domain, nx, ny))
    out = torch.empty((ny, nx), dtype=torch.float32, device=dev)
    _launch("dwell", dev, out.data_ptr(), int(nx), int(ny), xmin, ymin, dx, dy,
            int(max_iter))
    return out


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
