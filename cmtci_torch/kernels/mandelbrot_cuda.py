"""K1, the TCI distance-estimator kernel, with its plain twin and wrappers.

Port of the K1 part of ``cmtci/kernels/mandelbrot_pallas.py``
(``_tci_kernel`` and its hosts ``tci_de_field_pallas``,
``_tci_selection_core``, ``_tci_sample_padded``, ``tci_boundary_sample``,
``tci_boundary_selection``). The kernel is ``csrc/tci_de.cu``, built with
nvcc and called through ctypes (``_build.py``).

A wrapper given a CPU device runs the plain twin ``tci_de_field_torch``;
given a CUDA device it launches the kernel or raises. Nothing falls back.
The q25 band and the subsample around the kernel are plain torch on the
same device, as the reference left them to XLA.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cmtci_torch.utils.device import resolve_device

#: kernel launches of tci_de (one per grid); read and reset by callers that
#: need to show a run went through the kernel
launches = 0

_LIB_NAME = "tci_de"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p]


def _params(domain, grid_n: int) -> np.ndarray:
    """f32 (xmin, ymin, dx, dy): spacings computed in f64 on the host, then
    cast, as the reference's wrappers do."""
    xmin, xmax, ymin, ymax = domain
    dx = (xmax - xmin) / (grid_n - 1)
    dy = (ymax - ymin) / (grid_n - 1)
    return np.asarray([xmin, ymin, dx, dy], dtype=np.float32)


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
    p = torch.as_tensor(_params(domain, grid_n), device=dev)
    xmin, ymin, dx, dy = p[0], p[1], p[2], p[3]
    idx = torch.arange(grid_n, dtype=f32, device=dev)
    cr = (xmin + idx * dx)[None, :].expand(grid_n, grid_n)
    ci = (ymin + idx * dy)[:, None].expand(grid_n, grid_n)

    xm = cr - 0.25
    q = xm * xm + ci * ci
    in_cardioid = q * (q + xm) <= 0.25 * ci * ci - 1e-5
    xp = cr + 1.0
    # the reference folds 0.0625 - 1e-5 in double and compares in f32
    in_bulb = xp * xp + ci * ci <= float(np.float32(0.0625 - 1e-5))
    active = ~(in_cardioid | in_bulb)

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
    global launches
    if dev.type == "cpu":
        return tci_de_field_torch(domain, grid_n, max_iter, escape_r, device=dev)
    if grid_n < 2:
        raise ValueError(f"grid_n must be >= 2, got {grid_n}")
    from cmtci_torch.kernels._build import library

    lib = library(_LIB_NAME)
    fn = lib.tci_de_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    xmin, ymin, dx, dy = (float(v) for v in _params(domain, grid_n))
    r2 = float(np.float32(escape_r * escape_r))
    with torch.cuda.device(dev):
        out = torch.empty((grid_n, grid_n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(out.data_ptr(), int(grid_n), xmin, ymin, dx, dy, int(max_iter), r2, stream)
    if rc != 0:
        raise RuntimeError(f"tci_de kernel launch failed: cudaError {rc}")
    launches += 1
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
