"""Mandelbrot TCI distance-estimator field and the boundary-band sampler.

Port of the tracker subset of ``cmtci/kernels/mandelbrot.py``. Complex
values are (re, im) tensor pairs, and the op order is the reference's
(``de_field_tci``: dz is updated BEFORE z each step, z is latched at the
first |z| > escape_r, dz is not latched and overflows to inf for early
escapers, so d == 0 there).

Grids are built from ``np.linspace`` — the oracle's grid. ``jnp.linspace``
and ``torch.linspace`` each differ from it in the last ulp, and a grid node
that moves by an ulp can flip a borderline escape.
"""

from __future__ import annotations

import numpy as np
import torch

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


def de_field_tci(cr, ci, max_iter: int = 250, escape_r: float = 250.0,
                 eps: float = 1e-12):
    """TCI distance estimator (tci_construct_mandelbrot_v002_fixed.py:35-47)
    on the tensors' device and dtype. Returns (esc, d, last_r, last_i)."""
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
                             dtype=torch.float64, impl: str = "torch", device="cuda"):
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
    """
    if impl not in SAMPLE_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {SAMPLE_IMPLS}")
    if impl == "cuda":
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
