"""Fourier boundary spectra, decay-exponent fits, bootstrap CIs, kernel spectra
(port of ``cmtci/stats/spectral.py``).

Reference behaviour:
  * angle-order about the centroid, complex FFT of the centered signal,
    normalized magnitude, low-mode IFFT reconstructions —
    spatial_stats_phase4.py:8-78
  * amplitude decay-exponent fits over fixed log-frequency ranges
    (LinearRegression slope + R²) — spectral_decay_exponent.py:39-75
  * power-spectrum slope with a 200-resample bootstrap 95% CI —
    phase4b_spectral_bootstrap.py:10-56
  * kernel-eigenvalue spectral distance (dense Gaussian kernel, top-K
    eigenvalues, L2/sqrt(K)) — tci_construct_mandelbrot_v002_fixed.py:110-118

The FFTs and the least-squares fits are numpy, copied unchanged. The
bootstrap is one batch of closed-form fits on the device over an index
matrix drawn on the host from np.random.default_rng(seed): the CPU run and
the card run use the same indices. The reference draws them from
jax.random.randint(PRNGKey(seed)), which the port cannot reproduce, so its CI
ends agree with the reference's statistically, not bitwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device


def order_points_by_angle(points):
    """Sort by angle about the centroid (spatial_stats_phase4.py:9-13)."""
    xy = _xy(points)
    c = xy.mean(axis=0)
    ang = np.arctan2(xy[:, 1] - c[1], xy[:, 0] - c[0])
    return xy[np.argsort(ang)]


def boundary_fft(points, order: bool = True):
    """Centered complex-signal FFT. Returns (freqs, fft_coeffs)."""
    xy = order_points_by_angle(points) if order else _xy(points)
    z = xy[:, 0] + 1j * xy[:, 1]
    f = np.fft.fft(z - z.mean())
    return np.fft.fftfreq(len(f)), f


def amplitude_spectrum(points, order: bool = True):
    """Positive-frequency normalized |FFT| (spectral_decay_exponent.py:24-37)."""
    freqs, f = boundary_fft(points, order)
    m = freqs > 0
    amp = np.abs(f[m])
    return freqs[m], amp / amp.max()


def power_spectrum(points):
    """Positive-frequency normalized |FFT|² (phase4b_spectral_bootstrap.py:9-16).

    NOTE: phase4b does NOT angle-order its inputs (it FFTs file order).
    """
    xy = _xy(points)
    z = xy[:, 0] + 1j * xy[:, 1]
    spec = np.abs(np.fft.fft(z)) ** 2
    freqs = np.fft.fftfreq(len(z))
    m = freqs > 0
    return freqs[m], spec[m] / spec[m].max()


def reconstruct_low_modes(fft_coeffs, n_modes: int):
    """Low-mode IFFT reconstruction (spatial_stats_phase4.py:62-67).

    n_modes=1 keeps only the DC coefficient (the reference's slice
    coeffs[-0:] would silently copy everything).
    """
    coeffs = np.zeros_like(fft_coeffs, dtype=complex)
    coeffs[:n_modes] = fft_coeffs[:n_modes]
    if n_modes > 1:
        coeffs[-n_modes + 1 :] = fft_coeffs[-n_modes + 1 :]
    return np.fft.ifft(coeffs)


def _ols_slope_r2(x, y):
    """Plain least-squares slope/intercept/R² (== sklearn LinearRegression)."""
    xm, ym = x.mean(), y.mean()
    vx = ((x - xm) ** 2).sum()
    slope = (((x - xm) * (y - ym)).sum()) / vx
    intercept = ym - slope * xm
    resid = y - (slope * x + intercept)
    ss_res = (resid**2).sum()
    ss_tot = ((y - ym) ** 2).sum()
    return slope, intercept, 1.0 - ss_res / ss_tot


def fit_decay_exponent(freqs, spectrum, fmin: float, fmax: float):
    """Log-log slope + R² over [fmin, fmax] (spectral_decay_exponent.py:47-56).

    Returns (slope, r2, n_points) or None if fewer than 5 points in range.
    """
    m = (freqs >= fmin) & (freqs <= fmax)
    if m.sum() < 5:
        return None
    x = np.log10(freqs[m])
    y = np.log10(spectrum[m])
    slope, _, r2 = _ols_slope_r2(x, y)
    return float(slope), float(r2), int(m.sum())


def _bootstrap_slopes(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The least-squares slope of each resample: row b of the
    (n_bootstrap, n) index matrix `idx` picks (x[idx[b]], y[idx[b]])."""
    xs, ys = x[idx], y[idx]
    xc = xs - xs.mean(dim=1, keepdim=True)
    yc = ys - ys.mean(dim=1, keepdim=True)
    return (xc * yc).sum(dim=1) / (xc * xc).sum(dim=1)


def bootstrap_indices(n: int, n_bootstrap: int, seed: int) -> np.ndarray:
    """The (n_bootstrap, n) resample index matrix, drawn on the host."""
    return np.random.default_rng(seed).integers(0, n, size=(int(n_bootstrap), n))


def fit_slope_bootstrap(freqs, spectrum, fmin: float, fmax: float,
                        n_bootstrap: int = 200, seed: int = 0, device="cuda"):
    """Slope, R², and bootstrap 95% CI (phase4b_spectral_bootstrap.py:18-37).

    The resamples are one batch of f64 fits on `device` over the index
    matrix of bootstrap_indices(n, n_bootstrap, seed).
    """
    dev = resolve_device(device)
    m = (freqs >= fmin) & (freqs <= fmax)
    if m.sum() < 2:  # an empty or one-point range: NaNs in the tuple's shape
        nan = float("nan")
        return nan, nan, (nan, nan)
    x = np.log10(freqs[m])
    y = np.log10(spectrum[m])
    slope, _, r2 = _ols_slope_r2(x, y)
    idx = torch.as_tensor(bootstrap_indices(len(x), n_bootstrap, seed), device=dev)
    slopes = _bootstrap_slopes(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
                               idx).cpu().numpy()
    # a resample can draw all-identical x on very short ranges -> nan slope
    lo, hi = np.nanpercentile(slopes, [2.5, 97.5])
    return float(slope), float(r2), (float(lo), float(hi))


def _kernel_eigs(xy, sigma: float, top_k: int):
    dx = xy[:, 0, None] - xy[None, :, 0]
    dy = xy[:, 1, None] - xy[None, :, 1]
    k = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    return torch.linalg.eigvalsh(k)[-top_k:]  # ascending


def spectral_distance(x, y, top_k: int = 30, sigma: float = 0.05, device="cuda") -> float:
    """||top-K eigenvalues of K(x) - those of K(y)|| / sqrt(K), f64.

    The reference takes nonsymmetric eigenvalues of the symmetric kernel and
    sorts their real parts, which is the same spectrum; like ``cmtci`` this
    uses the symmetric solver, in f64, on the caller's device.
    """
    dev = resolve_device(device)
    ax = torch.as_tensor(_xy(x), dtype=torch.float64, device=dev)
    by = torch.as_tensor(_xy(y), dtype=torch.float64, device=dev)
    w1 = _kernel_eigs(ax, sigma, top_k)
    w2 = _kernel_eigs(by, sigma, top_k)
    return float(torch.linalg.norm(w1 - w2) / math.sqrt(top_k))
