"""Kernel-eigenvalue spectral distance (the TCI pipeline's subset of
``cmtci/stats/spectral.py``): dense Gaussian kernel, top-K eigenvalues,
L2 / sqrt(K) (tci_construct_mandelbrot_v002_fixed.py:110-118).

The reference takes nonsymmetric eigenvalues of the symmetric kernel and
sorts their real parts, which is the same spectrum; like ``cmtci`` this uses
the symmetric solver, in f64, on the caller's device (Hopper has native
f64; the reference pins the solve to the host CPU only because the TPU has
no f64 eigensolver).
"""

from __future__ import annotations

import math

import torch

from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device


def _kernel_eigs(xy, sigma: float, top_k: int):
    dx = xy[:, 0, None] - xy[None, :, 0]
    dy = xy[:, 1, None] - xy[None, :, 1]
    k = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    return torch.linalg.eigvalsh(k)[-top_k:]  # ascending


def spectral_distance(x, y, top_k: int = 30, sigma: float = 0.05, device="cuda") -> float:
    """||top-K eigenvalues of K(x) - those of K(y)|| / sqrt(K), f64."""
    dev = resolve_device(device)
    ax = torch.as_tensor(_xy(x), dtype=torch.float64, device=dev)
    by = torch.as_tensor(_xy(y), dtype=torch.float64, device=dev)
    w1 = _kernel_eigs(ax, sigma, top_k)
    w2 = _kernel_eigs(by, sigma, top_k)
    return float(torch.linalg.norm(w1 - w2) / math.sqrt(top_k))
