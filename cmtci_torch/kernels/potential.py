"""Logarithmic potential of a point cloud on a grid (blocked reduction).

Port of ``cmtci/kernels/potential.py``. Covers the reference's three
conventions:
  * U = +(1/N) sum log(|z-p| + eps), eps=1e-12   (Potentials.py:19-27)
  * U = -(1/N) sum log(|z-p| + eps), eps=1e-12   (Laplacian_C-M.py:16-24)
  * U = (1/N) sum log(1/(|z-p| + eps)), eps=1e-6
    (variograms_construct_mandelbrot.py:128-146)

The O(H·W·N) pairwise work is blocked over point chunks so memory stays
bounded (about five H x W x chunk temporaries). The grid's dtype is the
working dtype, f64 included: both run on the device the caller names. The
last chunk is simply shorter; the reference's zero-weight padding lanes only
kept its compiled loop at one shape.
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.utils.device import resolve_device


def cloud_log_potential(gx, gy, pts, eps: float = 1e-12, sign: int = 1, chunk: int = 2048,
                        device="cuda") -> torch.Tensor:
    """U(z) = sign * (1/N) sum log(|z-p_k| + eps) over the grid (gx, gy), as a
    tensor of the grid's shape and dtype on `device`.

    pts: complex array or (N, 2) real array. sign=+1 matches Potentials.py,
    sign=-1 the log(1/r) form of Laplacian_C-M.py and the variogram script
    (each term is log(1.0 / r), as there).
    """
    dev = resolve_device(device)
    pts = np.asarray(pts)
    if np.iscomplexobj(pts):
        px, py = pts.real.ravel(), pts.imag.ravel()
    else:
        px, py = pts[:, 0], pts[:, 1]
    gxt = torch.as_tensor(np.asarray(gx), device=dev)
    dt = gxt.dtype
    gyt = torch.as_tensor(np.asarray(gy), dtype=dt, device=dev)
    n = px.shape[0]
    u = torch.zeros_like(gxt)
    if n == 0:
        return u
    pxt = torch.as_tensor(np.ascontiguousarray(px), dtype=dt, device=dev)
    pyt = torch.as_tensor(np.ascontiguousarray(py), dtype=dt, device=dev)
    for i in range(0, n, chunk):
        dx = gxt[:, :, None] - pxt[None, None, i : i + chunk]
        dy = gyt[:, :, None] - pyt[None, None, i : i + chunk]
        r = torch.sqrt(dx * dx + dy * dy) + eps
        term = torch.log(r) if sign > 0 else torch.log(1.0 / r)
        u = u + term.sum(dim=-1)
    return u / n
