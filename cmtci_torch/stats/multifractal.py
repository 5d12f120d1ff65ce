"""Multifractal box-counting spectrum D(q), tau(q), f(alpha) (port of
``cmtci/stats/multifractal.py``).

Reference: multifractal_phase6.py:41-122 — box partition via integer keys,
Z(q, eps) partition sums over a q grid excluding q=1, tau(q) = slope of
log Z vs log eps, D(q) = tau/(q-1), Legendre alpha = dtau/dq,
f(alpha) = q*alpha - tau. backend="host" is the reference's integer-key
grouping in numpy (copied unchanged). backend="device" keys the points by
box on the device, counts each key with torch.unique and forms the partition
sums of every scale and q there, in log-sum-exp form.

The reference's device grid is a fixed dense 2048² so that XLA compiles one
static shape, and it raises when the cloud does not fit. Here grid=None
sizes the grid from the data, floor(range / min_eps) + 2 boxes a side, and
only the non-empty boxes are held, so a wide cloud costs no more memory than
a narrow one; an explicit grid that is too small still raises.
"""

from __future__ import annotations

from math import isclose

import numpy as np
import torch

from cmtci_torch.utils.device import resolve_device


def default_q_values():
    q = np.concatenate((np.linspace(-5, -1, 5), np.linspace(-0.8, 0.8, 9), np.linspace(1, 5, 5)))
    return np.array([v for v in q if not isclose(v, 1.0)])


def default_scales():
    return np.logspace(np.log10(0.002), np.log10(0.5), 12)


def box_counts(points, eps: float):
    """Counts per non-empty box of size eps (multifractal_phase6.py:41-56)."""
    pts = np.asarray(points, dtype=float)
    ix = np.floor((pts[:, 0] - pts[:, 0].min()) / eps).astype(np.int64)
    iy = np.floor((pts[:, 1] - pts[:, 1].min()) / eps).astype(np.int64)
    keys = ix * (10**9) + iy
    _, counts = np.unique(keys, return_counts=True)
    return counts


def _z_device(x: torch.Tensor, y: torch.Tensor, scales: torch.Tensor,
              q_values: torch.Tensor, grid: int):
    """(log Z(q, eps) as a (n_q, n_scales) tensor, non-empty boxes per scale).

    Per scale, the boxes of multifractal_phase6.py:41-56 (the floor of the
    shifted coordinates over eps) are keyed ix * grid + iy and counted with
    one int64 torch.unique, the host's np.unique grouping: the memory goes
    with the number of points, not with the grid's area, so a cloud whose
    extent is many thousand smallest boxes wide needs no more than a narrow
    one. Then log sum p^q over the non-empty boxes for every q, in
    log-sum-exp form: a raw f32 sum p^q overflows for q = -5 on clouds of
    millions of points (a singleton box contributes n^5). The counts are
    exact at any size. Requires floor(range/eps) <= grid - 1 boxes;
    box_counts_grid_device checks that.
    """
    xmin, ymin = x.min(), y.min()
    n = x.shape[0]
    log_n = torch.log(torch.tensor(float(n), dtype=x.dtype, device=x.device))
    logz, nonempty = [], []
    for eps in scales:
        ix = torch.clamp(torch.floor((x - xmin) / eps).to(torch.int64), 0, grid - 1)
        iy = torch.clamp(torch.floor((y - ymin) / eps).to(torch.int64), 0, grid - 1)
        cnt = torch.unique(ix * grid + iy, return_counts=True)[1].to(x.dtype)
        logp = torch.log(cnt) - log_n
        t = q_values[:, None] * logp[None, :]
        m = t.max(dim=1, keepdim=True).values
        lse = m[:, 0] + torch.log(torch.exp(t - m).sum(dim=1))
        logz.append(torch.where(q_values == 0, torch.log(torch.tensor(
            float(cnt.numel()), dtype=x.dtype, device=x.device)), lse))
        nonempty.append(cnt.numel())
    return torch.stack(logz, dim=1), nonempty


def box_counts_grid_device(points, scales, q_values, grid: int | None = None,
                           dtype=torch.float64, device="cuda"):
    """(Z, nonempty) for all (q, eps) from the device box counts, in `dtype`
    on `device`; Z is exponentiated from log Z in f64 on the host."""
    pts = np.asarray(points)
    if np.iscomplexobj(pts):
        pts = np.column_stack([pts.real.ravel(), pts.imag.ravel()])
    pts = np.asarray(pts, dtype=float)
    rng_x = pts[:, 0].max() - pts[:, 0].min()
    rng_y = pts[:, 1].max() - pts[:, 1].min()
    min_eps = float(np.min(scales))
    need = max(rng_x, rng_y) / min_eps
    # the max-coordinate point lands at index floor(range/eps), its own box
    # in the host partition, so the grid needs floor(need)+1 boxes; one more
    # absorbs f32 index rounding at the edge
    if grid is None:
        grid = int(np.floor(need)) + 2
        if grid > 3_000_000_000:  # the keys ix * grid + iy must fit in int64
            raise ValueError(f"eps={min_eps:g} over range {max(rng_x, rng_y):g} gives "
                             f"{grid} boxes a side, beyond the int64 box keys")
    elif need >= grid - 1:
        raise ValueError(
            f"device grid {grid} too small for eps={min_eps:g} over range "
            f"{max(rng_x, rng_y):g} (needs ≥{int(np.ceil(need)) + 2}); raise "
            "grid= or drop the smallest scales")
    dev = resolve_device(device)
    logz, nonempty = _z_device(torch.as_tensor(pts[:, 0], dtype=dtype, device=dev),
                               torch.as_tensor(pts[:, 1], dtype=dtype, device=dev),
                               torch.as_tensor(np.asarray(scales), dtype=dtype, device=dev),
                               torch.as_tensor(np.asarray(q_values), dtype=dtype, device=dev),
                               int(grid))
    return np.exp(logz.cpu().numpy().astype(np.float64)), np.asarray(nonempty)


def multifractal_spectrum(points, q_values=None, scales=None, min_count_boxes: int = 5,
                          backend: str = "host", grid: int | None = None,
                          dtype=torch.float64, device="cuda"):
    """Full multifractal analysis; returns dict(q, tau, Dq, alpha, f_alpha, scales, Z).

    backend="device" computes the box counts and partition sums in `dtype`
    on `device`; "host" is the reference-parity integer-key grouping."""
    pts = np.asarray(points)  # complex check BEFORE the float cast (which
    if np.iscomplexobj(pts):  # would silently drop the imaginary part)
        pts = np.column_stack([pts.real.ravel(), pts.imag.ravel()])
    pts = np.asarray(pts, dtype=float)
    q_values = default_q_values() if q_values is None else np.asarray(q_values, dtype=float)
    scales = default_scales() if scales is None else np.asarray(scales, dtype=float)

    z = np.zeros((len(q_values), len(scales)))
    valid = np.zeros(len(scales), dtype=bool)
    if backend == "device":
        z, nonempty = box_counts_grid_device(pts, scales, q_values, grid, dtype, device)
        valid = nonempty >= min_count_boxes
        z[:, ~valid] = np.nan
    elif backend != "host":
        raise ValueError(f"unknown backend '{backend}'")
    else:
        for j, eps in enumerate(scales):
            counts = box_counts(pts, eps)
            if len(counts) < min_count_boxes:
                z[:, j] = np.nan
                continue
            valid[j] = True
            ps = counts / counts.sum()
            for i, q in enumerate(q_values):
                z[i, j] = ps.size if q == 0 else np.sum(ps**q)

    log_eps = np.log(scales[valid])
    tau = np.full(len(q_values), np.nan)
    dq = np.full(len(q_values), np.nan)
    for i, q in enumerate(q_values):
        y = np.log(z[i, valid])
        if np.any(np.isfinite(y)):
            a = np.vstack([log_eps, np.ones_like(log_eps)]).T
            m, _ = np.linalg.lstsq(a, y, rcond=None)[0]
            tau[i] = m
            dq[i] = m / (q - 1) if not isclose(q, 1.0) else np.nan

    alpha = np.gradient(tau, q_values, edge_order=2)
    f_alpha = q_values * alpha - tau
    return {"q": q_values, "tau": tau, "Dq": dq, "alpha": alpha,
            "f_alpha": f_alpha, "scales": scales, "Z": z}
