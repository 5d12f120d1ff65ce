"""Grid-field Laplacians and global/local correlation maps (port of
``cmtci/stats/fields.py``).

Reference:
  * 5-point roll Laplacian / h² — Laplacian_C-M.py:49-59,
    Iterative_Variogram_Laplacian.py:132-137
  * global Pearson r — Potentials.py:63-70
  * sliding-window local Pearson correlation map (half-window win, window
    slice [i-win:i+win] of size 2*win) — Potentials.py:77-95

The reference's double loop over pixels is box-filter moment sums (one pass
of cumulative sums), equal to the per-window Pearson r. The tensor functions
run in their input's dtype on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.utils.device import resolve_device


def laplacian5(u: torch.Tensor, h: float) -> torch.Tensor:
    """(-4u + roll sums)/h² with wraparound, matching np.roll semantics."""
    return (
        -4.0 * u
        + torch.roll(u, 1, dims=0) + torch.roll(u, -1, dims=0)
        + torch.roll(u, 1, dims=1) + torch.roll(u, -1, dims=1)
    ) / (h * h)


def pearson_global(a, b) -> float:
    a = np.asarray(a, dtype=float).ravel()
    b = np.asarray(b, dtype=float).ravel()
    m = ~(np.isnan(a) | np.isnan(b))
    a, b = a[m], b[m]
    am, bm = a.mean(), b.mean()
    return float(((a - am) * (b - bm)).sum() / np.sqrt(((a - am) ** 2).sum() * ((b - bm) ** 2).sum()))


def pearson_global_device(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pearson r over the jointly finite pixels as a 0-dim tensor on the
    device (the statistic of pearson_global, Potentials.py:63-70); means are
    subtracted before the products, so f32 sums do not cancel."""
    valid = torch.isfinite(a) & torch.isfinite(b)
    n = torch.clamp(valid.sum().to(a.dtype), min=1)
    a0 = torch.where(valid, a, 0.0)
    b0 = torch.where(valid, b, 0.0)
    ac = torch.where(valid, a0 - a0.sum() / n, 0.0)
    bc = torch.where(valid, b0 - b0.sum() / n, 0.0)
    return (ac * bc).sum() / torch.sqrt((ac * ac).sum() * (bc * bc).sum())


def _box_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """Sum over the window [i-win, i+win) x [j-win, j+win) per interior pixel."""
    c = torch.nn.functional.pad(torch.cumsum(torch.cumsum(x, dim=0), dim=1), (1, 0, 1, 0))
    ny, nx = x.shape
    i = torch.arange(win, ny - win, device=x.device)
    j = torch.arange(win, nx - win, device=x.device)
    top, bot, lef, rig = i - win, i + win, j - win, j + win
    return (c[bot][:, rig] - c[bot][:, lef] - c[top][:, rig] + c[top][:, lef])


def _local_corr(u1: torch.Tensor, u2: torch.Tensor, win: int) -> torch.Tensor:
    """The interior of the local correlation map, in u1's dtype.

    Per window, Pearson r over the jointly non-NaN pixels, like the
    reference's mask = ~(isnan(a)|isnan(b)) + pearsonr (Potentials.py:
    89-91); a window with <= 5 valid pixels stays NaN (":91 sum(mask) > 5").
    """
    valid = torch.isfinite(u1) & torch.isfinite(u2)
    a = torch.where(valid, u1, 0.0)
    b = torch.where(valid, u2, 0.0)
    n = _box_sum(valid.to(u1.dtype), win)
    ns = torch.clamp(n, min=1.0)
    s1 = _box_sum(a, win)
    s2 = _box_sum(b, win)
    s11 = _box_sum(a * a, win)
    s22 = _box_sum(b * b, win)
    s12 = _box_sum(a * b, win)
    cov = s12 - s1 * s2 / ns
    v1 = s11 - s1 * s1 / ns
    v2 = s22 - s2 * s2 / ns
    denom = torch.sqrt(torch.clamp(v1 * v2, min=0.0))
    return torch.where((n > 5) & (denom > 0), cov / denom, float("nan"))


def _local_corr_windows(u1: torch.Tensor, u2: torch.Tensor, win: int,
                        rows: int = 32) -> torch.Tensor:
    """The interior of the local correlation map by the per-window two-pass
    Pearson r (Potentials.py:89-91 itself), in u1's dtype, `rows` window
    rows at a time.

    For f32 fields: _local_corr's cumulative sums run over the whole grid,
    so at the coupling's 300² grid their corners carry an f32 rounding of
    the grid's total, and the moment differences s11 - s1²/n cancel where a
    window's variance is small against its mean; r then moves by up to 0.3.
    Here each window's mean is subtracted before its products are summed,
    so a window's r carries only its own pixels' rounding. The NaN gate is
    _local_corr's (<= 5 jointly finite pixels, or no variance).
    """
    valid = torch.isfinite(u1) & torch.isfinite(u2)
    a = torch.where(valid, u1, 0.0)
    b = torch.where(valid, u2, 0.0)
    v = valid.to(u1.dtype)
    ny, nx = u1.shape
    k = 2 * win
    out = []
    for r0 in range(0, max(ny - k, 0), rows):
        r1 = min(r0 + rows, ny - k)
        sl = slice(r0, r1 + k - 1)
        wa, wb, wv = (t[sl].unfold(0, k, 1).unfold(1, k, 1)[:, : nx - k]
                      for t in (a, b, v))
        n = wv.sum(dim=(-2, -1))
        ns = torch.clamp(n, min=1.0)[..., None, None]
        da = (wa - wa.sum(dim=(-2, -1))[..., None, None] / ns) * wv
        db = (wb - wb.sum(dim=(-2, -1))[..., None, None] / ns) * wv
        cov = (da * db).sum(dim=(-2, -1))
        denom = torch.sqrt((da * da).sum(dim=(-2, -1)) * (db * db).sum(dim=(-2, -1)))
        out.append(torch.where((n > 5) & (denom > 0), cov / denom, float("nan")))
    return torch.cat(out) if out else u1.new_empty((0, max(nx - k, 0)))


def framed(inner: np.ndarray, shape, win: int) -> np.ndarray:
    """The full (ny, nx) f64 map: NaN outside the valid frame, `inner` in it."""
    ny, nx = shape
    out = np.full((ny, nx), np.nan)
    out[win : ny - win, win : nx - win] = inner
    return out


def local_correlation(u1, u2, win: int = 15, device="cuda"):
    """Local Pearson map in f64 on `device` (Potentials.py:77-95), as a numpy
    array. NaN outside the valid frame and wherever a window has <= 5
    jointly non-NaN pixels."""
    dev = resolve_device(device)
    u1 = torch.as_tensor(np.asarray(u1), dtype=torch.float64, device=dev)
    u2 = torch.as_tensor(np.asarray(u2), dtype=torch.float64, device=dev)
    return framed(_local_corr(u1, u2, int(win)).cpu().numpy(), u1.shape, win)
