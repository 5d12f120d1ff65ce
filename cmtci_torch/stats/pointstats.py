"""Point-cloud spatial statistics: g(r), Ripley K, Hausdorff, box counting
(port of ``cmtci/stats/pointstats.py``).

Reference behaviour (blocked over rows: O(chunk·n) memory, never the n x n
matrix):
  * pair correlation and Ripley K with bbox-area density normalization
    (spatial_stats_phase2.py:9-47)
  * Hausdorff = max of the two directed distances
    (spatial_stats_phase3.py:10-15, tci_construct_mandelbrot_v002_fixed.py:97-98)
  * box-counting fractal dimension over 10 logspaced relative scales
    (spatial_stats_phase3.py:41-55), the boxes counted on the device by
    ``csrc/boxcount.cu`` (kernels/boxcount.py) with the reference's f64 keys

The pair histogram keeps exact int64 counts in either dtype, so it has no
pair-count ceiling; the reference's masked int32 (hi, lo) head and its block
sizing served TPU scatter-adds and int32 counters and have no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.kernels import boxcount
from cmtci_torch.stats.variogram import masked_bin_reduce
from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device


def _pair_hist(xy, r_edges, nbins: int, chunk: int = 1024, rows=None, count=None):
    """int64 histogram of the upper-triangle pairwise distances of xy into
    the r_edges bins (bin k holds r_edges[k] <= d < r_edges[k+1]; values
    >= the last edge are dropped, matching the reference's shell masks). A
    block of rows meets only the columns from its first row on. rows =
    (lo, hi) restricts the pairs to first indices in [lo, hi). `count`, a
    callable (name, n), takes ``spatial_stats.distances``: the distances a
    block evaluates, its masked entries included, from the shapes alone."""
    counts = torch.zeros(nbins, dtype=torch.int64, device=xy.device)
    local = torch.arange(xy.shape[0], device=xy.device)
    lo, hi = (0, xy.shape[0]) if rows is None else rows
    for i in range(lo, hi, chunk):
        blk, rest = xy[i : min(i + chunk, hi)], xy[i:]
        if count is not None:
            count("spatial_stats.distances", blk.shape[0] * rest.shape[0])
        dx = blk[:, 0, None] - rest[None, :, 0]
        dy = blk[:, 1, None] - rest[None, :, 1]
        d = torch.sqrt(dx * dx + dy * dy)
        valid = local[None, : rest.shape[0]] > local[: blk.shape[0], None]
        counts += masked_bin_reduce(d, valid, r_edges, nbins)
    return counts


def _shell_counts(points, r_max: float, dr: float, dtype=torch.float64, device="cuda",
                  mesh=None, count=None):
    """(r_vals, shell counts over [r, r+dr), n, rho): one O(N^2) pass shared
    by g(r) and Ripley K, in `dtype` on `device`. The counts are exact in
    either dtype; f32 distances can land a borderline pair one bin over
    against f64. With a `mesh` the pass shards its i-rows over the ranks
    (parallel.sharded.sharded_shell_counts), on the ranks' devices. `count`,
    a callable (name, n), takes ``spatial_stats.distances`` (``_pair_hist``)
    and ``spatial_stats.in_shells``, the pairs counted in a shell; the
    sharded pass counts nothing."""
    if mesh is not None:
        from cmtci_torch.parallel.sharded import sharded_shell_counts

        return sharded_shell_counts(points, r_max, dr, mesh, dtype=dtype)
    dev = resolve_device(device)
    xy = _xy(points)
    n = len(xy)
    area = (xy[:, 0].max() - xy[:, 0].min()) * (xy[:, 1].max() - xy[:, 1].min())
    rho = n / area
    r_vals = np.arange(0, r_max, dr)
    edges = torch.as_tensor(np.concatenate([r_vals, [r_vals[-1] + dr]]), dtype=dtype,
                            device=dev)
    counts = _pair_hist(torch.as_tensor(xy, dtype=dtype, device=dev), edges, len(r_vals),
                        count=count)
    counts = counts.cpu().numpy()
    if count is not None:
        count("spatial_stats.in_shells", int(counts.sum()))
    return r_vals, counts.astype(np.float64), n, rho


def pair_correlation(points, r_max: float, dr: float, _shells=None, device="cuda"):
    """g(r) per spatial_stats_phase2.py:9-31 (shells [r, r+dr))."""
    r_vals, counts, n, rho = _shells or _shell_counts(points, r_max, dr, device=device)
    norm = 2 * np.pi * r_vals * dr * n * rho
    g = np.where(norm > 0, counts / np.where(norm > 0, norm, 1.0), 0.0)
    return r_vals, g


def ripley_k(points, r_max: float, dr: float, _shells=None, device="cuda"):
    """K(r) per spatial_stats_phase2.py:33-47 (cumulative count < r).

    count(d < k*dr) = cumulative sum of the shells below k: the same
    histogram as pair_correlation, shifted by one bin.
    """
    r_vals, counts, n, rho = _shells or _shell_counts(points, r_max, dr, device=device)
    below = np.concatenate([[0.0], np.cumsum(counts)[:-1]])  # pairs with d < r
    return r_vals, (2.0 * below) / (n * rho)


def _directed_hausdorff(a, b, chunk: int = 1024):
    """max_i min_j |a_i - b_j| (0-dim tensor): squared distances dx*dx + dy*dy
    per block of rows of a, the square root once at the end."""
    best = torch.full((), float("-inf"), dtype=a.dtype, device=a.device)
    for i in range(0, a.shape[0], chunk):
        blk = a[i : i + chunk]
        dx = blk[:, 0, None] - b[None, :, 0]
        dy = blk[:, 1, None] - b[None, :, 1]
        best = torch.maximum(best, torch.min(dx * dx + dy * dy, dim=1).values.max())
    return torch.sqrt(best)


def hausdorff(a, b, dtype=torch.float64, device="cuda") -> float:
    """Symmetric Hausdorff distance of two clouds (complex or (N, 2)), exact
    (equals scipy's directed pair), in `dtype` on `device`."""
    dev = resolve_device(device)
    a = torch.as_tensor(_xy(a), dtype=dtype, device=dev)
    b = torch.as_tensor(_xy(b), dtype=dtype, device=dev)
    return float(torch.maximum(_directed_hausdorff(a, b), _directed_hausdorff(b, a)))


def fractal_dimensions(clouds, scales=None, device="cuda", count=None) -> list:
    """Box-counting dimension of each cloud (spatial_stats_phase3.py:41-55):
    a list of (slope, (log(1/scales), log(N))), one a cloud.

    mins and rng (each column's extremes, boxcount.extent), each scale's
    step = rng * s and the fit are the reference's numpy values. The occupied boxes come from kernels.boxcount.box_counts on
    `device` (CUDA: one boxcount.cu launch for every cloud and scale; CPU:
    its twin), keyed in f64 as the reference keys them, so the counts are
    its counts. A cloud whose extent along an axis is zero or not finite
    keeps the reference's host lines. `count`, a callable (name, n), takes
    ``spatial_stats.box_scales_card``: the (cloud, scale) counts the kernel
    made (none on the CPU or the host lines)."""
    dev = resolve_device(device)
    if scales is None:
        scales = np.logspace(-2, 0, 10, base=10.0)
    xys = [_xy(p) for p in clouds]
    ends = [boxcount.extent(xy) for xy in xys]
    mins = [lo for lo, _ in ends]
    rngs = [hi - lo for lo, hi in ends]
    keyed = [i for i, rng in enumerate(rngs) if np.all(np.isfinite(rng) & (rng > 0))]
    n_boxes = {}
    if keyed:
        col = np.asarray(scales, dtype=np.float64)[:, None]
        counts, _ = boxcount.box_counts([xys[i] for i in keyed], [mins[i] for i in keyed],
                                        [rngs[i] * col for i in keyed],
                                        boxcount.box_layout(scales), device=dev)
        n_boxes.update(zip(keyed, counts.cpu().tolist()))
        if count is not None and dev.type == "cuda":
            count("spatial_stats.box_scales_card", counts.numel())
    out = []
    for i, (xy, lo, rng) in enumerate(zip(xys, mins, rngs)):
        if i not in n_boxes:
            n_boxes[i] = []
            for s in scales:
                step = rng * s
                grid = np.floor((xy - lo) / step).astype(int)
                n_boxes[i].append(len(np.unique(grid, axis=0)))
        coeffs = np.polyfit(np.log(1 / scales), np.log(n_boxes[i]), 1)
        out.append((coeffs[0], (np.log(1 / scales), np.log(n_boxes[i]))))
    return out


def fractal_dimension(points, scales=None, device="cuda", count=None):
    """Box-counting dimension of one cloud (fractal_dimensions): returns
    (slope, (log(1/scales), log(N)))."""
    return fractal_dimensions([points], scales, device=device, count=count)[0]
