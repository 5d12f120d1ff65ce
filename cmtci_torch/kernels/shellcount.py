"""Shell counts of a cloud's pairs: the ``csrc/shellcount.cu`` kernel, its
plain twin and the wrapper.

``shell_counts`` is the int64 histogram of the distances of the pairs (i, j),
j > i, i in a row range, of an (N, 2) cloud into the shells edges[k] <= d <
edges[k + 1], k < nbins; a distance at or past the last edge counts nowhere.
The twin, ``shell_counts_torch``, is the blocked torch chain (dx, dy, d =
sqrt(dx * dx + dy * dy), bucketize and bincount over blocks of rows). The
kernel takes no square root: it counts the thresholds tau[k] <= d^2
(``thresholds``), which equals the chain's bin bitwise because the correctly
rounded square root is monotone.

Given a CPU tensor the wrapper runs the twin; given a CUDA tensor it launches
the kernel (one launch for the whole row range) or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmtci_torch.kernels._launch import launch
from cmtci_torch.stats.variogram import masked_bin_reduce

#: rows a thread of shellcount.cu holds (kRowsPerThread)
ROWS_PER_THREAD = 4
#: threads a CTA, when the counters fit
THREADS = 256
#: columns a CTA meets: the unit of work is a tile of rows against this many
#: columns, so that every unit is one size but a tile's last (on an H100,
#: 1,024 ran 1.5% faster than 2,048 and 5% faster than 4,096 on the pair
#: cell's clouds)
COLS_PER_CTA = 1024
#: the most shared memory a CTA's counters take: (nbins + 2) slots of 32
#: bits a thread; more shells take fewer threads, down to one warp
COUNTER_BYTES = 128 * 1024
#: the largest cloud the kernel's int indices take
MAX_POINTS = 2**30
#: the most pairs one CTA may count: its counters are 32-bit
MAX_CTA_PAIRS = 2**31 - 1


class Plan(NamedTuple):
    threads: int  # a CTA
    tile: int  # rows a CTA
    cols: int  # columns a CTA
    ctas: int  # units of the launch
    distances: int  # d^2 the kernel computes, the masked ones of the diagonal units included


def launch_plan(n: int, rows, nbins: int, cols: int = COLS_PER_CTA) -> Plan:
    """shellcount.cu's launch for n points, rows (lo, hi) and nbins shells:
    tile a's rows [lo + a * tile, min(lo + (a + 1) * tile, hi)) meet the
    columns from the tile's first row to n in units of `cols`. Raises
    ValueError when the counters of nbins shells do not fit one warp's share
    of COUNTER_BYTES or when a CTA's rows x columns could pass MAX_CTA_PAIRS."""
    slots = nbins + 2
    threads = min(THREADS, COUNTER_BYTES // (4 * slots) // 32 * 32)
    if nbins < 1 or threads < 32:
        raise ValueError(f"{nbins} shells: the kernel takes 1 to "
                         f"{COUNTER_BYTES // (4 * 32) - 2}")
    tile = threads * ROWS_PER_THREAD
    if cols < 1 or tile * cols > MAX_CTA_PAIRS:
        raise ValueError(f"{tile} rows x {cols} columns a CTA could pass the "
                         f"{MAX_CTA_PAIRS} pairs its 32-bit counters hold")
    lo, hi = rows
    first = np.arange(lo, hi, tile, dtype=np.int64)
    meet = n - first
    ctas = int(((meet + cols - 1) // cols).sum())
    distances = int(((np.minimum(first + tile, hi) - first) * meet).sum())
    return Plan(threads, tile, cols, ctas, distances)


def thresholds(edges) -> np.ndarray:
    """tau[k], in edges' dtype (float32 or float64): the least non-negative
    value whose correctly rounded square root is >= edges[k], found by a
    search over the dtype's bit patterns (0 for an edge <= 0). For s >= 0,
    sqrt(s) >= edges[k] exactly when s >= tau[k], so the number of tau[k] <= s
    is bucketize(sqrt(s), edges, right=True)."""
    e = np.ascontiguousarray(edges)
    if e.dtype not in (np.float32, np.float64) or not np.all(np.isfinite(e)):
        raise ValueError(f"edges must be finite float32 or float64, got {e.dtype}")
    ut = np.uint32 if e.dtype == np.float32 else np.uint64
    lo = np.zeros(e.shape, dtype=ut)
    hi = np.full(e.shape, np.array(np.inf, dtype=e.dtype).view(ut), dtype=ut)
    while np.any(lo < hi):
        mid = lo + (hi - lo) // ut(2)
        ok = np.sqrt(mid.view(e.dtype)) >= e
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid + ut(1))
    return hi.view(e.dtype)


def check_inputs(xy: torch.Tensor, edges: torch.Tensor, nbins: int, rows=None) -> tuple:
    """(lo, hi, the edges as a host array), or ValueError: xy a contiguous
    (N, 2) float32 or float64 tensor, edges nbins + 1 finite, ascending
    values of its dtype on its device, rows (lo, hi) with 0 <= lo <= hi <=
    N."""
    if xy.dtype not in (torch.float32, torch.float64) or xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError(f"xy must be (N, 2) float32 or float64, got {tuple(xy.shape)} "
                         f"{xy.dtype}")
    if not xy.is_contiguous():
        raise ValueError("xy must be contiguous")
    if (edges.dtype != xy.dtype or edges.device != xy.device
            or tuple(edges.shape) != (nbins + 1,)):
        raise ValueError(f"edges must be ({nbins + 1},) {xy.dtype} on {xy.device}, got "
                         f"{tuple(edges.shape)} {edges.dtype} on {edges.device}")
    e = edges.cpu().numpy()
    if not np.all(np.isfinite(e)) or np.any(e[1:] < e[:-1]):
        raise ValueError("edges must be finite and ascending")
    lo, hi = (0, xy.shape[0]) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= lo <= hi <= xy.shape[0]:
        raise ValueError(f"rows ({lo}, {hi}) outside [0, {xy.shape[0]}]")
    return lo, hi, e


def shell_counts_torch(xy, edges, nbins: int, chunk: int = 1024, rows=None, count=None):
    """Plain-torch twin of shellcount.cu (the port's blocked chain): a block
    of `chunk` rows meets the columns from its first row on. `count`, a
    callable (name, n), takes ``spatial_stats.distances``: rows x columns of
    each block, its masked entries included."""
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
        counts += masked_bin_reduce(d, valid, edges, nbins)
    return counts


def device_inputs(xy: torch.Tensor, e: np.ndarray, nbins: int, lo: int, hi: int):
    """shellcount.cu's inputs for a CUDA xy and the host edges `e`, as
    check_inputs passed them: (the launch's arguments before the stream, the
    zeroed counts, the plan, the tau table the arguments point into, which
    the caller holds until it has launched)."""
    n = xy.shape[0]
    if n > MAX_POINTS or xy.data_ptr() % (2 * xy.element_size()):
        raise ValueError(f"the kernel takes at most {MAX_POINTS} points, aligned to a point")
    plan = launch_plan(n, (lo, hi), nbins)
    tau = torch.as_tensor(thresholds(e), device=xy.device)
    span = float(e[-1]) - float(e[0])
    counts = torch.zeros(nbins, dtype=torch.int64, device=xy.device)
    args = (xy.data_ptr(), n, lo, hi, tau.data_ptr(), nbins, float(e[0]),
            nbins / span if span > 0 else 0.0, plan.threads, plan.cols, plan.ctas,
            int(xy.dtype == torch.float64), counts.data_ptr())
    return args, counts, plan, tau


def shell_counts(xy: torch.Tensor, edges: torch.Tensor, nbins: int, rows=None,
                 chunk: int = 1024, count=None) -> torch.Tensor:
    """int64 shell counts (nbins,) of the pairs j > i, i in rows = (lo, hi)
    (default all), of xy on its device (CUDA: one shellcount.cu launch; CPU:
    the twin with blocks of `chunk` rows). `count`, a callable (name, n),
    takes ``spatial_stats.distances``: the d^2 the launch computes (rows x
    columns of every unit, launch_plan) or the twin's blocks evaluate.
    Raises ValueError on inputs check_inputs or the plan refuses."""
    lo, hi, e = check_inputs(xy, edges, nbins, rows)
    if xy.device.type == "cpu":
        return shell_counts_torch(xy, edges, nbins, chunk, (lo, hi), count)
    args, counts, plan, _tau = device_inputs(xy, e, nbins, lo, hi)
    if count is not None:
        count("spatial_stats.distances", plan.distances)
    if plan.ctas:
        launch("shellcount", xy.device, *args)
    return counts
