"""Box counts of point clouds: the ``csrc/boxcount.cu`` kernel, its plain
twin and the wrapper.

``box_counts`` counts the occupied boxes of each (cloud, scale): a point's box
is (floor((x - mins_x) / step_x), floor((y - mins_y) / step_y)) in f64, the
keys of the reference's ``np.unique`` rows (``cmtci/stats/pointstats.py:197``),
bitwise. Each scale's boxes are the bits of a W x W bitmap, W = floor(1/s) + 2
(``box_layout``): a cloud's keys run from 0 to floor(rng / step), about 1/s.
Subtraction and division are monotone, so the keys of a cloud's extreme
points bound all of its keys; the wrapper refuses a layout they overflow.

Given a CPU device the wrapper runs the twin; given a CUDA device it launches
the kernel (all clouds in one launch) or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from cmtci_torch.kernels._launch import launch
from cmtci_torch.utils.device import resolve_device

#: points a CTA of boxcount.cu keys (kPointsPerCta)
POINTS_PER_CTA = 2048
#: the most scales a call takes: the kernel keeps a table of 24 bytes a
#: scale in shared memory, whose 48 KB a launch takes without an opt-in
MAX_SCALES = 1024


def box_layout(scales) -> np.ndarray:
    """Bitmap side W_k = floor(1/s_k) + 2 of each scale (int64); the keys of
    a cloud at scale s run to floor(rng / (rng * s)), which rounds to at most
    floor(1/s) + 1."""
    s = np.asarray(scales, dtype=np.float64)
    if s.ndim != 1 or not len(s) or not np.all(np.isfinite(s) & (s > 0)):
        raise ValueError(f"scales must be finite and positive, got {scales!r}")
    return np.floor(1.0 / s).astype(np.int64) + 2


def extent(xy: np.ndarray) -> tuple:
    """(lo, hi): the smallest and the largest value of each column of an
    (N, 2) array, xy.min(axis=0) and xy.max(axis=0), taken a column at a time
    (numpy reduces a two-wide axis 0 about ten times slower)."""
    cols = np.ascontiguousarray(xy.T)
    return cols.min(axis=1), cols.max(axis=1)


def _offsets(widths: np.ndarray) -> np.ndarray:
    """Word offset of each scale's bitmap in a cloud's, and the total last."""
    return np.concatenate([[0], np.cumsum((widths * widths + 31) // 32)]).astype(np.int64)


def _check_keys(xys, mins, steps, widths) -> None:
    """Raise ValueError unless every key of every cloud lies in its bitmap:
    the keys of each axis's smallest and largest coordinate, which bound the
    rest, in [0, W)."""
    if not np.all(np.isfinite(steps) & (steps > 0)) or not np.all(np.isfinite(mins)):
        raise ValueError("box steps must be finite and positive, and mins finite")
    for c, xy in enumerate(xys):
        for end in extent(xy):
            keys = np.floor((end - mins[c]) / steps[c])  # (nscales, 2)
            if not np.all((keys >= 0) & (keys < widths[:, None])):
                raise ValueError(
                    f"cloud {c}: box keys {keys.tolist()} fall outside the bitmaps of "
                    f"sides {widths.tolist()}")


def box_counts_torch(xys, mins, steps, widths, device="cpu"):
    """Plain-torch twin of boxcount.cu: (counts (nclouds, nscales) int32,
    bitmaps (nclouds * words,) int32) on `device`, the bitmaps in the
    kernel's layout."""
    dev = resolve_device(device)
    offsets = _offsets(widths)
    base = torch.as_tensor(offsets[:-1] * 32, device=dev)[:, None]
    side = torch.as_tensor(widths, device=dev)[:, None]
    counts, bitmaps = [], []
    for c, xy in enumerate(xys):
        d = (torch.as_tensor(xy, dtype=torch.float64, device=dev)
             - torch.as_tensor(mins[c], dtype=torch.float64, device=dev))
        # the divisors as a tensor: CUDA divides by a host scalar as a
        # product with its reciprocal, which is not the IEEE quotient
        keys = torch.floor(d / torch.as_tensor(steps[c], dtype=torch.float64,
                                               device=dev)[:, None, :]).long()
        occupied = torch.zeros(int(offsets[-1]) * 32, dtype=torch.bool, device=dev)
        occupied[base + keys[..., 0] * side + keys[..., 1]] = True
        counts += [occupied[32 * lo:32 * hi].sum() for lo, hi in zip(offsets[:-1], offsets[1:])]
        word = (occupied.view(-1, 32).long() << torch.arange(32, device=dev)).sum(1)
        bitmaps.append(torch.where(word >= 2**31, word - 2**32, word))
    return (torch.stack(counts).to(torch.int32).view(len(xys), len(widths)),
            torch.cat(bitmaps).to(torch.int32))


def box_counts(xys, mins, steps, widths, device="cuda"):
    """Occupied boxes of each (cloud, scale) on `device` (CUDA: one
    boxcount.cu launch for every cloud; CPU: the twin): (counts (nclouds,
    nscales) int32, bitmaps (nclouds * words,) int32).

    xys: (N_c, 2) float64 arrays, N_c >= 1; mins: (nclouds, 2) and steps:
    (nclouds, nscales, 2) float64, the keys' origins and box sides; widths:
    box_layout's sides. Raises ValueError when a key could fall outside its
    bitmap."""
    xys = [np.ascontiguousarray(xy, dtype=np.float64) for xy in xys]
    mins = np.asarray(mins, dtype=np.float64)
    steps = np.asarray(steps, dtype=np.float64)
    widths = np.asarray(widths, dtype=np.int64)
    if not xys or any(xy.ndim != 2 or xy.shape[1] != 2 or not len(xy) for xy in xys):
        raise ValueError("box_counts takes one or more non-empty (N, 2) clouds")
    if mins.shape != (len(xys), 2) or steps.shape != (len(xys), len(widths), 2):
        raise ValueError(f"mins {mins.shape} and steps {steps.shape} do not match "
                         f"{len(xys)} clouds and {len(widths)} scales")
    if len(widths) > MAX_SCALES or _offsets(widths)[-1] >= 2**31:
        raise ValueError(f"{len(widths)} scales of bitmaps of sides up to {widths.max()}: "
                         f"the kernel takes at most {MAX_SCALES} scales and 2**31 words")
    _check_keys(xys, mins, steps, widths)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return box_counts_torch(xys, mins, steps, widths, device=dev)
    args, counts, buf, _inputs = device_inputs(xys, mins, steps, widths, dev)
    launch("boxcount", dev, *args)
    return counts, buf[:-1]


def device_inputs(xys, mins, steps, widths, dev):
    """boxcount.cu's inputs on `dev` for checked arguments: (the launch's
    arguments before the stream, counts, the zeroed bitmaps with the ticket
    last, the input tensors the arguments point into, which the caller holds
    until it has launched)."""
    offsets = _offsets(widths)
    words = int(offsets[-1])
    sizes = np.array([len(xy) for xy in xys], dtype=np.int64)
    ctas = (sizes + POINTS_PER_CTA - 1) // POINTS_PER_CTA
    iparams = np.concatenate([[0], np.cumsum(sizes), [0], np.cumsum(ctas), widths, offsets])
    fparams = np.concatenate([mins.ravel(), steps.ravel()])
    xy = torch.as_tensor(xys[0] if len(xys) == 1 else np.concatenate(xys), device=dev)
    iparams = torch.as_tensor(iparams.astype(np.int64), device=dev)
    fparams = torch.as_tensor(fparams, device=dev)
    buf = torch.zeros(len(xys) * words + 1, dtype=torch.int32, device=dev)
    counts = torch.empty((len(xys), len(widths)), dtype=torch.int32, device=dev)
    args = (xy.data_ptr(), fparams.data_ptr(), iparams.data_ptr(), len(xys), len(widths), words,
            int(ctas.sum()), buf.data_ptr(), counts.data_ptr(), buf[-1:].data_ptr())
    return args, counts, buf, (xy, fparams, iparams)
