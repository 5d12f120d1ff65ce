"""The kernel-argmax matcher on the card: the two passes of
``csrc/argmax_match.cu``, their launch plan and wrapper.

For clouds a (n, 2) and b (m, 2) of one float dtype the matcher of
``transport/sinkhorn.py`` (``_match_fused``) takes the mean of the n x m
pairwise distances, then for each row i of a the first j that maximises
nan_to_num(exp(-(d_ij / mean) / eps)). On a CPU tensor ``_match_fused`` runs
its twin, the blocked torch chain (``sinkhorn._blocked_dist_total``,
``mean_from_total``, ``sinkhorn._argmax_kernel_rows``); on a CUDA tensor
``argmax_match`` here: one ``argmax_mean`` launch for the f64 total of the
distances (``dist_total``), the mean from it in torch on the device
(``mean_from_total``, the twin's epilogue too), and one ``argmax_rows``
launch for the indices (``argmax_rows``), nothing back to the host between
them. Given the same mean the indices are bitwise the chain's; the kernel's
total differs from the chain's only in the order of its f64 sum.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmtci_torch.kernels._launch import launch

#: threads a CTA (argmax_match.cu's kThreads)
THREADS = 256
#: rows a thread holds (kRowsPerThread)
ROWS_PER_THREAD = 4
#: rows a CTA holds
TILE = THREADS * ROWS_PER_THREAD
#: the CTAs a launch aims at: several waves of the card's 132 SMs, so that the
#: last wave's remainder costs little
TARGET_CTAS = 4096
#: the fewest columns a slab takes when there is more than one
MIN_SLAB = 256
#: the largest cloud the kernels' int indices take
MAX_POINTS = 2**30


class Plan(NamedTuple):
    tiles: int  # tiles of TILE rows
    slabs: int  # slabs of columns a tile meets, one CTA each
    ctas: int  # tiles x slabs, tile-major


def launch_plan(n: int, m: int) -> Plan:
    """Both passes' grid for n rows and m columns, from the shapes alone: as
    many slabs as bring tiles x slabs to about TARGET_CTAS, each of at least
    MIN_SLAB columns (one slab when m < 2 * MIN_SLAB); slab s takes the
    columns [s * m // slabs, (s + 1) * m // slabs)."""
    tiles = -(-n // TILE)
    slabs = max(1, min(-(-TARGET_CTAS // tiles), m // MIN_SLAB))
    return Plan(tiles, slabs, tiles * slabs)


def mean_from_total(total: torch.Tensor, n: int, m: int, dtype) -> torch.Tensor:
    """The mean distance in `dtype` (0-dim) from the f64 total of n x m
    distances: total / (n * m) in f64, rounded once to `dtype`. The one
    epilogue of the kernel path, its twin and the sharded matcher, so that the
    three take the same op (torch on the card multiplies by the reciprocal of
    a Python scalar)."""
    return (total / (n * m)).to(dtype)


def inverse_eps(eps: float, dtype) -> float:
    """1 / eps rounded in `dtype`, exact as a Python float: what torch on the
    card multiplies by when it divides a tensor of `dtype` by the Python
    scalar eps."""
    if dtype == torch.float32:
        return float(np.float32(1.0) / np.float32(eps))
    return 1.0 / float(eps)


def check_inputs(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(n, m), or ValueError: a and b contiguous (n, 2) and (m, 2) tensors of
    one dtype, float32 or float64, on one device, 1 <= n, m <= MAX_POINTS."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in (torch.float32, torch.float64) or t.ndim != 2 or t.shape[1] != 2:
            raise ValueError(f"{name} must be (N, 2) float32 or float64, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b.dtype != a.dtype or b.device != a.device:
        raise ValueError(f"a and b differ: {a.dtype} on {a.device}, {b.dtype} on {b.device}")
    n, m = a.shape[0], b.shape[0]
    if not (1 <= n <= MAX_POINTS and 1 <= m <= MAX_POINTS):
        raise ValueError(f"the kernels take 1 to {MAX_POINTS} points a cloud, got {n} and {m}")
    return n, m


def _card_inputs(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """check_inputs, and a and b on a card, aligned to a point."""
    n, m = check_inputs(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"argmax_match: a {a.device} tensor (expected cuda)")
    if a.data_ptr() % (2 * a.element_size()) or b.data_ptr() % (2 * b.element_size()):
        raise ValueError("a and b must be aligned to a point")
    return n, m


def dist_total(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0-dim float64 on the card: the sum of the n x m distances of CUDA
    clouds a and b, each widened to f64 and added in f64 in an order fixed by
    the shapes; one argmax_mean launch."""
    n, m = _card_inputs(a, b)
    plan = launch_plan(n, m)
    partials = torch.empty(plan.ctas + 1, dtype=torch.float64, device=a.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=a.device)
    total = partials[plan.ctas]
    launch("argmax_mean", a.device, a.data_ptr(), b.data_ptr(), n, m, plan.slabs,
           int(a.dtype == torch.float64), partials.data_ptr(), ticket.data_ptr(),
           total.data_ptr())
    return total


def argmax_rows(a: torch.Tensor, b: torch.Tensor, mean: torch.Tensor,
                eps: float) -> torch.Tensor:
    """int64 (n,) on the card: for each row of a the first column of b that
    maximises nan_to_num(exp(-(d / mean) / eps)), `mean` a one-element tensor
    of a's dtype on its card; one argmax_rows launch, bitwise the chain's
    (sinkhorn._argmax_kernel_rows) given the same mean."""
    n, m = _card_inputs(a, b)
    if mean.dtype != a.dtype or mean.device != a.device or mean.numel() != 1:
        raise ValueError(f"mean must be one {a.dtype} value on {a.device}, got "
                         f"{tuple(mean.shape)} {mean.dtype} on {mean.device}")
    plan = launch_plan(n, m)
    out = torch.empty(n, dtype=torch.int64, device=a.device)
    bufs = [None, None, None]
    if plan.slabs > 1:
        bufs = [torch.empty(plan.slabs * n, dtype=a.dtype, device=a.device),
                torch.empty(plan.slabs * n, dtype=torch.int32, device=a.device),
                torch.zeros(plan.tiles, dtype=torch.int32, device=a.device)]
    kpart, jpart, tickets = (0 if t is None else t.data_ptr() for t in bufs)
    launch("argmax_rows", a.device, a.data_ptr(), b.data_ptr(), n, m, plan.slabs,
           int(a.dtype == torch.float64), mean.data_ptr(),
           inverse_eps(eps, a.dtype), kpart, jpart, tickets, out.data_ptr())
    return out


def argmax_match(a: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """int64 (n,) match indices of CUDA clouds a and b: dist_total, the mean
    by mean_from_total and argmax_rows, on the card. Raises ValueError on
    inputs check_inputs refuses or off a card, RuntimeError on a failed
    build or launch; nothing falls back."""
    total = dist_total(a, b)
    return argmax_rows(a, b, mean_from_total(total, a.shape[0], b.shape[0], a.dtype), eps)
