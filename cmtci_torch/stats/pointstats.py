"""Point-cloud Hausdorff distance (the TCI pipeline's subset of
``cmtci/stats/pointstats.py``).

Hausdorff = max of the two directed distances (spatial_stats_phase3.py:10-15,
tci_construct_mandelbrot_v002_fixed.py:97-98), exact and blocked over rows:
O(chunk·m) memory, never the n x m matrix.
"""

from __future__ import annotations

import torch

from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device


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
