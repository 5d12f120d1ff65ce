"""PCA-eccentricity curvature proxy (the TCI pipeline's subset of
``cmtci/stats/curvature.py``): the kNN covariance λ_min/Σλ of
tci_construct_mandelbrot_v002_fixed.py:100-108.

The reference queries a KDTree per point; here, as in ``cmtci``, it is a
dense top-k over row blocks (O(chunk·N) memory). The k nearest neighbours
(self included) are the reference's ``lax.top_k`` choice: ascending squared
distance, equal distances broken by the lower index. That matters on the
Mandelbrot sample, whose points are grid nodes with many equal distances.
"""

from __future__ import annotations

import torch

from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device


def _knn_indices(d2, k: int):
    """(rows, k) indices of the k smallest entries of each row of d2, ordered
    by ascending value with ties to the lower index (``lax.top_k(-d2, k)``).
    torch.topk gives the k-th value; which of the tied entries at that value
    are taken is then decided by index, not left to topk."""
    kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]
    below = d2 < kth
    tie = d2 == kth
    room = k - below.sum(dim=1, keepdim=True)
    take = below | (tie & (torch.cumsum(tie.to(torch.int32), dim=1) <= room))
    idx = take.nonzero()[:, 1].view(-1, k)  # ascending index within each row
    order = torch.sort(torch.gather(d2, 1, idx), dim=1, stable=True).indices
    return torch.gather(idx, 1, order)


def pca_eccentricity(pts, k: int = 6, dtype=torch.float64, device="cuda",
                     chunk: int = 2048):
    """λ_min/Σλ of the covariance of each point's k nearest neighbours (self
    included), in `dtype` on `device`; returns a numpy array. The 2x2
    eigenvalues are the closed form m ± sqrt(((a-d)/2)² + b²)."""
    dev = resolve_device(device)
    xy = torch.as_tensor(_xy(pts), dtype=dtype, device=dev)
    n = xy.shape[0]
    out = torch.empty(n, dtype=dtype, device=dev)
    tiny = xy.new_tensor(1e-300 if dtype == torch.float64 else 1e-30)
    for i in range(0, n, chunk):
        blk = xy[i : i + chunk]
        dx = blk[:, 0, None] - xy[None, :, 0]
        dy = blk[:, 1, None] - xy[None, :, 1]
        neigh = xy[_knn_indices(dx * dx + dy * dy, int(k))]  # (rows, k, 2)
        z = neigh - neigh.mean(dim=1, keepdim=True)
        cov = torch.einsum("nki,nkj->nij", z, z) / (k - 1)
        a, b, d = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
        m = 0.5 * (a + d)
        s = torch.sqrt(torch.clamp(0.25 * (a - d) ** 2 + b * b, min=0.0))
        out[i : i + chunk] = (m - s) / torch.maximum(a + d, tiny)
    return out.cpu().numpy()
