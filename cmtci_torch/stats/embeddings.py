"""Sparse kNN gaussian kernel of a point cloud (the first stage of the
diffusion-map embeddings; port of ``cmtci/stats/embeddings.py:28-143``).

Reference: dynamical_embeddings_phase7.py:42-68: a sparse kNN gaussian
kernel (k=20, sigma = eps_scale * median kNN distance), symmetrized. The kNN
search is a blocked dense top-k on the device; the neighbours are
``lax.top_k``'s (ascending distance, equal distances to the lower index,
``curvature._knn_indices``).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import csr_matrix

from cmtci_torch.stats.curvature import _knn_indices
from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device


def _knn(xy, k: int, chunk: int = 2048):
    """(distances, indices) of the k nearest neighbours of each row of the
    (n, 2) tensor xy, self excluded, in xy's dtype on its device."""
    n = xy.shape[0]
    dists = torch.empty((n, k), dtype=xy.dtype, device=xy.device)
    idxs = torch.empty((n, k), dtype=torch.int64, device=xy.device)
    for i in range(0, n, chunk):
        blk = xy[i : i + chunk]
        dx = blk[:, 0, None] - xy[None, :, 0]
        dy = blk[:, 1, None] - xy[None, :, 1]
        d2 = dx * dx + dy * dy
        d2.diagonal(offset=i).fill_(float("inf"))  # drop self
        nbr = _knn_indices(d2, k)
        dists[i : i + chunk] = torch.sqrt(torch.gather(d2, 1, nbr))
        idxs[i : i + chunk] = nbr
    return dists, idxs


def _knn_hilo(hi, lo, k: int, chunk: int = 2048):
    """f32 kNN candidate search with hi/lo two-float coordinates.

    Plain f32 coordinates collapse near-duplicate points (the inverse-
    eigenvalue clouds carry ~1e-11 spacings) onto the same value, so the
    candidate set within such a cluster would be arbitrary. Splitting each
    f64 coordinate as hi = f32(x), lo = f32(x - hi) makes the block difference
    (hi_i - hi_j) exact for close points (Sterbenz) and (dh + dl) accurate to
    ~1e-14 relative. Returns candidate indices (n, k)."""
    n = hi.shape[0]
    idxs = torch.empty((n, k), dtype=torch.int64, device=hi.device)
    for i in range(0, n, chunk):
        bh, bl = hi[i : i + chunk], lo[i : i + chunk]
        dx = (bh[:, 0, None] - hi[None, :, 0]) + (bl[:, 0, None] - lo[None, :, 0])
        dy = (bh[:, 1, None] - hi[None, :, 1]) + (bl[:, 1, None] - lo[None, :, 1])
        d2 = dx * dx + dy * dy
        d2.diagonal(offset=i).fill_(float("inf"))
        idxs[i : i + chunk] = _knn_indices(d2, k)
    return idxs


def build_sparse_kernel(points, k: int = 20, eps_scale: float = 0.5,
                        dtype=torch.float64, device="cuda"):
    """Symmetric sparse gaussian kNN kernel; returns (K csr, sigma).

    dtype=torch.float64 runs the blocked kNN search exactly. torch.float32
    runs the SEARCH with hi/lo two-float coordinates (_knn_hilo) over k+8
    candidates, then re-ranks the candidates by exact f64 distance on the
    host (O(n·k)): the neighbour sets match the f64 path unless a true k-th
    neighbour is pushed past the 8-candidate margin (that needs
    ~1e-14-relative near-ties 8 deep; exact ties can still resolve to a
    different but equidistant member). The kernel weights are always f64:
    an f32 exp underflows to 0 for isolated points, and a zero kernel row
    has no Markov normalization.
    """
    dev = resolve_device(device)
    xy = _xy(points)
    n = len(xy)
    k = int(k)
    if dtype == torch.float32 and n > k + 1:
        # (n <= k+1 degenerates to the exact scan below: every other point
        # is a neighbour, so there is no search to speed up)
        k_cand = min(k + 8, n - 1)
        hi = xy.astype(np.float32)
        lo = (xy - hi).astype(np.float32)
        cand = _knn_hilo(torch.as_tensor(hi, device=dev), torch.as_tensor(lo, device=dev),
                         k_cand).cpu().numpy()
        d2 = ((xy[cand] - xy[:, None, :]) ** 2).sum(-1)  # exact f64
        order = np.argsort(d2, axis=1, kind="stable")[:, :k]
        idxs = np.take_along_axis(cand, order, axis=1)
        dists = np.sqrt(np.take_along_axis(d2, order, axis=1))
    else:
        dists, idxs = _knn(torch.as_tensor(xy, dtype=torch.float64, device=dev), k)
        dists, idxs = dists.cpu().numpy(), idxs.cpu().numpy()
    sigma = float(np.median(dists.ravel()) * eps_scale)
    if sigma <= 0:
        sigma = 1.0
    rows = np.repeat(np.arange(n), k)
    data = np.exp(-(dists.ravel() ** 2) / (2 * sigma * sigma))
    kmat = csr_matrix((data, (rows, idxs.ravel())), shape=(n, n))
    return 0.5 * (kmat + kmat.T), sigma
