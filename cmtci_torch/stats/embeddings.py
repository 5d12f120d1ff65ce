"""Diffusion-map style spectral embeddings of point clouds (port of
``cmtci/stats/embeddings.py``).

Reference: dynamical_embeddings_phase7.py:42-102 — sparse kNN gaussian
kernel (k=20, sigma = eps_scale * median kNN distance), symmetrize, row-
normalize to a Markov matrix, top-n_eigs eigenpairs of the symmetrized P,
and an L2 spectral distance on leading eigenvalues.

The kNN search is a blocked dense top-k on the device; the neighbours are
``lax.top_k``'s (ascending distance, equal distances to the lower index,
``curvature._knn_indices``). The eigenpairs come from scipy's eigsh on the
host (backend "scipy", the parity oracle) or from a dense Lanczos with full
reorthogonalization on the device (backend "device"), whose m x m
tridiagonal eigensolve runs on the host. Both start from a vector drawn on
the host from np.random.default_rng(0): the reference's Lanczos draws its
start from the JAX key 0, which the port cannot reproduce (_lanczos_dense
takes it as an argument), and its eigsh call lets ARPACK draw one from a
generator whose state carries over from call to call in a process, so two
runs of one stage in one process differ in their last digits.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.linalg import eigsh

from cmtci_torch.stats.curvature import _knn_indices
from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device


def _knn(xy, k: int, chunk: int = 2048, rows=None):
    """(distances, indices) of the k nearest neighbours of each row of the
    (n, 2) tensor xy, self excluded, in xy's dtype on its device; rows =
    (lo, hi) answers only the query rows lo..hi-1 (shape (hi - lo, k))."""
    lo, hi = (0, xy.shape[0]) if rows is None else rows
    dists = torch.empty((hi - lo, k), dtype=xy.dtype, device=xy.device)
    idxs = torch.empty((hi - lo, k), dtype=torch.int64, device=xy.device)
    for i in range(lo, hi, chunk):
        blk = xy[i : min(i + chunk, hi)]
        dx = blk[:, 0, None] - xy[None, :, 0]
        dy = blk[:, 1, None] - xy[None, :, 1]
        d2 = dx * dx + dy * dy
        d2.diagonal(offset=i).fill_(float("inf"))  # drop self
        nbr = _knn_indices(d2, k)
        dists[i - lo : i - lo + blk.shape[0]] = torch.sqrt(torch.gather(d2, 1, nbr))
        idxs[i - lo : i - lo + blk.shape[0]] = nbr
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
                        dtype=None, device="cuda", mesh=None):
    """Symmetric sparse gaussian kNN kernel; returns (K csr, sigma).

    dtype=None or torch.float64 runs the blocked kNN search exactly; with a
    `mesh` that search shards its query rows over the ranks
    (parallel.sharded.sharded_knn, bitwise per row). torch.float32
    runs the SEARCH with hi/lo two-float coordinates (_knn_hilo) over k+8
    candidates, then re-ranks the candidates by exact f64 distance on the
    host (O(n·k)): the neighbour sets match the f64 path unless a true k-th
    neighbour is pushed past the 8-candidate margin (that needs
    ~1e-14-relative near-ties 8 deep; exact ties can still resolve to a
    different but equidistant member). The kernel weights are always f64:
    an f32 exp underflows to 0 for isolated points, and a zero kernel row
    has no Markov normalization.
    """
    xy = _xy(points)
    n = len(xy)
    k = int(k)
    if mesh is not None and dtype is not None:
        raise ValueError(
            "build_sparse_kernel: mesh and dtype are mutually exclusive — the "
            "sharded kNN is the f64 multi-device path; the f32 device path is "
            "single-device (drop one of them)")
    if mesh is not None:
        from cmtci_torch.parallel.sharded import sharded_knn

        dists, idxs = sharded_knn(xy, k, mesh)
    elif dtype == torch.float32 and n > k + 1:
        dev = resolve_device(device)
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
        dists, idxs = _knn(torch.as_tensor(xy, dtype=torch.float64,
                                           device=resolve_device(device)), k)
        dists, idxs = dists.cpu().numpy(), idxs.cpu().numpy()
    sigma = float(np.median(dists.ravel()) * eps_scale)
    if sigma <= 0:
        sigma = 1.0
    rows = np.repeat(np.arange(n), k)
    data = np.exp(-(dists.ravel() ** 2) / (2 * sigma * sigma))
    kmat = csr_matrix((data, (rows, idxs.ravel())), shape=(n, n))
    return 0.5 * (kmat + kmat.T), sigma


def markov_from_kernel(kmat):
    """Row-normalize to a Markov matrix (dynamical_embeddings_phase7.py:69-76)."""
    row_sum = np.asarray(kmat.sum(axis=1)).ravel()
    inv = np.divide(1.0, row_sum, out=np.zeros_like(row_sum), where=row_sum != 0)
    d_inv = csr_matrix((inv, (np.arange(len(inv)), np.arange(len(inv)))), shape=kmat.shape)
    return d_inv.dot(kmat)


def _lanczos_dense(s: torch.Tensor, m: int, v0: torch.Tensor):
    """m-step Lanczos with full reorthogonalization on the dense symmetric
    (n, n) tensor s from the start vector v0, in s's dtype on its device.
    Returns (tridiagonal alphas (m,), betas (m-1,), basis Q (m, n)).

    The reorthogonalization projects against the whole (m, n) basis, whose
    rows past j are still zero, as the reference does.
    """
    n = s.shape[0]
    q = torch.zeros((m, n), dtype=s.dtype, device=s.device)
    q[0] = v0 / torch.linalg.norm(v0)
    v_prev_beta = torch.zeros(n, dtype=s.dtype, device=s.device)
    alphas = torch.empty(m, dtype=s.dtype, device=s.device)
    betas = torch.empty(m, dtype=s.dtype, device=s.device)
    tiny = torch.tensor(1e-30, dtype=s.dtype, device=s.device)
    for j in range(m):
        vj = q[j]
        w = s @ vj - v_prev_beta
        alpha = w @ vj
        w = w - alpha * vj
        w = w - q.T @ (q @ w)
        beta = torch.linalg.norm(w)
        w = w / torch.maximum(beta, tiny)
        if j + 1 < m:
            q[j + 1] = w
        alphas[j] = alpha
        betas[j] = beta
        v_prev_beta = beta * vj
    return alphas, betas[:-1], q


def _dense_from_sparse_device(s_csr, dtype, device):
    """The symmetrized sparse kernel as a dense (n, n) tensor on `device`:
    only the O(n·k) coo triplets are copied; the n² matrix is filled there."""
    coo = s_csr.tocoo()
    n = s_csr.shape[0]
    rows = torch.as_tensor(coo.row.astype(np.int64), device=device)
    cols = torch.as_tensor(coo.col.astype(np.int64), device=device)
    data = torch.as_tensor(coo.data, dtype=dtype, device=device)
    return torch.zeros((n, n), dtype=dtype, device=device).index_put_((rows, cols), data)


def lanczos_start(n: int) -> np.ndarray:
    """The device eigensolver's start vector, drawn on the host (seed 0)."""
    return np.random.default_rng(0).standard_normal(n)


def spectral_embedding_device(p, n_eigs: int = 8, m: int = 0, dtype=torch.float64,
                              device="cuda"):
    """Lanczos eigenpairs of the symmetrized Markov matrix on the device
    (dynamical_embeddings_phase7.py:78-102): dense n² matvecs with full
    reorthogonalization in `dtype` on `device`, the m x m tridiagonal
    eigensolve on the host, the Ritz vectors in f64 on `device`.
    """
    dev = resolve_device(device)
    s = (0.5 * (p + p.T)).tocsr()
    n = s.shape[0]
    k = min(n_eigs, n - 2)
    # the symmetrized-Markov spectrum is clustered near its top, so interior
    # Ritz pairs converge slowly: the basis has to grow with n (m ≈ n/12
    # reaches 2.8e-8 at a 5049-point bus where m = 160 leaves 4.5e-3); past
    # 600, f32 reorthogonalization noise degrades it again (the reference's
    # measurements, kept as its rule)
    m = int(m) if m else min(max(20 * k, 120, min(600, n // 12)), n)
    sd = _dense_from_sparse_device(s, dtype, dev)
    v0 = torch.as_tensor(lanczos_start(n), dtype=dtype, device=dev)
    alphas, betas, q = _lanczos_dense(sd, m, v0)
    alphas = alphas.cpu().numpy().astype(np.float64)
    betas = betas.cpu().numpy().astype(np.float64)
    t = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    tvals, tvecs = np.linalg.eigh(t)
    order = np.argsort(np.abs(tvals))[::-1][:k]  # eigsh which="LM"
    ritz = (q.to(torch.float64).T @ torch.as_tensor(tvecs[:, order], device=dev)).cpu().numpy()
    vals = tvals[order]
    desc = np.argsort(vals)[::-1]
    vals = vals[desc]
    vecs = ritz[:, desc]
    vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=0, keepdims=True), 1e-300)
    return vals, vecs


def spectral_embedding(p, n_eigs: int = 8, backend: str = "scipy", dtype=torch.float64,
                       device="cuda"):
    """Top eigenpairs of the symmetrized Markov matrix, descending.

    backend="scipy" is the reference-parity oracle (eigsh, host); "device"
    runs the dense Lanczos in `dtype` on `device`."""
    if backend == "device":
        return spectral_embedding_device(p, n_eigs=n_eigs, dtype=dtype, device=device)
    s = (0.5 * (p + p.T)).tocsr()
    k = min(n_eigs, s.shape[0] - 2)
    try:
        # ARPACK's own start vector comes from a generator whose state runs
        # on across calls in a process; the host draw makes each call alike
        vals, vecs = eigsh(s, k=k, which="LM", v0=lanczos_start(s.shape[0]))
    except Exception:
        vals_all, vecs_all = np.linalg.eigh(s.toarray())
        vals = vals_all[::-1][:n_eigs]
        vecs = vecs_all[:, ::-1][:, :n_eigs]
    order = np.argsort(vals)[::-1]
    return vals[order], vecs[:, order]


def diffusion_map(points, k: int = 20, n_eigs: int = 8, eps_scale: float = 0.5,
                  eig_backend: str = "scipy", eig_dtype=torch.float64,
                  knn_dtype=None, device="cuda", mesh=None):
    """Full pipeline: kernel -> Markov -> spectrum. Returns (vals, vecs, sigma).
    `mesh` shards the kNN search (build_sparse_kernel)."""
    kmat, sigma = build_sparse_kernel(points, k=k, eps_scale=eps_scale, dtype=knn_dtype,
                                      device=device, mesh=mesh)
    p = markov_from_kernel(kmat)
    vals, vecs = spectral_embedding(p, n_eigs=n_eigs, backend=eig_backend, dtype=eig_dtype,
                                    device=device)
    return vals, vecs, sigma


def embedding_spectral_distance(vals_a, vals_b) -> float:
    """L2 on leading eigenvalues (dynamical_embeddings_phase7.py:169-172)."""
    n = min(len(vals_a), len(vals_b))
    return float(np.linalg.norm(np.asarray(vals_a)[:n] - np.asarray(vals_b)[:n]))
