"""Kernel-argmax matcher (the tracker's "fixed" entropic OT alignment) and
the full log-domain Sinkhorn (the stage-1 matcher).

Port of ``entropic_argmax_match``, ``sinkhorn_log`` and ``sinkhorn_match``
from ``cmtci/transport/sinkhorn.py``; on the card ``sinkhorn_log`` replays
its loop from a CUDA graph. The argmax matcher
(tci_construct_mandelbrot_v002_fixed.py:62-71 semantics) subsamples the
larger cloud to the smaller's size with the caller's numpy RNG, scales the
distance matrix by its mean, K = exp(-M/eps), match = argmax over rows.

backend="numpy" is the reference's exact op order (scipy cdist, full K);
backend="torch" computes the same match blocked over rows on a device,
without materializing K. Distances are sqrt(dx*dx + dy*dy), as the
reference's ``_pairwise_dist`` writes them — not ``torch.cdist``, which
switches to a matrix-product formula with other rounding on large inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device

MATCH_BACKENDS = ("numpy", "torch")


def _pairwise_dist(a, b):
    """Euclidean distances computed like cdist: sqrt of coordinate sums."""
    dx = a[:, 0][:, None] - b[:, 0][None, :]
    dy = a[:, 1][:, None] - b[:, 1][None, :]
    return torch.sqrt(dx * dx + dy * dy)


def _blocked_mean_dist(a, b, chunk: int = 2048):
    """Mean pairwise distance accumulated per block of rows (0-dim tensor)."""
    acc = torch.zeros((), dtype=a.dtype, device=a.device)
    for i in range(0, a.shape[0], chunk):
        acc = acc + torch.sum(_pairwise_dist(a[i : i + chunk], b))
    return acc / (a.shape[0] * b.shape[0])


def _argmax_kernel_rows(a, b, mean, eps: float, chunk: int = 2048):
    """argmax_j exp(-(d_ij/mean)/eps) blocked over rows of a (int64 tensor).

    Op order matches the reference (scale by mean, then by eps, then exp);
    torch.argmax returns the first maximal index, as numpy does."""
    out = torch.empty(a.shape[0], dtype=torch.int64, device=a.device)
    for i in range(0, a.shape[0], chunk):
        d = _pairwise_dist(a[i : i + chunk], b) / mean
        k = torch.nan_to_num(torch.exp(-d / eps))
        out[i : i + chunk] = torch.argmax(k, dim=1)
    return out


def _match_fused(a, b, eps: float, chunk: int = 2048):
    """Mean pairwise distance, then the kernel-argmax rows."""
    mean = _blocked_mean_dist(a, b, chunk=chunk)
    return _argmax_kernel_rows(a, b, mean, eps, chunk=chunk)


def entropic_argmax_match(x, y, eps: float = 0.8, rng=None, backend: str = "torch",
                          dtype=None, device="cuda", mesh=None):
    """Match each x to argmax_j exp(-d/eps). Returns (y[match], x) like the
    reference.

    The larger cloud is first subsampled to the smaller's size with `rng`
    (np.random or a RandomState, shared with the caller's stream). `dtype`
    (torch dtype, default float64) is the torch backend's coordinate type on
    `device`; the numpy backend ignores both. With a `mesh` the torch
    backend's rows are sharded over its ranks, on the ranks' devices
    (parallel.sharded.sharded_argmax_match, bitwise the single-device
    match).
    """
    if backend not in MATCH_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {MATCH_BACKENDS}")
    x = np.asarray(x)
    y = np.asarray(y)
    r = rng if rng is not None else np.random
    n, m = len(x), len(y)
    # complex 1-D inputs go through r.choice directly (the reference's exact
    # RNG stream); (N,2) arrays are subsampled by index (choice needs 1-D)
    if n > m:
        x = r.choice(x, m, replace=False) if x.ndim == 1 else x[r.choice(n, m, replace=False)]
    if m > n:
        y = r.choice(y, n, replace=False) if y.ndim == 1 else y[r.choice(m, n, replace=False)]
    ax, by = _xy(x), _xy(y)
    if backend == "numpy":
        from scipy.spatial.distance import cdist

        d = cdist(ax, by)
        d = d / d.mean()
        k = np.nan_to_num(np.exp(-d / eps))
        match = np.argmax(k, axis=1)
    elif mesh is not None:
        from cmtci_torch.parallel.sharded import sharded_argmax_match

        dt = torch.float64 if dtype is None else dtype
        match = sharded_argmax_match(torch.as_tensor(ax, dtype=dt),
                                     torch.as_tensor(by, dtype=dt), eps, mesh)
    else:
        dev = resolve_device(device)
        dt = torch.float64 if dtype is None else dtype
        match = _match_fused(torch.as_tensor(ax, dtype=dt, device=dev),
                             torch.as_tensor(by, dtype=dt, device=dev), eps).cpu().numpy()
    return y[match], x


def sinkhorn_log_torch(cost: torch.Tensor, iters: int = 1000, eps: float = 0.05) -> torch.Tensor:
    """Log-domain Sinkhorn with uniform marginals on the cost's device and
    dtype; returns the plan. The reference's ``lax.scan`` becomes `iters`
    eager steps of two ``torch.logsumexp`` calls, with no host round trip
    inside the loop (tci_construct_mandelbrot-v002.py:60-72 intent, stable
    for small eps). The plain twin of sinkhorn_log's CUDA graph."""
    n, m = cost.shape
    log_mu = -math.log(n) * torch.ones(n, dtype=cost.dtype, device=cost.device)
    log_nu = -math.log(m) * torch.ones(m, dtype=cost.dtype, device=cost.device)
    mk = -cost / eps
    f = torch.zeros(n, dtype=cost.dtype, device=cost.device)
    g = torch.zeros(m, dtype=cost.dtype, device=cost.device)
    for _ in range(iters):
        f = eps * (log_mu - torch.logsumexp(mk + g[None, :] / eps, dim=1))
        g = eps * (log_nu - torch.logsumexp(mk + f[:, None] / eps, dim=0))
    return torch.exp(mk + f[:, None] / eps + g[None, :] / eps)


#: replays of sinkhorn_log's captured graphs; read and reset by callers that
#: need to show a run went through a graph
replays = {"sinkhorn_log": 0}
#: captured loops, keyed by (device, shape, dtype, iters, eps): (graph, the
#: cost buffer it reads, the plan it writes); the oldest goes past _GRAPHS_KEPT
_GRAPHS: dict = {}
_GRAPHS_KEPT = 8


def _captured(cost: torch.Tensor, iters: int, eps: float):
    key = (cost.device, tuple(cost.shape), cost.dtype, int(iters), float(eps))
    if key not in _GRAPHS:
        if len(_GRAPHS) >= _GRAPHS_KEPT:
            _GRAPHS.pop(next(iter(_GRAPHS)))
        static = cost.detach().clone(memory_format=torch.contiguous_format)
        # a warm-up step on a side stream before the capture, as
        # torch.cuda.graphs asks
        side = torch.cuda.Stream(cost.device)
        side.wait_stream(torch.cuda.current_stream(cost.device))
        with torch.cuda.stream(side):
            sinkhorn_log_torch(static, 1, eps)
        torch.cuda.current_stream(cost.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            plan = sinkhorn_log_torch(static, iters, eps)
        _GRAPHS[key] = (graph, static, plan)
    return _GRAPHS[key]


def sinkhorn_log(cost: torch.Tensor, iters: int = 1000, eps: float = 0.05) -> torch.Tensor:
    """Log-domain Sinkhorn with uniform marginals on the cost's device and
    dtype; returns the plan (the reference's ``lax.scan``).

    CPU: the eager twin sinkhorn_log_torch. CUDA: the same `iters` steps
    captured once per (device, shape, dtype, iters, eps) into a CUDA graph
    over a static cost buffer and replayed: the same torch kernels on the
    same inputs, so the plan is bitwise the eager one, without a host launch
    per op. A capture error raises; nothing falls back."""
    if cost.device.type == "cpu":
        return sinkhorn_log_torch(cost, iters, eps)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device} (expected cuda or cpu)")
    with torch.cuda.device(cost.device):
        graph, static, plan = _captured(cost, iters, eps)
        static.copy_(cost)
        graph.replay()
        replays["sinkhorn_log"] += 1
        return plan.clone()


def sinkhorn_match(x, y, eps: float = 0.05, iters: int = 1000, squared: bool = True,
                   device="cuda"):
    """Full-Sinkhorn barycentric matching in f64 on `device`: each x_i ->
    argmax_j plan_ij, with the squared cdist cost of
    tci_construct_mandelbrot-v002.py scaled by its mean. Returns (y[match],
    plan) as numpy arrays."""
    dev = resolve_device(device)
    d = _pairwise_dist(torch.as_tensor(_xy(x), dtype=torch.float64, device=dev),
                       torch.as_tensor(_xy(y), dtype=torch.float64, device=dev))
    cost = d**2 if squared else d
    cost = cost / torch.clamp(cost.mean(), min=1e-300)
    plan = sinkhorn_log(cost, iters=iters, eps=eps).cpu().numpy()
    match = plan.argmax(axis=1)
    return np.asarray(y)[match], plan
