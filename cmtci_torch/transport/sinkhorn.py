"""Kernel-argmax matcher (the tracker's "fixed" entropic OT alignment) and
the full log-domain Sinkhorn (the stage-1 matcher).

Port of ``entropic_argmax_match``, ``sinkhorn_log`` and ``sinkhorn_match``
from ``cmtci/transport/sinkhorn.py``; on the card ``sinkhorn_log`` runs its
whole loop as one launch of csrc/sinkhorn.cu. The argmax matcher
(tci_construct_mandelbrot_v002_fixed.py:62-71 semantics) subsamples the
larger cloud to the smaller's size with the caller's numpy RNG, scales the
distance matrix by its mean, K = exp(-M/eps), match = argmax over rows.

backend="numpy" is the reference's exact op order (scipy cdist, full K);
backend="torch" computes the same match without materializing K: on a card
the two passes of csrc/argmax_match.cu (kernels/argmax_match.py), on the CPU
their twin, the chain below blocked over rows. Distances are sqrt(dx*dx +
dy*dy), as the reference's ``_pairwise_dist`` writes them — not
``torch.cdist``, which switches to a matrix-product formula with other
rounding on large inputs. The mean distance is summed in f64 whatever the
clouds' dtype (each distance widened first, as the benchmark's plain
reference does; the reference package sums f32 distances in f32) and rounded
once to their dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from cmtci_torch.kernels import _launch, argmax_match
from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device

MATCH_BACKENDS = ("numpy", "torch")


def _pairwise_dist(a, b):
    """Euclidean distances computed like cdist: sqrt of coordinate sums."""
    dx = a[:, 0][:, None] - b[:, 0][None, :]
    dy = a[:, 1][:, None] - b[:, 1][None, :]
    return torch.sqrt(dx * dx + dy * dy)


def _blocked_dist_total(a, b, chunk: int = 2048):
    """Sum of the pairwise distances (0-dim float64): each block of `chunk`
    rows summed by torch with every distance widened to f64, the blocks added
    in order. The twin of csrc/argmax_match.cu's mean pass, which adds the
    same f64 values in another fixed order."""
    acc = torch.zeros((), dtype=torch.float64, device=a.device)
    for i in range(0, a.shape[0], chunk):
        acc = acc + torch.sum(_pairwise_dist(a[i : i + chunk], b), dtype=torch.float64)
    return acc


def _blocked_mean_dist(a, b, chunk: int = 2048):
    """Mean pairwise distance in a's dtype (0-dim): _blocked_dist_total's f64
    total through argmax_match.mean_from_total, the kernel path's epilogue."""
    return argmax_match.mean_from_total(_blocked_dist_total(a, b, chunk), a.shape[0],
                                        b.shape[0], a.dtype)


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
    """Mean pairwise distance, then the kernel-argmax rows (int64 tensor): on
    a CUDA tensor the two launches of csrc/argmax_match.cu
    (argmax_match.argmax_match, which raises on what it cannot take), on a CPU
    tensor their twin, this module's chain in blocks of `chunk` rows."""
    if a.device.type != "cpu":
        return argmax_match.argmax_match(a, b, eps)
    mean = _blocked_mean_dist(a, b, chunk=chunk)
    return _argmax_kernel_rows(a, b, mean, eps, chunk=chunk)


def entropic_argmax_match(x, y, eps: float = 0.8, rng=None, backend: str = "torch",
                          dtype=None, device="cuda", mesh=None, count=None):
    """Match each x to argmax_j exp(-d/eps). Returns (y[match], x) like the
    reference.

    The larger cloud is first subsampled to the smaller's size with `rng`
    (np.random or a RandomState, shared with the caller's stream). `dtype`
    (torch dtype, default float64) is the torch backend's coordinate type on
    `device`; the numpy backend ignores both. With a `mesh` the torch
    backend's rows are sharded over its ranks, on the ranks' devices
    (parallel.sharded.sharded_argmax_match, bitwise the single-device
    match). `count`, a callable (name, n), takes ``tracker.match_card``: one
    for a match made by csrc/argmax_match.cu (the torch backend on a card,
    without a mesh).
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
        if count is not None and dev.type == "cuda":
            count("tracker.match_card", 1)
    return y[match], x


#: lanes of a warp: the partial sums of a logsumexp (csrc/sinkhorn.cu)
WARP = 32
#: CTAs a grid slot of each SM (sinkhorn.cu's CTAS_PER_SM)
SINKHORN_CTAS_PER_SM = 1
#: threads a CTA (sinkhorn.cu's THREADS): at most THREADS / WARP lines a pass
SINKHORN_THREADS = 512
#: passes the streaming ring holds (sinkhorn.cu's RING, at least 3)
SINKHORN_RING = 3


def warp_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 of e (length, width) in csrc/sinkhorn.cu's order: lane
    l of a warp sums the rows l, l + 32, l + 64, ... in increasing order
    (from +0.0), and the 32 partial sums fold by a butterfly, acc[:s] +
    acc[s:2s] for s = 16, 8, 4, 2, 1 (what __shfl_xor_sync leaves in lane
    0). Returns shape (width,)."""
    acc = e.new_zeros((WARP, e.shape[1]))
    for k in range(0, e.shape[0], WARP):
        chunk = e[k : k + WARP]
        acc[: chunk.shape[0]] += chunk
    s = WARP // 2
    while s:
        acc = acc[:s] + acc[s : 2 * s]
        s //= 2
    return acc[0]


def logsumexp_fixed(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over dim 0 of x (length, width), as torch.logsumexp computes
    it (the max, an infinite one replaced by 0, then log(sum exp(x - max)) +
    max) with the sum in warp_sum's order."""
    mx = torch.amax(x, dim=0)
    mx = mx.masked_fill(mx.abs() == math.inf, 0.0)
    return torch.log(warp_sum(torch.exp(x - mx))) + mx


def sinkhorn_log_torch(cost: torch.Tensor, iters: int = 1000, eps: float = 0.05) -> torch.Tensor:
    """Log-domain Sinkhorn with uniform marginals on the cost's device and
    dtype; returns the plan. The reference's ``lax.scan`` of `iters` steps
    (tci_construct_mandelbrot-v002.py:60-72 intent, stable for small eps),
    written as csrc/sinkhorn.cu computes it, op for op: every division by eps
    a product by inv_eps = 1 / eps, each logsumexp logsumexp_fixed over a
    contiguous dim 0 (the f half step over the transpose of mk, the g half
    step over mk). The plain twin of sinkhorn_kernel."""
    n, m = cost.shape
    inv_eps = 1.0 / eps
    log_mu = -math.log(n) * torch.ones(n, dtype=cost.dtype, device=cost.device)
    log_nu = -math.log(m) * torch.ones(m, dtype=cost.dtype, device=cost.device)
    mk = (-cost) * inv_eps
    mk_t = mk.T.contiguous()
    f = torch.zeros(n, dtype=cost.dtype, device=cost.device)
    g = torch.zeros(m, dtype=cost.dtype, device=cost.device)
    for _ in range(iters):
        f = eps * (log_mu - logsumexp_fixed(mk_t + (g * inv_eps)[:, None]))
        g = eps * (log_nu - logsumexp_fixed(mk + (f * inv_eps)[:, None]))
    return torch.exp(mk + (f * inv_eps)[:, None] + (g * inv_eps)[None, :])


@dataclass(frozen=True)
class SinkhornPlan:
    """How csrc/sinkhorn.cu covers an (n, m) cost: `ctas` CTAs, CTA c owning
    the rows [c n // ctas, (c + 1) n // ctas) and the columns likewise; at
    most `row_block` rows and `col_block` columns a CTA; `resident` when
    every CTA holds its lines of mk in shared memory (a warp a line), else
    they stream from global scratch through a ring of `depth` passes of
    `pass_rows` and `pass_cols` lines (0 when resident), `staged` bytes
    copied into shared memory a step (every line of mk and mkT once; 0 when
    resident); `smem` bytes of dynamic shared memory a CTA."""

    ctas: int
    resident: bool
    smem: int
    row_block: int
    col_block: int
    pass_rows: int
    pass_cols: int
    depth: int
    staged: int


def block(c: int, count: int, ctas: int) -> tuple[int, int]:
    """[start, stop) of CTA c's lines among `count` over `ctas` CTAs."""
    return c * count // ctas, (c + 1) * count // ctas


def padded(count: int) -> int:
    """A streamed line's stride in csrc/sinkhorn.cu's scratch and ring:
    `count` rounded up to even, so that a line spans whole 16 bytes."""
    return count + count % 2


def launch_plan(n: int, m: int, sms: int, smem_max: int, ctas: int | None = None,
                streaming: bool = False, threads: int = SINKHORN_THREADS,
                depth: int = SINKHORN_RING, pass_max: int | None = None) -> SinkhornPlan:
    """The launch of an (n, m) cost on a card of `sms` SMs whose CTA may
    opt in to `smem_max` bytes of shared memory, for a build of `threads`
    threads a CTA and a ring of `depth` passes: SINKHORN_CTAS_PER_SM a SM
    (or `ctas`); a pass of at most threads / WARP lines (or `pass_max`).
    Resident when f, g and a CTA's largest blocks of rows and columns fit (a
    warp takes a whole line: no passes, pass_rows and pass_cols 0);
    streaming otherwise (or when `streaming`), each pass as many lines as
    `depth` passes of them fit beside f and g. Shared memory
    also holds three passes' segment maxima (3 threads / WARP keys of 8
    bytes) and `depth` mbarriers. Raises when f, g and `depth` single lines do not fit."""
    ctas = sms * SINKHORN_CTAS_PER_SM if ctas is None else int(ctas)
    if n < 1 or m < 1 or ctas < 1:
        raise ValueError(f"sinkhorn: a {n} x {m} cost on {ctas} CTAs")
    if depth < 3:
        raise ValueError(f"sinkhorn: a ring of {depth} passes (three are read at once)")
    warps = threads // WARP
    most = warps if pass_max is None else max(1, min(warps, int(pass_max)))
    rows, cols = -(-n // ctas), -(-m // ctas)
    fixed = 8 * (n + m + 3 * warps + depth)
    held = fixed + 8 * (rows * m + cols * n)
    if not streaming and held <= smem_max:
        return SinkhornPlan(ctas, True, held, rows, cols, 0, 0, depth, 0)
    pr, pc = min(rows, most), min(cols, most)
    ldm, ldn = padded(m), padded(n)
    room = (smem_max - fixed) // (8 * depth)
    pr, pc = min(pr, room // ldm), min(pc, room // ldn)
    if pr < 1 or pc < 1:
        raise ValueError(f"sinkhorn: f, g and {depth} lines of a {n} x {m} cost take "
                         f"{fixed + 8 * depth * max(ldm, ldn)} B of shared memory, past the "
                         f"{smem_max} B a CTA may hold")
    smem = fixed + 8 * depth * max(pr * ldm, pc * ldn)
    return SinkhornPlan(ctas, False, smem, rows, cols, pr, pc, depth, 8 * (n * ldm + m * ldn))


def _ctypes_call(name: str, *args) -> None:
    """Call sinkhorn.cu's query `name` (sinkhorn_limits, sinkhorn_occupancy);
    raise on a non-zero cudaError."""
    import ctypes

    from cmtci_torch.kernels._build import library

    fn = getattr(library("sinkhorn"), name)
    fn.argtypes = {"sinkhorn_limits": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                   "sinkhorn_occupancy": [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]}[name]
    fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc}")


#: (SMs, opt-in shared memory a CTA) of each card, read once
_LIMITS: dict = {}


def card_limits(dev: torch.device) -> tuple[int, int]:
    """(SMs, the shared memory a CTA may opt in to) of `dev`, read once."""
    import ctypes

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _LIMITS:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(index):
            _ctypes_call("sinkhorn_limits", index, out)
        _LIMITS[index] = (out[0], out[1])
    return _LIMITS[index]


def card_plan(dev: torch.device, n: int, m: int, ctas: int | None = None,
              streaming: bool = False) -> SinkhornPlan:
    """launch_plan on `dev`'s SM count and shared memory; raises when the
    grid cannot be co-resident (another process holding SMs through MPS, or
    a MIG slice, leaves fewer)."""
    import ctypes

    sms, smem_max = card_limits(dev)
    plan = launch_plan(n, m, sms, smem_max, ctas, streaming)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    per_sm = (ctypes.c_int * 1)()
    with torch.cuda.device(index):
        _ctypes_call("sinkhorn_occupancy", int(plan.resident), plan.smem, per_sm)
    if plan.ctas > per_sm[0] * sms:
        raise RuntimeError(f"sinkhorn: {plan.ctas} CTAs of {plan.smem} B cannot be co-resident "
                           f"({per_sm[0]} a SM on {sms} SMs); a cooperative launch needs "
                           "every CTA resident at once")
    return plan


def kernel_args(cost: torch.Tensor, iters: int, eps: float, plan: SinkhornPlan):
    """(the arguments of csrc/sinkhorn.cu's sinkhorn_launch but the stream,
    the plan tensor it writes, the buffers it uses) for a contiguous f64 cost
    on a card; keep the buffers alive until the launch has run."""
    n, m = cost.shape
    dev = cost.device
    bufs = [torch.empty(n, dtype=cost.dtype, device=dev),
            torch.empty(m, dtype=cost.dtype, device=dev)]
    if not plan.resident:
        bufs += [torch.empty((n, padded(m)), dtype=cost.dtype, device=dev),
                 torch.empty((m, padded(n)), dtype=cost.dtype, device=dev)]
    out = torch.empty_like(cost)
    f, g = bufs[:2]
    mk, mk_t = (bufs[2].data_ptr(), bufs[3].data_ptr()) if not plan.resident else (0, 0)
    args = (cost.data_ptr(), mk, mk_t, f.data_ptr(), g.data_ptr(), out.data_ptr(), n, m,
            int(iters), float(eps), 1.0 / eps, -math.log(n), -math.log(m), plan.ctas,
            int(plan.resident), plan.smem, plan.pass_rows, plan.pass_cols)
    return args, out, bufs


def sinkhorn_kernel(cost: torch.Tensor, iters: int = 1000, eps: float = 0.05,
                    ctas: int | None = None, streaming: bool = False) -> torch.Tensor:
    """The loop of sinkhorn_log_torch as one cooperative launch of
    csrc/sinkhorn.cu on the cost's card (f64); returns the plan, bitwise the
    twin's. `ctas` and `streaming` override the launch plan (card_plan); the
    plan's bits do not depend on them. Raises on any other device or dtype,
    on a grid that cannot be co-resident and on a failed build or launch."""
    if cost.device.type != "cuda":
        raise ValueError(f"sinkhorn_kernel: a {cost.device} tensor (expected cuda)")
    if cost.dtype != torch.float64 or cost.dim() != 2:
        raise ValueError(f"sinkhorn_kernel: a {cost.dtype} tensor of {cost.dim()} dims "
                         "(expected a 2-D float64 cost)")
    cost = cost.contiguous()
    plan = card_plan(cost.device, *cost.shape, ctas, streaming)
    args, out, _ = kernel_args(cost, iters, eps, plan)
    _launch.launch("sinkhorn", cost.device, *args)
    return out


def sinkhorn_log(cost: torch.Tensor, iters: int = 1000, eps: float = 0.05) -> torch.Tensor:
    """Log-domain Sinkhorn with uniform marginals on the cost's device and
    dtype; returns the plan (the reference's ``lax.scan``).

    CPU: the twin sinkhorn_log_torch. CUDA: one launch of csrc/sinkhorn.cu
    (sinkhorn_kernel), counted in kernels._launch.launches["sinkhorn"]; a
    failed build, launch or co-residency check raises, nothing falls back."""
    if cost.device.type == "cpu":
        return sinkhorn_log_torch(cost, iters, eps)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device} (expected cuda or cpu)")
    return sinkhorn_kernel(cost, iters, eps)


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
