"""Multi-device execution: sharded grids, eigensweeps and reductions over a
torch.distributed process group.

Port of ``cmtci/parallel/sharded.py``. The reference runs one controller
that drives a 1-D ``("data",)`` mesh through ``shard_map``; the port runs
one process per rank (SPMD). Every rank calls the same function with the
same replicated inputs and the same host RNG state, computes its block with
the port's single-device function, and then gathers (``all_gather``) or
reduces (``all_reduce``), so every rank returns the full result with the
shape and type of the reference's. Host work (the RNG stream, quantiles,
Procrustes) is identical on every rank, as it is in the reference's single
controller. The hot loops hold no collective; one gather or reduction sits
at each head's edge.

Blocks are contiguous ranges of rows (points, angles, polynomials): rank r
takes items [r·per, (r+1)·per). A gathered block is padded to `per` items
and the padding is cropped after the gather. Integer counts are int64 and
reduce exactly in any order. A head that the reference holds bitwise to its
single-device path is bitwise here too: elementwise heads compute every
item with the same ops whatever the block; the matcher's normalizer sums
its per-chunk partials in global chunk order after the gather, as the
single-device blocked sum does. f64 sums reduced across ranks (the
variogram sums) are held at rtol 1e-12. The reference never shard_maps a
Pallas kernel; the port's kernel heads run on each rank's block all the
same: K2's row entry on a rank's rows (sharded_dwell_field) and the f32 K3
head on a rank's points (sharded_green_cloud_f32), both bitwise the single
card.

The reference's guards against an f64 loop on an accelerator mesh
(``_guard_green_accel``, ``_guard_accel_f64``, ``_guard_accel_step``) exist
because a TPU emulates f64; Hopper has native f64, so they have no
counterpart and every head runs in f64 on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from cmtci_torch.kernels import companion
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels import mandelbrot_cuda as mc
from cmtci_torch.utils import cplx
from cmtci_torch.utils.arrays import as_xy as _xy
from cmtci_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the group: `group` (the torch.distributed process
    group; None is the default group), this process's `rank`, the group's
    `size`, the `device` this rank computes on and the `backend`."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def device_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The 1-D data-parallel mesh of this process's group.

    Inside a group (``launch.run``, ``cmtci-torch --devices``, ``torchrun``
    with ``distributed.initialize()``) the mesh spans its ranks, and
    `n_devices` must be the group's size. Outside a group, n_devices 1 (or
    None) starts a one-rank group on `device`: NCCL on a card, gloo on the
    CPU. A larger count outside a group raises: the other ranks must be
    launched. The default device is the card (the rank's, in a group), and
    without a card that raises: a CPU mesh comes only from device="cpu".
    """
    import torch.distributed as dist

    from cmtci_torch.parallel import distributed

    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"device_mesh({n_devices}) needs {n_devices} ranks; start them with "
                "parallel.launch.run, `cmtci-torch ... --devices N` or torchrun, and "
                "call parallel.distributed.initialize() in each")
        dev = resolve_device("cuda" if device is None else device)
        distributed.set_rank_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0,
                                timeout=distributed.TIMEOUT)
    size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"device_mesh({n_devices}) in a group of {size} ranks")
    dev = device if device is not None else distributed._LOCAL["device"]
    return Mesh(group=None, rank=dist.get_rank(), size=size,
                device=resolve_device("cuda" if dev is None else dev),
                backend=str(dist.get_backend()))


def is_writer(mesh) -> bool:
    """Whether this rank writes files: every single-device run, and rank 0
    of a mesh."""
    return mesh is None or mesh.rank == 0


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _staged(mesh: Mesh) -> bool:
    """A gloo group moves a card's tensor through host memory (its CUDA
    collectives are not relied on); NCCL never stages."""
    return mesh.backend == "gloo" and mesh.device.type == "cuda"


def all_gather(mesh: Mesh, t: torch.Tensor) -> list:
    """Every rank's `t` (one shape on all ranks), in rank order, on this
    rank's device. bool tensors travel as uint8."""
    import torch.distributed as dist

    if mesh.size == 1:
        return [t]
    is_bool = t.dtype == torch.bool
    src = t.to(torch.uint8) if is_bool else t
    src = src.cpu() if _staged(mesh) else src.contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    out = [o.to(mesh.device) for o in out]
    return [o.bool() for o in out] if is_bool else out


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """`t` reduced over the ranks ("sum" or "max"), as a new tensor."""
    import torch.distributed as dist

    if mesh.size == 1:
        return t.clone()
    buf = t.cpu().clone() if _staged(mesh) else t.clone().contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=mesh.group)
    return buf.to(mesh.device)


def _share(n: int, mesh: Mesh, align: int = 1):
    """(lo, hi, per): this rank's items [lo, hi) of n, `per` items a rank
    (a multiple of `align`)."""
    per = -(-n // (mesh.size * align)) * align if n else align
    lo = min(mesh.rank * per, n)
    return lo, min(lo + per, n), per


def _gather_rows(mesh: Mesh, block: torch.Tensor, per: int, n: int):
    """The rows of every rank's block, concatenated in rank order and
    cropped to n. A block shorter than `per` is padded with zeros before
    the gather."""
    short = per - block.shape[0]
    if short:
        block = torch.cat([block, block.new_zeros((short, *block.shape[1:]))])
    return torch.cat(all_gather(mesh, block))[:n]


# ---------------------------------------------------------------------------
# escape-time grids
# ---------------------------------------------------------------------------


def _dwell_local(cr, ci, max_iter: int):
    """The per-shard dwell (no communication): the port's single-device
    ``dwell_grid`` on the block, returned in the coordinates' dtype as the
    reference's float dwell."""
    return mb.dwell_grid(cr, ci, max_iter=max_iter).to(cr.dtype)


def sharded_dwell_grid(domain, nx: int, ny: int, max_iter: int, mesh: Mesh,
                       dtype=torch.float32):
    """Row-sharded dwell grid over the mesh, each rank synthesizing its rows
    as ymin + (rank·rows_per + i)·dy and the columns as xmin + j·dx in
    `dtype`. ny must divide by the mesh size. Returns (ny, nx) on the
    rank's device."""
    if ny % mesh.size:
        raise ValueError(f"ny={ny} must be a multiple of mesh size {mesh.size}")
    xmin, xmax, ymin, ymax = domain
    dx = (xmax - xmin) / (nx - 1)
    dy = (ymax - ymin) / (ny - 1)
    rows_per = ny // mesh.size
    dev = mesh.device
    rows = float(mesh.rank * rows_per) + torch.arange(rows_per, dtype=dtype, device=dev)
    cols = torch.arange(nx, dtype=dtype, device=dev)
    cr = (xmin + cols[None, :] * dx).expand(rows_per, nx)
    ci = (ymin + rows[:, None] * dy).expand(rows_per, nx)
    return torch.cat(all_gather(mesh, _dwell_local(cr, ci, max_iter)))


def sharded_dwell_rows(cr, ci, max_iter: int, mesh: Mesh):
    """Row-sharded dwell over PRECOMPUTED coordinate grids (the caller's
    exact nodes, e.g. np.linspace grids, so a mesh run of the boundary
    pipeline gives bitwise the single-device dwell field). ny must be a
    mesh multiple (pad and crop at the call site). Returns (ny, nx) in the
    coordinates' dtype on the rank's device."""
    cr = torch.as_tensor(cr, device=mesh.device)
    ci = torch.as_tensor(ci, dtype=cr.dtype, device=mesh.device)
    if cr.shape[0] % mesh.size:
        raise ValueError(f"ny={cr.shape[0]} must be a multiple of mesh size {mesh.size}")
    per = cr.shape[0] // mesh.size
    lo = mesh.rank * per
    return torch.cat(all_gather(mesh, _dwell_local(cr[lo : lo + per], ci[lo : lo + per],
                                                   max_iter)))


def sharded_dwell_field(domain, nx: int, ny: int, max_iter: int, mesh: Mesh):
    """K2's f32 dwell field (``mandelbrot_cuda.mandelbrot_field``, kind
    "dwell") with rows sharded over the mesh: each rank launches K2's row
    entry on its block of the whole grid's rows (the twin on a CPU rank), so
    the gathered field is bitwise the single-device K2 field. Returns (ny,
    nx) f32 on the rank's device."""
    lo, hi, per = _share(ny, mesh)
    block = mc.dwell_rows(domain, nx, ny, lo, hi - lo, max_iter=max_iter, device=mesh.device)
    return _gather_rows(mesh, block, per, ny)


def sharded_de_tci_field(domain, grid_n: int, mesh: Mesh, max_iter: int = 250,
                         escape_r: float = 250.0, eps: float = 1e-12,
                         dtype=torch.float64, grid=None):
    """(esc, d) of the TCI DE grid with rows sharded over the mesh.

    The coordinates are the single-device complex_grid's (or the caller's
    `grid=(cr, ci)`), sliced by rows, so every pixel's orbit is bitwise
    ``kernels.mandelbrot.de_field_tci``'s. Returns host arrays (grid_n,
    grid_n)."""
    if grid is not None:
        cr, ci = (torch.as_tensor(g, device=mesh.device) for g in grid)
    else:
        cr, ci = mb.complex_grid(domain, grid_n, grid_n, dtype=dtype, device=mesh.device)
    ny = cr.shape[0]
    lo, hi, per = _share(ny, mesh)
    esc, d, _, _ = mb.de_field_tci(cr[lo:hi], ci[lo:hi], max_iter=max_iter,
                                   escape_r=escape_r, eps=eps)
    esc = _gather_rows(mesh, esc, per, ny)
    d = _gather_rows(mesh, d, per, ny)
    return esc.cpu().numpy(), d.cpu().numpy()


# ---------------------------------------------------------------------------
# eigensweep and histograms
# ---------------------------------------------------------------------------


def sharded_eigensweep(ns, family: str = "lucas_all_ones", mesh: Mesh | None = None,
                       max_iters: int = 200):
    """Companion eigensweep (the port's f64 Aberth) with the polynomial
    batch sharded over the ranks. Pads the batch to a mesh multiple with
    low-degree polynomials that converge at once; returns (re, im, valid)
    on the rank's device with the padding rows cropped."""
    if mesh is None:
        mesh = device_mesh()
    fam = family if companion._closed_form_ok(ns, family) else None
    a, deg = companion.poly_coeff_batch(ns, family, device=mesh.device)
    b = a.shape[0]
    lo, hi, per = _share(b, mesh)
    a_loc, deg_loc = a[lo:hi], deg[lo:hi]
    short = per - a_loc.shape[0]
    if short:
        # pad rows: zero coefficients but the constant; their degree must
        # satisfy the closed form's own eligibility (the sparser family's
        # geometric identity needs n >= 2)
        pad = torch.zeros((short, a.shape[1]), dtype=a.dtype, device=a.device)
        pad[:, 0] = 1.0
        pad_deg = 2 if fam == "sparser_gap_1_0_1_then_ones" else 1
        a_loc = torch.cat([a_loc, pad])
        deg_loc = torch.cat([deg_loc, torch.full((short,), pad_deg, dtype=deg.dtype,
                                                 device=deg.device)])
    zr, zi, valid = companion.aberth_roots(a_loc, deg_loc, max_iters=max_iters, family=fam)
    return (torch.cat(all_gather(mesh, zr))[:b], torch.cat(all_gather(mesh, zi))[:b],
            torch.cat(all_gather(mesh, valid))[:b])


def sharded_histogram(points_r, points_i, bins: int, domain, mesh: Mesh):
    """Per-rank 2D histogram of a block of the points, summed over the ranks.

    The bins are np.histogram2d's over the domain (transport.histogram's
    np.linspace edges, cast to the points' dtype; interior edges
    right-inclusive, the last edge inclusive, points outside dropped).
    Counts are int64 and sum exactly, so the result equals the
    single-device histogram. Returns (bins, bins) counts in the points'
    dtype on the rank's device."""
    from cmtci_torch.transport.histogram import np_edges

    xr = torch.as_tensor(points_r, device=mesh.device).reshape(-1)
    xi = torch.as_tensor(points_i, dtype=xr.dtype, device=mesh.device).reshape(-1)
    lo, hi, _ = _share(xr.shape[0], mesh)
    x, y = xr[lo:hi], xi[lo:hi]
    xe, ye = (torch.as_tensor(e, dtype=xr.dtype, device=mesh.device)
              for e in np_edges(bins, domain))
    ix = torch.bucketize(x, xe, right=True) - 1
    iy = torch.bucketize(y, ye, right=True) - 1
    ix = torch.where(x == xe[-1], bins - 1, ix)
    iy = torch.where(y == ye[-1], bins - 1, iy)
    ok = (ix >= 0) & (ix < bins) & (iy >= 0) & (iy < bins)
    flat = torch.where(ok, ix * bins + iy, bins * bins)
    counts = torch.bincount(flat, minlength=bins * bins + 1)[: bins * bins]
    return all_reduce(mesh, counts).reshape(bins, bins).to(xr.dtype)


# ---------------------------------------------------------------------------
# pair scans: variograms, shell counts
# ---------------------------------------------------------------------------


def sharded_binned_sq_diff(c1, v1, c2, v2, r_edges, mesh: Mesh, upper: bool = True,
                           chunk: int = 512, dtype=None):
    """stats.variogram._binned_sq_diff with the i-rows sharded over the mesh.

    Each rank bins its row block's (value difference)² against the full
    replicated (c2, v2) set; upper=True applies the global j > i mask (the
    grid semivariogram), upper=False bins the full rectangle (the cross
    semivariogram). Counts are exact int64; the f64 sums are reduced over
    the ranks. `dtype` (default f64) is the working dtype. Returns host
    (sums f64, counts int64)."""
    from cmtci_torch.stats.variogram import _binned_sq_diff

    dt = torch.float64 if dtype is None else dtype
    dev = mesh.device
    r_edges = np.asarray(r_edges, dtype=float)
    c1, v1, c2, v2 = (torch.as_tensor(np.ascontiguousarray(a, dtype=float), dtype=dt,
                                      device=dev) for a in (c1, v1, c2, v2))
    lo, hi, _ = _share(c1.shape[0], mesh, chunk)
    edges = torch.as_tensor(r_edges, dtype=dt, device=dev)
    sums, counts = _binned_sq_diff(c1[lo:hi], v1[lo:hi], c2, v2, edges, len(r_edges) - 1,
                                   chunk, upper, row0=lo)
    return (all_reduce(mesh, sums).cpu().numpy(),
            all_reduce(mesh, counts).cpu().numpy())


def sharded_semivariogram(coords, values, r_edges, mesh: Mesh, chunk: int = 512):
    """All-pairs (j > i) semivariogram with the i-rows sharded over the mesh:
    the multi-device form of stats.variogram.grid_semivariogram on every
    point (no pair caps). Returns (gamma, counts int64)."""
    sums, counts = sharded_binned_sq_diff(coords, values, coords, values, r_edges, mesh,
                                          upper=True, chunk=chunk)
    gamma = np.zeros(len(counts))
    nz = counts > 0
    gamma[nz] = 0.5 * sums[nz] / counts[nz]
    return gamma, counts


def sharded_point_variogram(locs, values=None, max_dist=None, nbins: int = 50,
                            mesh: Mesh | None = None, chunk: int = 512, dtype=None):
    """stats.variogram.point_variogram_device with the i-rows sharded over
    the mesh: bin k holds edges[k] <= d < edges[k+1] (np.digitize(d, bins) -
    1; d == max_dist dropped), counts exact int64, f64 sums reduced over the
    ranks. max_dist=None takes 0.5·max(d), the maximum reduced over the
    ranks. `dtype` (default f64) is the working dtype. Returns (centers,
    gamma, counts) like the host function."""
    from cmtci_torch.stats.variogram import _point_variogram_rows

    if mesh is None:
        mesh = device_mesh()
    n = len(np.asarray(locs))
    lo, hi, _ = _share(n, mesh, chunk)
    return _point_variogram_rows(locs, values, max_dist, nbins, chunk,
                                 torch.float64 if dtype is None else dtype, mesh.device,
                                 rows=(lo, hi), combine=lambda op, t: all_reduce(mesh, t, op))


def sharded_shell_counts(points, r_max: float, dr: float, mesh: Mesh, chunk: int = 1024,
                         dtype=None):
    """stats.pointstats._shell_counts with the i-rows sharded over the mesh.

    Each rank bins the upper-triangle pair distances of its row block
    against the replicated cloud with the single-device head's
    pointstats._pair_hist (on a card one shellcount.cu launch over the
    rank's rows), so the int64 counts are bitwise the single-device ones at
    equal dtype (default f64). Returns the `_shells`
    tuple (r_vals, counts f64, n, rho) that pair_correlation and ripley_k
    take."""
    from cmtci_torch.stats.pointstats import _pair_hist

    dt = torch.float64 if dtype is None else dtype
    xy = _xy(points)
    n = len(xy)
    area = (xy[:, 0].max() - xy[:, 0].min()) * (xy[:, 1].max() - xy[:, 1].min())
    rho = n / area
    r_vals = np.arange(0, r_max, dr)
    edges = torch.as_tensor(np.concatenate([r_vals, [r_vals[-1] + dr]]), dtype=dt,
                            device=mesh.device)
    lo, hi, _ = _share(n, mesh, chunk)
    counts = _pair_hist(torch.as_tensor(xy, dtype=dt, device=mesh.device), edges,
                        len(r_vals), chunk, rows=(lo, hi))
    return r_vals, all_reduce(mesh, counts).cpu().numpy().astype(np.float64), n, rho


# ---------------------------------------------------------------------------
# analysis heads: kNN, symmetry angle scan, Green clouds, cloud potential
# ---------------------------------------------------------------------------


def sharded_knn(xy, k: int, mesh: Mesh, chunk: int = 2048):
    """Blocked dense kNN with the query rows sharded over the mesh: each
    row's top-k involves only that row and the replicated point set, so it
    is bitwise stats.embeddings._knn's. Returns host (distances (n, k),
    indices (n, k))."""
    from cmtci_torch.stats.embeddings import _knn

    xy = torch.as_tensor(np.asarray(xy, dtype=float), dtype=torch.float64,
                         device=mesh.device)
    n = xy.shape[0]
    lo, hi, per = _share(n, mesh, chunk)
    d, i = _knn(xy, int(k), chunk, rows=(lo, hi))
    return (_gather_rows(mesh, d, per, n).cpu().numpy(),
            _gather_rows(mesh, i, per, n).cpu().numpy())


def sharded_score_angles(points, angles, tol: float, mesh: Mesh):
    """Symmetry preservation fractions with the ANGLE scan sharded: each
    rank scores its slice of the angles against the replicated cloud; the
    per-angle scores are independent, so this equals
    stats.symmetry._score_angles bitwise (f64)."""
    from cmtci_torch.stats.symmetry import _score_angles

    angles = np.asarray(angles, dtype=float)
    a = len(angles)
    lo, hi, per = _share(a, mesh)
    frac = torch.as_tensor(_score_angles(points, angles[lo:hi], tol, torch.float64,
                                         mesh.device) if hi > lo else np.zeros(0),
                           dtype=torch.float64, device=mesh.device)
    return _gather_rows(mesh, frac, per, a).cpu().numpy()


def green_stage_executor(mesh: Mesh):
    """Point-sharded executor for kernels.mandelbrot._green_stage.

    Plugs into green_potential_compacted(stage_executor=...): each
    compaction stage's active points are split over the ranks (elementwise
    orbits), the seven results gathered; the host compaction walk is
    unchanged and runs alike on every rank."""

    def exec_(zr, zi, cr, ci, k0, iters, r2, dtype_max_iter):
        n = zr.shape[0]
        lo, hi, per = _share(n, mesh)
        out = mb._green_stage(zr[lo:hi], zi[lo:hi], cr[lo:hi], ci[lo:hi], k0, iters, r2,
                              dtype_max_iter)
        return tuple(_gather_rows(mesh, o, per, n) for o in out)

    return exec_


def sharded_green_cloud(points, max_iter: int = 20000, escape_r: float = 2.0,
                        mesh: Mesh | None = None, stage_iters: int = 512):
    """g_M / Phi of a point cloud, point-sharded over the mesh: the
    compaction staging of green_potential_compacted with each stage run
    across the ranks (f64 on the ranks' devices). Equal to the
    single-device path per point up to the last bits of exp2 and atan2,
    whose vectorized CPU forms differ from their scalar forms at a block's
    tail (held at rtol 1e-10). Returns host (g, k, phi)."""
    if mesh is None:
        mesh = device_mesh()
    return mb.green_potential_compacted(points, max_iter=max_iter, escape_r=escape_r,
                                        stage_iters=stage_iters, device=mesh.device,
                                        stage_executor=green_stage_executor(mesh))


def sharded_green_cloud_f32(points, max_iter: int = 20000, escape_r: float = 2.0,
                            mesh: Mesh | None = None):
    """(g, k, phi) of a point cloud through the f32 K3 head
    (``mandelbrot_cuda.green_cloud_f32``), point-sharded over the mesh: each
    rank runs the head on its contiguous block of points (K3 on the card,
    its twin on a CPU rank) and the three results are gathered. K3 and the
    head's host records are per point, so the result is the single-device
    head's. Returns host (g, k, phi)."""
    if mesh is None:
        mesh = device_mesh()
    pts = np.asarray(points, dtype=complex).ravel()
    lo, hi, per = _share(pts.size, mesh)
    g, k, phi = mc.green_cloud_f32(pts[lo:hi], max_iter=max_iter, escape_r=escape_r,
                                   device=mesh.device)
    block = torch.as_tensor(np.stack([g, k.astype(np.float64), phi.real, phi.imag], axis=1))
    out = _gather_rows(mesh, block.to(mesh.device), per, pts.size).cpu().numpy()
    return out[:, 0], out[:, 1].astype(np.int32), out[:, 2] + 1j * out[:, 3]


def sharded_cloud_potential(domain, nx: int, ny: int, pts, mesh: Mesh, eps: float = 1e-12,
                            sign: int = 1, dtype=torch.float32, chunk: int = 2048,
                            grid=None):
    """Row-sharded cloud log-potential grid (kernels.potential's multi-device
    head): each rank runs cloud_log_potential on its rows against the
    replicated cloud; per-pixel sums are independent, so no collective but
    the gather. The rows are the caller's `grid=(gx, gy)` (host arrays,
    e.g. the pipeline's np.linspace meshgrid, sliced by rows: bitwise the
    single-device grid's potential), or synthesized as xmin + j·dx and
    ymin + i·dy in `dtype` (then ny must be a mesh multiple). Reference
    conventions: Potentials.py:19-27 (sign=+1), Laplacian_C-M.py:16-24
    (sign=-1). Returns the (ny, nx) grid on the rank's device."""
    from cmtci_torch.kernels.potential import cloud_log_potential

    if grid is not None:
        gx, gy = (np.asarray(g) for g in grid)
        ny, nx = gx.shape
    else:
        if ny % mesh.size:
            raise ValueError(f"ny={ny} must be a multiple of mesh size {mesh.size}")
        xmin, xmax, ymin, ymax = domain
        dx = (xmax - xmin) / (nx - 1)
        dy = (ymax - ymin) / (ny - 1)
        cols = torch.arange(nx, dtype=dtype)
        rows = torch.arange(ny, dtype=dtype)
        gx = (xmin + cols[None, :] * dx).expand(ny, nx).numpy()
        gy = (ymin + rows[:, None] * dy).expand(ny, nx).numpy()
    lo, hi, per = _share(ny, mesh)
    u = cloud_log_potential(gx[lo:hi], gy[lo:hi], pts, eps=eps, sign=sign, chunk=chunk,
                            device=mesh.device)
    return _gather_rows(mesh, u, per, ny)


# ---------------------------------------------------------------------------
# the tracker stage, sharded (gi_assumption_tracker_v3.py:212-247)
# ---------------------------------------------------------------------------


def _match_core(rows, b_all, mean, eps):
    """Per-row kernel argmax: sinkhorn._argmax_kernel_rows's math."""
    from cmtci_torch.transport.sinkhorn import _pairwise_dist

    d = _pairwise_dist(rows, b_all) / mean
    k = torch.nan_to_num(torch.exp(-d / eps))
    return torch.argmax(k, dim=1)


def sharded_argmax_match(ax, by, eps: float, mesh: Mesh, chunk: int = 2048):
    """Kernel-argmax OT matcher with the rows of `ax` sharded over the mesh.

    Each rank matches its chunks of rows against the replicated `by`; the
    mean-distance normalizer sums the per-chunk f64 partials, gathered, in
    global chunk order, as the single-device blocked matcher
    (sinkhorn._blocked_dist_total) accumulates them, and takes the mean by
    the same epilogue, so the match is bitwise the single-device twin's.
    Returns host int64 match indices (n,)."""
    ax = torch.as_tensor(ax, device=mesh.device)
    by = torch.as_tensor(by, dtype=ax.dtype, device=mesh.device)
    return _sharded_argmax_match_dev(ax, by, ax.shape[0], eps, mesh, chunk).cpu().numpy()


def _sharded_argmax_match_dev(a, b, n: int, eps, mesh: Mesh, chunk: int):
    """Device core of sharded_argmax_match: (n,) int64 on every rank."""
    from cmtci_torch.kernels.argmax_match import mean_from_total
    from cmtci_torch.transport.sinkhorn import _pairwise_dist

    n_chunks = -(-n // chunk)
    lo_c, hi_c, k_loc = _share(n_chunks, mesh)
    parts = torch.zeros(k_loc, dtype=torch.float64, device=a.device)
    for j, c in enumerate(range(lo_c, hi_c)):
        parts[j] = torch.sum(_pairwise_dist(a[c * chunk : (c + 1) * chunk], b),
                             dtype=torch.float64)
    all_parts = torch.cat(all_gather(mesh, parts))
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    for c in range(n_chunks):  # global chunk order, as _blocked_dist_total adds
        total = total + all_parts[c]
    mean = mean_from_total(total, n, b.shape[0], a.dtype)
    out = torch.zeros(k_loc * chunk, dtype=torch.int64, device=a.device)
    for j, c in enumerate(range(lo_c, hi_c)):
        rows = a[c * chunk : (c + 1) * chunk]
        out[j * chunk : j * chunk + rows.shape[0]] = _match_core(rows, b, mean, eps)
    return torch.cat(all_gather(mesh, out))[:n]


def _masked_quantile(vals, mask, q):
    """np.quantile(vals[mask], q) with linear interpolation, fixed shapes.

    With an all-false mask the indices are clamped into range and the result
    is the +inf sentinel; callers surface the empty count themselves
    (tracker_train_step returns n_escaped for that)."""
    v = torch.sort(torch.where(mask, vals, float("inf"))).values
    cnt = int(mask.sum())
    pos = torch.tensor(q, dtype=vals.dtype) * float(max(cnt - 1, 0))
    last = vals.shape[0] - 1
    lo = min(max(int(math.floor(float(pos))), 0), last)
    hi = min(max(int(math.ceil(float(pos))), 0), last)
    frac = pos.to(vals.device) - float(lo)
    # frac == 0 takes v[lo] exactly (no inf*0 = nan on the empty-mask sentinel)
    return torch.where(frac > 0, v[lo] * (1.0 - frac) + v[hi] * frac, v[lo])


def _rotation_align(x0r, x0i, y0r, y0i):
    """Optimal rotation angle aligning centered x onto centered y (2-D):
    closed-form orthogonal Procrustes in the proper-rotation case
    (tci_construct_mandelbrot_v002_fixed.py:73-78)."""
    a = torch.sum(x0r * y0r + x0i * y0i)
    b = torch.sum(x0r * y0i - x0i * y0r)
    return torch.atan2(b, a)


def _hist_prob(xr, xi, bins: int, domain, sigma_bins: float, eps, mesh: Mesh):
    """Point-sharded mollified probability histogram on the rank's device,
    in the points' dtype: counts summed over the ranks, floored at eps,
    scipy's 'nearest' Gaussian filter as transport.histogram's torch
    expression tree, re-floored, normalized."""
    from cmtci_torch.transport.histogram import _sep_correlate_nearest, gaussian_kernel1d

    h = torch.clamp(sharded_histogram(xr, xi, bins, domain, mesh), min=eps)
    if sigma_bins and sigma_bins > 0:
        k = gaussian_kernel1d(float(sigma_bins))
        h = _sep_correlate_nearest(h, torch.as_tensor(k, dtype=h.dtype, device=h.device),
                                   (len(k) - 1) // 2)
        h = torch.clamp(h, min=eps)
    return h / h.sum()


def _kl(p, x, eps):
    p = torch.clamp(p, min=eps)
    x = torch.clamp(x, min=eps)
    return torch.sum(p * (torch.log(p) - torch.log(x)))


def host_tracker_cloud(ns, family: str = "lucas_all_ones", dtype=torch.float32):
    """Inverse-eigenvalue cloud for tracker_train_step(cloud=...): the f64
    Aberth sweep on the host CPU, flattened to (re, im, valid) with the
    invalid lanes zeroed, cast to `dtype` (CPU tensors)."""
    ir, ii, valid = companion.inverse_cloud_padded(ns, family, device="cpu")
    v = valid.reshape(-1)
    cr = torch.where(v, ir.reshape(-1), 0.0).to(dtype)
    ci = torch.where(v, ii.reshape(-1), 0.0).to(dtype)
    return cr, ci, v


def _gumbel(gen: torch.Generator, n: int) -> torch.Tensor:
    """n standard Gumbel draws (f32, CPU) from `gen`: -log of Exp(1)."""
    return -torch.log(torch.empty(n, dtype=torch.float32).exponential_(generator=gen))


def tracker_train_step(mesh: Mesh, ns, domain, grid_n: int, n_samples: int, bins: int,
                       key: int, max_iter: int = 64, escape_r: float = 250.0,
                       sinkhorn_eps: float = 0.8, sigma_bins: float = 1.0, alpha: float = 0.1,
                       t_steps: int = 5, eps: float = 1e-12, chunk: int = 256,
                       dtype=torch.float32, cloud=None) -> dict:
    """The tracker stage as one fixed-shape multi-device step.

    sample -> match -> Procrustes -> mollify -> GI flow
    (gi_assumption_tracker_v3.py:212-247):

      * the C cloud from `cloud` = (re, im, valid) flat arrays
        (host_tracker_cloud) or from the batch-sharded eigensweep;
      * the TCI DE grid row-sharded, rows built as ymin + (rank·rows_per +
        i)·dy in `dtype`; the escaped & d <= q25 band as a mask, then
        subsampling without replacement by Gumbel top-k on the gathered
        grid (band points first, other escaped points after);
      * the kernel-argmax matcher with the C rows sharded;
      * rotation Procrustes in closed form; mollified histograms
        point-sharded, summed over the ranks; GI flow on the replicated
        histograms.

    `key` seeds a torch.Generator (on the CPU) that draws the Gumbel noise
    of the grid's pixels, then of the cloud's lanes, identically on every
    rank: jax.random's draws cannot be reproduced, so the step equals the
    reference statistically, and bitwise itself at any world size. Returns a
    dict of scalar diagnostics; callers check n_samples <= n_escaped and
    n_valid_roots (the top-k would otherwise take masked entries).
    """
    dev = mesh.device
    # 1. C cloud
    if cloud is not None:
        cr_pts, ci_pts, vflat = (torch.as_tensor(c, device=dev) for c in cloud)
        cr_pts, ci_pts, vflat = cr_pts.to(dtype), ci_pts.to(dtype), vflat.bool()
    else:
        zr, zi, valid = sharded_eigensweep(ns, mesh=mesh)
        ir, ii = cplx.reciprocal((zr, zi))
        vflat = valid.reshape(-1)
        cr_pts = torch.where(vflat, ir.reshape(-1), 0.0).to(dtype)
        ci_pts = torch.where(vflat, ii.reshape(-1), 0.0).to(dtype)

    # 2. M sample: row-sharded TCI DE grid, quantile band, Gumbel top-k
    xmin, xmax, ymin, ymax = domain
    dx = (xmax - xmin) / (grid_n - 1)
    dy = (ymax - ymin) / (grid_n - 1)
    _, _, rows_per = _share(grid_n, mesh)
    rows = float(mesh.rank * rows_per) + torch.arange(rows_per, dtype=dtype, device=dev)
    xs = xmin + torch.arange(grid_n, dtype=dtype, device=dev) * dx
    cr = xs[None, :].expand(rows_per, grid_n)
    ci = (ymin + rows[:, None] * dy).expand(rows_per, grid_n)
    esc, d, _, _ = mb.de_field_tci(cr, ci, max_iter=max_iter, escape_r=escape_r, eps=eps)
    escf = torch.cat(all_gather(mesh, esc))[:grid_n].reshape(-1)
    df = torch.cat(all_gather(mesh, d))[:grid_n].reshape(-1)
    ys = ymin + torch.arange(grid_n, dtype=dtype, device=dev) * dy
    q = _masked_quantile(df, escf, 0.25)
    sel = escf & (df <= q)
    if n_samples > escf.shape[0] or n_samples > vflat.shape[0]:
        raise ValueError(
            f"tracker_train_step: n_samples={n_samples} exceeds the pixel "
            f"({escf.shape[0]}) or root-lane ({vflat.shape[0]}) pool — the "
            "Gumbel top-k would select masked entries")
    gen = torch.Generator().manual_seed(int(key))
    g1 = _gumbel(gen, escf.shape[0]).to(dev)
    g2 = _gumbel(gen, vflat.shape[0]).to(dev)
    # band points first; escaped points outside the band fill any remainder
    # (Gumbel values lie in about [-3, 20] here: +1e4 separates the tiers)
    score = torch.where(sel, g1 + 1e4, torch.where(escf, g1, float("-inf")))
    midx = torch.topk(score, n_samples).indices
    mxr = xs[midx % grid_n]
    mxi = ys[midx // grid_n]

    # 3. C subsample to the matcher size (Gumbel top-k over the valid lanes)
    cidx = torch.topk(torch.where(vflat, g2, float("-inf")), n_samples).indices
    cxr, cxi = cr_pts[cidx], ci_pts[cidx]

    # 4. kernel-argmax matcher, C rows sharded against the replicated M
    match = _sharded_argmax_match_dev(torch.stack([cxr, cxi], dim=1),
                                      torch.stack([mxr, mxi], dim=1), n_samples,
                                      sinkhorn_eps, mesh, chunk)
    myr, myi = mxr[match], mxi[match]

    # 5. Procrustes (rotation + translation, closed-form 2x2)
    cmr, cmi = torch.mean(cxr), torch.mean(cxi)
    mmr, mmi = torch.mean(myr), torch.mean(myi)
    x0r, x0i = cxr - cmr, cxi - cmi
    y0r, y0i = myr - mmr, myi - mmi
    th = _rotation_align(x0r, x0i, y0r, y0i)
    ct, st = torch.cos(th), torch.sin(th)
    axr = x0r * ct - x0i * st + mmr
    axi = x0r * st + x0i * ct + mmi

    # 6. mollified histograms (point-sharded) + GI flow
    p_m = _hist_prob(mxr, mxi, bins, domain, sigma_bins, eps, mesh)
    p_c = _hist_prob(axr, axi, bins, domain, sigma_bins, eps, mesh)
    kl0 = _kl(p_m, p_c, eps)
    x_t = p_c
    for _ in range(t_steps):
        x_t = (1.0 - alpha) * x_t + alpha * p_m
    delta = _kl(p_m, x_t, eps)
    return {
        "kl_initial": float(kl0), "delta_n": float(delta),
        "tv_XT_PM": float(0.5 * torch.sum(torch.abs(x_t - p_m))),
        "tv_PC_PM": float(0.5 * torch.sum(torch.abs(p_c - p_m))),
        "overlap_mass_PC_PM": float(torch.sum(torch.minimum(p_c, p_m))),
        "n_escaped": int(escf.sum()), "q25": float(q),
        "n_valid_roots": int(vflat.sum()),
    }


def analysis_step(ns, domain, grid_n: int, bins: int, max_iter: int, mesh: Mesh,
                  alpha: float = 0.1, gi_steps: int = 5, eps: float = 1e-12) -> dict:
    """The sharded analysis step: eigensweep (batch-sharded) -> inverse-cloud
    histogram (point-sharded, summed) -> dwell grid (row-sharded) ->
    escape-proxy histogram -> GI flow on the replicated histograms. Returns
    the small diagnostics kl, escaped_frac and n_roots."""
    dev = mesh.device
    zr, zi, valid = sharded_eigensweep(ns, mesh=mesh)
    inv_r, inv_i = cplx.reciprocal((zr, zi))
    # invalid lanes go outside the domain, so the histogram drops them
    inv_r = torch.where(valid, inv_r, domain[1] + 1.0)
    inv_i = torch.where(valid, inv_i, domain[3] + 1.0)
    p_c = torch.clamp(sharded_histogram(inv_r, inv_i, bins, domain, mesh), min=eps)
    p_c = p_c / p_c.sum()

    dwell = sharded_dwell_grid(domain, grid_n, grid_n, max_iter, mesh)
    esc = dwell < max_iter
    xs = torch.as_tensor(np.linspace(domain[0], domain[1], grid_n), device=dev)
    ys = torch.as_tensor(np.linspace(domain[2], domain[3], grid_n), device=dev)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    wr = torch.where(esc, gx.to(dwell.dtype), domain[1] + 1.0)
    wi = torch.where(esc, gy.to(dwell.dtype), domain[3] + 1.0)
    p_m = torch.clamp(sharded_histogram(wr, wi, bins, domain, mesh), min=eps)
    p_m = p_m / p_m.sum()
    x_t = p_c
    for _ in range(gi_steps):
        x_t = (1.0 - alpha) * x_t + alpha * p_m
    return {"kl": float(_kl(p_m, x_t, eps)),
            "escaped_frac": float(torch.mean(esc.to(torch.float32))),
            "n_roots": int(valid.sum())}
