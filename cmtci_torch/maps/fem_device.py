"""Device FEM θ-iteration (S2-S4 on the card), on PyTorch.

Port of ``cmtci/maps/fem_device.py``. The reference solves the Laplace
Dirichlet problem and the harmonic conjugate with scipy `spsolve` per
θ-iteration pass (lucas_to_cardioid_v18_periodic_theta_crbins_artifacts.py:
726-727, assembly :331-346); the host rebuild (cmtci_torch.maps.fem) factors
each system once with SuperLU. This module runs the whole iteration on a
device:

  * the operators (Dirichlet K_ff, Dirichlet K_fb, the Schur-condensed
    Neumann K for the conjugate) go to the device as COO triplets of
    canonical CSR (no duplicate entries) and are scattered into dense
    matrices there;
  * both SPD blocks are symmetrically equilibrated (D^-1/2 K D^-1/2: the
    Lucas alpha-shape meshes carry slim boundary triangles whose stiffness
    diagonal spans ~1e11) and Cholesky-factorized once; every pass is two
    triangular solves a system plus the weak-form conjugate right-hand side,
    an `index_add_` over the triangles;
  * the conjugate is the statically condensed, rank-one-lifted full Neumann
    system (the host Schur-eliminates the high-diagonal sliver nodes in
    f64; the device recovers v_s = K_ss⁻¹b_s − W v_r per pass), shifted so
    v[pin] = 0;
  * the θ machinery (circle normalization with a median radius, anchored
    unwrap, periodic moving average, 2π-mismatch redistribution,
    relaxation) runs in torch between the solves.

dtype: None is float64 on the device (Hopper has native f64), and the result
is the device's own solve. float32 runs the same code; its
`final_host_solve` (the default exactly for float32) re-solves the final
pass on the host in f64 with SuperLU at the converged θ. The host
preparation (`_reduced_systems`, `_equilibrated_coo`, `_condense_slivers`,
`_mesh_prep` with its FIFO cache) is the reference's.

Medians here average the two middle values, as numpy's and jnp's do
(torch.median returns the lower one); the unwrap is numpy's formula with its
±π tie rule.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import scipy.sparse as sp
import torch

from cmtci_torch.utils.device import resolve_device


def _resolve_dtype(dtype):
    dt = torch.float64 if dtype is None else dtype
    if dt not in (torch.float64, torch.float32):
        raise ValueError(f"unsupported dtype {dtype!r}")
    return dt


def _np_dtype(dt):
    return np.float32 if dt == torch.float32 else np.float64


def _coo_parts(m: sp.spmatrix, dtype, device):
    c = m.tocoo()
    return (torch.as_tensor(c.row.astype(np.int64), device=device),
            torch.as_tensor(c.col.astype(np.int64), device=device),
            torch.as_tensor(c.data.astype(_np_dtype(dtype)), device=device))


def _dense_from_coo(rows, cols, vals, shape):
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    return out.index_put_((rows, cols), vals, accumulate=True)


def _median(x):
    """Median with numpy's rule: the mean of the two middle values when the
    count is even (torch.median would return the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    m = n // 2
    if n % 2:
        return s[m]
    return (s[m - 1] + s[m]) * 0.5


def _unwrap(p):
    """np.unwrap (period 2π, discont π) of a 1-D tensor."""
    dd = p[1:] - p[:-1]
    ddmod = torch.remainder(dd + math.pi, 2.0 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), math.pi, ddmod)
    ph_correct = torch.where(torch.abs(dd) < math.pi, 0.0, ddmod - dd)
    return torch.cat([p[:1], p[1:] + torch.cumsum(ph_correct, dim=0)])


def _unwrap_anchored(theta, anchor: int):
    """Torch version of fem.unwrap_theta (np.unwrap + 2π re-anchoring)."""
    u = _unwrap(theta)
    off = u[anchor] - theta[anchor]
    return u - 2.0 * math.pi * torch.round(off / (2.0 * math.pi))


def _moving_avg_periodic(x, w: int, winding):
    """Torch version of fem.moving_average_periodic (w odd): the reference
    device path's shifted-slice sum, in its order."""
    if w <= 1:
        return x
    pad = w // 2
    x_ext = torch.cat([x[-pad:] - winding, x, x[:pad] + winding])
    n = x.shape[0]
    acc = x_ext[:n]
    for i in range(1, w):
        acc = acc + x_ext[i : i + n]
    return acc / float(w)


def _circle_normalize(ub, vb):
    """Torch version of fem.circle_normalize_boundary (mean center, median
    radius with the degenerate-radius fallback, v18:674-684)."""
    cu = torch.mean(ub)
    cv = torch.mean(vb)
    r_abs = torch.hypot(ub - cu, vb - cv)
    r = _median(r_abs)
    r = torch.where(torch.isfinite(r) & (r >= 1e-12), r, torch.mean(r_abs) + 1e-12)
    return cu, cv, r


def _chol_solve(l_fac, b):
    """x with L Lᵀ x = b via two triangular solves."""
    return torch.cholesky_solve(b[:, None], l_fac)[:, 0]


def _factor(k):
    """(L, info) of a dense SPD matrix; info is checked where the result is
    read, so factoring does not wait on the device."""
    return torch.linalg.cholesky_ex(k)


def _check_info(info, what: str):
    bad = int(info)
    if bad:
        raise RuntimeError(f"{what}: Cholesky failed (leading minor {bad} is not "
                           "positive definite)")


def _theta_core(prep, t_param, *, n: int, iters: int, relax: float, smooth: int,
                anchor: int, pin: int, feedback: bool, periodic_enforce: bool):
    """The θ-iteration on the device. Returns the device tensors (uv,
    scalars (cu, cv, r, period_mis), theta, drifts, infos)."""
    dtype = prep["area"].dtype
    ffd, fbd, sred = prep["ffd_eq"], prep["fbd"], prep["sred_eq"]
    d_d, d_s, w_hat = prep["d_d"], prep["d_s"], prep["w_hat"]
    kss_inv, w_bs = prep["kss_inv"], prep["w_bs"]
    r_idx, s_idx = prep["r_idx"], prep["s_idx"]
    tris, grads, area = prep["tris"], prep["grads"], prep["area"]
    bnd_idx, free_d_idx = prep["bnd_idx"], prep["free_d_idx"]
    nf_d = free_d_idx.shape[0]
    nb = bnd_idx.shape[0]
    nr = r_idx.shape[0]
    # ffd/sred arrive equilibrated; sred is the Schur-condensed Neumann
    # operator on the r (non-sliver) nodes, w_hat its equilibrated constant
    # null vector, kss_inv/w_bs the f64-host-prepared |s|-block inverse and
    # couplings W = K_ss⁻¹K_sr
    kd = _dense_from_coo(*ffd, (nf_d, nf_d))
    kb = _dense_from_coo(*fbd, (nf_d, nb))
    kc = _dense_from_coo(*sred, (nr, nr)) + w_hat[:, None] * w_hat[None, :]
    lc, info_c = _factor(kc)
    ld, info_d = _factor(kd)
    two_pi = 2.0 * math.pi
    tri_flat = tris.reshape(-1)

    def solve_conj(rhs):
        b_s = rhs[s_idx]
        b_r = rhs[r_idx] - w_bs.T @ b_s
        v_r = d_s * _chol_solve(lc, d_s * b_r)
        v_s = kss_inv @ b_s - w_bs @ v_r
        v0 = torch.zeros((n,), dtype=dtype, device=rhs.device)
        v0[r_idx] = v_r
        v0[s_idx] = v_s
        return v0 - v0[pin]

    def solve_uv(th_bnd):
        g = torch.cos(th_bnd)
        uf = d_d * _chol_solve(ld, -d_d * (kb @ g))
        u = torch.zeros((n,), dtype=dtype, device=g.device)
        u[bnd_idx] = g
        u[free_d_idx] = uf
        gu = torch.einsum("ta,tad->td", u[tris], grads)
        ju = torch.stack([-gu[:, 1], gu[:, 0]], dim=-1)
        contrib = area[:, None] * torch.einsum("td,tad->ta", ju, grads)
        rhs = torch.zeros((n,), dtype=dtype, device=g.device).index_add_(
            0, tri_flat, contrib.reshape(-1))
        return u, solve_conj(rhs)

    theta0 = -math.pi + two_pi * t_param
    theta = theta0
    period_mis = torch.full((), float("nan"), dtype=dtype, device=t_param.device)
    drifts = []
    for _ in range(iters):
        u, v = solve_uv(theta if feedback else theta0)
        cu, cv, r = _circle_normalize(u[bnd_idx], v[bnd_idx])
        theta_new = torch.atan2((v[bnd_idx] - cv) / r, (u[bnd_idx] - cu) / r)
        if feedback:
            theta_new = _unwrap_anchored(theta_new, anchor)
            span = theta_new[-1] - theta_new[0]
            wind = two_pi * torch.round(span / two_pi + 0.1 * torch.sign(span))
            theta_new = _moving_avg_periodic(theta_new, smooth, wind)
        else:
            theta_new = _moving_avg_periodic(theta_new, smooth, 0.0)
            theta_new = _unwrap_anchored(theta_new, anchor)
        if periodic_enforce:
            theta_new = theta_new - theta_new[0]
            period_mis = (theta_new[-1] - theta_new[0]) - two_pi
            theta_new = theta_new - period_mis * t_param
        drifts.append(_median(torch.abs(theta_new - theta)))
        theta = (1.0 - relax) * theta + relax * theta_new

    u, v = solve_uv(theta if feedback else theta0)
    cu, cv, r = _circle_normalize(u[bnd_idx], v[bnd_idx])
    uv = torch.stack([(u - cu) / r, (v - cv) / r])
    scalars = torch.stack([cu, cv, r, period_mis])
    drifts = torch.stack(drifts) if drifts else torch.zeros((0,), dtype=dtype,
                                                             device=t_param.device)
    return {"uv": uv, "scalars": scalars, "theta": theta, "drifts": drifts,
            "info": torch.stack([info_d, info_c])}


def _reduced_systems(k: sp.csr_matrix, bnd_ord: np.ndarray, pin: int = 0):
    """Host extraction of the three reduced operators (cheap CSR slicing)."""
    n = k.shape[0]
    free_d = np.ones(n, dtype=bool)
    free_d[bnd_ord] = False
    free_c = np.ones(n, dtype=bool)
    free_c[pin] = False
    return (k[free_d][:, free_d], k[free_d][:, bnd_ord], k[free_c][:, free_c],
            np.where(free_d)[0], np.where(free_c)[0])


def _equilibrated_coo(m: sp.spmatrix, dtype, device):
    """(COO triplets of D^-1/2 M D^-1/2 on `device`, d = 1/sqrt(diag M)) —
    scaling in f64 on the host so f32 triplets carry no extra roundoff."""
    c = m.tocoo()
    d = 1.0 / np.sqrt(c.tocsr().diagonal())
    vals = c.data * d[c.row] * d[c.col]
    return (torch.as_tensor(c.row.astype(np.int64), device=device),
            torch.as_tensor(c.col.astype(np.int64), device=device),
            torch.as_tensor(vals.astype(_np_dtype(dtype)), device=device)), d


def _condense_slivers(k: sp.csr_matrix, diag_factor: float = 1e6):
    """Static condensation of the sliver vertices out of the Neumann K.

    Sliver nodes — diag(K) > diag_factor·median(diag(K)), from slim
    alpha-shape boundary triangles — are the source of the λ≈1e-11
    equilibrated modes that break an f32 factorization. Eliminating them
    exactly (f64 host Schur complement over a ~10-node dense block) leaves
    a reduced Neumann operator whose equilibrated+lifted κ is ~3e3.

    Returns (r_idx, s_idx, S, kss_inv, W) with S = K_rr − K_rs K_ss⁻¹ K_sr
    (sparse — W inherits K_sr's column sparsity) and W = K_ss⁻¹ K_sr.
    """
    dg = k.diagonal()
    s_mask = dg > diag_factor * np.median(dg)
    s_idx = np.where(s_mask)[0]
    r_idx = np.where(~s_mask)[0]
    if len(s_idx) == 0:
        return r_idx, s_idx, k, np.zeros((0, 0)), sp.csr_matrix((0, k.shape[0]))
    kss_inv = np.linalg.inv(k[s_idx][:, s_idx].toarray())
    k_sr = k[s_idx][:, r_idx].tocsr()
    w = sp.csr_matrix(kss_inv) @ k_sr
    s_red = (k[r_idx][:, r_idx] - k[r_idx][:, s_idx] @ w).tocsr()
    return r_idx, s_idx, s_red, kss_inv, w


def _host(x):
    return x.cpu().numpy().astype(np.float64)


class ThetaHandle:
    """Handle of a dispatched device θ-iteration.

    torch queues the device's work without waiting for it, so a pipeline can
    dispatch every level's iteration (the host meshes the next level while
    the device solves), then `.result()` each. `prefetch()` is the
    reference's dispatch/prefetch/result protocol, which uniformize_fem
    drives; here the few result vectors are read in result(). result()
    checks the factorizations and, for an f32 run with final_host_solve,
    re-solves the final pass on the host in f64 at the converged θ, reusing
    the prep cache's SuperLU factors.
    """

    def __init__(self, out, ctx):
        self._out = out
        self._ctx = ctx

    def prefetch(self):
        return self

    def result(self):
        from cmtci_torch.maps import fem

        c = self._ctx
        out = {k: v.cpu().numpy() for k, v in self._out.items()}
        info = out["info"]
        _check_info(info[0], "the Dirichlet K_ff")
        _check_info(info[1], "the condensed Neumann K")
        uv = out["uv"].astype(np.float64)
        scalars = out["scalars"].astype(np.float64)
        theta_h = out["theta"].astype(np.float64)
        if c["verbose"]:
            for i, d in enumerate(out["drifts"], start=1):
                print(f"    [theta-iter/device] k={i}/{c['iters']} median "
                      f"drift {float(d):.6f} rad")
        if c["final_host_solve"]:
            n = c["n"]
            period_mis = float(scalars[3])
            bnd_ord, s_b, big_l = c["bnd_ord"], c["s_b"], c["big_l"]
            prep = c["prep"]
            triangles, grads, area = (prep["triangles_np"], prep["grads_np"],
                                      prep["area_np"])
            th0 = -np.pi + 2.0 * np.pi * (s_b / big_l)
            solve_d, solve_c = prep["splu_d"], prep["splu_c"]
            g = np.cos(theta_h if c["feedback"] else th0)
            u = np.zeros(n)
            u[bnd_ord] = g
            u[prep["free_d_idx_np"]] = solve_d(-(prep["k_fb_np"] @ g))
            rhs = fem._conjugate_rhs(triangles, grads, area, u, n)
            v = np.zeros(n)
            v[prep["free_c_idx_np"]] = solve_c(rhs[prep["free_c_idx_np"]])
            wb = u[bnd_ord] + 1j * v[bnd_ord]
            c_last, r_last, _ = fem.circle_normalize_boundary(wb)
            w = (u + 1j * v - c_last) / r_last
            return w.real, w.imag, c_last, r_last, period_mis
        return (uv[0], uv[1], complex(scalars[0], scalars[1]),
                float(scalars[2]), float(scalars[3]))


_PREP_CACHE: dict = {}
_PREP_CACHE_MAX = 24


def _mesh_prep(points, triangles, bnd_ord, dtype, need_splu: bool, device):
    """Device-resident per-mesh dispatch state, memoized.

    Everything that depends only on (mesh, boundary order, dtype, device) —
    the equilibrated COO triplets on the device, the condensation couplings,
    the index arrays, and (lazily) the SuperLU factors for the final f64
    host solve. Bounded FIFO cache.
    """
    from cmtci_torch.maps import fem

    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(points))
    h.update(np.ascontiguousarray(triangles))
    h.update(np.ascontiguousarray(bnd_ord))
    key = (h.hexdigest(), str(dtype), str(device))
    prep = _PREP_CACHE.get(key)
    if prep is None:
        npdt = _np_dtype(dtype)

        def dev_t(x, dt=npdt):
            return torch.as_tensor(np.ascontiguousarray(x).astype(dt), device=device)

        k = fem.assemble_stiffness(points, triangles)
        grads, area = fem.p1_grads_areas(points, triangles)
        kffd, kfbd, kffc, free_d_idx, free_c_idx = _reduced_systems(k, bnd_ord)
        ffd_eq, d_d = _equilibrated_coo(kffd, dtype, device)
        r_idx, s_idx, s_red, kss_inv, w_cpl = _condense_slivers(k)
        sred_eq, d_s = _equilibrated_coo(s_red, dtype, device)
        w = 1.0 / d_s  # D^{1/2}·1_r — the reduced Neumann null vector
        w_hat = w / np.linalg.norm(w)
        n = len(points)
        free_d = np.ones(n, dtype=bool)
        free_d[bnd_ord] = False
        prep = dict(
            ffd_eq=ffd_eq, fbd=_coo_parts(kfbd, dtype, device), sred_eq=sred_eq,
            d_d=dev_t(d_d), d_s=dev_t(d_s), w_hat=dev_t(w_hat),
            kss_inv=dev_t(kss_inv), w_bs=dev_t(w_cpl.toarray()),
            r_idx=dev_t(r_idx, np.int64), s_idx=dev_t(s_idx, np.int64),
            tris=dev_t(triangles, np.int64), grads=dev_t(grads), area=dev_t(area),
            bnd_idx=dev_t(bnd_ord, np.int64), free_d_idx=dev_t(free_d_idx, np.int64),
            triangles_np=triangles, grads_np=grads, area_np=area,
            kffd=kffd, kffc=kffc, k_fb_np=k[free_d][:, bnd_ord].tocsr(),
            free_d_idx_np=free_d_idx, free_c_idx_np=free_c_idx,
            splu_d=None, splu_c=None,
        )
        if len(_PREP_CACHE) >= _PREP_CACHE_MAX:
            _PREP_CACHE.pop(next(iter(_PREP_CACHE)))
        _PREP_CACHE[key] = prep
    if need_splu and prep["splu_d"] is None:
        prep["splu_d"] = sp.linalg.splu(prep["kffd"].tocsc()).solve
        prep["splu_c"] = sp.linalg.splu(prep["kffc"].tocsc()).solve
    return prep


def dispatch_theta_iteration_device(
    points, triangles, poly,
    iters: int = 6, relax: float = 0.7, smooth: int = 7,
    unwrap_anchor: int = 0, periodic_enforce: bool = True,
    feedback: bool = True, verbose: bool = False,
    bnd_data=None, dtype=None, final_host_solve: bool | None = None, device="cuda",
) -> ThetaHandle:
    """Dispatch the θ-iteration to `device`; returns a ThetaHandle.

    dtype=None is float64. final_host_solve (default: True exactly when the
    device runs f32) re-solves the final pass on the host with SuperLU in
    f64 at the device-converged θ. The per-mesh state (equilibrated
    operators on the device, condensation couplings, SuperLU factors) is
    memoized in _PREP_CACHE, so a warm repeat ships nothing but the solves.
    """
    from cmtci_torch.maps import fem

    dev = resolve_device(device)
    bnd_ord, s_b, big_l = (bnd_data if bnd_data is not None
                           else fem.boundary_order_by_arclength(points, triangles, poly))
    dtype = _resolve_dtype(dtype)
    if final_host_solve is None:
        final_host_solve = dtype == torch.float32

    smooth = int(smooth)
    if smooth > 1 and smooth % 2 == 0:
        smooth += 1  # host moving_average_periodic widens even windows

    n = len(points)
    prep = _mesh_prep(points, triangles, bnd_ord, dtype, need_splu=final_host_solve,
                      device=dev)
    out = _theta_core(
        prep, torch.as_tensor((s_b / big_l).astype(_np_dtype(dtype)), device=dev),
        n=n, iters=int(iters), relax=float(relax), smooth=smooth,
        anchor=int(unwrap_anchor), pin=0, feedback=bool(feedback),
        periodic_enforce=bool(periodic_enforce),
    )
    ctx = dict(verbose=verbose, final_host_solve=final_host_solve,
               feedback=feedback, n=n, iters=int(iters), bnd_ord=bnd_ord,
               s_b=s_b, big_l=big_l, prep=prep)
    return ThetaHandle(out, ctx)


def theta_iteration_device(points, triangles, poly, **kw):
    """Drop-in device twin of fem.theta_iteration (same returns)."""
    return dispatch_theta_iteration_device(points, triangles, poly, **kw).result()


class DeviceSPDSolver:
    """Dense Cholesky solver on `device` for a (reduced) SPD FEM matrix.

    The standalone-solve twin of the θ-iteration path: ships the matrix as
    COO, factorizes once on the device, and solves right-hand sides with
    two triangular solves per call. `refine` steps of classical iterative
    refinement compute the residual on the host in f64 against the exact
    sparse operator — in f32 this recovers ~4 digits per step until the f32
    correction-solve floor (~κ·ε32).
    Reference solves: lucas_to_cardioid_v18...py:726-727 (spsolve).
    """

    def __init__(self, k_ff: sp.spmatrix, dtype=None, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = _resolve_dtype(dtype)
        self.k = k_ff.tocsr()
        (rows, cols, vals), self._d = _equilibrated_coo(self.k, self.dtype, self.device)
        nf = self.k.shape[0]
        self._l, info = _factor(_dense_from_coo(rows, cols, vals, (nf, nf)))
        _check_info(info, "DeviceSPDSolver")

    def _apply(self, b64: np.ndarray) -> np.ndarray:
        y = _chol_solve(self._l, torch.as_tensor(
            (self._d * b64).astype(_np_dtype(self.dtype)), device=self.device))
        return self._d * _host(y)

    def solve(self, b: np.ndarray, refine: int = 2) -> np.ndarray:
        b64 = np.asarray(b, np.float64)
        x = self._apply(b64)
        for _ in range(refine):
            x = x + self._apply(b64 - self.k @ x)
        return x


class DeviceNeumannSolver:
    """Pinned Neumann solve (harmonic-conjugate class) on `device`.

    The standalone twin of the θ-iteration's conjugate path: the
    weakly-pinned reduced system has κ≈2e15 on sliver-bearing meshes and
    its f32 Cholesky is not positive-definite, so this solver takes the
    FULL singular Neumann K, Schur-condenses the high-diagonal sliver nodes
    on the host in f64 (_condense_slivers), equilibrates + lifts the
    constant null mode, factorizes on the device, back-substitutes the
    sliver values, and shifts so v[pin]=0. Classical refinement is OFF by
    default: the pin-shifted lifted apply is not a contraction for
    x += apply(b − Kx) on a near-singular K, and the direct solve already
    sits at the lifted-vs-pinned distribution floor (~1e-6 relative at the
    solution scale) in both dtypes.
    Reference: lucas_to_cardioid_v18...py:407-431.
    """

    def __init__(self, k: sp.spmatrix, pin: int = 0, dtype=None, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = _resolve_dtype(dtype)
        self.k = k.tocsr()
        self.pin = pin
        self._r_idx, self._s_idx, s_red, self._kss_inv, w_cpl = _condense_slivers(self.k)
        self._w_bs = w_cpl.toarray()
        (rows, cols, vals), self._d = _equilibrated_coo(s_red, self.dtype, self.device)
        w = 1.0 / self._d
        w_hat = torch.as_tensor((w / np.linalg.norm(w)).astype(_np_dtype(self.dtype)),
                                device=self.device)
        nr = s_red.shape[0]
        kc = _dense_from_coo(rows, cols, vals, (nr, nr)) + w_hat[:, None] * w_hat[None, :]
        self._l, info = _factor(kc)
        _check_info(info, "DeviceNeumannSolver")

    def _apply(self, b64: np.ndarray) -> np.ndarray:
        b_s = b64[self._s_idx]
        b_r = b64[self._r_idx] - self._w_bs.T @ b_s
        y = _chol_solve(self._l, torch.as_tensor(
            (self._d * b_r).astype(_np_dtype(self.dtype)), device=self.device))
        v_r = self._d * _host(y)
        v_s = self._kss_inv @ b_s - self._w_bs @ v_r
        v = np.zeros(len(b64))
        v[self._r_idx] = v_r
        v[self._s_idx] = v_s
        return v - v[self.pin]

    def solve(self, rhs: np.ndarray, refine: int = 0) -> np.ndarray:
        b64 = np.asarray(rhs, np.float64)
        x = self._apply(b64)
        for _ in range(refine):
            x = x + self._apply(b64 - self.k @ x)
        return x
