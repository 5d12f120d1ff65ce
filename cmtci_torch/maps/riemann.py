"""Boundary-integral (Nyström) Riemann map with Green-function modulus (S5),
on PyTorch.

Port of ``cmtci/maps/riemann.py``. Reference:
lucas_to_cardioid_v40_reference.py:184-360 —
  g(z) = -log|z-a| + ∫ σ(ζ) log|z-ζ| ds + C (+ g_shift), |f| = exp(-g),
  phase from Im of the path integral of Φ'(z) = -1/(z-a) + Σ σ_j ds_j/(z-ζ_j)
  along [a + ε·dir, z] with 16-node Gauss–Legendre; (σ, C) from a dense
  least-squares fit with log kernel, diagonal surrogate log(ds/2)-1,
  constraint ∫σ ds = 0, ridge 1e-8, robust median recompute of C, and a
  g_shift calibration so median g(boundary-in) = 0.

The map evaluations are plain torch functions on (re, im) float pairs on a
device: g_real is a log-kernel matvec blocked over z, Φ_raw a blocked
16-node quadrature over (chunk, 16, N). Every reduction runs along the
boundary-node axis, so the block size moves a value only by the rounding of
the BLAS matvec that reduces it. dtype float64 is
the parity path; float32 the fast path, with the reference's error budget
(Im Φ mod 2π p99 ~1e-5 rad, g within 1e-4). Scalar constants stay Python
floats, so a float32 evaluation rounds them as the reference's weakly typed
constants round (``+ 1e-300`` is 0 in float32).

The fit: "lstsq" and "normal" are the reference's host f64 solves; "qr32"
factorizes the column-equilibrated stacked system in float32 on the device
(``torch.linalg.qr``, two triangular solves) and refines on the host in f64.
The numpy helpers (Gauss-Legendre nodes, the log kernels, the residual) are
copies of the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from cmtci_torch.geometry.polygon import Polygon, ensure_interior_point, slightly_inside
from cmtci_torch.geometry.resample import sample_polygon_boundary
from cmtci_torch.utils.device import resolve_device

PATH_GAUSS_N = 16
EPS_POLE = 1e-6
DZ_EPS = 1e-14
EXP_CLIP = 60.0
RIDGE_LAMBDA = 1e-8
#: rows of z a block of the Φ quadrature on a card: a (512, 16, 2000) f64
#: temporary is 131 MB. On the CPU a block holds about PHI_CPU_TERMS pole
#: terms, so its temporaries are reused from the heap instead of being
#: mapped afresh each block
PHI_CHUNK = 512
PHI_CPU_TERMS = 1 << 20
#: rows of z a block of the log-kernel matvec: (600, 2000) f64 is 9.6 MB
G_CHUNK = 600


def _phi_chunk(device, n_terms: int) -> int:
    """Rows of z a block of the Φ quadrature on `device` (n_terms pole terms
    a row); the reductions run along the boundary-node axis."""
    if device.type == "cuda":
        return PHI_CHUNK
    return max(1, PHI_CPU_TERMS // max(1, n_terms))


def gauss_legendre_01(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def safe_exp_minus_real(g):
    return np.exp(np.clip(-np.asarray(g, dtype=float), -EXP_CLIP, EXP_CLIP))


def _g_real_blocked(zr, zi, br, bi, sigw, ar: float, ai: float, c_plus_shift: float,
                    chunk: int = G_CHUNK):
    """g(z) = -log|z-a| + Σ_j sigw_j log|z-ζ_j| + C + shift, blocked over z."""
    out = torch.empty_like(zr)
    for i in range(0, zr.shape[0], chunk):
        zzr = zr[i : i + chunk]
        zzi = zi[i : i + chunk]
        dr = zzr[:, None] - br[None, :]
        di = zzi[:, None] - bi[None, :]
        logabs = torch.log(torch.hypot(dr, di) + 1e-300)
        sl = logabs @ sigw
        da = torch.hypot(zzr - ar, zzi - ai)
        out[i : i + chunk] = -torch.log(da + 1e-300) + sl + c_plus_shift
    return out


def _dphi(xr, xi_, d0r, d0i, br, bi, sigds):
    """Φ'(x) for x of shape (B,G): -1/(x-a) + Σ_j sigds_j/(x-ζ_j), with
    (d0r, d0i) = x - a.

    The (B,G,N) pole terms are formed in place (three temporaries of the
    block's size) and reduced over j by a matvec with sigds."""
    small0 = torch.hypot(d0r, d0i) < DZ_EPS
    d0r = torch.where(small0, DZ_EPS, d0r)
    d0i = torch.where(small0, 0.0, d0i)
    den0 = d0r * d0r + d0i * d0i
    # -1/(x-a)
    out_r = -d0r / den0
    out_i = d0i / den0
    # + Σ_j sigds_j / (x - ζ_j); a pole closer than DZ_EPS is moved to DZ_EPS
    dr = xr[..., None] - br
    di = xi_[..., None] - bi
    den = dr * dr
    den += di * di
    small = den < DZ_EPS * DZ_EPS
    dr.masked_fill_(small, DZ_EPS)
    di.masked_fill_(small, 0.0)
    den.masked_fill_(small, DZ_EPS * DZ_EPS)
    dr /= den
    di /= den
    out_r = out_r + dr @ sigds
    out_i = out_i - di @ sigds
    return out_r, out_i


def _phi_raw_blocked(zr, zi, br, bi, sigds, ar: float, ai: float, c_const: float, gx, gw,
                     chunk: int | None = None):
    """Path-integrated Φ at each z (v40:213-238), blocked over z.

    Returns (re, im). Quadrature nodes xi = z0 + gx*seg with z0 = a + ε·dir.
    """
    if chunk is None:
        chunk = _phi_chunk(zr.device, gx.shape[0] * br.shape[0])
    out_r = torch.empty_like(zr)
    out_i = torch.empty_like(zr)
    for i in range(0, zr.shape[0], chunk):
        zzr = zr[i : i + chunk]
        zzi = zi[i : i + chunk]
        dzr = zzr - ar
        dzi = zzi - ai
        dabs = torch.hypot(dzr, dzi)
        dirr = dzr / torch.clamp(dabs, min=1e-300)
        diri = dzi / torch.clamp(dabs, min=1e-300)
        z0r = ar + EPS_POLE * dirr
        z0i = ai + EPS_POLE * diri
        segr = zzr - z0r
        segi = zzi - z0i
        xr = z0r[:, None] + gx[None, :] * segr[:, None]
        xi_ = z0i[:, None] + gx[None, :] * segi[:, None]
        # x - a from its parts, ε·dir + t·seg: (z0 + t·seg) - a would cancel
        # z0's rounding against a, which in float32 turns the direction of
        # x - a by ~eps/|x - a| at the nodes nearest a
        d0r = EPS_POLE * dirr[:, None] + gx[None, :] * segr[:, None]
        d0i = EPS_POLE * diri[:, None] + gx[None, :] * segi[:, None]
        dp_r, dp_i = _dphi(xr, xi_, d0r, d0i, br, bi, sigds)
        # integral = Σ_k w_k * dphi_k * seg
        ir = (dp_r @ gw) * segr - (dp_i @ gw) * segi
        ii = (dp_r @ gw) * segi + (dp_i @ gw) * segr
        # real anchor: -log(EPS_POLE) + Σ sigds log|z0-ζ| + C
        lr = torch.log(torch.hypot(z0r[:, None] - br, z0i[:, None] - bi) + 1e-300)
        phi0 = -math.log(EPS_POLE) + lr @ sigds + c_const
        out_r[i : i + chunk] = ir + phi0
        out_i[i : i + chunk] = ii
    return out_r, out_i


def _g_phi_fused(gzr, gzi, pzr, pzi, br, bi, sigw, sigds, ar, ai, c_plus_shift, c_const,
                 gx, gw):
    """g_real on (gzr,gzi) and Φ_raw on (pzr,pzi): the pipeline evaluates g on
    the interior and boundary-in points and Φ on the interior points."""
    g = _g_real_blocked(gzr, gzi, br, bi, sigw, ar, ai, c_plus_shift)
    pre, pim = _phi_raw_blocked(pzr, pzi, br, bi, sigds, ar, ai, c_const, gx, gw)
    return g, pre, pim


def _as_dtype(dtype):
    """None -> float64 (the parity path); torch.float32 is the fast path."""
    dt = torch.float64 if dtype is None else dtype
    if dt not in (torch.float64, torch.float32):
        raise ValueError(f"unsupported map dtype {dtype!r}")
    return dt


def _scalar(x: float, dt) -> float:
    """A Python float rounded to dt, as the reference passes its scalars."""
    return float(np.float32(x)) if dt == torch.float32 else float(x)


@dataclass
class RiemannMapGreenModulus:
    """Fitted Lucas-domain -> unit-disk Riemann map (v40 semantics).

    Its evaluations run on `device` ("cuda" raises without a card) and
    return numpy float64 arrays."""

    bdy_z: np.ndarray  # complex (N,)
    ds: np.ndarray
    sigma: np.ndarray
    a: complex
    c: float
    g_shift: float = 0.0
    gauss_n: int = PATH_GAUSS_N
    device: object = "cuda"
    _gx: np.ndarray = field(default=None, repr=False)
    _gw: np.ndarray = field(default=None, repr=False)
    _kds: np.ndarray = field(default=None, repr=False)  # fit-time log kernel,
    # cached so boundary_residual doesn't re-assemble the N×N host matrix

    def __post_init__(self):
        self._gx, self._gw = gauss_legendre_01(self.gauss_n)

    def _t(self, x, dt):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=self._dev).to(dt)

    @property
    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    def _args(self, dt):
        return (self._t(self.bdy_z.real, dt), self._t(self.bdy_z.imag, dt),
                self._t(self.sigma * self.ds, dt),
                _scalar(self.a.real, dt), _scalar(self.a.imag, dt))

    def g_real(self, z, dtype=None):
        dt = _as_dtype(dtype)
        z = np.asarray(z, dtype=complex).ravel()
        br, bi, sigds, ar, ai = self._args(dt)
        out = _g_real_blocked(self._t(z.real, dt), self._t(z.imag, dt), br, bi, sigds,
                              ar, ai, _scalar(self.c + self.g_shift, dt))
        return out.cpu().numpy().astype(np.float64)

    def phi_raw(self, z, dtype=None):
        dt = _as_dtype(dtype)
        z = np.asarray(z, dtype=complex).ravel()
        br, bi, sigds, ar, ai = self._args(dt)
        re, im = _phi_raw_blocked(self._t(z.real, dt), self._t(z.imag, dt), br, bi, sigds,
                                  ar, ai, _scalar(self.c, dt), self._t(self._gx, dt),
                                  self._t(self._gw, dt))
        return (re.cpu().numpy().astype(np.float64)
                + 1j * im.cpu().numpy().astype(np.float64))

    def phi(self, z, dtype=None):
        """Composite Φ: Re from g_real, Im from phi_raw (v40:259-264)."""
        return self.g_real(z, dtype) + 1j * self.phi_raw(z, dtype).imag

    def eval_g_phi(self, z_g, z_phi, dtype=None):
        """(g(z_g), Im Φ_raw(z_phi)) in one call (see _g_phi_fused)."""
        dt = _as_dtype(dtype)
        z_g = np.asarray(z_g, dtype=complex).ravel()
        z_phi = np.asarray(z_phi, dtype=complex).ravel()
        br, bi, sigds, ar, ai = self._args(dt)
        g, _, pim = _g_phi_fused(
            self._t(z_g.real, dt), self._t(z_g.imag, dt),
            self._t(z_phi.real, dt), self._t(z_phi.imag, dt),
            br, bi, sigds, sigds, ar, ai,
            _scalar(self.c + self.g_shift, dt), _scalar(self.c, dt),
            self._t(self._gx, dt), self._t(self._gw, dt))
        return (g.cpu().numpy().astype(np.float64), pim.cpu().numpy().astype(np.float64))

    def f(self, z, dtype=None):
        """f(z) = exp(-g) · exp(-i Im Φ_raw) (v40:266-272)."""
        g = self.g_real(z, dtype)
        im = self.phi_raw(z, dtype).imag
        return safe_exp_minus_real(g) * np.exp(-1j * im)

    def boundary_residual(self):
        """Fit residual on boundary nodes (v40:347,592-599)."""
        if self._kds is None:
            # memoized: a map reconstructed from a cached fit state arrives
            # without the N×N kernel
            self._kds = _log_kernel_ds(self.bdy_z, self.ds)
        return (self._kds @ self.sigma) + self.c - np.log(np.abs(self.bdy_z - self.a) + 1e-300)


def _log_kernel_ds(z: np.ndarray, ds: np.ndarray):
    absd = np.abs(z[:, None] - z[None, :])
    k = np.log(absd + 1e-300)
    di = np.diag_indices_from(k)
    k[di] = np.log(np.maximum(ds, 1e-300) / 2.0) - 1.0
    return k * ds[None, :]


def _log_kernel_ds_fast(z: np.ndarray, ds: np.ndarray, workers: int = 4):
    """log|z_i-z_j| via 0.5·log(d²) — skips the hypot that dominates
    _log_kernel_ds (np.abs on complex). Differs from the exact form by
    ≤1 ulp per entry, far below the qr32 fit's refinement limit; the
    parity lstsq path keeps _log_kernel_ds.

    Row-blocked across a small thread pool (numpy's big ufuncs release the
    GIL). Each row's values are computed by the identical expressions in the
    identical order — bitwise-equal to the single-thread result."""
    x, y = z.real, z.imag
    n = len(z)
    k = np.empty((n, n))
    dsw = ds[None, :]

    def _rows(lo, hi):
        d2 = ((x[lo:hi, None] - x[None, :]) ** 2
              + (y[lo:hi, None] - y[None, :]) ** 2)
        np.multiply(0.5 * np.log(d2 + 1e-300), dsw, out=k[lo:hi])

    if workers > 1 and n >= 512:
        from concurrent.futures import ThreadPoolExecutor

        step = (n + workers - 1) // workers
        with ThreadPoolExecutor(workers) as ex:
            list(ex.map(lambda lo: _rows(lo, min(lo + step, n)),
                        range(0, n, step)))
    else:
        _rows(0, n)
    di = np.diag_indices_from(k)
    k[di] = (np.log(np.maximum(ds, 1e-300) / 2.0) - 1.0) * ds
    return k


def _qr_r_device(zr, zi, ds, ar: float, ai: float, n: int, ridge: float):
    """R factor + direct solve of the column-equilibrated v40 fit, in
    float32 (its tensor inputs' dtype) on their device.

    Stacked system (v40:300-321): N log-kernel rows [kds | 1], one
    constraint row [ds | 0], N ridge rows sqrt(ridge)·[I | 0]; columns
    scaled by 1/cn, with cn (the column norms) computed on the device, so
    the host assembles its f64 kds for the refinement residuals while the
    device runs the QR. Returns (R, cn, x0), x0 the corrected-semi-normal
    direct solve.
    """
    dt, dev = zr.dtype, zr.device
    dr = zr[:, None] - zr[None, :]
    di_ = zi[:, None] - zi[None, :]
    absd = torch.sqrt(dr * dr + di_ * di_)
    eye = torch.eye(n, dtype=dt, device=dev)
    k = torch.where(eye > 0,
                    (torch.log(torch.clamp(ds, min=1e-30) / 2.0) - 1.0)[None, :],
                    torch.log(absd + 1e-30))
    kds = k * ds[None, :]
    cn = torch.cat([
        torch.sqrt(torch.sum(kds * kds, dim=0) + ds * ds + ridge),
        torch.sqrt(torch.full((1,), float(n), dtype=dt, device=dev)),
    ])
    a_top = torch.cat([kds, torch.ones((n, 1), dtype=dt, device=dev)], dim=1)
    a_con = torch.cat([ds, torch.zeros((1,), dtype=dt, device=dev)])[None, :]
    # sqrt of the f32 ridge, as the reference's jnp.sqrt of its f32 scalar
    a_reg = torch.cat([float(np.sqrt(np.float32(ridge))) * eye,
                       torch.zeros((n, 1), dtype=dt, device=dev)], dim=1)
    a0 = torch.cat([a_top, a_con, a_reg], dim=0) / cn[None, :]
    r_mat = torch.linalg.qr(a0, mode="r").R
    b = torch.log(torch.hypot(zr - ar, zi - ai) + 1e-30)
    atb = torch.cat([kds.T @ b, torch.sum(b)[None]]) / cn
    x0 = _seminormal_solve_device(r_mat, atb) / cn
    return r_mat, cn, x0


def _seminormal_solve_device(r_mat, atr_scaled):
    """x̂ = R⁻¹ R⁻ᵀ (Aᵀr/cn) — corrected-semi-normal step."""
    y = torch.linalg.solve_triangular(r_mat.T, atr_scaled[:, None], upper=False)
    return torch.linalg.solve_triangular(r_mat, y, upper=True)[:, 0]


def _seminormal_solve_scaled(r_mat, cn, atr):
    """Semi-normal step with the device-resident column scaling."""
    return _seminormal_solve_device(r_mat, atr / cn) / cn


def _fit_sigma_qr32(z, ds, b, a, ridge, refine: int = 2, device="cuda"):
    """Device-f32 QR + host-f64 iterative refinement for the v40 fit.

    The preconditioner (QR of the f32 column-equilibrated stacked matrix)
    lives on the device with the direct solve; each refinement round the
    host computes the FULL f64 residual of the stacked system (O(N²)
    matvecs against the f64 kds) and only (N+1)-vectors cross to the
    device. The all-f32 variant stalls at 2e-4, which is why the residuals
    are f64. TF32 stays off (torch's default): the QR and the solves are
    full f32.
    """
    dev = resolve_device(device)
    n = len(z)
    sridge = math.sqrt(ridge)
    f32 = torch.float32

    def t32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev).to(f32)

    # torch queues the device's f32 assembly and QR while the host builds
    # the f64 log kernel the refinement residuals need
    r_mat, cn_dev, x0 = _qr_r_device(t32(z.real), t32(z.imag), t32(ds),
                                     _scalar(a.real, f32), _scalar(a.imag, f32), n, ridge)
    kds = _log_kernel_ds_fast(z, ds)
    x = x0.cpu().numpy().astype(np.float64)
    for _ in range(refine):
        r_top = b - (kds @ x[:n] + x[n])
        atr = (kds.T @ r_top + ds * (-(ds @ x[:n]))
               + sridge * (-sridge * x[:n]))
        atr = np.append(atr, r_top.sum())
        dx = _seminormal_solve_scaled(r_mat, cn_dev, t32(atr)).cpu().numpy().astype(np.float64)
        x = x + dx
    return x, kds


def fit_riemann_map(poly: Polygon, n_bdy: int = 2000, a: complex | None = None,
                    ridge: float = RIDGE_LAMBDA, inward_eps: float = 1e-3,
                    gauss_n: int = PATH_GAUSS_N, verbose: bool = False,
                    solver: str = "lstsq", calibrate_g_shift: bool = True, device="cuda"):
    """Fit (σ, C, g_shift) — lucas_to_cardioid_v40_reference.py:278-360.

    solver="lstsq" is the reference's np.linalg.lstsq (SVD — the parity
    default); "normal" solves the ridge-regularized normal equations by
    Cholesky on the host; "qr32" runs the dense factorization on `device` in
    f32 (column-equilibrated QR + corrected-semi-normal solves) with f64
    host-residual refinement. The map's evaluations (the g_shift calibration
    of the lstsq and normal fits among them) run on `device`.
    """
    dev = resolve_device(device)
    z, ds = sample_polygon_boundary(poly, n_bdy)
    if a is None:
        a = poly.centroid
    a = ensure_interior_point(poly, a)
    n = len(z)

    b = np.log(np.abs(z - a) + 1e-300)

    if solver == "qr32":
        # kds is assembled inside (host f64, overlapped with the device QR)
        x, kds = _fit_sigma_qr32(z, ds, b, a, ridge, device=dev)
    elif solver in ("normal", "lstsq"):
        kds = _log_kernel_ds(z, ds)
        a_mat = np.zeros((n, n + 1))
        a_mat[:, :n] = kds
        a_mat[:, n] = 1.0
        a_con = np.zeros((1, n + 1))
        a_con[0, :n] = ds
        a0 = np.vstack([a_mat, a_con])
        b0 = np.concatenate([b, [0.0]])
        if ridge > 0:
            a_reg = np.zeros((n, n + 1))
            a_reg[:, :n] = math.sqrt(ridge) * np.eye(n)
            a0 = np.vstack([a0, a_reg])
            b0 = np.concatenate([b0, np.zeros(n)])
        if solver == "normal":
            import scipy.linalg as _sla

            x = _sla.solve(a0.T @ a0, a0.T @ b0, assume_a="pos")
        else:
            x, *_ = np.linalg.lstsq(a0, b0, rcond=None)
    else:
        raise ValueError(f"unknown solver '{solver}'")
    sigma = x[:n]
    # robust median recompute of C (v40:328)
    c = float(np.median(np.log(np.abs(z - a) + 1e-300) - (kds @ sigma)))

    rm = RiemannMapGreenModulus(bdy_z=z, ds=ds, sigma=sigma, a=a, c=c, gauss_n=gauss_n,
                                device=dev)
    rm._kds = kds
    if not calibrate_g_shift:
        # the caller derives g_shift from its own g(boundary-in) evaluation
        # (the uniformize-green pipeline evaluates the same inward-shifted
        # nodes anyway); rm.g_shift stays 0.0
        return rm
    z_in = slightly_inside(z, a, inward_eps)
    if solver == "qr32":
        # g_shift calibration with the direct host log-kernel (0.5·log d²
        # form, no diagonal: z_in is strictly inside)
        d2 = ((z_in.real[:, None] - z.real[None, :]) ** 2
              + (z_in.imag[:, None] - z.imag[None, :]) ** 2)
        g_in = (-np.log(np.abs(z_in - a) + 1e-300)
                + (0.5 * np.log(d2 + 1e-300)) @ (sigma * ds) + c)
        rm.g_shift = -float(np.median(g_in))
    else:
        rm.g_shift = -float(np.median(rm.g_real(z_in)))

    if verbose:
        mod = np.abs(rm.f(z_in))
        r = rm.boundary_residual()
        print(f"[riemann] a={a:.6f} |f(bdy-in)| median={np.median(mod):.9f} "
              f"p90={np.quantile(mod, 0.9):.9f}")
        print(f"[riemann] bdy-resid median={np.median(r):+.3e} "
              f"maxabs={np.max(np.abs(r)):.3e}")
    return rm
