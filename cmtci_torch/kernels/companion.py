"""Batched inverse-eigenvalue clouds of generalized Lucas companion matrices.

Port of ``cmtci/kernels/companion.py``. The eigenvalues of a companion
matrix with first row (c_1..c_n) are the roots of
p(x) = x^n - c_1 x^{n-1} - ... - c_n, found by a batched Aberth–Ehrlich
simultaneous iteration: elementwise f64 work over (batch, lane) tensors with
validity masks, carried as (re, im) pairs exactly as the reference writes
it. The reference's ``lax.while_loop`` becomes a Python loop that reads the
convergence flag with ``.item()`` (with the curve-registered init that is a
handful of iterations). LAPACK on the host stays the parity oracle
(``backend="lapack"``).

Stability for degrees up to ~1220 comes from the two-branch Newton ratio
(reversed polynomial for |z| > r, direct Horner inside), see
``_newton_ratio`` and ``_newton_ratio_closed``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cmtci_torch.utils import cplx
from cmtci_torch.utils.device import resolve_device

FAMILIES = (
    "lucas_all_ones",
    "pell_like_all_twos",
    "sparser_gap_1_0_1_then_ones",
    "padovan_like_0_1_then_ones",
)

# Branch-switch radius for the two Horner evaluations.
_R_SWITCH2 = 1.25 * 1.25


def family_top_row(name: str, n: int) -> np.ndarray:
    """First row of the generalized companion matrix (host)."""
    if name == "lucas_all_ones":
        return np.ones(n)
    if name == "pell_like_all_twos":
        return 2.0 * np.ones(n)
    if name == "sparser_gap_1_0_1_then_ones":
        top = np.ones(n)
        if n >= 2:
            top[1] = 0.0
        return top
    if name == "padovan_like_0_1_then_ones":
        top = np.ones(n)
        top[0] = 0.0
        return top
    raise ValueError(f"Unknown family '{name}'")


def companion_matrix(top: np.ndarray) -> np.ndarray:
    """Dense companion matrix (host; parity oracle only)."""
    top = np.asarray(top, dtype=float).reshape(-1)
    n = top.shape[0]
    c = np.zeros((n, n))
    c[0, :] = top
    c[1:, :-1] += np.eye(n - 1)
    return c


def poly_coeff_batch(ns, family: str = "lucas_all_ones", device="cuda"):
    """Padded ascending coefficient batch for the char polys of `ns`.

    Returns (a, deg) on `device`: a[b, k] is the coefficient of u^k in
    q_b(u) = 1 - sum_k c_k u^k, zero-padded to the max degree (f64);
    deg[b] = n_b (int64).
    """
    dev = resolve_device(device)
    ns = [int(n) for n in ns]
    lmax = max(ns)
    a = np.zeros((len(ns), lmax + 1))
    a[:, 0] = 1.0
    for b, n in enumerate(ns):
        a[b, 1 : n + 1] = -family_top_row(family, n)
    return (torch.as_tensor(a, dtype=torch.float64, device=dev),
            torch.as_tensor(ns, dtype=torch.int64, device=dev))


def _re_pair(x):
    return x, torch.zeros_like(x)


def _horner_pair(a, z, reverse: bool):
    """Simultaneous Horner of the polynomial and its derivative.

    a: (B, L+1) real coefficients, ascending in u; z: pair of (B, nL).
    reverse=False evaluates P(x) = sum_k a_k x^(L-k) (padded direct form);
    reverse=True evaluates q(u) = sum_k a_k u^k. Returns (val, deriv) pairs.
    """
    big_l = a.shape[1] - 1
    zero = torch.zeros_like(z[0])
    p = (zero, zero)
    d = (zero, zero)
    for i in range(big_l + 1):
        k = big_l - i if reverse else i
        ak = a[:, k : k + 1]
        d = cplx.add(cplx.mul(d, z), p)
        p = cplx.add(cplx.mul(p, z), (ak + zero, zero))
    return p, d


def _safe_ratio(num, den, like):
    den2 = cplx.abs2(den)
    safe = den2 > 0
    den2 = torch.where(safe, den2, torch.ones_like(den2))
    w = ((num[0] * den[0] + num[1] * den[1]) / den2,
         (num[1] * den[0] - num[0] * den[1]) / den2)
    return cplx.where(safe, w, cplx.full_like(like, 0.0))


def _newton_ratio(a, deg, z):
    """w = p(z)/p'(z) for the charpoly, stable for any |z|. Pair in/out.

      outside: w = z*q / (deg*q - u*q')        with u = 1/z
      inside:  w = z*P / (z*P' - pad*P)        with P = z^pad * p
    """
    big_l = a.shape[1] - 1
    degf = _re_pair(deg[:, None].to(z[0].dtype))
    outside = cplx.abs2(z) > _R_SWITCH2

    u = cplx.where(outside, cplx.reciprocal(z), cplx.full_like(z, 0.5))
    q, qp = _horner_pair(a, u, reverse=True)
    num_out = cplx.mul(z, q)
    den_out = cplx.sub(cplx.mul(degf, q), cplx.mul(u, qp))

    z_in = cplx.where(outside, cplx.full_like(z, 0.5), z)
    p, pp = _horner_pair(a, z_in, reverse=False)
    pad = _re_pair(big_l - degf[0])
    num_in = cplx.mul(z_in, p)
    den_in = cplx.sub(cplx.mul(z_in, pp), cplx.mul(pad, p))

    num = cplx.where(outside, num_out, num_in)
    den = cplx.where(outside, den_out, den_in)
    return _safe_ratio(num, den, z)


def _pow_int(z, n, nbits: int = 12):
    """z**n elementwise by binary exponentiation; n an int tensor (per row).

    12 bits covers n < 4096; |z| <= 1.25 keeps the largest repeated square
    inside f64 range, and |u| < 0.8 underflows to the correct 0 limit.
    """
    acc = cplx.full_like(z, 1.0)
    base = z
    for i in range(nbits):
        bit = ((n >> i) & 1) > 0
        acc = cplx.where(bit, cplx.mul(acc, base), acc)
        if i + 1 < nbits:
            base = cplx.mul(base, base)
    return acc


# Closed-form numerators of q(u) = 1 - sum_k c_k u^k for the four reference
# top-row families: q(u) = (P(u) + a*u^(n+1)) / (1 - u) with deg(P) <= 3.
# (P ascending coefficients, a) per family:
_CLOSED_FAMILIES = {
    "lucas_all_ones": ((1.0, -2.0), 1.0),
    "pell_like_all_twos": ((1.0, -3.0), 2.0),
    "sparser_gap_1_0_1_then_ones": ((1.0, -2.0, 1.0, -1.0), 1.0),
    "padovan_like_0_1_then_ones": ((1.0, -1.0, -1.0), 1.0),
}


def _poly_eval_small(coeffs, z):
    """P(z) and P'(z) for a tiny ascending-coefficient real polynomial."""
    p = cplx.full_like(z, 0.0)
    d = cplx.full_like(z, 0.0)
    for c in reversed(coeffs):
        d = cplx.add(cplx.mul(d, z), p)
        p = cplx.add(cplx.mul(p, z), _re_pair(c + torch.zeros_like(z[0])))
    return p, d


def _newton_ratio_closed(family: str, deg, z):
    """w = p(z)/p'(z) via the family's closed form; O(log n) per lane.

    Outside (u = 1/z), with M(u) = P(u) + a*u^(n+1):
      w = z*M*(1-u) / (n*M*(1-u) - u*(M'*(1-u) + M)).
    Inside, with N = z^(n+1-dP) * Prev(z) + a and p = N/(z-1):
      w = N*(z-1) / (N'*(z-1) - N).
    The switch radius r = min(1.25, 10^(140/n)) keeps the inside branch's
    products (~|z|^(2n)·n²) inside f64 range.
    """
    coeffs, a_const = _CLOSED_FAMILIES[family]
    degf = _re_pair(deg[:, None].to(z[0].dtype))
    r_sw = torch.clamp(10.0 ** (140.0 / torch.clamp(degf[0], min=1.0)), max=1.25)
    outside = cplx.abs2(z) > r_sw * r_sw

    # --- outside branch (u = 1/z)
    u = cplx.where(outside, cplx.reciprocal(z), cplx.full_like(z, 0.5))
    p_u, dp_u = _poly_eval_small(coeffs, u)
    un = _pow_int(u, deg[:, None])  # u^n
    un1 = cplx.mul(un, u)
    m = cplx.add(p_u, cplx.scale(un1, a_const))
    # M' = P' + a*(n+1)*u^n
    np1 = cplx.add(degf, (torch.ones_like(z[0]), torch.zeros_like(z[0])))
    mp = cplx.add(dp_u, cplx.scale(cplx.mul(np1, un), a_const))
    one_mu = cplx.sub(cplx.full_like(z, 1.0), u)
    m_omu = cplx.mul(m, one_mu)
    num_out = cplx.mul(z, m_omu)
    den_out = cplx.sub(cplx.mul(degf, m_omu),
                       cplx.mul(u, cplx.add(cplx.mul(mp, one_mu), m)))

    # --- inside branch: N(z) = z^(n+1-dP) * Prev(z) + a
    dp_small = len(coeffs) - 1
    rev = tuple(reversed(coeffs))
    z_in = cplx.where(outside, cplx.full_like(z, 0.5), z)
    prev, dprev = _poly_eval_small(rev, z_in)
    k_exp = deg[:, None] + (1 - dp_small)  # n+1-dP (>= 0 for n >= dP)
    zk = _pow_int(z_in, torch.clamp(k_exp, min=0))
    n_big = cplx.add(cplx.mul(zk, prev), cplx.full_like(z, a_const))
    # N' = z^(k-1)*(k*Prev + z*Prev') for k >= 1; for k == 0 it is Prev'.
    kf = _re_pair(k_exp.to(z[0].dtype) + torch.zeros_like(z[0]))
    zk1 = _pow_int(z_in, torch.clamp(k_exp - 1, min=0))
    n_prime = cplx.mul(zk1, cplx.add(cplx.mul(kf, prev), cplx.mul(z_in, dprev)))
    n_prime = cplx.where((k_exp == 0).expand_as(z[0]), dprev, n_prime)
    zm1 = cplx.sub(z_in, cplx.full_like(z, 1.0))
    num_in = cplx.mul(n_big, zm1)
    den_in = cplx.sub(cplx.mul(n_prime, zm1), n_big)

    num = cplx.where(outside, num_out, num_in)
    den = cplx.where(outside, den_out, den_in)
    return _safe_ratio(num, den, z)


# Curve init is asymptotic in n; below this degree the unit-circle init is
# both safer and just as fast.
_CURVE_INIT_MIN_DEG = 16


def _small_poly_on(coeffs, e):
    """P(e) for a tiny ascending-coefficient real polynomial, pair input."""
    p = cplx.full_like(e, 0.0)
    for c in reversed(coeffs):
        p = cplx.add(cplx.mul(p, e), _re_pair(c + torch.zeros_like(e[0])))
    return p


def _curve_init(family: str, deg, nl: int, dtype):
    """Structured Aberth init on the known root curve of the closed-form
    families (see ``cmtci/kernels/companion.py:_curve_init`` for the root
    structure): ndom dominant roots at 1/u_P, the rest on
    |u|^{n+1} = |P(u)|/a at η-registered phase slots. Rows with
    deg < _CURVE_INIT_MIN_DEG keep the circle init."""
    coeffs, a_const = _CLOSED_FAMILIES[family]
    proots = np.roots(list(reversed(coeffs)))
    dom = [1.0 / r for r in proots if abs(r) < 0.9]
    ndom = len(dom)

    dev = deg.device
    lane = torch.arange(nl, device=dev)[None, :]
    degf = torch.clamp(deg, min=1)[:, None].to(dtype)
    k = lane.to(dtype) + 1.0
    denom = torch.clamp(degf + 1.0 - float(ndom), min=1.0)
    theta = 2.0 * math.pi * k / denom
    e = (torch.cos(theta), torch.sin(theta))
    mp = cplx.scale(_small_poly_on(coeffs, e), -1.0 / a_const)  # -P/a
    # winding-removed residual R = (-P/a)·e^{-i·ndom·θ}
    r = mp
    for _ in range(ndom):
        r = cplx.mul(r, (e[0], -e[1]))
    eta = torch.atan2(r[1], r[0])
    theta = (2.0 * math.pi * k + eta) / denom
    e = (torch.cos(theta), torch.sin(theta))
    mp = cplx.scale(_small_poly_on(coeffs, e), -1.0 / a_const)
    s = torch.sqrt(torch.clamp(cplx.abs2(mp), min=1e-300)) ** (1.0 / (degf + 1.0))
    z = ((1.0 / s) * e[0], -(1.0 / s) * e[1])
    # last ndom valid lanes -> the dominant points
    for i, lam in enumerate(dom):
        is_dom = lane == (deg[:, None] - 1 - i)
        z = (torch.where(is_dom, float(np.real(lam)), z[0]),
             torch.where(is_dom, float(np.imag(lam)), z[1]))
    # small-degree rows: keep the circle init
    theta_c = 2.0 * math.pi * (lane.to(dtype) + 0.256) / degf + 0.577 / degf
    small = (deg[:, None] < _CURVE_INIT_MIN_DEG).expand_as(z[0])
    return (torch.where(small, torch.cos(theta_c), z[0]),
            torch.where(small, torch.sin(theta_c), z[1]))


def _pairwise_repulsion(z, valid, chunk: int):
    """S_i = sum_{j != i, valid_j} 1/(z_i - z_j), blocked over j to bound memory."""
    nl = z[0].shape[1]
    lane = torch.arange(nl, device=z[0].device)[None, :]
    s_r = torch.zeros_like(z[0])
    s_i = torch.zeros_like(z[0])
    for j0 in range(0, nl, chunk):
        j1 = min(j0 + chunk, nl)
        dr = z[0][:, :, None] - z[0][:, None, j0:j1]
        di = z[1][:, :, None] - z[1][:, None, j0:j1]
        d2 = dr * dr + di * di
        mask = valid[:, None, j0:j1] & (lane[:, :, None] != lane[:, None, j0:j1])
        pos = d2 > 0
        inv = torch.where(mask & pos, 1.0 / torch.where(pos, d2, torch.ones_like(d2)),
                          torch.zeros_like(d2))
        s_r = s_r + torch.sum(dr * inv, dim=2)
        s_i = s_i + torch.sum(-di * inv, dim=2)
    return s_r, s_i


def aberth_roots(a, deg, max_iters: int = 200, tol: float = 1e-13, chunk: int = 128,
                 family: str | None = None, repulsion_dtype=torch.float32):
    """Batched Aberth–Ehrlich root finder on the tensors' device.

    a: (B, L+1) ascending coefficients (see poly_coeff_batch); deg: (B,).
    Returns (re, im, valid): (B, L) roots with valid[b, k] = k < deg[b].

    When `family` names a closed-form family the Newton ratio uses the
    O(log n) geometric-series form. The pairwise repulsion runs in
    `repulsion_dtype` (default f32, as in the reference): it only conditions
    the simultaneous convergence, the fixed point is where the f64 Newton
    ratio vanishes. Pass repulsion_dtype=None to keep it in a's dtype.
    """
    bsz, lp1 = a.shape
    nl = lp1 - 1
    dev = a.device
    lane = torch.arange(nl, device=dev)[None, :]
    valid = lane < deg[:, None]

    if family in _CLOSED_FAMILIES:
        z = _curve_init(family, deg, nl, a.dtype)
    else:
        degf = torch.clamp(deg, min=1)[:, None].to(a.dtype)
        theta = 2.0 * math.pi * (lane.to(a.dtype) + 0.256) / degf + 0.577 / degf
        z = (torch.cos(theta), torch.sin(theta))
    # Park invalid lanes far away so they never interact with valid ones.
    lanef = lane.to(a.dtype) + torch.zeros((bsz, 1), dtype=a.dtype, device=dev)
    far = (1e9 * torch.cos(lanef), 1e9 * torch.sin(lanef))
    z = cplx.where(valid, z, far)

    tol2 = tol * tol
    frozen = torch.zeros_like(valid)
    it = 0
    done = False
    while it < max_iters and not done:
        if family in _CLOSED_FAMILIES:
            w = _newton_ratio_closed(family, deg, z)
        else:
            w = _newton_ratio(a, deg, z)
        if repulsion_dtype is not None and repulsion_dtype != a.dtype:
            z_rep = (z[0].to(repulsion_dtype), z[1].to(repulsion_dtype))
            s32 = _pairwise_repulsion(z_rep, valid, chunk)
            s = (s32[0].to(a.dtype), s32[1].to(a.dtype))
        else:
            s = _pairwise_repulsion(z, valid, chunk)
        denom = cplx.sub(cplx.full_like(z, 1.0), cplx.mul(w, s))
        corr = cplx.div(w, denom)
        moved2 = cplx.abs2(corr)
        # latch convergence permanently (see the reference's aberth_roots)
        frozen = frozen | (moved2 <= tol2 * torch.clamp(cplx.abs2(z), min=1e-30))
        corr = cplx.where(valid & ~frozen, corr, cplx.full_like(z, 0.0))
        z = cplx.sub(z, corr)
        done = bool(torch.all(torch.where(valid, frozen, True)).item())
        it += 1
    return z[0], z[1], valid


def _closed_form_ok(ns, family: str) -> bool:
    """Closed-form eligibility (full top-row pattern; n < 4096)."""
    if family not in _CLOSED_FAMILIES:
        return False
    ns = list(ns)
    if max(ns) >= 4096:
        return False
    if family == "sparser_gap_1_0_1_then_ones" and min(ns) < 2:
        return False
    return True


def eigvals_batched(ns, family: str = "lucas_all_ones", max_iters: int = 200,
                    repulsion_dtype=torch.float32, device="cuda"):
    """Padded batched companion eigenvalues via Aberth. Returns (re, im, valid)."""
    a, deg = poly_coeff_batch(ns, family, device=device)
    fam = family if _closed_form_ok(ns, family) else None
    return aberth_roots(a, deg, max_iters=max_iters, family=fam,
                        repulsion_dtype=repulsion_dtype)


def eigvals_bucketed(ns, family: str = "lucas_all_ones", max_iters: int = 200,
                     growth: float = 1.5, min_cap: int = 64,
                     repulsion_dtype=torch.float32, device="cuda"):
    """Degree-bucketed batched Aberth sweep (host-orchestrated).

    Same contract as eigvals_batched — (re, im, valid) padded to max(ns),
    rows in input order — but each polynomial is padded only to its
    bucket's max degree, so the O(L²) repulsion tracks Σ n² instead of
    B·n_max², and each bucket stops iterating on its own.
    """
    dev = resolve_device(device)
    ns_list = [int(n) for n in ns]
    ns_arr = np.asarray(ns_list)
    lmax = int(ns_arr.max())
    caps = []
    c = min_cap
    while c < lmax:
        caps.append(c)
        c = max(int(np.ceil(c * growth)), c + 1)
    caps.append(lmax)

    # padding lanes parked far away so a downstream reciprocal stays finite
    zr = torch.full((len(ns_arr), lmax), 1e9, dtype=torch.float64, device=dev)
    zi = torch.zeros((len(ns_arr), lmax), dtype=torch.float64, device=dev)
    valid = torch.zeros((len(ns_arr), lmax), dtype=torch.bool, device=dev)
    lo = 0
    for cap in caps:
        idx = np.where((ns_arr > lo) & (ns_arr <= cap))[0]
        lo = cap
        if idx.size == 0:
            continue
        sub = [ns_list[i] for i in idx]
        r_zr, r_zi, r_valid = eigvals_batched(sub, family, max_iters=max_iters,
                                              repulsion_dtype=repulsion_dtype,
                                              device=dev)
        w = r_zr.shape[1]
        rows = torch.as_tensor(idx, device=dev)
        zr[rows, :w] = r_zr
        zi[rows, :w] = r_zi
        valid[rows, :w] = r_valid
    return zr, zi, valid


def _bucketing_pays(ns) -> bool:
    """Gate for the degree-bucketed sweep: large padded repulsion work, or a
    sweep that spans the curve-init threshold (the reference's gate)."""
    ns = [int(n) for n in ns]
    if len(set(ns)) <= 1:
        return False
    if min(ns) < _CURVE_INIT_MIN_DEG < max(ns):
        return True
    return len(ns) * max(ns) ** 2 > 5e7


def inverse_cloud_padded(ns, family: str = "lucas_all_ones",
                         bucketed: bool = True, repulsion_dtype=torch.float32,
                         device="cuda"):
    """Padded inverse-eigenvalue cloud 1/λ on `device`. Returns (re, im, valid)."""
    ns = [int(n) for n in ns]
    if bucketed and _bucketing_pays(ns):
        zr, zi, valid = eigvals_bucketed(ns, family, repulsion_dtype=repulsion_dtype,
                                         device=device)
    else:
        zr, zi, valid = eigvals_batched(ns, family, repulsion_dtype=repulsion_dtype,
                                        device=device)
    inv = cplx.reciprocal((zr, zi))
    return inv[0], inv[1], valid


def inverse_cloud_split(ns, family: str = "lucas_all_ones", tol: float = 1e-10,
                        backend: str = "aberth", repulsion_dtype=torch.float32,
                        device="cuda") -> list:
    """Per-n list of inverse-eigenvalue clouds (one complex128 array per n).

    backend="lapack" is the host numpy oracle (the reference's per-n LAPACK
    ordering) and ignores `device`; backend="aberth" solves on `device`.
    """
    if backend == "lapack":
        pts = []
        for n in ns:
            vals = np.linalg.eigvals(companion_matrix(family_top_row(family, n)))
            vals = vals[np.abs(vals) > tol]
            pts.append(1.0 / vals)
        return pts
    if backend != "aberth":
        raise ValueError(f"unknown backend {backend!r}")
    zr, zi, valid = inverse_cloud_padded(ns, family, repulsion_dtype=repulsion_dtype,
                                         device=device)
    zr, zi, valid = zr.cpu().numpy(), zi.cpu().numpy(), valid.cpu().numpy()
    lam2 = 1.0 / (zr ** 2 + zi ** 2 + 1e-300)  # |λ|² of padded 1/λ
    keep = valid & (lam2 > tol * tol)
    z = zr + 1j * zi
    return [z[b][keep[b]] for b in range(z.shape[0])]


def inverse_cloud(ns, family: str = "lucas_all_ones", tol: float = 1e-10,
                  backend: str = "aberth", repulsion_dtype=torch.float32,
                  device="cuda") -> np.ndarray:
    """Host complex128 inverse-eigenvalue cloud, concatenated over ns
    (drop |λ| <= tol, then invert — tci_construct_mandelbrot_v002_fixed.py:
    27-33 semantics)."""
    return np.concatenate(inverse_cloud_split(ns, family, tol=tol, backend=backend,
                                              repulsion_dtype=repulsion_dtype,
                                              device=device))
