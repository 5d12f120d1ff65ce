"""Batched inverse-eigenvalue clouds of generalized Lucas companion matrices.

Port of ``cmtci/kernels/companion.py``. The eigenvalues of a companion
matrix with first row (c_1..c_n) are the roots of
p(x) = x^n - c_1 x^{n-1} - ... - c_n, found by a batched Aberth–Ehrlich
simultaneous iteration: elementwise f64 work over (batch, lane) tensors with
validity masks, carried as (re, im) pairs exactly as the reference writes
it. On CUDA tensors the reference's ``lax.while_loop`` is one launch of
``csrc/aberth.cu`` (one CTA a polynomial, the whole loop inside, each
polynomial leaving when its lanes are frozen); on CPU tensors it is the
plain twin ``aberth_roots_torch``, a Python loop that reads the convergence
flag with ``.item()``. LAPACK on the host stays the parity oracle
(``backend="lapack"``).

Stability for degrees up to ~1220 comes from the two-branch Newton ratio
(reversed polynomial for |z| > r, direct Horner inside), see
``_newton_ratio`` and ``_newton_ratio_closed``.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from cmtci_torch.kernels._launch import launch as _launch
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


def _circle_init(deg, nl: int, dtype):
    """Distinct angles on the unit circle with a golden-ratio phase offset."""
    lane = torch.arange(nl, device=deg.device)[None, :]
    degf = torch.clamp(deg, min=1)[:, None].to(dtype)
    theta = 2.0 * math.pi * (lane.to(dtype) + 0.256) / degf + 0.577 / degf
    return torch.cos(theta), torch.sin(theta)


def _far(bsz: int, nl: int, dtype, dev):
    """Where the invalid lanes are parked, so they never interact with valid
    ones and a downstream reciprocal stays finite."""
    lane = torch.arange(nl, device=dev)[None, :]
    lanef = lane.to(dtype) + torch.zeros((bsz, 1), dtype=dtype, device=dev)
    return 1e9 * torch.cos(lanef), 1e9 * torch.sin(lanef)


def _start(a, deg, family):
    """The start roots of aberth_roots and the valid lanes."""
    bsz, lp1 = a.shape
    nl = lp1 - 1
    valid = torch.arange(nl, device=a.device)[None, :] < deg[:, None]
    if family in _CLOSED_FAMILIES:
        z = _curve_init(family, deg, nl, a.dtype)
    else:
        z = _circle_init(deg, nl, a.dtype)
    return cplx.where(valid, z, _far(bsz, nl, a.dtype, a.device)), valid


def aberth_roots_torch(a, deg, max_iters: int = 200, tol: float = 1e-13, chunk: int = 128,
                       family: str | None = None, repulsion_dtype=torch.float32,
                       return_steps: bool = False, return_lane_steps: bool = False):
    """Plain twin of aberth_roots: the eager loop on the tensors' device,
    every polynomial iterated until all are done (the convergence flag read
    on the host each step). With return_steps, also the (B,) int32 count of
    the steps each polynomial took until its lanes were all frozen; with
    return_lane_steps, both that and the (B,) int64 sum over those steps of
    the lanes not yet frozen (the lane updates aberth.cu computes)."""
    z, valid = _start(a, deg, family)
    tol2 = tol * tol
    frozen = torch.zeros_like(valid)
    steps = torch.zeros(deg.shape, dtype=torch.int32, device=a.device)
    lane_steps = torch.zeros(deg.shape, dtype=torch.int64, device=a.device)
    row_done = torch.zeros(deg.shape, dtype=torch.bool, device=a.device)
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
        lane_steps += (valid & ~frozen).sum(dim=1)
        # latch convergence permanently (see the reference's aberth_roots)
        frozen = frozen | (moved2 <= tol2 * torch.clamp(cplx.abs2(z), min=1e-30))
        corr = cplx.where(valid & ~frozen, corr, cplx.full_like(z, 0.0))
        z = cplx.sub(z, corr)
        steps += (~row_done).to(torch.int32)
        row_done = torch.all(torch.where(valid, frozen, True), dim=1)
        done = bool(torch.all(row_done).item())
        it += 1
    if return_lane_steps:
        return z[0], z[1], valid, steps, lane_steps
    if return_steps:
        return z[0], z[1], valid, steps
    return z[0], z[1], valid


#: the dynamic shared memory one CTA of csrc/aberth.cu may use on an H100
#: (227 KB); aberth_roots refuses a polynomial whose CTA does not fit
ABERTH_SMEM_MAX = 232448
#: the threads of a CTA (aberth.cu's MAX_THREADS); a thread owns at most 32
#: lanes
ABERTH_THREADS = 256
#: the CTAs of a thread block cluster that share a polynomial of more lanes
#: than a CTA has threads (aberth.cu's CLUSTER; 1 to 16 were measured)
ABERTH_CLUSTER = 8


def aberth_parts(n: int, threads: int = ABERTH_THREADS, cluster: int = ABERTH_CLUSTER) -> int:
    """The CTAs aberth.cu gives a polynomial of degree n: the whole cluster
    when n is more lanes than a CTA has threads, else one."""
    return cluster if cluster > 1 and int(n) > threads else 1


def aberth_smem_bytes(ns, widths, closed, f64_repulsion: bool, threads: int = ABERTH_THREADS,
                      cluster: int = ABERTH_CLUSTER) -> int:
    """Dynamic shared memory of the largest CTA of an aberth.cu launch (a
    build with `threads` a CTA and `cluster` CTAs a cluster): the votes (two
    ints a CTA of the cluster, padded to 16 B), two copies of the n roots the
    repulsion reads (8 B a lane, 16 with an f64 repulsion), 16 B a lane the
    CTA owns (ceil(n / parts) of them) for its f64 roots, 8 a coefficient of
    a row without a closed form."""
    per_copy = 16 if f64_repulsion else 8
    votes = -(-8 * cluster // 16) * 16
    return max(votes + 2 * per_copy * int(n)
               + 16 * -(-int(n) // aberth_parts(n, threads, cluster))
               + (0 if c else 8 * (int(w) + 1))
               for n, w, c in zip(ns, widths, closed))


def aberth_max_degree(f64_repulsion: bool, closed: bool = False, threads: int = ABERTH_THREADS,
                      cluster: int = ABERTH_CLUSTER) -> int:
    """The largest degree whose CTA fits ABERTH_SMEM_MAX (a row padded to its
    own degree; the closed form also needs n < 4096)."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        fits = aberth_smem_bytes([mid], [mid], [closed], f64_repulsion, threads,
                                 cluster) <= ABERTH_SMEM_MAX
        lo, hi = (mid, hi) if fits else (lo, mid - 1)
    return lo


def aberth_tasks(ns, threads: int = ABERTH_THREADS, cluster: int = ABERTH_CLUSTER):
    """aberth.cu's CTAs for the degrees ns: a (ctas, 2) int32 array of (b,
    parts) rows, a whole cluster for each polynomial aberth_parts splits
    (largest first), then the others one CTA each, `cluster` to a cluster, a
    spare CTA (-1, 1) filling the last."""
    order = sorted(range(len(ns)), key=lambda b: -int(ns[b]))
    big = [b for b in order if aberth_parts(ns[b], threads, cluster) > 1]
    small = [b for b in order if aberth_parts(ns[b], threads, cluster) == 1]
    rows = [(b, cluster) for b in big for _ in range(cluster)]
    rows += [(b, 1) for b in small] + [(-1, 1)] * (-len(small) % cluster)
    return np.asarray(rows, dtype=np.int32).reshape(-1, 2)


def aberth_launch_shape(ns, threads: int = ABERTH_THREADS, cluster: int = ABERTH_CLUSTER):
    """(task, block) of an aberth.cu build with `threads` a CTA (its
    MAX_THREADS) and `cluster` CTAs a cluster (its CLUSTER) for the degrees
    ns: aberth_tasks' table and the threads the launch gives a CTA, a warp at
    least and no more than its largest CTA's lanes need. Refuses a shape the
    kernel cannot run."""
    if not (1 <= cluster <= 16 and 32 <= threads <= 1024):
        raise ValueError(f"aberth.cu: cluster {cluster} (1..16), threads {threads} (32..1024)")
    span = max(-(-int(n) // aberth_parts(n, threads, cluster)) for n in ns)
    block = min(threads, max(32, -(-span // 32) * 32))
    if span > 32 * block:
        raise ValueError(f"aberth.cu: {span} lanes a CTA is more than 32 a thread of {block}")
    return aberth_tasks(ns, threads, cluster), block


def _aberth_prepare(a, deg, ns, z, widths, closed, family, max_iters: int, tol: float,
                    repulsion_dtype):
    """The output buffers of one aberth.cu launch (see _aberth_cuda) and the
    launch: (zr, zi, steps, go), zr and zi holding the start roots until go()
    launches the kernel on them in place; go is None when there is no
    polynomial."""
    dev = a.device
    if a.dtype != torch.float64:
        raise TypeError(f"aberth.cu takes float64 coefficients, got {a.dtype}")
    bsz, lanes = z[0].shape
    rep64 = repulsion_dtype is None or repulsion_dtype == a.dtype
    if not rep64 and repulsion_dtype != torch.float32:
        raise TypeError(f"aberth.cu repulses in float32 or float64, got {repulsion_dtype}")
    zr = z[0].to(torch.float64).contiguous().clone()
    zi = z[1].to(torch.float64).contiguous().clone()
    steps = torch.zeros(bsz, dtype=torch.int32, device=dev)
    if bsz == 0:
        return zr, zi, steps, None
    smem = aberth_smem_bytes(ns, widths, closed, rep64)
    if smem > ABERTH_SMEM_MAX:
        limit = aberth_max_degree(rep64)
        raise ValueError(
            f"aberth.cu: a polynomial of degree {max(ns)} needs {smem} bytes of shared "
            f"memory a CTA ({ABERTH_CLUSTER} CTAs a cluster), more than a CTA holds "
            f"({ABERTH_SMEM_MAX}); the largest degree it takes is {limit} "
            f"({'f64' if rep64 else 'f32'} repulsion, Horner form); use device='cpu'")
    coeffs, a_const = _CLOSED_FAMILIES.get(family, ((0.0,), 0.0))
    c = [float(v) for v in coeffs] + [0.0] * (4 - len(coeffs))
    key = (tuple(int(n) for n in ns), tuple(int(w) for w in widths),
           tuple(bool(v) for v in closed), str(dev))

    def tables():
        task, block = aberth_launch_shape(ns)
        return (torch.as_tensor(task, device=dev), block,
                torch.as_tensor(np.asarray(widths, dtype=np.int32), device=dev),
                torch.as_tensor(np.asarray(closed, dtype=np.uint8), device=dev))

    task, block, width32, closed8 = _cached(("tasks",) + key, tables)
    deg32 = deg.to(device=dev, dtype=torch.int32).contiguous()
    coef = a.contiguous()

    def go():
        _launch("aberth", dev, zr.data_ptr(), zi.data_ptr(), steps.data_ptr(), task.data_ptr(),
                deg32.data_ptr(), width32.data_ptr(), closed8.data_ptr(), coef.data_ptr(),
                int(coef.shape[1]), int(task.shape[0]), int(lanes), int(max_iters),
                float(tol * tol), int(rep64), *c, len(coeffs), float(a_const), int(block),
                int(smem))

    return zr, zi, steps, go


def _aberth_cuda(a, deg, ns, z, widths, closed, family, max_iters: int, tol: float,
                 repulsion_dtype):
    """One launch of csrc/aberth.cu from the start roots z (a pair of (B, L)
    tensors) for the degrees deg (on the device) and ns (the same on the
    host), each row b with its twin's padded width widths[b] and the closed
    form where closed[b]. Returns (zr, zi, steps) on a's device."""
    zr, zi, steps, go = _aberth_prepare(a, deg, ns, z, widths, closed, family, max_iters, tol,
                                        repulsion_dtype)
    if go is not None:
        go()
    return zr, zi, steps


def aberth_roots(a, deg, max_iters: int = 200, tol: float = 1e-13, chunk: int = 128,
                 family: str | None = None, repulsion_dtype=torch.float32,
                 return_steps: bool = False):
    """Batched Aberth–Ehrlich root finder on the tensors' device.

    a: (B, L+1) ascending coefficients (see poly_coeff_batch); deg: (B,).
    Returns (re, im, valid): (B, L) roots with valid[b, k] = k < deg[b]; with
    return_steps also each polynomial's (B,) int32 step count.

    When `family` names a closed-form family the Newton ratio uses the
    O(log n) geometric-series form. The pairwise repulsion runs in
    `repulsion_dtype` (default f32, as in the reference): it only conditions
    the simultaneous convergence, the fixed point is where the f64 Newton
    ratio vanishes. Pass repulsion_dtype=None to keep it in a's dtype.

    CUDA tensors: one launch of csrc/aberth.cu, nothing read on the host
    inside the loop; the roots agree with the twin's within the freeze
    tolerance (not bitwise: the f32 repulsion is summed in another order).
    CPU tensors: the eager twin aberth_roots_torch (`chunk` sets its blocks).
    """
    if a.device.type == "cpu":
        return aberth_roots_torch(a, deg, max_iters, tol, chunk, family, repulsion_dtype,
                                  return_steps)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device} (expected cuda or cpu)")
    z, valid = _start(a, deg, family)
    bsz, nl = valid.shape
    zr, zi, steps = _aberth_cuda(a, deg, deg.tolist(), z, [nl] * bsz,
                                 [family in _CLOSED_FAMILIES] * bsz, family, max_iters, tol,
                                 repulsion_dtype)
    return (zr, zi, valid, steps) if return_steps else (zr, zi, valid)


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
                    repulsion_dtype=torch.float32, device="cuda", roots=None,
                    return_steps: bool = False, return_lane_steps: bool = False):
    """Padded batched companion eigenvalues via Aberth. Returns (re, im, valid).

    `roots` is the root finder (default aberth_roots; aberth_roots_torch runs
    the eager twin on any device). With return_steps also each row's step
    count, with return_lane_steps also its lane updates (aberth_roots_torch's).
    """
    a, deg = poly_coeff_batch(ns, family, device=device)
    fam = family if _closed_form_ok(ns, family) else None
    extra = ({"return_lane_steps": True} if return_lane_steps
             else {"return_steps": True} if return_steps else {})
    return (roots or aberth_roots)(a, deg, max_iters=max_iters, family=fam,
                                   repulsion_dtype=repulsion_dtype, **extra)


def _bucket_rows(ns, growth: float = 1.5, min_cap: int = 64) -> list:
    """The rows of each degree bucket of eigvals_bucketed, in cap order:
    caps grow geometrically from min_cap to max(ns)."""
    ns_arr = np.asarray([int(n) for n in ns])
    lmax = int(ns_arr.max())
    caps = []
    c = min_cap
    while c < lmax:
        caps.append(c)
        c = max(int(np.ceil(c * growth)), c + 1)
    caps.append(lmax)
    rows = []
    lo = 0
    for cap in caps:
        idx = np.where((ns_arr > lo) & (ns_arr <= cap))[0]
        lo = cap
        if idx.size:
            rows.append(idx)
    return rows


def eigvals_bucketed(ns, family: str = "lucas_all_ones", max_iters: int = 200,
                     growth: float = 1.5, min_cap: int = 64,
                     repulsion_dtype=torch.float32, device="cuda", roots=None,
                     return_steps: bool = False, return_lane_steps: bool = False):
    """Degree-bucketed batched Aberth sweep (host-orchestrated).

    Same contract as eigvals_batched — (re, im, valid) padded to max(ns),
    rows in input order, `roots` and the step counts — but each polynomial
    is padded only to its bucket's max degree, so the O(L²) repulsion tracks
    Σ n² instead of B·n_max², and each bucket stops iterating on its own.
    """
    dev = resolve_device(device)
    ns_list = [int(n) for n in ns]
    bsz, lmax = len(ns_list), max(ns_list)

    # padding lanes parked far away so a downstream reciprocal stays finite
    zr = torch.full((bsz, lmax), 1e9, dtype=torch.float64, device=dev)
    zi = torch.zeros((bsz, lmax), dtype=torch.float64, device=dev)
    valid = torch.zeros((bsz, lmax), dtype=torch.bool, device=dev)
    counts = [torch.zeros(bsz, dtype=dt, device=dev) for dt in (torch.int32, torch.int64)]
    counts = counts[:2 if return_lane_steps else 1 if return_steps else 0]
    for idx in _bucket_rows(ns_list, growth, min_cap):
        sub = [ns_list[i] for i in idx]
        r_zr, r_zi, r_valid, *r_counts = eigvals_batched(
            sub, family, max_iters=max_iters, repulsion_dtype=repulsion_dtype, device=dev,
            roots=roots, return_steps=return_steps, return_lane_steps=return_lane_steps)
        w = r_zr.shape[1]
        rows = torch.as_tensor(idx, device=dev)
        zr[rows, :w] = r_zr
        zi[rows, :w] = r_zi
        valid[rows, :w] = r_valid
        for count, r_count in zip(counts, r_counts):
            count[rows] = r_count
    return (zr, zi, valid, *counts)


def _build_plan(ns, family: str, bucketed: bool, dev):
    """_one_launch_plan, built anew: eigvals_one_launch's arguments of
    _aberth_cuda for `ns`, with the twin's arithmetic on each row: the padded
    width, the closed form's eligibility and the start roots of the bucket
    (or the one batch) eigvals_bucketed (eigvals_batched) puts the row in,
    and the same padding lanes. Returns (a, deg, ns, z, widths, closed,
    valid), ns, widths and closed as tuples."""
    ns_list = [int(n) for n in ns]
    bsz, lmax = len(ns_list), max(ns_list)
    if bucketed and _bucketing_pays(ns_list):
        groups = _bucket_rows(ns_list)
    else:
        groups = [np.arange(bsz)]
    widths = np.zeros(bsz, dtype=np.int64)
    closed = np.zeros(bsz, dtype=bool)
    for idx in groups:
        sub = [ns_list[i] for i in idx]
        widths[idx] = max(sub)
        closed[idx] = _closed_form_ok(sub, family)
    a, deg = poly_coeff_batch(ns_list, family, device=dev)
    lane = torch.arange(lmax, device=dev)[None, :]
    valid = lane < deg[:, None]
    z = _circle_init(deg, lmax, a.dtype)
    if closed.any():
        curve = _curve_init(family, deg, lmax, a.dtype)
        z = cplx.where(torch.as_tensor(closed, device=dev)[:, None], curve, z)
    # the twin parks a bucket's padding lanes at 1e9 (cos, sin) of the lane,
    # and fills the lanes past the bucket's width with 1e9 + 0i
    inside = lane < torch.as_tensor(widths, device=dev)[:, None]
    far = _far(bsz, lmax, a.dtype, dev)
    fill = cplx.where(inside, far, (torch.full_like(far[0], 1e9), torch.zeros_like(far[1])))
    z = cplx.where(valid, z, fill)
    return a, deg, tuple(ns_list), z, tuple(widths.tolist()), tuple(closed.tolist()), valid


#: the launch plans and tables of the last few dozen distinct sweeps, by key
_CACHE = OrderedDict()
_CACHE_SIZE = 64


def _cached(key, build):
    """build() once per key, the least recently used of more than _CACHE_SIZE
    keys dropped. What it returns is shared: no caller writes into it."""
    if key in _CACHE:
        _CACHE.move_to_end(key)
        return _CACHE[key]
    value = _CACHE[key] = build()
    if len(_CACHE) > _CACHE_SIZE:
        _CACHE.popitem(last=False)
    return value


def _one_launch_plan(ns, family: str, bucketed: bool, dev):
    """_build_plan's tensors, cached per (ns, family, bucketed, device): a
    pure function of its arguments. The launch clones the start roots
    (_aberth_prepare), so the kernel's in-place update never reaches the
    cache."""
    ns = tuple(int(n) for n in ns)
    return _cached(("plan", ns, family, bool(bucketed), str(dev)),
                   lambda: _build_plan(ns, family, bucketed, dev))


def eigvals_one_launch(ns, family: str = "lucas_all_ones", bucketed: bool = True,
                       max_iters: int = 200, repulsion_dtype=torch.float32, device="cuda",
                       return_steps: bool = False):
    """inverse_cloud_padded's eigenvalues on a CUDA device in ONE aberth.cu
    launch over all of `ns`, each row with the arithmetic of the twin's call
    tree (_one_launch_plan, cached). Each polynomial stops on its own, so the
    host's buckets buy nothing here. Returns (re, im, valid) padded to max(ns),
    with return_steps also each row's step count."""
    dev = resolve_device(device)
    a, deg, ns_list, z, widths, closed, valid = _one_launch_plan(ns, family, bucketed, dev)
    zr, zi, steps = _aberth_cuda(a, deg, ns_list, z, widths, closed, family, max_iters, 1e-13,
                                 repulsion_dtype)
    valid = valid.clone()
    return (zr, zi, valid, steps) if return_steps else (zr, zi, valid)


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
    """Padded inverse-eigenvalue cloud 1/λ on `device`. Returns (re, im, valid).

    On a CUDA device the eigenvalues are one aberth.cu launch
    (eigvals_one_launch); on the CPU the twin's buckets or batch."""
    ns = [int(n) for n in ns]
    if resolve_device(device).type == "cuda":
        zr, zi, valid = eigvals_one_launch(ns, family, bucketed,
                                           repulsion_dtype=repulsion_dtype, device=device)
    elif bucketed and _bucketing_pays(ns):
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
