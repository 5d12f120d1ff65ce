"""Plain reference of the Appendix-A tracker (gi_assumption_tracker_v3.py with
the TCI boundary sampler of tci_construct_mandelbrot_v002_fixed.py), written
from the configuration alone.

Per stage, bins doubling from bins_start to bins_max:
  1. C: the inverse eigenvalues of the Lucas companion matrices,
     n = step .. construct_max (``lucas``, complex128);
  2. M: the TCI distance estimate on the grid_n x grid_n grid of the domain in
     the configured field dtype (z and dz iterated max_iter times, dz not
     latched, z latched at the first |z|^2 > R^2; d = log(max|z|,1)|z| /
     max(|2 z dz|, eps), non-finite -> 0), the escaped pixels with d at or
     below the 25% quantile of the escaped d, and of those the `samples` with
     the largest of the uniforms torch.rand draws on the device from a
     torch.Generator seeded with one draw rng.randint(0, 2**31 - 1) of the
     stage's host stream (one uniform a pixel, in row-major order); points on
     the np.linspace grid;
  3. the larger cloud cut to the smaller's size by rng.choice without
     replacement, each C point matched to argmax_j exp(-(d_ij / mean d) /
     sinkhorn_eps), and C rotated onto its matches by the reference's
     Procrustes convention (svd of Y0^T X0);
  4. histograms of both on the domain, floored at eps, scipy's Gaussian filter
     (sigma_bins, mode nearest), floored again, normalised;
  5. the GI flow X <- (1 - alpha) X + alpha P_M for t_fixed steps from P_C,
     delta = KL(P_M || X_T); the diagnostics of the row.
The f32 field is built on the grid the f32 field is defined on: c = xmin +
col * dx in f32, with xmin and dx = (xmax - xmin) / (grid_n - 1) rounded to
f32 (and the same for y).

``level="stated"`` computes in the configuration's precision: the field and
the matcher in field_dtype, the cloud and the histograms in f64. The matcher
has to: a real C point lies as near to an M node as to its mirror image, and
the configured precision decides such a tie (f32 rounds the two distances to
one value, and the first index wins), where f64 would decide it by the last
bits of the grid. "lower" is the control, one step below: the cloud in
complex64, the field and the matcher in the next lower float (f32 -> bf16,
f64 -> f32).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from benchmarks.reference import lucas

#: the row's counts and values that are compared
COUNTS = ("bins", "n_construct_pts", "n_mandel_pts", "T_n")
VALUES = ("kl_initial", "delta_n", "kl_PM_PC", "tv_XT_PM", "tv_PC_PM",
          "overlap_mass_PC_PM", "mass_outside_domain_C", "mass_outside_domain_M")

_LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def precisions(cfg: dict, level: str) -> dict:
    field = getattr(torch, cfg["field_dtype"])
    if level == "stated":
        return {"cloud": np.complex128, "field": field, "match": field}
    if level == "lower":
        return {"cloud": np.complex64, "field": _LOWER[field], "match": _LOWER[field]}
    raise ValueError(f"unknown level {level!r}")


def de_field(domain, grid_n: int, max_iter: int, escape_r: float, eps: float, dtype,
             device) -> tuple:
    """(escaped, d) on the grid_n x grid_n grid, in `dtype` on `device`."""
    xmin, xmax, ymin, ymax = domain
    p = np.asarray([xmin, ymin, (xmax - xmin) / (grid_n - 1), (ymax - ymin) / (grid_n - 1)],
                   dtype=np.float32 if dtype != torch.float64 else np.float64)
    p = torch.as_tensor(p, device=device).to(dtype)
    idx = torch.arange(grid_n, device=device).to(dtype)
    cr = (p[0] + idx * p[2])[None, :].expand(grid_n, grid_n)
    ci = (p[1] + idx * p[3])[:, None].expand(grid_n, grid_n)
    zr = torch.zeros((grid_n, grid_n), dtype=dtype, device=device)
    zi, dzi, lzr, lzi = (torch.zeros_like(zr) for _ in range(4))
    dzr = torch.ones_like(zr)
    esc = torch.zeros(zr.shape, dtype=torch.bool, device=device)
    r2 = torch.tensor(escape_r * escape_r, dtype=dtype, device=device)
    for _ in range(max_iter):
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        hit = ~esc & (zr * zr + zi * zi > r2)
        lzr = torch.where(hit, zr, lzr)
        lzi = torch.where(hit, zi, lzi)
        esc = esc | hit
    az = torch.sqrt(lzr * lzr + lzi * lzi)
    pr = 2.0 * (lzr * dzr - lzi * dzi)
    pi = 2.0 * (lzr * dzi + lzi * dzr)
    den = torch.clamp(torch.sqrt(pr * pr + pi * pi), min=eps)
    d = torch.log(torch.clamp(az, min=1.0)) * az / den
    d = torch.where(torch.isfinite(d) & esc, d, torch.zeros_like(d))
    return esc, d


def band_sample(cfg: dict, grid_n: int, n_samples: int, seed: int, dtype, device) -> np.ndarray:
    """Step 2: the boundary band's subsample, complex128 on the host."""
    esc, d = de_field(cfg["domain"], grid_n, cfg["max_iter"], cfg["escape_r"], cfg["eps"],
                      dtype, device)
    de = d[esc].double().cpu().numpy()
    if de.size == 0:
        raise RuntimeError("no pixel escapes")
    q = np.quantile(de, 0.25)
    band = (esc & (d.double() <= q)).reshape(-1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(band.shape, generator=gen, dtype=torch.float32, device=device)
    k = min(int(n_samples), grid_n * grid_n)
    idx = torch.topk(torch.where(band, u, torch.full_like(u, -1.0)), k).indices
    idx = idx[: min(int(n_samples), int(band.sum()))].cpu().numpy()
    xmin, xmax, ymin, ymax = cfg["domain"]
    xs = np.linspace(xmin, xmax, grid_n)
    ys = np.linspace(ymin, ymax, grid_n)
    return xs[idx % grid_n] + 1j * ys[idx // grid_n]


def match(x: np.ndarray, y: np.ndarray, eps: float, rng, dtype, device, chunk: int = 2048):
    """Step 3's matcher: (y[match], x) after the cut to equal sizes."""
    n, m = len(x), len(y)
    if n > m:
        x = rng.choice(x, m, replace=False)
    if m > n:
        y = rng.choice(y, n, replace=False)
    a = torch.as_tensor(np.stack([x.real, x.imag], 1), device=device).to(dtype)
    b = torch.as_tensor(np.stack([y.real, y.imag], 1), device=device).to(dtype)

    def dist(blk):
        dx = blk[:, None, 0] - b[None, :, 0]
        dy = blk[:, None, 1] - b[None, :, 1]
        return torch.sqrt(dx * dx + dy * dy)

    total = sum(dist(a[i : i + chunk]).double().sum() for i in range(0, len(a), chunk))
    mean = (total / (len(a) * len(b))).to(dtype)
    pick = torch.cat([torch.argmax(torch.exp(-(dist(a[i : i + chunk]) / mean) / eps), dim=1)
                      for i in range(0, len(a), chunk)])
    return y[pick.cpu().numpy()], x


def procrustes(xc: np.ndarray, yc: np.ndarray) -> np.ndarray:
    """The reference's rotation of xc onto yc (svd of Y0^T X0; no scaling)."""
    x = np.stack([xc.real, xc.imag], 1)
    y = np.stack([yc.real, yc.imag], 1)
    x0, y0 = x - x.mean(0), y - y.mean(0)
    u, _, vt = np.linalg.svd(y0.T @ x0)
    out = x0 @ (u @ vt) + y.mean(0)
    return out[:, 0] + 1j * out[:, 1]


def histogram(cloud: np.ndarray, bins: int, domain, sigma: float, eps: float) -> np.ndarray:
    xmin, xmax, ymin, ymax = domain
    h, _, _ = np.histogram2d(cloud.real, cloud.imag, bins=bins, range=[[xmin, xmax], [ymin, ymax]])
    h = np.maximum(h, eps)
    if sigma > 0:
        h = np.maximum(gaussian_filter(h, sigma, mode="nearest"), eps)
    return h / h.sum()


def kl(p, x, eps):
    p, x = np.clip(p, eps, None), np.clip(x, eps, None)
    return float(np.sum(p * (np.log(p) - np.log(x))))


def outside(cloud, domain) -> float:
    xmin, xmax, ymin, ymax = domain
    x, y = cloud.real, cloud.imag
    return float(1.0 - np.mean((x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)))


def run_tracker(cfg: dict, seed: int, device, level: str = "stated") -> list:
    """The tracker's rows (dicts of COUNTS and VALUES) for host seed `seed`."""
    if int(cfg["t_fixed"]) <= 0 or cfg["family"] != "lucas_all_ones":
        raise ValueError("the reference runs the fixed-T flow of the Lucas family only")
    prec = precisions(cfg, level)
    rng = np.random.RandomState(seed)
    domain = tuple(cfg["domain"])
    eps, alpha, step = cfg["eps"], cfg["alpha"], int(cfg["construct_step"])
    bins, cmax = int(cfg["bins_start"]), int(cfg["construct_max_start"])
    grid, samples = int(cfg["mandelbrot_grid_start"]), int(cfg["mandelbrot_samples_start"])
    rows = []
    while bins <= int(cfg["bins_max"]):
        c = np.concatenate(lucas.inverse_cloud(range(step, cmax + 1, step), prec["cloud"]))
        c = c.astype(np.complex128)
        m = band_sample(cfg, grid, samples, int(rng.randint(0, 2**31 - 1)), prec["field"], device)
        m_match, c_sub = match(c, m, cfg["sinkhorn_eps"], rng, prec["match"], device)
        c_al = procrustes(c_sub, m_match)
        p_m = histogram(m_match, bins, domain, cfg["sigma_bins"], eps)
        p_c = histogram(c_al, bins, domain, cfg["sigma_bins"], eps)
        x = p_c
        kl0 = kl(p_m, x, eps)
        t_n = int(cfg["t_fixed"])
        for _ in range(t_n):
            x = (1.0 - alpha) * x + alpha * p_m
        delta = kl(p_m, x, eps)
        tv_pc_pm = 0.5 * float(np.abs(p_c - p_m).sum())
        factor = (1.0 - alpha) ** (-t_n)
        rows.append({
            "bins": bins, "n_construct_pts": int(c_al.size), "n_mandel_pts": int(m_match.size),
            "T_n": t_n, "kl_initial": kl0, "delta_n": delta, "kl_PM_PC": kl(p_m, p_c, eps),
            "tv_XT_PM": 0.5 * float(np.abs(x - p_m).sum()), "tv_PC_PM": tv_pc_pm,
            "overlap_mass_PC_PM": float(np.minimum(p_c, p_m).sum()),
            "mass_outside_domain_C": outside(c_al, domain),
            "mass_outside_domain_M": outside(m_match, domain)})
        if (delta <= cfg["kl_threshold"] and factor * math.sqrt(delta) <= cfg["compound_threshold"]
                and tv_pc_pm <= cfg["tv_threshold"]):
            break
        bins *= 2
        cmax = int(round((cmax * cfg["construct_max_growth"]) / step)) * step
        grid = int(round(grid * cfg["mandelbrot_grid_growth"]))
        samples = min(int(cfg["mandelbrot_samples_max"]),
                      int(round(samples * cfg["mandelbrot_samples_growth"])))
    return rows


def _finite(gap: float) -> float:
    return math.inf if math.isnan(gap) else gap


def compare(program_rows: list, reference_rows: list) -> dict:
    """rows_count_gap: the largest |p - r| of a row's counts (bins, the two
    clouds' sizes, T) over the stages, exact; rows_gap: the largest relative
    gap |p - r| / |r| of a row's values over the stages (0 where both are 0,
    infinite where r is 0 alone). Both are infinite where a stage is missing
    or extra, and a NaN reads infinite."""
    if len(program_rows) != len(reference_rows):
        return {"rows_count_gap": math.inf, "rows_gap": math.inf}
    counts, values = 0.0, 0.0
    for p, r in zip(program_rows, reference_rows):
        for k in COUNTS:
            counts = max(counts, _finite(abs(float(p[k]) - float(r[k]))))
        for k in VALUES:
            a, b = float(p[k]), float(r[k])
            if a != b:
                values = max(values, _finite(abs(a - b) / abs(b)) if b != 0 else math.inf)
    return {"rows_count_gap": counts, "rows_gap": values}
