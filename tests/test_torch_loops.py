"""The reference's compiled device loops in the port: batched Aberth
(csrc/aberth.cu), the per-point escape loops (csrc/orbit.cu) and the
Sinkhorn loop (csrc/sinkhorn.cu on the card), on the CPU.

The kernels run only on the card, where chip_smoke.py (phase 23) holds them
to their twins. Here:
  (a) a schedule model of aberth.cu (one polynomial at a time, leaving when
      its lanes are frozen, the f32 repulsion summed one term after another
      in j) is fed the launch plan inverse_cloud_padded builds for the card,
      and held to the eager twin and to cmtci's aberth at 1e-12 relative,
      step counts within one;
  (b) each orbit loop, split into the loop state and the epilogue both paths
      share, is held bitwise to the function as it stood before the split
      (restated below) and to cmtci at the thresholds the other test_torch_*
      files use;
  (c) CPU tensors run the twins and launch nothing; the card's paths raise
      without one.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cmtci.kernels import companion as ref_companion
from cmtci.kernels import mandelbrot as ref_mb
from cmtci_torch.kernels import _launch, companion
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.transport import sinkhorn
from cmtci_torch.utils import cplx

CSRC = Path(__file__).resolve().parents[1] / "cmtci_torch" / "csrc"
DOM = (-2.2, 1.2, -1.6, 1.6)
#: the degrees of the pipelines' clouds: stage1, lucas-boundary, the tracker
#: and run_tci
CLOUDS = {"stage1": list(range(2, 41)), "lucas_boundary": list(range(2, 101)),
          "tracker": list(range(20, 301, 20))}
#: the relative bound the card holds aberth.cu to its twin at: ten times the
#: 1e-13 freeze tolerance, within which two schedules stop a lane
ROOT_RTOL = 1e-12
ORBIT_ENTRIES = ("orbit_dwell", "orbit_de_tci", "orbit_de_std", "orbit_de_stage1",
                 "orbit_green", "orbit_potential")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) Aberth: the kernel's schedule on the CPU
# ---------------------------------------------------------------------------


def _repulsion_in_j_order(z, f64: bool):
    """aberth.cu's repulsion: s_i = sum over j of (z_i - z_j)/|z_i - z_j|^2
    where that is > 0, one term after another in j (numpy's add.accumulate
    is sequential), in f32 on f32 copies of the roots or in f64."""
    dt = np.float64 if f64 else np.float32
    xr, xi = z[0][0].numpy().astype(dt), z[1][0].numpy().astype(dt)
    dr = xr[:, None] - xr[None, :]
    di = xi[:, None] - xi[None, :]
    d2 = dr * dr + di * di
    pos = d2 > 0
    inv = np.where(pos, dt(1) / np.where(pos, d2, dt(1)), dt(0))
    sr = np.add.accumulate(dr * inv, axis=1)[:, -1]
    si = np.add.accumulate(-di * inv, axis=1)[:, -1]
    return (torch.from_numpy(sr.astype(np.float64))[None],
            torch.from_numpy(si.astype(np.float64))[None])


def aberth_kernel_model(a, deg, ns, z, widths, closed, family, max_iters, tol,
                        repulsion_dtype):
    """companion._aberth_cuda's contract, computed as aberth.cu schedules it:
    each polynomial alone, with the twin's f64 Newton ratio (closed form or
    Horner over the row's padded width) and the twin's update and latch,
    leaving when its lanes are all frozen. Returns (zr, zi, steps)."""
    f64 = repulsion_dtype is None or repulsion_dtype == a.dtype
    zr, zi = z[0].clone(), z[1].clone()
    steps = torch.zeros(len(deg), dtype=torch.int32)
    tol2 = tol * tol
    for b in range(len(deg)):
        n = int(deg[b])
        zb = (zr[b:b + 1, :n].clone(), zi[b:b + 1, :n].clone())
        frozen = torch.zeros((1, n), dtype=torch.bool)
        it = 0
        while it < max_iters:
            if closed[b]:
                w = companion._newton_ratio_closed(family, deg[b:b + 1], zb)
            else:
                w = companion._newton_ratio(a[b:b + 1, :widths[b] + 1], deg[b:b + 1], zb)
            s = _repulsion_in_j_order(zb, f64)
            corr = cplx.div(w, cplx.sub(cplx.full_like(zb, 1.0), cplx.mul(w, s)))
            frozen = frozen | (cplx.abs2(corr)
                               <= tol2 * torch.clamp(cplx.abs2(zb), min=1e-30))
            zb = cplx.sub(zb, cplx.where(~frozen, corr, cplx.full_like(zb, 0.0)))
            it += 1
            if bool(frozen.all()):
                break
        zr[b, :n], zi[b, :n] = zb[0][0], zb[1][0]
        steps[b] = it
    return zr, zi, steps


def _twin_eigvals(ns, family):
    """The eager twin under inverse_cloud_padded on the CPU with each
    polynomial's step count, (zr, zi, valid, steps)."""
    sweep = (companion.eigvals_bucketed if companion._bucketing_pays(ns)
             else companion.eigvals_batched)
    zr, zi, valid, steps = sweep(ns, family, device="cpu", return_steps=True)
    return zr, zi, valid, steps.numpy()


@pytest.mark.parametrize("sweep", ["eigvals_batched", "eigvals_bucketed"])
def test_step_counts_leave_the_roots(sweep):
    """return_steps and return_lane_steps, and the twin named as `roots`,
    give the default call's roots bitwise; a row's lane updates lie between
    its steps and steps x n."""
    ns = list(range(20, 301, 20))
    fn = getattr(companion, sweep)
    want = fn(ns, device="cpu")
    zr, zi, valid, steps = fn(ns, device="cpu", return_steps=True)
    lr, li, lv, lsteps, lanes = fn(ns, device="cpu", roots=companion.aberth_roots_torch,
                                   return_lane_steps=True)
    for got in ((zr, zi, valid), (lr, li, lv)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(steps, lsteps) and steps.dtype == torch.int32
    assert bool((lanes >= steps).all() and (lanes <= steps.long() * torch.as_tensor(ns)).all())


#: every family at every pipeline's degrees, and the sparser family with
#: n = 1..100, whose first bucket takes the Horner form
SCHEDULE_CASES = ([(f, c) for f in companion.FAMILIES for c in CLOUDS]
                  + [("sparser_gap_1_0_1_then_ones", "with_n1")])


@pytest.fixture(scope="module")
def scheduled():
    """{(family, cloud): (the plan run through the kernel model, the twin,
    the degrees)}."""
    cases = SCHEDULE_CASES
    out = {}
    original = companion._aberth_cuda
    companion._aberth_cuda = aberth_kernel_model
    try:
        for family, cloud in cases:
            ns = CLOUDS.get(cloud, list(range(1, 101)))
            out[family, cloud] = (companion.eigvals_one_launch(ns, family, device="cpu",
                                                               return_steps=True),
                                  _twin_eigvals(ns, family), ns)
    finally:
        companion._aberth_cuda = original
    return out


def _rel_err(zr, zi, wr, wi, valid):
    err = torch.hypot(zr - wr, zi - wi)
    return float((err / torch.hypot(wr, wi))[valid].max())


@pytest.mark.parametrize("family,cloud", SCHEDULE_CASES)
def test_kernel_schedule_against_twin(scheduled, family, cloud):
    """The one-launch plan under the kernel's schedule: every valid root
    within 1e-12 relative of the eager twin's, the parked lanes bitwise, the
    step counts within one."""
    (zr, zi, valid, steps), (wr, wi, wvalid, wsteps), ns = scheduled[family, cloud]
    assert torch.equal(valid, wvalid)
    assert _rel_err(zr, zi, wr, wi, valid) <= ROOT_RTOL
    assert torch.equal(zr[~valid], wr[~valid]) and torch.equal(zi[~valid], wi[~valid])
    assert np.abs(steps.numpy() - wsteps).max() <= 1
    assert steps.min() >= 1 and steps.max() < 200, (family, cloud, steps)


@pytest.mark.parametrize("family,cloud", [(f, "tracker") for f in companion.FAMILIES]
                         + [("lucas_all_ones", "stage1"),
                            ("lucas_all_ones", "lucas_boundary")])
def test_kernel_schedule_against_cmtci(scheduled, family, cloud):
    """The same roots within 1e-12 relative of cmtci's aberth_roots, lane
    for lane (the reference's own sweep as its inverse_cloud_padded runs
    it)."""
    (zr, zi, valid, _), _, ns = scheduled[family, cloud]
    if ref_companion._bucketing_pays(ns):
        rr, ri, rv = ref_companion.eigvals_bucketed(ns, family)
    else:
        rr, ri, rv = ref_companion.eigvals_batched(ns, family)
    rr, ri = torch.from_numpy(np.array(rr)), torch.from_numpy(np.array(ri))
    assert np.array_equal(valid.numpy(), np.asarray(rv))
    assert _rel_err(zr, zi, rr, ri, valid) <= ROOT_RTOL


@pytest.mark.parametrize("repulsion_dtype", [torch.float32, None])
def test_direct_call_schedule_against_twin(repulsion_dtype):
    """aberth_roots' own plan on the card (every row at the batch's width,
    one family), f32 and f64 repulsion, closed form and Horner."""
    ns = [3, 17, 40, 64]
    for fam in ("pell_like_all_twos", None):
        a, deg = companion.poly_coeff_batch(ns, "pell_like_all_twos", device="cpu")
        z, valid = companion._start(a, deg, fam)
        nl = valid.shape[1]
        zr, zi, steps = aberth_kernel_model(a, deg, ns, z, [nl] * 4, [fam is not None] * 4,
                                            fam, 200, 1e-13, repulsion_dtype)
        wr, wi, _, wsteps = companion.aberth_roots(a, deg, family=fam, return_steps=True,
                                                   repulsion_dtype=repulsion_dtype)
        assert _rel_err(zr, zi, wr, wi, valid) <= ROOT_RTOL
        assert torch.equal(zr[~valid], wr[~valid])
        assert (steps - wsteps).abs().max() <= 1


def test_shared_memory_limit_is_named():
    """A CTA holds two copies of a polynomial's roots and its own lanes in
    shared memory: the closed form's largest degree (4095) takes a cluster of
    8 CTAs and fits the H100's 227 KB with room to spare; a Horner row one
    degree above the largest the layout takes (8,937 with the f32
    repulsion; 4,842 was one CTA's) is refused before anything launches,
    and the refusal names that degree."""
    assert companion.ABERTH_SMEM_MAX == 232448
    assert companion.aberth_smem_bytes([4095], [4095], [True], False) == 73776
    limit = companion.aberth_max_degree(False)
    assert limit == 8937
    n = limit + 1
    a, deg = companion.poly_coeff_batch([n], "lucas_all_ones", device="cpu")
    z = (torch.zeros((1, n), dtype=torch.float64), torch.zeros((1, n), dtype=torch.float64))
    with pytest.raises(ValueError, match=r"232448\).*the largest degree it takes is 8937"):
        companion._aberth_cuda(a, deg, [n], z, [n], [False], None, 200, 1e-13, torch.float32)


def test_launch_signatures_match_the_sources():
    """Each entry's ctypes argument list has as many types as its extern "C"
    function in csrc/ has parameters (ctypes would pass a mismatch
    silently on the card)."""
    for entry in ("aberth", *ORBIT_ENTRIES):
        src = (CSRC / f"{_launch.LIBRARY.get(entry, entry)}.cu").read_text()
        m = re.search(rf'extern "C" int {entry}_launch\(([^)]*)\)', src)
        assert m, entry
        assert len(m.group(1).split(",")) == len(_launch.ARGTYPES[entry]), entry


# ---------------------------------------------------------------------------
# (b) the orbit loops: loop state plus shared epilogue
# ---------------------------------------------------------------------------


def _before_dwell_grid(cr, ci, max_iter):
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    dwell = torch.full(cr.shape, max_iter, dtype=torch.int32, device=cr.device)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    for n in range(max_iter):
        zr, zi = mb._zsq_add_c(zr, zi, cr, ci)
        hit = (zr * zr + zi * zi > 4.0) & ~esc
        dwell.masked_fill_(hit, n)
        esc = esc | hit
        old = esc & ~hit
        zr = torch.where(old, 0.0, zr)
        zi = torch.where(old, 0.0, zi)
    return dwell


def _before_green_stage(zr, zi, cr, ci, k0, iters, r2, dtype_max_iter):
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    kk = torch.full(cr.shape, dtype_max_iter, dtype=torch.int32, device=cr.device)
    lzr = torch.zeros_like(cr)
    lzi = torch.zeros_like(ci)
    for i in range(iters):
        zr, zi = mb._zsq_add_c(zr, zi, cr, ci)
        hit = ~esc & (zr * zr + zi * zi > r2)
        kk.masked_fill_(hit, k0 + i + 1)
        lzr = torch.where(hit, zr, lzr)
        lzi = torch.where(hit, zi, lzi)
        esc = esc | hit
        zr = torch.where(esc, 0.0, zr)
        zi = torch.where(esc, 0.0, zi)
    scale = torch.exp2(-kk.to(cr.dtype))
    logr = 0.5 * torch.log(torch.clamp(lzr * lzr + lzi * lzi, min=1e-300))
    gg = logr * scale
    gg = torch.where(torch.isfinite(gg) & (gg >= 0.0), gg, 0.0)
    g = torch.where(esc, gg, 0.0)
    lpr = torch.where(esc, logr * scale, 0.0)
    lpi = torch.where(esc, torch.atan2(lzi, lzr) * scale, 0.0)
    return zr, zi, esc, g, kk, lpr, lpi


def _before_de_field_tci(cr, ci, max_iter, escape_r=250.0, eps=1e-12):
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    dzr = torch.ones_like(cr)
    dzi = torch.zeros_like(ci)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    lr = torch.zeros_like(cr)
    li = torch.zeros_like(ci)
    for _ in range(max_iter):
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = mb._zsq_add_c(zr, zi, cr, ci)
        hit = (torch.sqrt(zr * zr + zi * zi) > escape_r) & ~esc
        lr = torch.where(hit, zr, lr)
        li = torch.where(hit, zi, li)
        esc = esc | hit
    az = torch.hypot(lr, li)
    pr, pi = 2.0 * lr * dzr - 2.0 * li * dzi, 2.0 * lr * dzi + 2.0 * li * dzr
    den = torch.maximum(torch.hypot(pr, pi), pr.new_tensor(eps))
    d = torch.where(esc, torch.log(torch.maximum(az, az.new_tensor(1e-300))) * az / den,
                    torch.zeros_like(az))
    d = torch.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)
    return esc, d, lr, li


def _before_latched(cr, ci, max_iter, radius, by_hypot):
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    dzr = torch.ones_like(cr)
    dzi = torch.zeros_like(ci)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    lzr, lzi = torch.zeros_like(cr), torch.zeros_like(ci)
    ldr, ldi = torch.ones_like(cr), torch.zeros_like(ci)
    for _ in range(max_iter):
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
        zr, zi = mb._zsq_add_c(zr, zi, cr, ci)
        r = torch.hypot(zr, zi) if by_hypot else torch.sqrt(zr * zr + zi * zi)
        hit = ~esc & (r > radius)
        lzr = torch.where(hit, zr, lzr)
        lzi = torch.where(hit, zi, lzi)
        ldr = torch.where(hit, dzr, ldr)
        ldi = torch.where(hit, dzi, ldi)
        esc = esc | hit
        zr = torch.where(esc, 0.0, zr)
        zi = torch.where(esc, 0.0, zi)
        dzr = torch.where(esc, 1.0, dzr)
        dzi = torch.where(esc, 0.0, dzi)
    return esc, lzr, lzi, ldr, ldi


def _before_de_field_std(cr, ci, max_iter, escape_r=4.0, eps=1e-14):
    esc, lzr, lzi, ldr, ldi = _before_latched(cr, ci, max_iter, escape_r, False)
    az = torch.hypot(lzr, lzi)
    pr, pi = 2.0 * (lzr * ldr - lzi * ldi), 2.0 * (lzr * ldi + lzi * ldr)
    num = torch.log(torch.maximum(az, az.new_tensor(1.0))) * az
    den = torch.maximum(torch.hypot(pr, pi), pr.new_tensor(eps))
    dist = torch.where(esc, torch.nan_to_num(num / den, nan=0.0, posinf=0.0, neginf=0.0),
                       torch.zeros_like(az))
    return esc, dist, (lzr, lzi), (ldr, ldi)


def _before_de_field_stage1(cr, ci, max_iter, bailout=1e6):
    esc, lzr, lzi, ldr, ldi = _before_latched(cr, ci, max_iter, bailout, True)
    az = torch.hypot(lzr, lzi)
    adz = torch.maximum(torch.hypot(ldr, ldi), ldr.new_tensor(1e-16))
    d = torch.where(esc, az * torch.log(torch.maximum(az, az.new_tensor(1e-300))) / adz,
                    torch.zeros_like(az))
    return esc, d


def _before_escape_potential_grid(cr, ci, max_iter, escape_r, normalization):
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    g = torch.zeros_like(cr)
    lzr, lzi = torch.zeros_like(cr), torch.zeros_like(ci)
    r2 = escape_r * escape_r
    with np.errstate(over="ignore"):
        pow2 = np.ldexp(1.0, np.arange(max_iter + 1))
    for i in range(max_iter):
        zr, zi = mb._zsq_add_c(zr, zi, cr, ci)
        a2 = zr * zr + zi * zi
        hit = ~esc & (a2 > r2)
        logr = 0.5 * torch.log(torch.clamp(a2, min=1e-300))
        if normalization == "two_pow_n":
            val = logr / float(pow2[i + 1])
        elif normalization == "k_plus_1":
            val = logr / float(i + 1)
        else:
            val = logr / float(pow2[i])
        g = torch.where(hit, val, g)
        lzr = torch.where(hit | esc, lzr, zr)
        lzi = torch.where(hit | esc, lzi, zi)
        lzr = torch.where(hit, zr, lzr)
        lzi = torch.where(hit, zi, lzi)
        esc = esc | hit
        zr = torch.where(esc, 0.0, zr)
        zi = torch.where(esc, 0.0, zi)
    if normalization == "two_pow_k_break":
        a2 = lzr * lzr + lzi * lzi
        tail = 0.5 * torch.log(torch.clamp(a2, min=1e-300)) / float(pow2[max_iter - 1])
        g = torch.where(esc, g, torch.where(a2 > 0.0, tail, torch.zeros_like(g)))
    return g


def _same(a, b):
    """Bitwise equal, NaN equal to NaN, nested tuples allowed."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _points(dtype, ny, nx, seed):
    """A grid on the tracker's domain, with points that escape late (c near
    the cusp 1/4 and the tip -2, from a numpy seed) on its first row: they
    leave after hundreds of steps, past 2^127's f32 range."""
    cr, ci = mb.complex_grid(DOM, nx, ny, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(seed)
    m = min(nx, 8)
    cr[0, :m] = torch.as_tensor(np.where(np.arange(m) % 2, 0.25, -2.0)
                                + np.where(np.arange(m) % 2, 1, -1)
                                * rng.uniform(1e-6, 1e-4, m))
    ci[0, :m] = 0.0
    return cr.to(dtype), ci.to(dtype)


LOOP_SHAPES = [(23, 31), (1, 5)]
LOOP_ITERS = [0, 1, 7, 600]


def _split_and_before(name, cr, ci, it):
    if name == "dwell":
        return mb.dwell_grid(cr, ci, it), _before_dwell_grid(cr, ci, it)
    if name == "de_tci":
        return mb.de_field_tci(cr, ci, it), _before_de_field_tci(cr, ci, it)
    if name == "de_std":
        return mb.de_field_std(cr, ci, it), _before_de_field_std(cr, ci, it)
    if name == "de_stage1":
        return mb.de_field_stage1(cr, ci, it), _before_de_field_stage1(cr, ci, it)
    if name == "green":
        z0 = (torch.zeros_like(cr), torch.full_like(ci, 0.125))
        return (mb._green_stage(*z0, cr, ci, 3, it, 4.0, 9999),
                _before_green_stage(*z0, cr, ci, 3, it, 4.0, 9999))
    norm = name.split(":")[1]
    return (mb.escape_potential_grid(cr, ci, it, 10.0, norm),
            _before_escape_potential_grid(cr, ci, it, 10.0, norm))


LOOPS = ["dwell", "de_tci", "de_std", "de_stage1", "green",
         *(f"potential:{n}" for n in mb.POTENTIAL_NORMALIZATIONS)]


@pytest.mark.parametrize("name", LOOPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_loop_is_the_function_before_the_split(name, dtype):
    """Loop state plus shared epilogue, on the CPU, bitwise the function as
    it stood before the split, at max_iter 0, 1, 7 and 600 on a grid with
    late escapers and on a single row; the *_torch twins are the same."""
    twins = {"dwell": mb.dwell_grid_torch, "de_tci": mb.de_field_tci_torch,
             "de_std": mb.de_field_std_torch, "de_stage1": mb.de_field_stage1_torch}
    for (ny, nx), it in [(s, i) for s in LOOP_SHAPES for i in LOOP_ITERS]:
        cr, ci = _points(dtype, ny, nx, seed=ny)
        got, want = _split_and_before(name, cr, ci, it)
        assert _same(got, want), (name, dtype, ny, nx, it)
        if name in twins:
            assert _same(twins[name](cr, ci, it), want)


def test_green_stage_twin_and_potential_twin():
    cr, ci = _points(torch.float64, 9, 13, seed=4)
    z0 = (torch.zeros_like(cr), torch.zeros_like(ci))
    assert _same(mb._green_stage_torch(*z0, cr, ci, 0, 300, 4.0, 300),
                 _before_green_stage(*z0, cr, ci, 0, 300, 4.0, 300))
    for norm in mb.POTENTIAL_NORMALIZATIONS:
        assert _same(mb.escape_potential_grid_torch(cr, ci, 300, 4.0, norm),
                     _before_escape_potential_grid(cr, ci, 300, 4.0, norm))


@pytest.fixture(scope="module")
def grid64():
    """test_torch_fields.py's f64 grid. cmtci's XLA loops contract FMAs in
    the f64 orbit (ROADMAP Queue 3) and the chaotic orbit amplifies the ulps
    with the steps, so each loop is held at the steps and thresholds the
    other test_torch_* files hold it at."""
    cr, ci = mb.complex_grid((-2.1, 0.9, -1.5, 1.5), 90, 70, device="cpu")
    return cr, ci


def test_dwell_against_cmtci(grid64):
    cr, ci = grid64
    got = mb.dwell_grid(cr, ci, 100).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_mb.dwell_grid(cr.numpy(), ci.numpy(),
                                                                    max_iter=100)))


def test_de_tci_against_cmtci(grid64):
    cr, ci = grid64
    esc, d, _, _ = mb.de_field_tci(cr, ci, 120)
    r_esc, r_d, _, _ = ref_mb.de_field_tci(cr.numpy(), ci.numpy(), max_iter=120)
    np.testing.assert_array_equal(esc.numpy(), np.asarray(r_esc))
    np.testing.assert_allclose(d.numpy(), np.asarray(r_d), rtol=1e-12, atol=1e-15)


def test_de_std_against_cmtci(grid64):
    cr, ci = grid64
    esc, d, _, _ = mb.de_field_std(cr, ci, 80)
    r_esc, r_d, _, _ = ref_mb.de_field_std(cr.numpy(), ci.numpy(), max_iter=80)
    np.testing.assert_array_equal(esc.numpy(), np.asarray(r_esc))
    np.testing.assert_allclose(d.numpy(), np.asarray(r_d), rtol=1e-8, atol=0.0)


def test_de_stage1_against_cmtci():
    """stage1's own grid (120 x 80, 200 steps), as tests/test_torch_stage1.py."""
    from cmtci_torch.pipelines import stage1

    cfg = stage1.Stage1Config()
    xs = np.linspace(stage1.BAND_DOMAIN[0], stage1.BAND_DOMAIN[1], cfg.nx)
    ys = np.linspace(stage1.BAND_DOMAIN[2], stage1.BAND_DOMAIN[3], cfg.ny)
    cr, ci = np.meshgrid(xs, ys)
    esc, d = mb.de_field_stage1(torch.as_tensor(cr), torch.as_tensor(ci), 200)
    r_esc, r_d = ref_mb.de_field_stage1(cr, ci, max_iter=200, bailout=1e6)
    np.testing.assert_array_equal(esc.numpy(), np.asarray(r_esc))
    np.testing.assert_allclose(d.numpy(), np.asarray(r_d), rtol=1e-8, atol=0.0)


def test_green_against_cmtci():
    """tests/test_torch_stage1.py's points and tolerances."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, size=(400,)) + 1j * rng.uniform(-2, 2, size=(400,))
    g, k, _, _ = mb.green_potential(torch.as_tensor(pts.real), torch.as_tensor(pts.imag),
                                    max_iter=2000)
    ref = ref_mb.green_potential(pts.real, pts.imag, max_iter=2000)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-15)
    np.testing.assert_array_equal(k.numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("norm,escape_r", [("two_pow_n", 4.0), ("two_pow_k_break", 10.0),
                                           ("k_plus_1", 2.0)])
def test_potential_against_cmtci(grid64, norm, escape_r):
    """test_torch_fields.py's steps and radii."""
    cr, ci = grid64
    g = mb.escape_potential_grid(cr, ci, 60, escape_r, norm).numpy()
    ref = np.asarray(ref_mb.escape_potential_grid(cr.numpy(), ci.numpy(), max_iter=60,
                                                  escape_r=escape_r, normalization=norm))
    np.testing.assert_array_equal(g == 0, ref == 0)
    np.testing.assert_allclose(g, ref, rtol=1e-8, atol=0.0)


# ---------------------------------------------------------------------------
# (c) the CPU runs the twins and launches nothing; the card's paths raise
# ---------------------------------------------------------------------------


def test_cpu_tensors_launch_nothing():
    _launch.reset_launches()
    companion.inverse_cloud_padded(list(range(2, 30)), device="cpu")
    a, deg = companion.poly_coeff_batch([5, 9], device="cpu")
    companion.aberth_roots(a, deg, family="lucas_all_ones")
    cr, ci = mb.complex_grid(DOM, 16, 12, device="cpu")
    mb.dwell_grid(cr, ci, 50)
    mb.de_field_tci(cr, ci, 50)
    mb.de_field_std(cr, ci, 50)
    mb.de_field_stage1(cr, ci, 50)
    mb.green_potential(cr, ci, 50)
    mb.escape_potential_grid(cr, ci, 50)
    cost = torch.rand((7, 5), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sinkhorn.sinkhorn_log(cost, 40, 0.1),
                       sinkhorn.sinkhorn_log_torch(cost, 40, 0.1))
    assert all(_launch.launches[e] == 0 for e in ("aberth", *ORBIT_ENTRIES, "sinkhorn"))
    assert sum(_launch.launches.values()) == 0
    assert _launch.launches["sinkhorn"] == 0 and not hasattr(sinkhorn, "_GRAPHS")


def test_card_paths_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: companion.inverse_cloud_padded([5, 9], device="cuda"),
                 lambda: companion.eigvals_one_launch([5, 9], device="cuda"),
                 lambda: mb.complex_grid(DOM, 8, 8, device="cuda"),
                 lambda: sinkhorn.sinkhorn_match(np.ones((3, 2)), np.ones((3, 2)),
                                                 device="cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_other_devices_are_refused():
    """Neither the twin nor a fallback runs on a device that is neither the
    CPU nor a card."""
    meta = torch.empty((4, 4), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mb.dwell_grid(meta, meta, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        mb._green_stage(meta, meta, meta, meta, 0, 5, 4.0, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        companion.aberth_roots(meta, torch.empty(4, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        sinkhorn.sinkhorn_log(meta, 5, 0.1)
