"""cmtci_torch's "de" and "green" fields (K4, K5), the Mariani-Silver dwell
(K6) and the f64 counterparts against cmtci (the JAX reference) and the
numpy oracles, on the CPU.

The kernels themselves (csrc/de_std.cu, csrc/green_grid.cu, csrc/dwell_ms.cu)
run only on the card, where chip_smoke.py holds each bitwise to its twin;
here the twins are held to the Pallas kernels in interpret mode, at the
sizes tests/test_pallas_kernel.py uses, to an IEEE re-execution of the
Pallas bodies in numpy, and to the f64 contracts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtci.kernels import mandelbrot as ref_mb
from cmtci.kernels.mandelbrot_pallas import dwell_field_ms as ref_dwell_field_ms
from cmtci.kernels.mandelbrot_pallas import mandelbrot_field_pallas
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels import mandelbrot_cuda as mc
from oracles import (de_std_np, escape_potential_2pn_np, escape_potential_kbreak_np,
                     escape_potential_kp1_np)

DOM = (-2.1, 0.9, -1.5, 1.5)
NY, NX = 64, 256
ITERS = {"de": 80, "green": 60}
#: the reference's f64 contracts (tests/test_pallas_kernel.py:21-35)
CONTRACT = {"de": (dict(rtol=1e-3, atol=1e-9), 0.98),
            "green": (dict(rtol=1e-4, atol=1e-7), 0.99)}
SHAPES = [(NY, NX), (77, 301)]  # the reference's size, and no tile multiple


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    return {kind: mc.mandelbrot_field(DOM, NX, NY, max_iter=ITERS[kind], kind=kind,
                                      device="cpu").numpy()
            for kind in ITERS}


def _ieee_f32_field(kind, nx, ny, max_iter, escape_r=4.0):
    """The Pallas bodies of _de_kernel / _green_kernel re-executed op by op in
    numpy f32 (numpy's real ufuncs round each op; no FMA), with the grid of
    _tile_coords and exact powers of two. The f32 log and sqrt are torch's:
    on the CPU torch's differ from numpy's by an ulp on about 5% (log) and
    0.7% (sqrt) of inputs, and the point here is the op order, not the
    libraries (on the card both sides call CUDA's logf and IEEE sqrtf)."""
    f32 = np.float32

    def log(a):
        return torch.log(torch.from_numpy(np.ascontiguousarray(a, dtype=f32))).numpy()

    def sqrt(a):
        return torch.sqrt(torch.from_numpy(np.ascontiguousarray(a, dtype=f32))).numpy()

    p = mc._params(DOM, nx, ny)
    cr = (p[0] + np.arange(nx, dtype=f32) * p[2])[None, :].repeat(ny, 0)
    ci = (p[1] + np.arange(ny, dtype=f32) * p[3])[:, None].repeat(nx, 1)
    q = (cr - f32(0.25)) * (cr - f32(0.25)) + ci * ci
    interior = ((q * (q + (cr - f32(0.25))) <= f32(0.25) * ci * ci - f32(1e-5))
                | ((cr + f32(1.0)) * (cr + f32(1.0)) + ci * ci <= f32(0.0625 - 1e-5)))
    r2 = f32(escape_r * escape_r)
    zr, zi = np.zeros_like(cr), np.zeros_like(cr)
    dzr, dzi = np.ones_like(cr), np.zeros_like(cr)
    lzr, lzi, ldr, ldi = np.zeros_like(cr), np.zeros_like(cr), np.ones_like(cr), np.zeros_like(cr)
    esc = interior.copy()
    g = np.zeros_like(cr)
    with np.errstate(all="ignore"):
        for n in range(max_iter):
            tr, ti = f32(2.0) * zr, f32(2.0) * zi
            dzr, dzi = tr * dzr - ti * dzi + f32(1.0), tr * dzi + ti * dzr
            zr, zi = zr * zr - zi * zi + cr, f32(2.0) * zr * zi + ci
            a2 = zr * zr + zi * zi
            hit = (a2 > r2) & ~esc
            if kind == "green":
                val = (f32(0.5) * log(np.maximum(a2, f32(1e-30)))
                       * np.ldexp(f32(1.0), -(n + 1)))
                g = np.where(hit, np.maximum(val, f32(0.0)), g)
            lzr, lzi = np.where(hit, zr, lzr), np.where(hit, zi, lzi)
            ldr, ldi = np.where(hit, dzr, ldr), np.where(hit, dzi, ldi)
            esc = esc | hit
            zr, zi = np.where(esc, f32(0.0), zr), np.where(esc, f32(0.0), zi)
            dzr, dzi = np.where(esc, f32(1.0), dzr), np.where(esc, f32(0.0), dzi)
        if kind == "green":
            return g
        az = sqrt(lzr * lzr + lzi * lzi)
        pr = f32(2.0) * (lzr * ldr - lzi * ldi)
        pi = f32(2.0) * (lzr * ldi + lzi * ldr)
        num = log(np.maximum(az, f32(1.0))) * az
        den = np.maximum(sqrt(pr * pr + pi * pi), f32(1e-14))
        return np.where(esc, num / den, f32(0.0))


@pytest.mark.parametrize("kind", ["de", "green"])
def test_k4_k5_twins_match_pallas_interpret(twins, kind):
    """Against the interpreted Pallas kernel the escape sets agree on
    >= 99.9% of pixels and the values on >= 99% within the f64 contract's
    tolerance. Values are NOT within rtol 1e-6 on 99.5%: the interpreted
    kernel is not IEEE op by op. XLA contracts FMAs in the orbit, which the
    chaotic iteration amplifies, and for K5 also rounds jnp.exp2(-k)
    inexactly (checked below). The share within rtol 1e-6 is pinned at what
    the CPU shows (0.896 for K4, 0.911 for K5), so a drift of a few ulps
    against the reference kernel shows. The op order itself is pinned
    bitwise in test_k4_k5_twins_equal_ieee_pallas_body."""
    ref = np.asarray(mandelbrot_field_pallas(DOM, NX, NY, max_iter=ITERS[kind], kind=kind,
                                             escape_r=4.0, tile=(32, 256)))
    twin = twins[kind]
    assert twin.dtype == np.float32 and twin.shape == (NY, NX)
    assert ((twin != 0) == (ref != 0)).mean() >= 0.999
    tol, _ = CONTRACT[kind]
    assert np.isclose(twin, ref, **tol).mean() >= 0.99
    assert np.isclose(twin, ref, rtol=1e-6, atol=0.0).mean() >= 0.88
    with jax.enable_x64(False):
        e2 = np.asarray(jnp.exp2(-jnp.arange(1, 61, dtype=jnp.float32)))
    assert not np.array_equal(e2, np.ldexp(np.float32(1.0), -np.arange(1, 61)))


@pytest.mark.parametrize("kind", ["de", "green"])
def test_k4_k5_twins_equal_ieee_pallas_body(twins, kind):
    """The Pallas body run op by op in IEEE f32 gives the twin bit for bit:
    the same orbit, latches, scale and epilogue, at the reference test's
    size and on a grid that is no tile multiple."""
    np.testing.assert_array_equal(twins[kind], _ieee_f32_field(kind, NX, NY, ITERS[kind]))
    twin = mc.mandelbrot_field(DOM, 301, 77, max_iter=ITERS[kind], kind=kind, device="cpu")
    np.testing.assert_array_equal(twin.numpy(), _ieee_f32_field(kind, 301, 77, ITERS[kind]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["de", "green"])
def test_k4_k5_twins_hold_the_f64_contract(kind, shape):
    """K4 > 98% within rtol 1e-3 / atol 1e-9 of de_field_std, K5 > 99% within
    rtol 1e-4 / atol 1e-7 of escape_potential_grid(two_pow_n) — the
    reference's own contracts — against the port's f64 counterparts and,
    at the reference test's size, cmtci's."""
    ny, nx = shape
    mi = ITERS[kind]
    twin = mc.mandelbrot_field(DOM, nx, ny, max_iter=mi, kind=kind, device="cpu").numpy()
    cr, ci = mb.complex_grid(DOM, nx, ny, device="cpu")
    if kind == "de":
        f64 = mb.de_field_std(cr, ci, max_iter=mi, escape_r=4.0)[1].numpy()
    else:
        f64 = mb.escape_potential_grid(cr, ci, max_iter=mi, escape_r=4.0).numpy()
    tol, share = CONTRACT[kind]
    assert np.isclose(twin, f64, **tol).mean() > share
    if shape == (NY, NX):
        rcr, rci = (np.asarray(a) for a in ref_mb.complex_grid(DOM, nx, ny))
        if kind == "de":
            ref = np.asarray(ref_mb.de_field_std(rcr, rci, max_iter=mi, escape_r=4.0)[1])
        else:
            ref = np.asarray(ref_mb.escape_potential_grid(rcr, rci, max_iter=mi,
                                                          escape_r=4.0))
        assert np.isclose(twin, ref, **tol).mean() > share


def test_k4_interior_and_overflow_semantics():
    """An interior pixel gives d = 0 (num 0 over the 1e-14 floor); a pixel
    that never escapes gives 0; deep escapers of K5 give g = 0 in f32
    because 2^-k is 0 past k = 149, and the scale is exact before that."""
    d = mc.de_field_std_torch((-0.1, 0.1, -0.1, 0.1), 3, 3, 50, device="cpu")
    assert float(d.abs().max()) == 0.0
    assert mc._pow2_f32(1) == 0.5 and mc._pow2_f32(127) == 2.0 ** -127
    assert mc._pow2_f32(149) == 2.0 ** -149 and mc._pow2_f32(150) == 0.0
    assert all(float(np.float32(mc._pow2_f32(k))) == mc._pow2_f32(k) for k in range(1, 200))


# ---------------------------------------------------------------------------
# the f64 counterparts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid64():
    cr, ci = mb.complex_grid(DOM, 90, 70, device="cpu")
    return cr, ci, cr.numpy() + 1j * ci.numpy()


def test_f64_de_std_vs_oracle_and_reference(grid64):
    """Escape sets equal; d within rel 1e-8 of the numpy oracle and of cmtci.
    Not bitwise: numpy's vectorized complex multiply rounds a*b - c*d with
    fused multiply-adds on AVX-512 hosts (the oracle's dz and z), and XLA
    contracts FMAs in the reference (ROADMAP Queue 3); the chaotic orbit
    amplifies the ulps to about 1.4e-9 here. The port rounds each op."""
    cr, ci, c = grid64
    esc, d, _, _ = mb.de_field_std(cr, ci, max_iter=80)
    o_esc, o_d = de_std_np(c, max_iter=80)
    np.testing.assert_array_equal(esc.numpy(), o_esc)
    np.testing.assert_allclose(d.numpy(), o_d, rtol=1e-8, atol=0.0)
    r_esc, r_d, _, _ = ref_mb.de_field_std(cr.numpy(), ci.numpy(), max_iter=80)
    np.testing.assert_array_equal(esc.numpy(), np.asarray(r_esc))
    np.testing.assert_allclose(d.numpy(), np.asarray(r_d), rtol=1e-8, atol=0.0)


@pytest.mark.parametrize("norm,oracle,kw,rtol", [
    # vectorized numpy oracle: its complex multiply contracts FMAs (above)
    ("two_pow_n", escape_potential_2pn_np, dict(max_iter=60, escape_r=4.0), 1e-8),
    # scalar Python-complex oracles round each op like the port: the only
    # difference left is log(hypot) against 0.5*log(|z|^2), an ulp
    ("two_pow_k_break", escape_potential_kbreak_np, dict(max_iter=60, escape_r=10.0), 1e-15),
    ("k_plus_1", escape_potential_kp1_np, dict(max_iter=60, escape_r=2.0), 1e-15),
])
def test_f64_escape_potential_vs_oracle_and_reference(grid64, norm, oracle, kw, rtol):
    cr, ci, c = grid64
    g = mb.escape_potential_grid(cr, ci, normalization=norm, **kw).numpy()
    with np.errstate(all="ignore"):
        want = oracle(c, **kw)
    np.testing.assert_allclose(g, want, rtol=rtol, atol=0.0)
    # cmtci's XLA loop contracts FMAs in the f64 orbit (ROADMAP Queue 3)
    ref = np.asarray(ref_mb.escape_potential_grid(cr.numpy(), ci.numpy(), normalization=norm,
                                                  **kw))
    np.testing.assert_array_equal(g == 0, ref == 0)
    np.testing.assert_allclose(g, ref, rtol=1e-8, atol=0.0)


def test_escape_potential_unknown_normalization_raises(grid64):
    cr, ci, _ = grid64
    with pytest.raises(ValueError, match="normalization"):
        mb.escape_potential_grid(cr, ci, max_iter=5, normalization="two_pow_m")


# ---------------------------------------------------------------------------
# K6: the Mariani-Silver dwell
# ---------------------------------------------------------------------------


def _ref_fill_loop(ch, ny, nx, tile, stride):
    """The reference's fill decision, copied verbatim from
    cmtci/kernels/mandelbrot_pallas.py:870-884."""
    th, tw = tile
    cyn, cxn = ny // stride, nx // stride
    n_ty, n_tx = ny // th, nx // tw
    rs, cs = th // stride, tw // stride
    fill = np.full((n_ty, n_tx), -1.0, np.float32)
    for ti in range(n_ty):
        r0, r1 = ti * rs, (ti + 1) * rs
        if r0 == 0 or r1 + 1 > cyn:
            continue
        for tj in range(n_tx):
            c0, c1 = tj * cs, (tj + 1) * cs
            if c0 == 0 or c1 + 1 > cxn:
                continue
            w = ch[r0 - 1 : r1 + 1, c0 - 1 : c1 + 1]
            v = w.flat[0]
            if (w == v).all():
                fill[ti, tj] = v
    return fill


@pytest.mark.parametrize("stride,max_iter", [(2, 100), (4, 250)])
def test_k6_twin_equals_k2_and_reference(stride, max_iter):
    """dwell_field_ms on the CPU (coarse K2 twin, device fill flags, K6 twin)
    is bitwise the K2 twin at the reference test's configs, with some tiles
    filled; its stats are cmtci's; its output differs from cmtci's exactly
    where the K2 twin differs from the interpreted K2 (XLA's FMA
    contraction flips a few borderline dwells: >= 99.8% equal)."""
    out, stats = mc.dwell_field_ms(DOM, 512, 256, max_iter=max_iter, stride=stride,
                                   tile=(8, 128), device="cpu")
    plain = mc.dwell_field_torch(DOM, 512, 256, max_iter, device="cpu").numpy()
    np.testing.assert_array_equal(out.numpy(), plain)
    assert 0 < stats["filled"] < stats["tiles"]
    ref_out, ref_stats = ref_dwell_field_ms(DOM, 512, 256, max_iter=max_iter, stride=stride,
                                            tile=(8, 128))
    assert stats == ref_stats
    ref_plain = np.asarray(mandelbrot_field_pallas(DOM, 512, 256, max_iter=max_iter,
                                                   kind="dwell", tile=(8, 128)))
    np.testing.assert_array_equal(out.numpy() != np.asarray(ref_out), plain != ref_plain)
    assert (out.numpy() == np.asarray(ref_out)).mean() >= 0.998


@pytest.mark.parametrize("ny,nx,tile,stride", [
    (256, 512, (8, 128), 2), (256, 512, (8, 128), 4), (96, 96, (8, 8), 8),
    (64, 128, (16, 32), 4), (32, 512, (16, 256), 8)])
def test_fill_flags_equal_reference_loop(ny, nx, tile, stride):
    """The vectorized fill decision equals the reference's loop on planted
    coarse arrays: uniform blocks, a uniform field, noise, a halo broken by
    one sample, and grids too small for any interior tile."""
    rng = np.random.default_rng(ny + nx + stride)
    cyn, cxn = ny // stride, nx // stride
    planted = [
        np.full((cyn, cxn), 7.0, np.float32),
        rng.integers(0, 3, (cyn, cxn)).astype(np.float32),
        np.kron(rng.integers(0, 2, (cyn // 2 + 1, cxn // 2 + 1)),
                np.ones((2, 2)))[:cyn, :cxn].astype(np.float32),
    ]
    broken = np.full((cyn, cxn), 5.0, np.float32)
    broken[cyn // 2, cxn // 2] = 6.0
    planted.append(broken)
    for ch in planted:
        got = mc.fill_flags(torch.from_numpy(ch), tile[0] // stride, tile[1] // stride)
        np.testing.assert_array_equal(got.numpy(), _ref_fill_loop(ch, ny, nx, tile, stride))


def test_k6_coarse_params_are_the_references():
    """The coarse pass's spacing is f32(dx*stride) with the product in f64
    (mandelbrot_pallas.py:867), not f32(dx)*stride. For a power-of-two
    stride the two are equal; for stride 3 (a tile of 24 x 96) they can
    differ by an ulp, as dy does at ny = 288."""
    for nx, ny, stride in ((512, 256, 4), (576, 288, 3), (576, 288, 6)):
        p = mc._coarse_params(DOM, nx, ny, stride)
        dx = (DOM[1] - DOM[0]) / (nx - 1)
        dy = (DOM[3] - DOM[2]) / (ny - 1)
        assert p.dtype == np.float32
        assert p[2] == np.float32(dx * stride) and p[3] == np.float32(dy * stride)
    assert p[3] != np.float32((DOM[3] - DOM[2]) / 287) * np.float32(6)
    p3 = mc._coarse_params(DOM, 576, 288, 3)[3]
    assert p3 != np.float32((DOM[3] - DOM[2]) / 287) * np.float32(3)



def test_k6_guards_raise():
    with pytest.raises(ValueError, match="multiple"):
        mc.dwell_field_ms(DOM, 500, 256, stride=2, tile=(8, 128), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        mc.dwell_field_ms(DOM, 512, 256, stride=3, tile=(8, 128), device="cpu")
    with pytest.raises(ValueError, match="does not tile"):
        mc.dwell_fill(DOM, 512, 256, torch.zeros(3, 3), (8, 128), device="cpu")


# ---------------------------------------------------------------------------
# routing and launches
# ---------------------------------------------------------------------------


def test_mandelbrot_field_kinds_route_on_cpu(twins):
    np.testing.assert_array_equal(
        twins["de"], mc.de_field_std_torch(DOM, NX, NY, ITERS["de"], 4.0).numpy())
    np.testing.assert_array_equal(
        twins["green"], mc.green_field_torch(DOM, NX, NY, ITERS["green"], 4.0).numpy())
    np.testing.assert_array_equal(
        mc.mandelbrot_field(DOM, 40, 30, max_iter=50, device="cpu").numpy(),
        mc.dwell_field_torch(DOM, 40, 30, 50).numpy())
    mc.dwell_field_ms(DOM, 256, 64, max_iter=40, stride=2, tile=(8, 32), device="cpu")
    with pytest.raises(ValueError, match="unknown kind"):
        mc.mandelbrot_field(DOM, 16, 16, kind="tci", device="cpu")
    assert set(mc.FIELD_KINDS) == {"dwell", "de", "green"}
    assert all(v == 0 for v in mc.launches.values()), mc.launches


@pytest.mark.parametrize("call", [
    lambda: mc.mandelbrot_field(DOM, 32, 32, kind="de"),
    lambda: mc.mandelbrot_field(DOM, 32, 32, kind="green"),
    lambda: mc.dwell_field_ms(DOM, 256, 64, stride=2, tile=(8, 32)),
])
def test_field_kernels_cuda_without_card_raise(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        call()
