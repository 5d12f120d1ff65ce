"""cmtci_torch.maps.riemann (the boundary-integral Riemann map) against
cmtci.maps.riemann, live on the CPU.

The fit of tests/test_maps.py:242 (export_lucas_boundary at n_max 40, 300
points, ordered polygon, n_bdy 200) and 500 interior points: the f64
evaluations within 1e-9 relative of the reference, the f32 path within the
reference's budget against its f64 path, the qr32 fit within
tests/test_maps.py:225-239's thresholds of the reference's lstsq fit, and the
lstsq and normal fits equal to the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtci.geometry.polygon import Polygon as RefPolygon
from cmtci.geometry.polygon import sample_interior_points
from cmtci.geometry.resample import enforce_ccw
from cmtci.maps import riemann as ref
from cmtci.pipelines.lucas_boundary import LucasBoundaryConfig, export_lucas_boundary
from cmtci_torch.geometry.polygon import Polygon, slightly_inside
from cmtci_torch.maps import riemann


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
def case():
    """(reference polygon, port polygon, 500 interior points), as
    tests/test_maps.py:242 builds them."""
    pts = enforce_ccw(export_lucas_boundary(LucasBoundaryConfig(n_max=40, n_boundary=300)))
    rpoly = RefPolygon(pts)
    z_int, _ = sample_interior_points(rpoly, 500, 0, 200000)
    return rpoly, Polygon(pts), z_int


@pytest.fixture(scope="module")
def fits(case):
    rpoly, poly, _ = case
    return (ref.fit_riemann_map(rpoly, n_bdy=200),
            riemann.fit_riemann_map(poly, n_bdy=200, device="cpu"))


def rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.maximum(np.abs(np.asarray(b)), 1e-300)))


@pytest.mark.parametrize("solver", ["lstsq", "normal"])
def test_host_fits_equal_the_reference(case, solver):
    rpoly, poly, _ = case
    want = ref.fit_riemann_map(rpoly, n_bdy=200, solver=solver)
    got = riemann.fit_riemann_map(poly, n_bdy=200, solver=solver, device="cpu")
    np.testing.assert_array_equal(got.bdy_z, want.bdy_z)
    np.testing.assert_array_equal(got.ds, want.ds)
    assert np.max(np.abs(got.sigma - want.sigma)) <= 1e-12
    assert abs(got.c - want.c) <= 1e-12 and abs(got.g_shift - want.g_shift) <= 1e-12
    assert got.a == want.a


@pytest.mark.parametrize("method", ["g_real", "phi_raw", "f", "phi"])
def test_f64_evaluations_match_the_reference(case, fits, method):
    _, _, z = case
    rm, tm = fits
    want = getattr(rm, method)(z)
    got = getattr(tm, method)(z)
    assert got.dtype == want.dtype
    assert rel(got, want) <= 1e-9


def test_eval_g_phi_matches_the_reference(case, fits):
    _, _, z = case
    rm, tm = fits
    z_g = np.concatenate([z, slightly_inside(rm.bdy_z, rm.a, 1e-3)])
    g_want, im_want = rm.eval_g_phi(z_g, z)
    g_got, im_got = tm.eval_g_phi(z_g, z)
    assert rel(g_got, g_want) <= 1e-9 and rel(im_got, im_want) <= 1e-9
    np.testing.assert_allclose(tm.boundary_residual(), rm.boundary_residual(),
                               rtol=0, atol=1e-12)


def test_f32_path_within_the_reference_budget(case, fits):
    """tests/test_maps.py:242: the f32 f within 1e-3 of the reference's f64 f
    (phase and modulus, 99th percentile)."""
    _, _, z = case
    rm, tm = fits
    f64v = rm.f(z)
    f32v = tm.f(z, dtype=torch.float32)
    dphase = np.angle(f32v / np.where(f64v == 0, 1.0, f64v))
    assert np.quantile(np.abs(dphase), 0.99) < 1e-3
    assert np.quantile(np.abs(np.abs(f32v) - np.abs(f64v)), 0.99) < 1e-3
    # the reference's f32 g budget (VALIDATION.md: abs err <= 1e-4)
    assert np.max(np.abs(tm.g_real(z, dtype=torch.float32) - rm.g_real(z))) <= 1e-4
    # and the port's f32 stays near the reference's own f32 realization
    ref32 = rm.f(z, dtype=jnp.float32)
    assert np.quantile(np.abs(np.angle(f32v / ref32)), 0.99) < 1e-3


def test_qr32_fit_meets_the_reference_thresholds(case, fits):
    """tests/test_maps.py:225-239 against the reference's lstsq fit."""
    rpoly, poly, _ = case
    rm_ref = fits[0]
    rm_qr = riemann.fit_riemann_map(poly, n_bdy=200, solver="qr32", device="cpu")
    assert np.abs(rm_qr.sigma - rm_ref.sigma).max() < 1e-5
    assert abs(rm_qr.c - rm_ref.c) < 1e-8
    assert abs(rm_qr.g_shift - rm_ref.g_shift) < 1e-8
    z_in = slightly_inside(rm_qr.bdy_z, rm_qr.a, 1e-3)
    assert abs(np.median(np.abs(rm_qr.f(z_in))) - 1.0) < 1e-3


def test_qr32_on_the_reference_polygon_of_test_maps():
    """The wobbled disk of tests/test_maps.py:228 at n_bdy 400."""
    t = np.linspace(0, 2 * np.pi, 500, endpoint=False)
    xy = np.column_stack([(1 + 0.1 * np.cos(3 * t)) * np.cos(t),
                          (1 + 0.1 * np.cos(3 * t)) * np.sin(t)])
    rm_ref = ref.fit_riemann_map(RefPolygon(xy), n_bdy=400, solver="lstsq")
    rm_qr = riemann.fit_riemann_map(Polygon(xy), n_bdy=400, solver="qr32", device="cpu")
    assert np.abs(rm_qr.sigma - rm_ref.sigma).max() < 1e-5
    assert abs(rm_qr.c - rm_ref.c) < 1e-8
    assert abs(rm_qr.g_shift - rm_ref.g_shift) < 1e-8


def test_disk_identity_map():
    """tests/test_maps.py's analytic disk: g = -log|z|, |f| = |z|."""
    t = np.linspace(0, 2 * np.pi, 600, endpoint=False)
    poly = Polygon(np.column_stack([np.cos(t), np.sin(t)]))
    rm = riemann.fit_riemann_map(poly, n_bdy=400, device="cpu")
    assert abs(rm.a) < 1e-8
    rr = np.array([0.3, 0.5, 0.7])
    np.testing.assert_allclose(rm.g_real(rr * np.exp(1.1j)), -np.log(rr), atol=5e-3)
    z_test = 0.6 * np.exp(1j * np.linspace(0, 2 * np.pi, 50, endpoint=False))
    np.testing.assert_allclose(np.abs(rm.f(z_test)), 0.6, atol=5e-3)
    np.testing.assert_allclose(rm.phi_raw(z_test).imag, 0.0, atol=1e-6)


def test_block_size_moves_values_by_rounding_only(fits, case):
    """The reductions run along the boundary axis: another block size moves
    a value only by the matvec's rounding."""
    _, _, z = case
    tm = fits[1]
    args = tm._args(torch.float64)
    zr = torch.as_tensor(z.real)
    zi = torch.as_tensor(z.imag)
    gx, gw = torch.as_tensor(tm._gx), torch.as_tensor(tm._gw)
    a = riemann._phi_raw_blocked(zr, zi, *args, tm.c, gx, gw, chunk=7)
    b = riemann._phi_raw_blocked(zr, zi, *args, tm.c, gx, gw, chunk=500)
    assert rel(a[0], b[0]) <= 1e-13 and rel(a[1], b[1]) <= 1e-13
    g1 = riemann._g_real_blocked(zr, zi, *args, tm.c, chunk=13)
    g2 = riemann._g_real_blocked(zr, zi, *args, tm.c, chunk=500)
    assert float(torch.max(torch.abs(g1 - g2))) <= 1e-13 * float(torch.max(torch.abs(g2)))


def test_unknown_solver_and_dtype_raise(case):
    _, poly, _ = case
    with pytest.raises(ValueError, match="unknown solver"):
        riemann.fit_riemann_map(poly, n_bdy=50, solver="svd", device="cpu")
    rm = riemann.fit_riemann_map(poly, n_bdy=50, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        rm.g_real([0.1j], dtype=torch.float16)


def test_cuda_without_card_raises(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, poly, _ = case
    with pytest.raises(RuntimeError, match="cuda"):
        riemann.fit_riemann_map(poly, n_bdy=50)
