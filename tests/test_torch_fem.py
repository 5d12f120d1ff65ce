"""cmtci_torch's mesh, interp, cardioid, fem and qc modules against cmtci's,
live on the CPU, on the reference tests' own meshes: the disk of
tests/test_maps.py and the wobbled ellipse ("blob") of
tests/test_fem_device.py:22-28.

The numpy/scipy code is a copy, so its outputs are equal to the reference's;
the torch CG (f64, CSR matvec) is held to SuperLU at atol 1e-8, the
reference's threshold for its jax CG (tests/test_maps.py:55).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cmtci.geometry import cardioid as ref_cardioid
from cmtci.geometry import interp as ref_interp
from cmtci.geometry import mesh as ref_mesh
from cmtci.geometry.polygon import Polygon as RefPolygon
from cmtci.maps import fem as ref_fem
from cmtci.maps import qc as ref_qc
from cmtci_torch.geometry import cardioid, interp, mesh
from cmtci_torch.geometry.polygon import Polygon
from cmtci_torch.maps import fem, qc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(name):
    t = np.linspace(0, 2 * np.pi, 400 if name == "disk" else 500, endpoint=False)
    if name == "disk":
        return np.column_stack([np.cos(t), np.sin(t)]), 0.12
    r = 1.0 + 0.18 * np.cos(3 * t) + 0.07 * np.sin(5 * t)
    return np.column_stack([1.3 * r * np.cos(t), r * np.sin(t)]), 0.14


@pytest.fixture(scope="module", params=["disk", "blob"])
def meshes(request):
    """(port polygon, reference polygon, points, triangles) of the port's
    mesher; the reference's mesh of the same polygon beside it."""
    xy, h = _ring(request.param)
    poly, rpoly = Polygon(xy), RefPolygon(xy)
    p, t = mesh.polygon_to_mesh(poly, h=h, boundary_h=0.8 * h, seed=0)
    rp, rt = ref_mesh.polygon_to_mesh(rpoly, h=h, boundary_h=0.8 * h, seed=0)
    return poly, rpoly, p, t, rp, rt


def test_mesher_equals_the_reference(meshes):
    _, _, p, t, rp, rt = meshes
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_array_equal(mesh.boundary_vertices(t), ref_mesh.boundary_vertices(rt))
    np.testing.assert_array_equal(mesh.tri_centroids(p, t), ref_mesh.tri_centroids(rp, rt))
    assert mesh.UV_QHULL_OPTIONS == ref_mesh.UV_QHULL_OPTIONS


def test_mesher_drops_degenerate_caps_relatively():
    """A square's collinear boundary runs: the relative filter of
    VALIDATION.md:644-656 leaves the same triangles as the reference's."""
    sq = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    p, t = mesh.polygon_to_mesh(Polygon(sq), h=0.1, seed=3)
    rp, rt = ref_mesh.polygon_to_mesh(RefPolygon(sq), h=0.1, seed=3)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(t, rt)
    _, area = fem.p1_grads_areas(p, t)
    assert area.min() > 1e-9 * 0.01


def test_assembly_equals_the_reference(meshes):
    _, _, p, t, _, _ = meshes
    g, a = fem.p1_grads_areas(p, t)
    rg, ra = ref_fem.p1_grads_areas(p, t)
    np.testing.assert_array_equal(g, rg)
    np.testing.assert_array_equal(a, ra)
    k, rk = fem.assemble_stiffness(p, t), ref_fem.assemble_stiffness(p, t)
    assert (k != rk).nnz == 0


def test_dirichlet_and_conjugate_equal_the_reference(meshes):
    _, _, p, t, _, _ = meshes
    k = fem.assemble_stiffness(p, t)
    bnd = mesh.boundary_vertices(t)
    g = np.cos(3 * np.arctan2(p[bnd, 1], p[bnd, 0]))
    np.testing.assert_array_equal(fem.dirichlet_solve(k, bnd, g),
                                  ref_fem.dirichlet_solve(k, bnd, g))
    np.testing.assert_array_equal(fem.harmonic_conjugate(p, t, p[:, 0]),
                                  ref_fem.harmonic_conjugate(p, t, p[:, 0]))


@pytest.mark.parametrize("feedback", [True, False])
def test_theta_iteration_equals_the_reference(meshes, feedback):
    poly, rpoly, p, t, _, _ = meshes
    got = fem.theta_iteration(p, t, poly, iters=3, feedback=feedback)
    want = ref_fem.theta_iteration(p, t, rpoly, iters=3, feedback=feedback)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    bo, s, big_l = fem.boundary_order_by_arclength(p, t, poly)
    rbo, rs, rl = ref_fem.boundary_order_by_arclength(p, t, rpoly)
    np.testing.assert_array_equal(bo, rbo)
    np.testing.assert_array_equal(s, rs)
    assert big_l == rl


def test_theta_helpers_equal_the_reference():
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.uniform(0.0, 0.4, 61)) - 3.0
    for w in (1, 4, 7):
        np.testing.assert_array_equal(fem.moving_average_periodic(x, w, 2 * np.pi),
                                      ref_fem.moving_average_periodic(x, w, 2 * np.pi))
    th = np.angle(np.exp(1j * np.linspace(0, 4 * np.pi, 100)))
    for anchor in (0, 37):
        np.testing.assert_array_equal(fem.unwrap_theta(th, anchor),
                                      ref_fem.unwrap_theta(th, anchor))
    wb = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    for a, b in zip(fem.circle_normalize_boundary(wb), ref_fem.circle_normalize_boundary(wb)):
        np.testing.assert_array_equal(a, b)
    assert fem.optimal_rotation(wb, wb * 1j) == ref_fem.optimal_rotation(wb, wb * 1j)
    assert fem.optimal_rotation(wb, 0 * wb) == 1.0


def test_cg_matches_spsolve(meshes):
    """tests/test_maps.py:55 at the reference's threshold."""
    _, _, p, t, _, _ = meshes
    k = fem.assemble_stiffness(p, t)
    bnd = mesh.boundary_vertices(t)
    g = np.cos(3 * np.arctan2(p[bnd, 1], p[bnd, 0]))
    u1 = fem.dirichlet_solve(k, bnd, g, method="spsolve")
    u2 = fem.dirichlet_solve(k, bnd, g, method="cg", device="cpu")
    np.testing.assert_allclose(u2, u1, atol=1e-8)
    v1 = fem.harmonic_conjugate(p, t, p[:, 0])
    v2 = fem.harmonic_conjugate(p, t, p[:, 0], method="cg", device="cpu")
    np.testing.assert_allclose(v2, v1, atol=1e-8)


def test_cg_theta_iteration_matches_spsolve(meshes):
    poly, _, p, t, _, _ = meshes
    host = fem.theta_iteration(p, t, poly, iters=2)
    cg = fem.theta_iteration(p, t, poly, iters=2, method="cg", device="cpu")
    np.testing.assert_allclose(cg[0], host[0], atol=1e-8)
    np.testing.assert_allclose(cg[1], host[1], atol=1e-8)
    assert abs(cg[4] - host[4]) < 1e-8


@pytest.mark.parametrize("check_every", [1, 5, 64])
def test_cg_stops_as_the_reference_cg(check_every, monkeypatch):
    """Zero right-hand side: no step; a diagonal system: exact after one
    step, and the steps after it leave x as it is; maxiter bounds the steps
    whatever the check interval."""
    monkeypatch.setattr(fem, "CG_CHECK_EVERY", check_every)
    a = sp.csr_matrix(np.diag([2.0, 4.0, 8.0]))
    np.testing.assert_array_equal(fem._cg_solve(a, np.zeros(3), device="cpu"), np.zeros(3))
    x = fem._cg_solve(a, np.array([2.0, 4.0, 8.0]), device="cpu")
    np.testing.assert_array_equal(x, np.ones(3))
    lap = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(200, 200)).tocsr()
    b = np.ones(200)
    x3 = fem._cg_solve(lap, b, maxiter=3, device="cpu")
    r3 = np.linalg.norm(b - lap @ x3)
    x = fem._cg_solve(lap, b, device="cpu")
    assert r3 > 1e-3 * np.linalg.norm(b)
    # the stop reads the recurrence residual; the true one drifts from it
    assert np.linalg.norm(b - lap @ x) <= 1e-11 * np.linalg.norm(b)


def test_interp_equals_the_reference(meshes):
    _, _, p, t, _, _ = meshes
    rng = np.random.default_rng(2)
    uv_nodes = p + 0.01 * rng.standard_normal(p.shape)
    z_nodes = np.exp(1j * p[:, 0]) * (1 + p[:, 1])
    q = rng.uniform(-1.2, 1.2, (300, 2))
    got = interp.invert_uv_to_z(q, uv_nodes, z_nodes)
    want = ref_interp.invert_uv_to_z(q, uv_nodes, z_nodes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cardioid_equals_the_reference():
    w = 0.9 * np.exp(1j * np.linspace(-3, 3, 50)) * np.linspace(0.1, 1, 50)
    np.testing.assert_array_equal(cardioid.disk_to_cardioid(w), ref_cardioid.disk_to_cardioid(w))
    z = cardioid.disk_to_cardioid(w)
    np.testing.assert_array_equal(cardioid.cardioid_to_disk(z), ref_cardioid.cardioid_to_disk(z))
    np.testing.assert_allclose(cardioid.cardioid_to_disk(z), w, atol=1e-14)
    for n, endpoint in ((401, True), (4000, False)):
        np.testing.assert_array_equal(cardioid.cardioid_polygon(n, endpoint).xy,
                                      ref_cardioid.cardioid_polygon(n, endpoint).xy)


@pytest.mark.parametrize("phi_name", ["identity", "affine", "smooth", "anti"])
def test_qc_equals_the_reference(meshes, phi_name):
    _, _, p, t, _, _ = meshes
    z = p[:, 0] + 1j * p[:, 1]
    phi = {"identity": z, "affine": z + 0.5 * np.conj(z), "smooth": np.exp(0.4 * z) + 0.1 * z * z,
           "anti": np.conj(z)}[phi_name]
    valid = np.ones(len(p), bool)
    valid[::17] = False
    for name in ("beltrami_mu_k", "beltrami_full", "angle_distortion"):
        got = getattr(qc, name)(p, t, phi, valid)
        want = getattr(ref_qc, name)(p, t, phi, valid)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(qc.cr_defect_metrics(p, t, phi.real, phi.imag),
                    ref_qc.cr_defect_metrics(p, t, phi.real, phi.imag)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(qc.triangle_gradients(p, t, phi.real),
                                  ref_qc.triangle_gradients(p, t, phi.real))


def test_binned_median_equals_the_reference():
    x = np.array([0.1, 0.2, 0.6, 0.7, 0.9])
    y = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    edges = np.array([0.0, 0.5, 1.0, 1.5])
    got, want = qc.binned_median(x, y, edges), ref_qc.binned_median(x, y, edges)
    np.testing.assert_array_equal(np.array(got), np.array(want))  # NaN of an empty bin
    assert got[0] == (0.0, 0.5, 1.5, 2) and got[2][3] == 0


def test_cg_on_cuda_without_card_raises(meshes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, p, t, _, _ = meshes
    k = fem.assemble_stiffness(p, t)
    bnd = mesh.boundary_vertices(t)
    with pytest.raises(RuntimeError, match="cuda"):
        fem.dirichlet_solve(k, bnd, np.zeros(len(bnd)), method="cg")
