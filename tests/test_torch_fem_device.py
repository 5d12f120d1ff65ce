"""cmtci_torch.maps.fem_device (the θ-iteration's dense solves on a device)
against the host SuperLU path and cmtci.maps.fem_device, live on the CPU.

The reference's own cases (tests/test_fem_device.py): the blob mesh, the f64
device path within 1e-9 of SuperLU with and without feedback and within
1e-11 of cmtci's f64 device path, the f32 path with its final host solve,
the standalone SPD and Neumann solvers, and the sliver condensation. Beside
them, the pieces torch does not have: numpy's median of an even count (a
boundary with an even node count would move r with torch.median's lower
middle value) and numpy's unwrap with its ±π tie rule.
"""

import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve

from cmtci.maps import fem_device as ref_dev
from cmtci_torch.geometry.mesh import boundary_vertices, polygon_to_mesh
from cmtci_torch.geometry.polygon import Polygon
from cmtci_torch.maps import fem, fem_device
from cmtci_torch.maps.fem_device import (DeviceNeumannSolver, DeviceSPDSolver,
                                         dispatch_theta_iteration_device)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blob_mesh(h=0.14):
    t = np.linspace(0, 2 * np.pi, 500, endpoint=False)
    r = 1.0 + 0.18 * np.cos(3 * t) + 0.07 * np.sin(5 * t)
    poly = Polygon(np.column_stack([1.3 * r * np.cos(t), r * np.sin(t)]))
    pts, tris = polygon_to_mesh(poly, h=h, boundary_h=0.8 * h, seed=0)
    return poly, pts, tris


@pytest.fixture(scope="module")
def blob():
    return _blob_mesh()


def _device(pts, tris, poly, **kw):
    return dispatch_theta_iteration_device(pts, tris, poly, device="cpu", **kw).result()


def _close(got, want, atol):
    np.testing.assert_allclose(got[0], want[0], atol=atol)
    np.testing.assert_allclose(got[1], want[1], atol=atol)
    assert abs(got[2] - want[2]) < atol
    assert abs(got[3] - want[3]) < atol
    assert abs(got[4] - want[4]) < atol


@pytest.mark.parametrize("feedback,iters", [(True, 4), (False, 3)])
def test_f64_matches_host_spsolve(blob, feedback, iters):
    poly, pts, tris = blob
    host = fem.theta_iteration(pts, tris, poly, iters=iters, feedback=feedback)
    dev = fem.theta_iteration(pts, tris, poly, iters=iters, feedback=feedback,
                              method="device", device="cpu")
    _close(dev, host, 1e-9)


@pytest.mark.parametrize("feedback", [True, False])
def test_f64_matches_the_reference_device_path(blob, feedback):
    poly, pts, tris = blob
    want = ref_dev.dispatch_theta_iteration_device(
        pts, tris, poly, iters=4, feedback=feedback, dtype=np.float64).result()
    got = _device(pts, tris, poly, iters=4, feedback=feedback)
    _close(got, want, 1e-11)


def test_f32_final_host_solve(blob):
    """tests/test_fem_device.py:57-75: the f32 iteration with the final f64
    host solve at the converged θ."""
    poly, pts, tris = blob
    host = fem.theta_iteration(pts, tris, poly, iters=4)
    u, v, c, r, mis = _device(pts, tris, poly, iters=4, dtype=torch.float32,
                              final_host_solve=True)
    assert u.dtype == np.float64
    np.testing.assert_allclose(u, host[0], atol=5e-4)
    np.testing.assert_allclose(v, host[1], atol=5e-4)
    assert abs(mis - host[4]) < 5e-4
    bnd = boundary_vertices(tris)
    assert np.median(np.abs(np.abs(u[bnd] + 1j * v[bnd]) - 1.0)) < 0.05


def test_f32_defaults_to_the_final_host_solve(blob):
    poly, pts, tris = blob
    h32 = dispatch_theta_iteration_device(pts, tris, poly, iters=2, dtype=torch.float32,
                                          device="cpu")
    h64 = dispatch_theta_iteration_device(pts, tris, poly, iters=2, device="cpu")
    assert h32._ctx["final_host_solve"] and not h64._ctx["final_host_solve"]
    assert h64._out["uv"].dtype == torch.float64


def test_even_smooth_window_widens_like_host(blob):
    poly, pts, tris = blob
    host = fem.theta_iteration(pts, tris, poly, iters=2, smooth=6)
    dev = fem.theta_iteration(pts, tris, poly, iters=2, smooth=6, method="device",
                              device="cpu")
    np.testing.assert_allclose(dev[0], host[0], atol=1e-9)


def test_median_of_an_even_count_is_numpys():
    rng = np.random.default_rng(4)
    for n in (2, 7, 40, 41):
        x = rng.standard_normal(n)
        assert float(fem_device._median(torch.as_tensor(x))) == float(np.median(x))
    ub, vb = rng.standard_normal(40), rng.standard_normal(40)
    cu, cv, r = fem_device._circle_normalize(torch.as_tensor(ub), torch.as_tensor(vb))
    c, r_np, _ = fem.circle_normalize_boundary(ub + 1j * vb)
    assert abs(float(cu) - c.real) < 1e-15 and abs(float(cv) - c.imag) < 1e-15
    assert abs(float(r) - r_np) < 1e-15


def test_even_boundary_count_needs_numpys_median(monkeypatch):
    """A mesh with an even number of boundary nodes: the device path equals
    SuperLU at 1e-9, and with torch.median's lower middle value in the
    circle fit it would not."""
    poly, pts, tris = _blob_mesh(h=0.19)
    assert len(boundary_vertices(tris)) == 54
    host = fem.theta_iteration(pts, tris, poly, iters=3)
    _close(_device(pts, tris, poly, iters=3), host, 1e-9)
    monkeypatch.setattr(fem_device, "_median", lambda x: torch.median(x))
    lower = _device(pts, tris, poly, iters=3)
    assert np.max(np.abs(lower[0] - host[0])) > 1e-6


def test_unwrap_is_numpys():
    rng = np.random.default_rng(6)
    p = np.cumsum(rng.uniform(-4.0, 4.0, 200))
    # exact ±π steps: numpy maps a -π remainder of a positive step to +π
    ties = np.array([0.0, math.pi, 0.0, -math.pi, 0.0, 2 * math.pi, -math.pi, 3.0])
    for x in (p, ties, np.angle(np.exp(1j * np.linspace(0, 9 * np.pi, 300)))):
        got = fem_device._unwrap(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, np.unwrap(x), rtol=0, atol=1e-12)
        for anchor in (0, 5):
            np.testing.assert_allclose(
                fem_device._unwrap_anchored(torch.as_tensor(x), anchor).numpy(),
                fem.unwrap_theta(x, anchor), rtol=0, atol=1e-12)


def test_moving_average_matches_the_reference():
    rng = np.random.default_rng(8)
    x = np.cumsum(rng.uniform(0, 0.3, 50))
    for w in (1, 3, 7):
        got = fem_device._moving_avg_periodic(torch.as_tensor(x), w, 2 * math.pi).numpy()
        want = fem.moving_average_periodic(x, w, 2 * math.pi)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_handle_prefetch_and_verbose(blob, capsys):
    poly, pts, tris = blob
    h = dispatch_theta_iteration_device(pts, tris, poly, iters=2, verbose=True, device="cpu")
    assert h.prefetch() is h
    u, v, c, r, mis = h.result()
    out = capsys.readouterr().out
    assert out.count("[theta-iter/device]") == 2
    assert np.isfinite(u).all() and np.isfinite(mis)


class TestDeviceSPDSolver:
    def test_dirichlet_device_matches_spsolve(self, blob):
        poly, pts, tris = blob
        k = fem.assemble_stiffness(pts, tris)
        bnd = boundary_vertices(tris)
        g = np.cos(3 * np.arctan2(pts[bnd, 1], pts[bnd, 0]))
        u_ref = fem.dirichlet_solve(k, bnd, g, method="spsolve")
        u_dev = fem.dirichlet_solve(k, bnd, g, method="device", device="cpu")
        np.testing.assert_allclose(u_dev, u_ref, atol=1e-9)

    def test_harmonic_conjugate_device(self, blob):
        poly, pts, tris = blob
        v_ref = fem.harmonic_conjugate(pts, tris, pts[:, 0], pin=0)
        v_dev = fem.harmonic_conjugate(pts, tris, pts[:, 0], pin=0, method="device",
                                       device="cpu")
        np.testing.assert_allclose(v_dev, v_ref, atol=1e-9)

    def test_f32_iterative_refinement_recovers_f64(self, blob):
        poly, pts, tris = blob
        k = fem.assemble_stiffness(pts, tris)
        free = np.ones(k.shape[0], dtype=bool)
        free[boundary_vertices(tris)] = False
        k_ff = k[free][:, free].tocsr()
        b = np.random.default_rng(0).standard_normal(k_ff.shape[0])
        x_ref = spsolve(k_ff, b)
        x32 = DeviceSPDSolver(k_ff, dtype=torch.float32, device="cpu").solve(b, refine=3)
        assert np.linalg.norm(x32 - x_ref) / np.linalg.norm(x_ref) < 1e-7

    def test_not_positive_definite_raises(self):
        k = sp.csr_matrix(np.array([[1.0, 2.0], [2.0, 1.0]]))
        with pytest.raises(RuntimeError, match="positive definite"):
            DeviceSPDSolver(k, device="cpu")


def _sliver_system(seed):
    """tests/test_fem_device.py's synthetic Neumann operator with two sliver
    nodes (mutual stiffness 1e11, weak anchors) and a compatible rhs."""
    rng = np.random.default_rng(seed)
    n = 40
    a = np.zeros((n, n))
    for i in range(n - 2):
        for j in rng.choice(n - 2, size=3, replace=False):
            if i != j:
                w = rng.uniform(0.5, 2.0)
                a[i, j] -= w
                a[j, i] -= w
    a[n - 2, n - 1] = a[n - 1, n - 2] = -1e11
    a[n - 2, 0] = a[0, n - 2] = -1e-3
    a[n - 1, 1] = a[1, n - 1] = -2e-3
    np.fill_diagonal(a, 0.0)
    np.fill_diagonal(a, -a.sum(axis=1))
    k = sp.csr_matrix(a)
    b = rng.standard_normal(n)
    b -= b.mean()
    free = np.ones(n, bool)
    free[0] = False
    v_ref = np.zeros(n)
    v_ref[free] = spsolve(k[free][:, free].tocsr(), b[free])
    return k, b, v_ref


class TestSliverCondensation:
    def test_condensation_equals_the_reference(self):
        k, _, _ = _sliver_system(1)
        got = fem_device._condense_slivers(k)
        want = ref_dev._condense_slivers(k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert set(got[1]) == {38, 39}
        assert abs(got[2] - want[2]).max() == 0
        np.testing.assert_array_equal(got[3], want[3])
        assert abs(got[4] - want[4]).max() == 0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_neumann_solver_on_sliver_system(self, dtype):
        """tests/test_fem_device.py:161-199: both dtypes at the lifted-vs-
        pinned floor."""
        k, b, v_ref = _sliver_system(2)
        v = DeviceNeumannSolver(k, pin=0, dtype=dtype, device="cpu").solve(b)
        assert np.isfinite(v).all()
        np.testing.assert_allclose(v, v_ref, atol=2e-3)

    def test_no_slivers_passthrough(self):
        k = sp.csr_matrix(np.array([[2.0, -1, -1], [-1, 2, -1], [-1, -1, 2]]))
        r_idx, s_idx, s_red, kss_inv, w = fem_device._condense_slivers(k)
        assert len(s_idx) == 0 and len(r_idx) == 3
        assert (s_red != k).nnz == 0


def test_cuda_without_card_raises(blob):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    poly, pts, tris = blob
    with pytest.raises(RuntimeError, match="cuda"):
        dispatch_theta_iteration_device(pts, tris, poly, iters=1)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceSPDSolver(sp.identity(3, format="csr"))
