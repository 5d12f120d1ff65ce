"""cmtci_torch's local-polynomial and gradient curvature (stats/curvature.py)
and run_curvature (pipelines/curvature.py) against cmtci (the JAX
reference) on the CPU, against the frozen curvature summaries in
artifacts/, and the curvature figures against their goldens.

κ is compared with rtol 1e-9 plus an atol of 1e-9 × max|κ|: the construct
boundary has long straight runs where κ is ~1e-10 of its maximum and the
Cramer solve's determinant is tiny, so a last-bit difference in the window
sums moves κ there by far more than its own rtol. The construct golden
(artifacts/construct_boundary.csv.gz) is no longer reproduced point for
point by cmtci itself (it starts at another vertex), so the chain that made
it is held to it geometrically.
"""

import os

import numpy as np
import pytest
import torch

from cmtci.pipelines import curvature as ref_pipeline
from cmtci.stats import curvature as ref_curv
from cmtci_torch.io import loaders, plots
from cmtci_torch.kernels import companion
from cmtci_torch.pipelines import curvature as pipeline
from cmtci_torch.pipelines import lucas_boundary as lucas
from cmtci_torch.stats import curvature as curv
from test_plots_golden import _check, _clouds

MANDEL = "artifacts/mandel_boundary.csv.gz"
CONSTRUCT = "artifacts/construct_boundary.csv.gz"
SUMMARY_KEYS = ("n", "mean", "median", "std", "q05", "q95", "max")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _repo_path(name):
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), name)


def _golden_summary(name):
    lines = open(_repo_path(name)).read().splitlines()
    assert lines[0] == "Local-Polynomial Curvature Summary"
    return {k: float(v) for k, v in (line.split(": ") for line in lines[1:])}


def _hausdorff(a, b) -> float:
    from scipy.spatial.distance import directed_hausdorff

    return max(directed_hausdorff(a, b)[0], directed_hausdorff(b, a)[0])


def _assert_kappa_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9 * np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def mandel():
    return loaders.load_points(_repo_path(MANDEL))


def test_solve3_against_cmtci():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(200, 3, 3)) + 3 * np.eye(3)
    b = rng.normal(size=(200, 3))
    got = curv._solve3(torch.as_tensor(m), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_curv._solve3(m, b)), rtol=1e-13, atol=0)
    np.testing.assert_allclose(got, np.linalg.solve(m, b[..., None])[..., 0], rtol=1e-12)


@pytest.mark.parametrize("closed", [True, False])
def test_window_indices_against_cmtci(closed):
    np.testing.assert_array_equal(curv._window_indices(40, 7, closed),
                                  ref_curv._window_indices(40, 7, closed))


@pytest.mark.parametrize("closed,neighbors", [(True, 7), (False, 7), (True, 3)])
def test_localpoly_curvature_against_cmtci(mandel, closed, neighbors):
    p = mandel[::3]
    got = curv.localpoly_curvature(p, neighbors, closed, device="cpu")
    ref = ref_curv.localpoly_curvature(p, neighbors, closed)
    _assert_kappa_close(got[0], ref[0])
    _assert_kappa_close(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-9)
    for key in ("xprime", "yprime", "x2", "y2"):
        v = ref[3][key]
        np.testing.assert_allclose(got[3][key], v, rtol=1e-9, atol=1e-9 * np.max(np.abs(v)))


def test_localpoly_curvature_rejects_short_input():
    with pytest.raises(ValueError, match=">= 2"):
        curv.localpoly_curvature(np.zeros((20, 2)), 1, device="cpu")
    with pytest.raises(ValueError, match="at least 15"):
        curv.localpoly_curvature(np.zeros((10, 2)), 7, device="cpu")


def test_gradient_curvature_against_cmtci(mandel):
    p = mandel[::7]
    got = curv.gradient_curvature(p, device="cpu")
    ref = ref_curv.gradient_curvature(p)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9 * np.max(ref))


def test_run_curvature_files_against_cmtci(tmp_path, mandel):
    """The mandel golden boundary: the 10-column CSV, the meta and the
    summary against cmtci's, and the summary against the frozen file."""
    p = mandel
    got = pipeline.run_curvature(p, pipeline.CurvatureConfig(), str(tmp_path / "port"),
                                 plots=False, device="cpu")
    ref = ref_pipeline.run_curvature(p, ref_pipeline.CurvatureConfig(), str(tmp_path / "ref"))
    _assert_kappa_close(got[0], ref[0])
    csv_got = (tmp_path / "port_curvature.csv").read_text().splitlines()
    csv_ref = (tmp_path / "ref_curvature.csv").read_text().splitlines()
    assert csv_got[0] == csv_ref[0] == "idx,x,y,curvature,kappa_signed,speed,xprime,yprime,x2,y2"
    a = np.loadtxt(tmp_path / "port_curvature.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(tmp_path / "ref_curvature.csv", delimiter=",", skiprows=1)
    assert a.shape == b.shape == (14391, 10)
    np.testing.assert_array_equal(a[:, :3], b[:, :3])
    for col in range(3, 10):
        np.testing.assert_allclose(a[:, col], b[:, col], rtol=1e-8,
                                   atol=1e-9 * np.max(np.abs(b[:, col])))
    assert ((tmp_path / "port_meta.txt").read_text()
            == (tmp_path / "ref_meta.txt").read_text())
    summary = (tmp_path / "port_summary.txt").read_text().splitlines()
    assert summary[0] == "Local-Polynomial Curvature Summary"
    assert [line.split(": ")[0] for line in summary[1:]] == list(SUMMARY_KEYS)
    assert not (tmp_path / "port_curvature_hist.png").exists()
    golden = _golden_summary("artifacts/mandel_curv_localpoly_summary.txt")
    for key in SUMMARY_KEYS:
        assert got[4][key] == pytest.approx(golden[key], rel=1e-8, abs=0), key
        assert got[4][key] == pytest.approx(ref[4][key], rel=1e-8, abs=0), key


def test_construct_chain_against_golden_geometrically():
    """Stage-1 cloud (max_n 40) -> construct_boundary (alpha 65, 1500) ->
    curvature (k = 7), the chain behind the construct golden: the same
    curve (Hausdorff <= 1e-4; cmtci reads 2.8e-5), the same n, and mean, std
    and q95 within 2% of the frozen summary."""
    z = companion.inverse_cloud(list(range(2, 41)), tol=1e-12, device="cpu")
    with pytest.warns(UserWarning, match="traced"):
        b, closed = lucas.construct_boundary(np.column_stack([z.real, z.imag]),
                                             lucas.ConstructBoundaryConfig())
    assert closed and b.shape == (1500, 2)
    assert _hausdorff(b, loaders.load_points(_repo_path(CONSTRUCT))) <= 1e-4
    summary = pipeline.run_curvature(b, pipeline.CurvatureConfig(), device="cpu")[4]
    golden = _golden_summary("artifacts/construct_curv_localpoly_summary.txt")
    assert summary["n"] == golden["n"]
    for key in ("mean", "std", "q95"):
        assert summary[key] == pytest.approx(golden[key], rel=0.02), key
    ref = ref_pipeline.run_curvature(b, ref_pipeline.CurvatureConfig())
    for key in SUMMARY_KEYS:
        assert summary[key] == pytest.approx(ref[4][key], rel=1e-6,
                                             abs=1e-9 * summary["max"]), key


def test_run_curvature_too_few_points_raises():
    with pytest.raises(ValueError, match="at least 15"):
        pipeline.run_curvature(np.zeros((10, 2)), pipeline.CurvatureConfig(), device="cpu")


def test_plot_curvature_golden(tmp_path):
    """tests/test_plots_golden.py's inputs against its goldens."""
    c, _ = _clouds()
    kappa = 1.0 + 0.3 * np.sin(np.linspace(0, 6 * np.pi, len(c)))
    h, o = plots.plot_curvature(c, kappa, str(tmp_path / "curv"))
    _check(h, "curvature_hist.png")
    _check(o, "curvature_overlay.png")


def test_curvature_cuda_without_card_raises(mandel):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.run_curvature(mandel, pipeline.CurvatureConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        curv.gradient_curvature(mandel)
