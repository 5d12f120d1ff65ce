"""cmtci_torch's stage-1 slice against cmtci (the JAX reference) on the CPU:
the stage-1 DE field and the Green potential (kernels/mandelbrot.py), the
log-domain Sinkhorn and its matcher (transport/sinkhorn.py), the weighted
Procrustes (transport/procrustes.py) and run_stage1 (pipelines/stage1.py)
at its defaults, file for file.

No function here has a Pallas kernel: the reference runs them as f64 XLA
loops on the host, the port as f64 torch ops on the device it is given.
"""

import math
import os

import numpy as np
import pytest
import torch

from cmtci.io import loaders as ref_loaders
from cmtci.kernels import mandelbrot as ref_mb
from cmtci.pipelines import stage1 as ref_stage1
from cmtci.transport import procrustes as ref_procrustes
from cmtci.transport import sinkhorn as ref_sinkhorn
from cmtci_torch.io import loaders
from cmtci_torch.io import plots
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.pipelines import stage1
from cmtci_torch.transport import procrustes, sinkhorn
from test_plots_golden import _check, _clouds

BUS_POINTS = ("construct_points.csv", "mandel_boundary_sample.csv", "construct_aligned.csv")
#: C and C_aligned against the reference (the Aberth clouds differ in the last bits)
BUS_TOL = {"construct_points.csv": 1e-12, "construct_aligned.csv": 1e-10}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scalar_de(c, max_iter=200, bailout=1e6):
    # construct_stage1_clean.py:50-58 semantics (tests/test_stage1_de.py)
    z = 0 + 0j
    dz = 0 + 0j
    for _ in range(int(max_iter)):
        dz = 2.0 * z * dz + 1.0
        z = z * z + c
        if abs(z) > bailout:
            return abs(z) * math.log(abs(z)) / max(abs(dz), 1e-16)
    return 0.0


@pytest.mark.parametrize("nx,ny", [(40, 30), (120, 80)])
def test_de_field_stage1_against_cmtci(nx, ny):
    """The grid of tests/test_stage1_de.py and stage 1's own: the same escape
    set, d within 1e-8 relative of XLA (which contracts FMAs; the orbit
    amplifies an ulp to about 6e-9), every sampled pixel within 1e-6 of the
    scalar loop, and on the stage-1 grid the same band pixels."""
    cfg = stage1.Stage1Config(nx=nx, ny=ny)
    cr, ci, d = stage1.band_field(cfg, device="cpu")
    esc, d_t = mb.de_field_stage1(torch.as_tensor(cr), torch.as_tensor(ci))
    np.testing.assert_array_equal(d_t.numpy(), d)
    esc_ref, d_ref = ref_mb.de_field_stage1(cr, ci, max_iter=200, bailout=1e6)
    d_ref = np.asarray(d_ref)
    np.testing.assert_array_equal(esc.numpy(), np.asarray(esc_ref))
    np.testing.assert_allclose(d, d_ref, rtol=1e-8, atol=0)
    for iy in range(0, ny, 7):
        for ix in range(0, nx, 7):
            ref = _scalar_de(complex(cr[iy, ix], ci[iy, ix]))
            assert np.isclose(d[iy, ix], ref, rtol=1e-6, atol=1e-300), (iy, ix)
    band = (d > cfg.threshold_low) & (d < cfg.threshold_high)
    band_ref = (d_ref > cfg.threshold_low) & (d_ref < cfg.threshold_high)
    np.testing.assert_array_equal(band, band_ref)
    if (nx, ny) == (120, 80):
        assert int(band.sum()) == 1624


def test_green_potential_against_cmtci():
    """tests/test_mandelbrot.py:55's points and tolerances."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, size=(400,)) + 1j * rng.uniform(-2, 2, size=(400,))
    ref = [np.asarray(a) for a in ref_mb.green_potential(pts.real, pts.imag, max_iter=2000)]
    got = [t.numpy() for t in mb.green_potential(torch.as_tensor(pts.real),
                                                 torch.as_tensor(pts.imag), max_iter=2000)]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-15)
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1].dtype == np.int32
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        m = ~np.isnan(b)
        np.testing.assert_allclose(a[m], b[m], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("eps,iters", [(0.05, 300), (1e-2, 1000)])
def test_sinkhorn_log_against_cmtci(eps, iters):
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(70, 2)), rng.normal(size=(55, 2))
    cost = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    ref = np.asarray(ref_sinkhorn.sinkhorn_log(cost, iters=iters, eps=eps))
    got = sinkhorn.sinkhorn_log(torch.as_tensor(cost), iters=iters, eps=eps).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(ref)
    np.testing.assert_array_equal(got.argmax(axis=1), ref.argmax(axis=1))
    # uniform marginals on the columns after the last g update
    np.testing.assert_allclose(got.sum(axis=0), 1.0 / 55, rtol=1e-9)


@pytest.mark.parametrize("squared", [True, False])
def test_sinkhorn_match_against_cmtci(squared):
    rng = np.random.default_rng(9)
    x = rng.normal(size=60) + 1j * rng.normal(size=60)
    y = rng.normal(size=(48, 2))
    ym_ref, plan_ref = ref_sinkhorn.sinkhorn_match(x, y, eps=0.05, iters=400, squared=squared)
    ym, plan = sinkhorn.sinkhorn_match(x, y, eps=0.05, iters=400, squared=squared,
                                       device="cpu")
    assert np.max(np.abs(plan - plan_ref)) <= 1e-12 * np.max(plan_ref)
    np.testing.assert_array_equal(ym, ym_ref)


def test_procrustes_weighted_against_cmtci():
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(40, 2)), rng.normal(size=(30, 2))
    plan = rng.uniform(size=(40, 30))
    got, r = procrustes.procrustes_align_weighted(x, y, plan)
    ref, r_ref = ref_procrustes.procrustes_align_weighted(x, y, plan)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(r, r_ref)


@pytest.fixture(scope="module")
def default_runs(tmp_path_factory):
    """run_stage1 at the defaults, the port on the CPU and the reference,
    each writing its bus."""
    root = tmp_path_factory.mktemp("stage1")
    port = stage1.run_stage1(stage1.Stage1Config(), str(root / "port"), device="cpu")
    ref = ref_stage1.run_stage1(ref_stage1.Stage1Config(), str(root / "ref"))
    return root, port, ref


def test_run_stage1_defaults_against_cmtci(default_runs):
    _, port, ref = default_runs
    assert port["C"].shape == (819, 2) and port["M"].shape == (600, 2)
    assert np.max(np.abs(port["C"] - ref["C"])) <= 1e-12
    np.testing.assert_array_equal(port["M"], ref["M"])
    np.testing.assert_array_equal(port["matches"], ref["matches"])
    assert np.max(np.abs(port["C_aligned"] - ref["C_aligned"])) <= 1e-10


def test_run_stage1_defaults_bus_file_for_file(default_runs):
    root = default_runs[0]
    for name in ("mandel_boundary_sample.csv", "matches_indices.csv", "meta.txt"):
        assert (root / "port" / name).read_bytes() == (root / "ref" / name).read_bytes(), name
    for name, tol in BUS_TOL.items():
        got = loaders.load_points(str(root / "port" / name))
        ref = ref_loaders.load_points(str(root / "ref" / name))
        assert got.shape == ref.shape and np.max(np.abs(got - ref)) <= tol, name
    assert os.path.exists(root / "port" / "alignment.png")


def test_bus_cross_read(default_runs):
    """Each package's loaders read the other's bus to the same arrays."""
    root = default_runs[0]
    for a, b in (("port", "ref"), ("ref", "port")):
        for name in BUS_POINTS:
            path = str(root / a / name)
            np.testing.assert_array_equal(loaders.load_points(path),
                                          ref_loaders.load_points(path))
        path = str(root / a / "matches_indices.csv")
        got = loaders.load_matches(path, 819)
        np.testing.assert_array_equal(got, ref_loaders.load_matches(path, 819))
        np.testing.assert_array_equal(got, loaders.load_matches(str(root / b / "matches_indices.csv")))


def test_run_stage1_greedy_small_against_cmtci(tmp_path):
    kw = dict(max_n=12, nx=60, ny=40, boundary_samples=80, matcher="greedy", seed=3)
    port = stage1.run_stage1(stage1.Stage1Config(**kw), str(tmp_path), plots=False,
                             device="cpu")
    ref = ref_stage1.run_stage1(ref_stage1.Stage1Config(**kw))
    assert np.max(np.abs(port["C"] - ref["C"])) <= 1e-12
    np.testing.assert_array_equal(port["M"], ref["M"])
    np.testing.assert_array_equal(port["matches"], ref["matches"])
    assert np.max(np.abs(port["C_aligned"] - ref["C_aligned"])) <= 1e-10
    assert sorted(os.listdir(tmp_path)) == sorted(BUS_POINTS + ("matches_indices.csv",
                                                                "meta.txt"))


def test_run_stage1_times_the_parts_of_match():
    """match's four parts are timed inside it: their sum is at most match,
    and the output is the untimed run's."""
    from cmtci_torch.utils.artifacts import StageTimer

    cfg = stage1.Stage1Config(max_n=10, nx=50, ny=36, boundary_samples=60)
    timer = StageTimer("cpu")
    got = stage1.run_stage1(cfg, plots=False, device="cpu", timer=timer)
    parts = ("features", "cost", "sinkhorn", "argmax")
    assert set(timer.times) == {"cloud", "band", "match", "align", *parts}
    assert sum(timer.times[k] for k in parts) <= timer.times["match"]
    want = stage1.run_stage1(cfg, plots=False, device="cpu")
    for key in ("C", "M", "C_aligned", "matches"):
        np.testing.assert_array_equal(got[key], want[key])


def test_sample_boundary_band_stays_in_band():
    """tests/test_stage1_de.py's band check, on the port's field."""
    cfg = stage1.Stage1Config(nx=80, ny=60, boundary_samples=100)
    pts = stage1.sample_boundary_band(cfg, np.random.RandomState(0), device="cpu")
    assert 0 < len(pts) <= 100
    _, d = mb.de_field_stage1(torch.as_tensor(pts[:, 0]), torch.as_tensor(pts[:, 1]))
    d = d.numpy()
    assert np.all((d > cfg.threshold_low) & (d < cfg.threshold_high))
    ref = ref_stage1.sample_boundary_band(ref_stage1.Stage1Config(nx=80, ny=60,
                                                                  boundary_samples=100),
                                          np.random.RandomState(0))
    np.testing.assert_array_equal(pts, ref)


def test_empty_band_raises():
    cfg = stage1.Stage1Config(max_n=6, nx=20, ny=12, threshold_low=1e3, threshold_high=1e4)
    with pytest.raises(ValueError, match="no boundary points"):
        stage1.run_stage1(cfg, device="cpu")


def test_plot_alignment_golden(tmp_path):
    """tests/test_plots_golden.py's inputs against its golden."""
    c, m = _clouds()
    _check(plots.plot_alignment(c, m, c * 0.98, str(tmp_path / "a.png")), "alignment.png")


def test_stage1_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        stage1.run_stage1(stage1.Stage1Config(max_n=6))
    with pytest.raises(RuntimeError, match="cuda"):
        sinkhorn.sinkhorn_match(np.ones(3), np.ones(3))
