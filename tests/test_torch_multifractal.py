"""cmtci_torch's multifractal spectrum and the `multifractal` pipeline against
cmtci (the JAX reference) on the CPU.

The host grouping is a numpy copy and must be equal. The f64 device count
grid must give Z within 1e-12 relative of the reference's device and host
paths; the f32 grid must pass the reference's own f32 tests
(tests/test_stats_fixes.py:29, tests/test_stats_more.py:152). The port sizes
the grid from the data when grid=None; an explicit grid that is too small
raises as the reference's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtci.pipelines import analysis as ref_analysis
from cmtci.stats import multifractal as ref
from cmtci_torch.pipelines import analysis
from cmtci_torch.stats import multifractal as mf


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(kind, rng):
    if kind == "uniform":
        return rng.uniform(size=(4000, 2))
    if kind == "line":
        t = rng.uniform(size=3000)
        return np.column_stack([t, 0.5 * t])
    t = rng.uniform(0, 2 * np.pi, 2500)  # a ring, as complex numbers
    return (0.45 + 0.02 * rng.standard_normal(2500)) * np.exp(1j * t)


def test_defaults_and_box_counts_equal(rng):
    np.testing.assert_array_equal(mf.default_q_values(), ref.default_q_values())
    np.testing.assert_array_equal(mf.default_scales(), ref.default_scales())
    pts = rng.uniform(size=(3000, 2))
    for eps in (0.002, 0.05, 0.5):
        np.testing.assert_array_equal(mf.box_counts(pts, eps), ref.box_counts(pts, eps))


@pytest.mark.parametrize("kind", ["uniform", "line", "complex"])
def test_host_spectrum_equal(kind, rng):
    pts = _cloud(kind, rng)
    got, want = mf.multifractal_spectrum(pts), ref.multifractal_spectrum(pts)
    for key in ("q", "tau", "Dq", "alpha", "f_alpha", "scales", "Z"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("kind", ["uniform", "line", "complex"])
def test_f64_device_grid_against_reference_device_and_host(kind, rng):
    pts = _cloud(kind, rng)
    got = mf.multifractal_spectrum(pts, backend="device", device="cpu")
    dev = ref.multifractal_spectrum(pts, backend="device", grid=512)
    host = ref.multifractal_spectrum(pts)
    for want in (dev, host):
        np.testing.assert_array_equal(np.isnan(got["Z"]), np.isnan(want["Z"]))
        np.testing.assert_allclose(got["Z"], want["Z"], rtol=1e-12)
        np.testing.assert_allclose(got["tau"], want["tau"], rtol=1e-10)


def test_grid_sized_from_the_data(rng):
    """grid=None: floor(range / min_eps) + 2 boxes a side, the same Z as an
    explicit larger grid."""
    pts = rng.uniform(size=(1500, 2)) * np.array([3.0, 1.0])
    scales = np.array([0.01, 0.1])
    z_auto, n_auto = mf.box_counts_grid_device(pts, scales, [0.0, 2.0], device="cpu")
    z_big, n_big = mf.box_counts_grid_device(pts, scales, [0.0, 2.0], grid=400, device="cpu")
    np.testing.assert_array_equal(n_auto, n_big)
    np.testing.assert_allclose(z_auto, z_big, rtol=1e-14)
    need = (pts[:, 0].max() - pts[:, 0].min()) / 0.01
    with pytest.raises(ValueError, match="too small"):
        mf.box_counts_grid_device(pts, scales, [2.0], grid=int(np.floor(need)) + 1,
                                  device="cpu")


def test_wide_cloud_holds_only_its_boxes(rng):
    """A cloud 5e6 smallest boxes wide, whose dense grid would hold 2.5e13
    counts: the device grouping keeps the non-empty boxes only and gives
    the host partition's Z."""
    pts = np.vstack([rng.uniform(size=(400, 2)), rng.uniform(size=(400, 2)) + 1e4])
    scales, q = mf.default_scales(), mf.default_q_values()
    z, nonempty = mf.box_counts_grid_device(pts, scales, q, device="cpu")
    for j, eps in enumerate(scales):
        counts = mf.box_counts(pts, eps)
        assert nonempty[j] == len(counts)
        ps = counts / counts.sum()
        want = np.array([ps.size if qq == 0 else np.sum(ps**qq) for qq in q])
        np.testing.assert_allclose(z[:, j], want, rtol=1e-12)


def test_explicit_grid_guards_as_the_reference(rng):
    """tests/test_stats_more.py:137-153: a grid too small, and the exact fit
    need == grid, raise."""
    pts = rng.uniform(size=(100, 2))
    with pytest.raises(ValueError, match="too small"):
        mf.multifractal_spectrum(pts, backend="device", grid=16,
                                 scales=np.array([1e-4, 0.5]), device="cpu")
    pts = np.vstack([rng.uniform(size=(500, 2)), [[0.0, 0.0], [1.0, 1.0]]])
    with pytest.raises(ValueError, match="too small"):
        mf.multifractal_spectrum(pts, backend="device", grid=64,
                                 scales=np.array([1.0 / 64, 0.25, 0.5]), device="cpu")


def test_f32_counts_exact_beyond_f32_mantissa():
    """tests/test_stats_fixes.py:29: one box holding more than 2^24 points;
    exact counts give log Z(q=1) = log 1 = 0 up to the f32 log's rounding."""
    n_big = (1 << 24) + (1 << 20)
    x = torch.zeros(n_big + 1, dtype=torch.float32)
    y = torch.zeros(n_big + 1, dtype=torch.float32)
    x[-1] = 0.9
    logz, nonempty = mf._z_device(x, y, torch.tensor([0.5]), torch.tensor([1.0]), 8)
    assert nonempty == [2]
    assert abs(float(logz[0, 0])) < 1e-5


def test_f32_extreme_q_no_overflow(rng):
    """tests/test_stats_more.py:152-174: q = -40 with singleton boxes (p^q
    about 1e139, beyond f32) stays finite, close to the host f64 path."""
    pts = rng.uniform(size=(3000, 2))
    q = np.array([-40.0, -5.0, 0.0, 2.0])
    scales = np.array([0.01, 0.05, 0.2])
    res_h = ref.multifractal_spectrum(pts, q_values=q, scales=scales)
    res_d = mf.multifractal_spectrum(pts, q_values=q, scales=scales, backend="device",
                                     dtype=torch.float32, device="cpu")
    assert np.isfinite(res_d["Z"]).all()
    np.testing.assert_allclose(np.log(res_d["Z"]), np.log(res_h["Z"]), rtol=0, atol=5e-3)
    np.testing.assert_allclose(res_d["tau"], res_h["tau"], rtol=5e-3)
    ref_d = ref.multifractal_spectrum(pts, q_values=q, scales=scales, backend="device",
                                      grid=512, dtype=jnp.float32)
    np.testing.assert_allclose(np.log(res_d["Z"]), np.log(ref_d["Z"]), rtol=0, atol=5e-3)


def test_unknown_backend_raises(rng):
    with pytest.raises(ValueError, match="unknown backend"):
        mf.multifractal_spectrum(rng.uniform(size=(50, 2)), backend="gpu")


@pytest.mark.parametrize("backend", ["host", "device"])
def test_run_multifractal_against_cmtci(tmp_path, rng, backend):
    c, m = rng.uniform(size=(819, 2)) * 2 - 1, _cloud("complex", rng)[:600]
    m = np.column_stack([m.real, m.imag])
    port, want = str(tmp_path / "p"), str(tmp_path / "r")
    got = analysis.run_multifractal(c, m, out_prefix=port, box_backend=backend, plots=False,
                                    device="cpu")
    # the reference's host grouping: its device grid gives the same Z
    ref_analysis.run_multifractal(c, m, out_prefix=want)
    assert open(f"{port}_meta.txt").read() == open(f"{want}_meta.txt").read()
    for name in ("construct", "mandel"):
        a = f"_{name}_multifractal.csv"
        if backend == "host":
            assert open(port + a).read() == open(want + a).read(), name
        else:
            assert open(port + a).readline() == open(want + a).readline()
            np.testing.assert_allclose(np.loadtxt(port + a, delimiter=",", skiprows=1),
                                       np.loadtxt(want + a, delimiter=",", skiprows=1),
                                       rtol=1e-9, atol=1e-12)
    assert set(got) == {"construct", "mandel"}


def test_f32_grid_equals_cmtci_f32_on_grid_nodes():
    """The stage-1 band pixels are DE-grid nodes, many on a box edge of some
    scale, so flooring in f32 moves points across edges and tau by up to
    3.6% from f64; the port's f32 grid does exactly what the reference's
    does."""
    from cmtci_torch.pipelines import stage1

    cfg = stage1.Stage1Config()
    cr, ci, d = stage1.band_field(cfg, device="cpu")
    band = (d > cfg.threshold_low) & (d < cfg.threshold_high)
    pts = np.column_stack([cr[band], ci[band]])
    assert len(pts) == 1624
    got = mf.multifractal_spectrum(pts, backend="device", dtype=torch.float32, device="cpu")
    want = ref.multifractal_spectrum(pts, backend="device", dtype=jnp.float32)
    np.testing.assert_allclose(got["Z"], want["Z"], rtol=1e-5)
    np.testing.assert_allclose(got["tau"], want["tau"], rtol=1e-6)
    host = ref.multifractal_spectrum(pts)
    assert np.nanmax(np.abs(got["tau"] - host["tau"]) / np.abs(host["tau"])) > 5e-3
