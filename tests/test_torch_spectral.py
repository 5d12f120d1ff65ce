"""cmtci_torch's spectral statistics and the `spectral` pipeline against
cmtci (the JAX reference) on the CPU.

The FFTs and fits are numpy copies and must be equal. The bootstrap core
fed the reference's own index matrix (jax.random.randint of the same key)
must agree within 1e-12. The port draws its indices on the host from
np.random.default_rng(seed), so its CI ends agree with the reference's
statistically: within 25% of the reference's CI width at each of the seeds
SEEDS of the pipeline config, on every power range with a determined slope.
The Mandelbrot curve's 1e-3..1e-2 range holds 8 frequencies and a flat
spectrum (R² 0.06): there a 200-resample percentile is so noisy that two
seeds of the reference itself differ by up to 0.44 of its width, so the
port is held there by the median over SEEDS of each CI end, within 25% of
the median width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtci.pipelines import spectral as ref_pipe
from cmtci.stats import spectral as ref
from cmtci_torch.pipelines import spectral as pipe
from cmtci_torch.stats import spectral as sp

#: the pipeline seeds the CI ends are checked at
SEEDS = (0, 1, 2, 3, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _curves(n=819, seed=0):
    """Two noisy closed curves of n points, in angle order and shuffled."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    c = np.column_stack([np.cos(t) + 0.02 * rng.standard_normal(n),
                         np.sin(t) + 0.02 * rng.standard_normal(n)])
    r = 1 + 0.2 * np.cos(5 * t) + 0.05 * np.cos(17 * t)
    m = np.column_stack([r * np.cos(t), r * np.sin(t)])[rng.permutation(n)]
    return c, m


@pytest.mark.parametrize("name", ["order_points_by_angle", "boundary_fft",
                                  "amplitude_spectrum", "power_spectrum"])
def test_copied_spectra_equal(name):
    c, m = _curves()
    for pts in (c, m, c[:, 0] + 1j * c[:, 1]):
        got, want = getattr(sp, name)(pts), getattr(ref, name)(pts)
        for g, w in zip(got, want) if isinstance(want, tuple) else ((got, want),):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_modes", [1, 2, 5, 30])
def test_reconstruct_low_modes_equal(n_modes):
    _, f = ref.boundary_fft(_curves()[1])
    np.testing.assert_array_equal(sp.reconstruct_low_modes(f, n_modes),
                                  ref.reconstruct_low_modes(f, n_modes))


def test_fits_equal():
    fr, am = ref.amplitude_spectrum(_curves()[1])
    for fmin, fmax in ((1e-3, 1e-2), (1e-2, 1e-1), (1e-1, 0.5), (0.4, 0.5)):
        assert sp.fit_decay_exponent(fr, am, fmin, fmax) == ref.fit_decay_exponent(
            fr, am, fmin, fmax)
    x, y = np.log10(fr[:40]), np.log10(am[:40])
    assert sp._ols_slope_r2(x, y) == ref._ols_slope_r2(x, y)


@pytest.mark.parametrize("seed", [0, 3])
def test_bootstrap_slopes_with_the_reference_indices(seed):
    """The batched fits fed jax.random.randint(PRNGKey(seed), (B, n), 0, n),
    the indices the reference draws inside _bootstrap_slopes."""
    rng = np.random.default_rng(seed)
    x = np.log10(np.linspace(1e-2, 1e-1, 57))
    y = -1.7 * x + 0.1 * rng.standard_normal(57)
    b = 200
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (b, len(x)), 0, len(x)))
    want = np.asarray(ref._bootstrap_slopes(jnp.asarray(x), jnp.asarray(y),
                                            jax.random.PRNGKey(seed), b))
    got = sp._bootstrap_slopes(torch.as_tensor(x), torch.as_tensor(y),
                               torch.as_tensor(idx.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_bootstrap_indices_are_host_draws():
    idx = sp.bootstrap_indices(57, 200, 4)
    assert idx.shape == (200, 57) and idx.min() >= 0 and idx.max() < 57
    np.testing.assert_array_equal(
        idx, np.random.default_rng(4).integers(0, 57, size=(200, 57)))


def _assert_ci_close(got, want):
    """slope and R² equal; each CI end within 25% of the reference's width."""
    assert got[:2] == want[:2]
    width = want[2][1] - want[2][0]
    assert width > 0
    for g, w in zip(got[2], want[2]):
        assert abs(g - w) <= 0.25 * width, (got, want)


#: (curve, fmin, fmax) of the power ranges with a determined slope
DETERMINED = ((0, 1e-3, 1e-2), (0, 1e-2, 1e-1), (1, 1e-2, 1e-1))
#: the Mandelbrot curve's short, flat range
FLAT = (1, 1e-3, 1e-2)


@pytest.mark.parametrize("seed", SEEDS)
def test_fit_slope_bootstrap_ci_within_a_quarter_width(seed):
    curves = _curves()
    for which, fmin, fmax in DETERMINED:
        fr, ps = ref.power_spectrum(curves[which])
        got = sp.fit_slope_bootstrap(fr, ps, fmin, fmax, 200, seed, device="cpu")
        want = ref.fit_slope_bootstrap(fr, ps, fmin, fmax, 200, seed)
        _assert_ci_close(got, want)


def test_fit_slope_bootstrap_ci_of_a_flat_short_range_over_the_seeds():
    which, fmin, fmax = FLAT
    fr, ps = ref.power_spectrum(_curves()[which])
    assert ((fr >= fmin) & (fr <= fmax)).sum() == 8
    got = [sp.fit_slope_bootstrap(fr, ps, fmin, fmax, 200, s, device="cpu") for s in SEEDS]
    want = [ref.fit_slope_bootstrap(fr, ps, fmin, fmax, 200, s) for s in SEEDS]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert want[0][1] < 0.1  # R²: the slope is not determined here
    g_ci, w_ci = np.array([g[2] for g in got]), np.array([w[2] for w in want])
    width = np.median(w_ci[:, 1] - w_ci[:, 0])
    np.testing.assert_array_less(np.abs(np.median(g_ci, 0) - np.median(w_ci, 0)),
                                 0.25 * width)


def test_fit_slope_bootstrap_empty_range_is_nan():
    fr, ps = ref.power_spectrum(_curves(n=60)[1])
    slope, r2, (lo, hi) = sp.fit_slope_bootstrap(fr, ps, 1e-4, 1e-3, device="cpu")
    assert all(np.isnan(v) for v in (slope, r2, lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
def test_run_spectral_against_cmtci(tmp_path, seed):
    c, m = _curves()
    port, want_prefix = str(tmp_path / "p"), str(tmp_path / "r")
    got = pipe.run_spectral(c, m, pipe.SpectralConfig(seed=seed), port, plots=False,
                            device="cpu")
    want = ref_pipe.run_spectral(c, m, ref_pipe.SpectralConfig(seed=seed), want_prefix)
    assert got["modes"] == want["modes"]
    assert got["amplitude_slopes"] == want["amplitude_slopes"]
    for name in ("_slopes.txt", "_meta.txt"):
        assert open(port + name).read() == open(want_prefix + name).read(), name
    assert len(got["power_slopes_bootstrap"]) == 4
    labels = ("Construct", "Mandelbrot")
    for g, w in zip(got["power_slopes_bootstrap"], want["power_slopes_bootstrap"]):
        assert (g["label"], g["fmin"], g["fmax"]) == (w["label"], w["fmin"], w["fmax"])
        if (labels.index(g["label"]), g["fmin"], g["fmax"]) == FLAT:
            assert (g["slope"], g["R2"]) == (w["slope"], w["R2"])
            continue  # held over the seeds above
        _assert_ci_close((g["slope"], g["R2"], (g["ci_lo"], g["ci_hi"])),
                         (w["slope"], w["R2"], (w["ci_lo"], w["ci_hi"])))
    header = open(port + "_bootstrap.csv").readline()
    assert header == open(want_prefix + "_bootstrap.csv").readline()


def test_spectral_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    c, m = _curves(n=200)
    with pytest.raises(RuntimeError, match="cuda"):
        pipe.run_spectral(c, m, pipe.SpectralConfig())
