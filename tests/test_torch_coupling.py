"""cmtci_torch's coupling pipeline and the modules it runs (fields, the point
variograms, the Gaussian filter) against cmtci (the JAX reference) on the
CPU.

The f64 path: the rows and the final cloud within 1e-12 of the reference and
the per-iteration variogram CSVs byte for byte, with the reference fed the
port's U_M. U_M is held apart: XLA contracts FMAs in the reference's f64
escape orbit, which moves U_M by up to ~1e-7 at a few hundred late
escapers of the 300² grid (the port does each operation in IEEE order, as
the numpy oracles do), and that moves corr_pot by ~1e-12 in the unpatched
reference. The f32 field path against the f64 path at the reference's own
thresholds (tests/test_review_r4b.py:372-434): d_* bitwise, corr_pot within
1e-4, corr_lap within 5e-3, the local-correlation maps' NaN supports
differing on fewer than 8% of pixels. The f32 local map is formed per window
in two passes, not from the reference's whole-grid cumulative sums, which
cancel in f32. The host Gaussian filter is bitwise scipy's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from cmtci.pipelines import coupling as ref_pipe
from cmtci.stats import fields as ref_fields
from cmtci.stats import variogram as ref_vg
from cmtci.transport import histogram as ref_hg
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.pipelines import coupling as pipe
from cmtci_torch.stats import fields
from cmtci_torch.stats import variogram as vg
from cmtci_torch.transport import histogram as hg

ROW_KEYS = ("iter", "vario_range_a", "sigma_px", "corr_pot", "corr_lap", "d_mean",
            "d_median", "d_max")
TRAJECTORY_KEYS = ("iter", "vario_range_a", "sigma_px", "d_mean", "d_median", "d_max")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds(n, seed):
    """The reference tests' coupling inputs (tests/test_review_r4b.py:378)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 2 * np.pi, n)
    c = np.column_stack([0.4 * np.cos(t), 0.4 * np.sin(t)])
    m = np.column_stack([0.5 * np.cos(t), 0.5 * np.sin(t)]) + 0.01
    return c, m, np.arange(n)


BASE = dict(n_iter=2, grid_res=72, max_iter_mb=60, win_local_corr=6)


@pytest.mark.parametrize("sigma", [0.5, 1.3, 3.0])
@pytest.mark.parametrize("shape", [(40, 40), (17, 29)])
def test_gaussian_filter_bitwise_scipy(sigma, shape, rng):
    h = rng.uniform(size=shape)
    want = gaussian_filter(h, sigma, mode="nearest")
    np.testing.assert_array_equal(hg.gaussian_filter_nearest(h, sigma), want)
    np.testing.assert_array_equal(hg.gaussian_kernel1d(sigma), ref_hg.gaussian_kernel1d(sigma))
    k = hg.gaussian_kernel1d(sigma)
    r = (len(k) - 1) // 2
    got = hg._sep_correlate_nearest(torch.as_tensor(h), torch.as_tensor(k), r).numpy()
    np.testing.assert_array_equal(got, want)  # f64 torch: scipy's tree, no FMA
    got32 = hg._sep_correlate_nearest(torch.as_tensor(h, dtype=torch.float32),
                                      torch.as_tensor(k, dtype=torch.float32), r).numpy()
    np.testing.assert_allclose(got32, want, rtol=1e-6)


def test_laplacian_and_pearson_against_cmtci(rng):
    u = rng.normal(size=(30, 40))
    v = 0.3 * u + rng.normal(size=(30, 40))
    want = np.asarray(ref_fields.laplacian5(u, 0.1))
    np.testing.assert_array_equal(fields.laplacian5(torch.as_tensor(u), 0.1).numpy(), want)
    v[3, 4] = np.nan
    assert fields.pearson_global(u, v) == ref_fields.pearson_global(u, v)
    got = float(fields.pearson_global_device(torch.as_tensor(u), torch.as_tensor(v)))
    want = float(ref_fields.pearson_global_device(jnp.asarray(u), jnp.asarray(v)))
    assert got == pytest.approx(want, rel=1e-13)
    assert got == pytest.approx(ref_fields.pearson_global(u, v), rel=1e-12)


def test_local_correlation_against_cmtci(rng):
    """Away from degenerate windows the map equals the reference's to f64
    rounding; the NaN blob and the frame as tests/test_stats_fixes.py pins."""
    from scipy.stats import pearsonr

    u1 = rng.normal(size=(26, 26))
    u2 = 0.4 * u1 + rng.normal(size=(26, 26))
    u1[8:11, 9:12] = np.nan
    u2[14, 14] = np.nan
    win = 5
    got = fields.local_correlation(u1, u2, win=win, device="cpu")
    want = ref_fields.local_correlation(u1, u2, win=win)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    for iy, ix in [(9, 9), (13, 13), (18, 7)]:
        a = u1[iy - win: iy + win, ix - win: ix + win].ravel()
        b = u2[iy - win: iy + win, ix - win: ix + win].ravel()
        mask = ~(np.isnan(a) | np.isnan(b))
        assert got[iy, ix] == pytest.approx(pearsonr(a[mask], b[mask])[0], rel=1e-9)
    assert np.isnan(fields.local_correlation(np.full((26, 26), np.nan), u2, win=win,
                                             device="cpu")).all()


def test_f32_local_map_by_windows(rng):
    """The f32 path's per-window two-pass map: in f64 it is _local_corr's map
    (the reference's box sums); in f32 it stays within 1e-5 of f64 on a
    field whose windows vary little against its mean, where f32 box sums of
    the whole grid's cumulative sums move r by more than 0.1."""
    u1 = rng.normal(size=(30, 27))
    u2 = 0.4 * u1 + rng.normal(size=(30, 27))
    u1[8:11, 9:12] = np.nan
    u2[20, 4] = np.nan
    for win, rows in ((3, 4), (5, 32)):
        want = fields._local_corr(torch.as_tensor(u1), torch.as_tensor(u2), win).numpy()
        got = fields._local_corr_windows(torch.as_tensor(u1), torch.as_tensor(u2), win,
                                         rows=rows).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    n = 120
    y, x = np.mgrid[0:n, 0:n] / n
    noise = np.random.default_rng(3).normal(size=(2, n, n))
    f1 = -1.0 + 0.05 * np.sin(3 * x + 2 * y) + 0.002 * noise[0]
    f2 = 0.3 * np.cos(4 * x - y) + 0.01 * noise[1]
    t1, t2 = torch.as_tensor(f1), torch.as_tensor(f2)
    want = fields._local_corr(t1, t2, 12).numpy()
    assert not np.isnan(want).any()
    got = fields._local_corr_windows(t1.float(), t2.float(), 12).numpy()
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(fields._local_corr(t1.float(), t2.float(), 12).numpy() - want).max() > 0.1


def test_point_variogram_bitwise_and_device_counts(rng):
    locs = rng.uniform(-1, 1, size=(300, 2))
    vals = rng.normal(size=300)
    for values in (None, vals):
        got = vg.point_variogram(locs, values, nbins=30)
        want = ref_vg.point_variogram(locs, values, nbins=30)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for dt in (torch.float64, torch.float32):
            lags, gamma, counts = vg.point_variogram_device(locs, values, nbins=30, dtype=dt,
                                                            chunk=64, device="cpu")
            if dt == torch.float64:
                np.testing.assert_allclose(lags, want[0], rtol=1e-15)
                np.testing.assert_array_equal(counts, want[2])
                np.testing.assert_allclose(gamma, want[1], rtol=1e-12)
            else:  # f32 distances can move a borderline pair one bin over
                np.testing.assert_allclose(lags, want[0], rtol=1e-6)
                assert np.abs(counts - want[2]).sum() <= 4
                ok = want[2] > 50
                np.testing.assert_allclose(gamma[ok], want[1][ok], rtol=1e-3)
        ref_dev = ref_vg.point_variogram_device(locs, values, nbins=30, max_dist=0.8)
        got_dev = vg.point_variogram_device(locs, values, nbins=30, max_dist=0.8, device="cpu")
        np.testing.assert_array_equal(got_dev[2], ref_dev[2])
        np.testing.assert_allclose(got_dev[1], ref_dev[1], rtol=1e-12)
    one = vg.point_variogram_device(locs[:1], nbins=4, device="cpu")
    assert np.isnan(one[1]).all() and (one[2] == 0).all()


def test_cross_variogram_from_matches_equal(rng):
    c, m = rng.normal(size=(80, 2)), rng.normal(size=(60, 2))
    ci, mi = np.arange(50), rng.integers(0, 60, 50)
    for g, w in zip(vg.cross_variogram_from_matches(c, m, ci, mi, nbins=12),
                    ref_vg.cross_variogram_from_matches(c, m, ci, mi, nbins=12)):
        np.testing.assert_array_equal(g, w)


def _port_u_m(gx, gy, max_iter, escape_r, normalization):
    """The port's escape potential, in the reference's call signature."""
    return mb.escape_potential_grid(torch.as_tensor(np.asarray(gx)), torch.as_tensor(
        np.asarray(gy)), max_iter=max_iter, escape_r=escape_r,
        normalization=normalization).numpy()


def test_f64_coupling_against_cmtci(tmp_path, monkeypatch):
    c, m, matches = _clouds(300, 5)
    cfg = dict(BASE, n_iter=3)
    port, want = str(tmp_path / "p"), str(tmp_path / "r")
    rows, c_out = pipe.run_coupling(c, m, matches, pipe.CouplingConfig(**cfg), port,
                                    plots=False, device="cpu")
    # unpatched: the trajectory bitwise, the diagnostics to XLA's U_M
    rows_x, c_x = ref_pipe.run_coupling(c, m, matches, ref_pipe.CouplingConfig(**cfg))
    np.testing.assert_array_equal(c_out, c_x)
    for r, w in zip(rows, rows_x):
        assert [r[k] for k in TRAJECTORY_KEYS] == [w[k] for k in TRAJECTORY_KEYS]
        assert r["corr_pot"] == pytest.approx(w["corr_pot"], abs=1e-10)
        assert r["corr_lap"] == pytest.approx(w["corr_lap"], abs=1e-10)
    monkeypatch.setattr(ref_pipe.mb, "escape_potential_grid", _port_u_m)
    rows_r, c_r = ref_pipe.run_coupling(c, m, matches, ref_pipe.CouplingConfig(**cfg), want)
    np.testing.assert_array_equal(c_out, c_r)
    assert len(rows) == len(rows_r) == 3
    for r, w in zip(rows, rows_r):
        assert list(r) == list(ROW_KEYS)
        for k in ROW_KEYS:
            assert r[k] == pytest.approx(w[k], rel=0, abs=1e-12), k
    for it in (1, 2, 3):
        name = f"_{it}_variogram_construct.csv"
        assert open(port + name, "rb").read() == open(want + name, "rb").read(), it
        a, b = np.load(f"{port}_{it}_localcorr.npy"), np.load(f"{want}_{it}_localcorr.npy")
        assert a.shape == b.shape == (72, 72)
        # windows where U_M is flat have no correlation: there both maps
        # hold rounding noise, and the n > 5 & denom > 0 gate flips with the
        # box sums' summation order. Measured: 149 of the 5,184 pixels (2.9%)
        # flip at each iteration, and the side that is finite holds at most
        # |r| = 1.33e-6 there. So a flip is allowed only where the finite side
        # is noise, and on under 3% of the pixels; elsewhere the maps agree to
        # f64 rounding
        n_a, n_b = np.isnan(a), np.isnan(b)
        flips = n_a != n_b
        assert flips.mean() < 0.03
        assert np.abs(np.where(n_a, b, a)[flips]).max(initial=0.0) < 1e-5
        ok = ~(n_a | n_b)
        assert ok.mean() > 0.5
        np.testing.assert_allclose(a[ok], b[ok], rtol=0, atol=1e-6)
        big = ok & (np.abs(b) > 1e-4)
        np.testing.assert_allclose(a[big], b[big], rtol=1e-9)
    assert open(port + "_meta.txt").read() == open(want + "_meta.txt").read()
    assert open(port + "_summary_metrics.csv").readline() == \
        open(want + "_summary_metrics.csv").readline()


def test_escape_potential_against_cmtci_but_xla_fma():
    """U_M on the coupling grid: equal to the reference's but at the pixels
    whose f64 orbit XLA contracts into FMAs."""
    from cmtci.kernels import mandelbrot as ref_mb

    gx, gy = np.meshgrid(np.linspace(-1.1, 1.1, 120), np.linspace(-1.0, 1.0, 120))
    got = _port_u_m(gx, gy, 300, 10.0, "k_plus_1")
    want = np.asarray(ref_mb.escape_potential_grid(gx, gy, max_iter=300, escape_r=10.0,
                                                   normalization="k_plus_1"))
    diff = np.abs(got - want)
    assert (diff > 1e-12).mean() < 0.01 and diff.max() < 1e-6


def test_f32_fields_keep_the_trajectory(tmp_path):
    """tests/test_review_r4b.py:372-434 on the port: the f32 field path
    against the f64 one."""
    c, m, matches = _clouds(250, 11)
    p64, p32 = str(tmp_path / "c64"), str(tmp_path / "c32")
    rows64, c64 = pipe.run_coupling(c, m, matches, pipe.CouplingConfig(**BASE), p64,
                                    plots=False, device="cpu")
    rows32, c32 = pipe.run_coupling(c, m, matches,
                                    pipe.CouplingConfig(**BASE, field_dtype="float32"), p32,
                                    plots=False, device="cpu")
    np.testing.assert_array_equal(c64, c32)
    for r64, r32 in zip(rows64, rows32):
        assert [r64[k] for k in TRAJECTORY_KEYS] == [r32[k] for k in TRAJECTORY_KEYS]
        assert abs(r64["corr_pot"] - r32["corr_pot"]) < 1e-4
        assert abs(r64["corr_lap"] - r32["corr_lap"]) < 5e-3
    for it in (1, 2):
        l64 = np.load(f"{p64}_{it}_localcorr.npy")
        l32 = np.load(f"{p32}_{it}_localcorr.npy")
        n64, n32 = np.isnan(l64), np.isnan(l32)
        w = BASE["win_local_corr"]
        assert n64[:w].all() and n64[-w:].all() and n32[:w].all() and n32[-w:].all()
        assert (n64 != n32).mean() < 0.08
        ok = ~(n64 | n32)
        assert ok.sum() > 0.3 * l64.size
        assert np.nanmax(np.abs(l64[ok] - l32[ok])) < 5e-2
        assert np.corrcoef(l64[ok], l32[ok])[0, 1] > 0.999
        assert (open(f"{p64}_{it}_variogram_construct.csv").read()
                == open(f"{p32}_{it}_variogram_construct.csv").read())


def test_f32_fields_against_cmtci_f32():
    """The port's f32 diagnostics against the reference's fused f32 path."""
    c, m, matches = _clouds(300, 5)
    cfg = dict(BASE, field_dtype="float32")
    rows, c_out = pipe.run_coupling(c, m, matches, pipe.CouplingConfig(**cfg), plots=False,
                                    device="cpu")
    rows_r, c_r = ref_pipe.run_coupling(c, m, matches, ref_pipe.CouplingConfig(**cfg))
    np.testing.assert_array_equal(c_out, c_r)
    for r, w in zip(rows, rows_r):
        assert abs(r["corr_pot"] - w["corr_pot"]) < 1e-4
        assert abs(r["corr_lap"] - w["corr_lap"]) < 5e-3


def test_f32_variogram_realization():
    """vario_dtype float32: the trajectory is an f32 realization of the f64
    one (the range is an f32 bin center)."""
    c, m, matches = _clouds(250, 11)
    rows64, c64 = pipe.run_coupling(c, m, matches, pipe.CouplingConfig(**BASE), plots=False,
                                    device="cpu")
    rows32, c32 = pipe.run_coupling(c, m, matches,
                                    pipe.CouplingConfig(**BASE, vario_dtype="float32"),
                                    plots=False, device="cpu")
    np.testing.assert_allclose(c32, c64, rtol=1e-6, atol=1e-9)
    for r64, r32 in zip(rows64, rows32):
        assert r32["vario_range_a"] == pytest.approx(r64["vario_range_a"], rel=1e-6)


def test_timer_records_the_layers():
    """`timer` takes one span a layer, summed over the iterations, and the
    rows are those of an untimed run."""
    from cmtci_torch.utils.artifacts import StageTimer

    c, m, matches = _clouds(120, 2)
    timer = StageTimer("cpu")
    rows, c_out = pipe.run_coupling(c, m, matches, pipe.CouplingConfig(**BASE), plots=False,
                                    device="cpu", timer=timer)
    assert list(timer.times) == ["u_m", "variogram", "u_c", "smooth", "diagnostics", "nudge"]
    assert all(t >= 0 for t in timer.times.values())
    rows_0, c_0 = pipe.run_coupling(c, m, matches, pipe.CouplingConfig(**BASE), plots=False,
                                    device="cpu")
    assert rows == rows_0
    np.testing.assert_array_equal(c_out, c_0)


def test_coupling_needs_matches():
    c, m, _ = _clouds(20, 0)
    with pytest.raises(ValueError, match="requires matches"):
        pipe.run_coupling(c, m, None, pipe.CouplingConfig(), device="cpu")
