"""cmtci_torch's variogram slice against cmtci (the JAX reference) on the
CPU, on the same numpy inputs: the cloud log potential, smooth5, the
DE-threshold boundary proxy, the pair binning in both dtypes, the three
semivariograms with the reference's RNG draw order, run_variograms at a small
grid, and the CLI.

Tolerances: pair counts are integers and must be equal. f64 values agree to
rel 1e-9 (the two sides sum in another order). f32 values carry f32 rounding:
rel 1e-3 for a gamma (the reference also accumulates its per-bin sums in f32,
the port in f64), 1e-5 for the log potential.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtci.kernels import mandelbrot as ref_mb
from cmtci.kernels import potential as ref_pot
from cmtci.pipelines import variograms as ref_pv
from cmtci.stats import variogram as ref_vg
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels import potential as pot
from cmtci_torch.pipelines import variograms as pv
from cmtci_torch.stats import variogram as vg

DTYPES = {"float64": (torch.float64, jnp.float64, np.float64),
          "float32": (torch.float32, jnp.float32, np.float32)}
SMALL = dict(n_list=(10, 20, 30), boundary_grid=64, boundary_max_iter=80, grid_nx=40,
             grid_ny=36, potential_max_iter=80, m_target=500)
GAMMAS = ("gamma_construct", "gamma_mandelbrot", "gamma_cross")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    m = b != 0
    assert np.array_equal(a == 0, b == 0)
    return float(np.max(np.abs(a[m] - b[m]) / np.abs(b[m]))) if m.any() else 0.0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("sign,eps", [(1, 1e-12), (-1, 1e-6)])
def test_cloud_log_potential_vs_reference(rng, dtype, sign, eps):
    _, _, np_dt = DTYPES[dtype]
    gx, gy = np.meshgrid(np.linspace(-2, 1, 20), np.linspace(-1.5, 1.5, 18))
    pts = 0.5 * rng.normal(size=300) + 0.5j * rng.normal(size=300)
    got = pot.cloud_log_potential(gx.astype(np_dt), gy.astype(np_dt), pts, eps=eps,
                                  sign=sign, chunk=128, device="cpu")
    want = np.asarray(ref_pot.cloud_log_potential(gx.astype(np_dt), gy.astype(np_dt), pts,
                                                  eps=eps, sign=sign, chunk=128))
    assert got.dtype == DTYPES[dtype][0] and got.shape == (18, 20)
    assert want.dtype == np_dt
    assert _rel(got.numpy(), want) <= (1e-12 if dtype == "float64" else 1e-5)


def test_cloud_log_potential_point_forms_and_empty_cloud(rng):
    gx, gy = np.meshgrid(np.linspace(-1, 1, 7), np.linspace(-1, 1, 5))
    pts = rng.normal(size=40) + 1j * rng.normal(size=40)
    a = pot.cloud_log_potential(gx, gy, pts, device="cpu")
    b = pot.cloud_log_potential(gx, gy, np.column_stack([pts.real, pts.imag]), chunk=7,
                                device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13)
    empty = pot.cloud_log_potential(gx, gy, np.zeros(0, complex), device="cpu")
    assert empty.shape == (5, 7) and not empty.any()


def test_smooth5_vs_reference(rng):
    g = rng.normal(size=(9, 11))
    got = mb.smooth5(torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_mb.smooth5(jnp.asarray(g))), rtol=0,
                               atol=2.3e-16)
    assert np.array_equal(got[0], g[0]) and np.array_equal(got[:, -1], g[:, -1])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_boundary_points_threshold_vs_reference(dtype):
    """The same nodes in the same row-major order; a coordinate may differ in
    its last ulp, because the reference's grid is jnp.linspace and the port's
    np.linspace (the oracle's)."""
    t_dt, j_dt, _ = DTYPES[dtype]
    kw = dict(grid_n=90, dist_thresh=0.01, max_iter=80)
    got = mb.boundary_points_threshold(dtype=t_dt, device="cpu", **kw)
    want = ref_mb.boundary_points_threshold(dtype=j_dt, **kw)
    assert got.dtype == np.complex128 and len(got) == len(want) > 1000
    assert np.max(np.abs(got - want)) <= (1e-15 if dtype == "float64" else 3e-7)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("upper", [True, False])
def test_binned_sq_diff_vs_both_reference_forms(rng, dtype, upper):
    """One port function against the reference's scatter form and its
    cumulative masked form: counts equal, sums at the dtype's tolerance."""
    t_dt, j_dt, _ = DTYPES[dtype]
    c1, v1 = rng.uniform(-1, 1, (900, 2)), rng.normal(size=900)
    c2, v2 = (c1, v1) if upper else (rng.uniform(-1, 1, (700, 2)), rng.normal(size=700))
    edges = np.linspace(0.0, 1.3, 36)
    args = (c1, v1, c2, v2, edges)
    sums, counts = vg._binned_sq_diff(*(torch.as_tensor(a, dtype=t_dt) for a in args), 35,
                                      256, upper)
    assert sums.dtype == torch.float64 and counts.dtype == torch.int64
    for ref_fn in (ref_vg._binned_sq_diff, ref_vg._binned_sq_diff_masked):
        with jax.enable_x64(dtype == "float64"):
            rs, rn = ref_fn(*(jnp.asarray(a, j_dt) for a in args), 35, 256, upper)
            rs, rn = np.asarray(rs), np.asarray(rn)
        np.testing.assert_array_equal(counts.numpy(), rn.astype(np.int64))
        assert _rel(sums.numpy(), rs) <= (1e-9 if dtype == "float64" else 1e-3)
    # every pair under the last edge is counted once (numpy, op by op in the
    # working dtype: a pair on the edge in f32 need not be on it in f64)
    np_dt = DTYPES[dtype][2]
    a, b = c1.astype(np_dt), c2.astype(np_dt)
    dx, dy = a[:, None, 0] - b[None, :, 0], a[:, None, 1] - b[None, :, 1]
    d = np.sqrt(dx * dx + dy * dy)
    if upper:
        d = d[np.triu_indices(len(c1), k=1)]
    assert int(counts.sum()) == int((d < np_dt(edges[-1])).sum())


def test_masked_bin_reduce_bin_edges_and_spill():
    """edges[k] <= d < edges[k+1]: a distance on an edge opens the bin above,
    one on the last edge or beyond is dropped, as is a masked pair."""
    edges = torch.tensor([0.0, 1.0, 2.0, 3.0], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.5, 1.0, 1.5], [2.0, 2.999, 3.0, 7.0]], dtype=torch.float64)
    valid = torch.ones_like(d, dtype=torch.bool)
    valid[0, 1] = False
    dvv = torch.full_like(d, 2.0)
    counts = vg.masked_bin_reduce(d, valid, edges, 3)
    assert counts.tolist() == [1, 2, 2]
    sums, counts2 = vg.masked_bin_reduce(d, valid, edges, 3, dvv=dvv)
    assert counts2.tolist() == [1, 2, 2] and sums.tolist() == [2.0, 4.0, 4.0]


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(11)
    gx, gy = np.meshgrid(np.linspace(-2.25, 1.25, 34), np.linspace(-1.75, 1.75, 30))
    f_c = np.sin(2 * gx) * np.cos(gy) + 0.1 * rng.normal(size=gx.shape)
    f_m = np.exp(-(gx ** 2 + gy ** 2)) + 0.1 * rng.normal(size=gx.shape)
    return f_c, f_m, gx, gy, np.linspace(0.0, 1.3, 36)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_three_semivariograms_vs_reference(fields, dtype):
    f_c, f_m, gx, gy, r_bins = fields
    t_dt, j_dt, _ = DTYPES[dtype]
    got = vg.three_semivariograms(f_c, f_m, gx, gy, r_bins, 400, np.random.RandomState(42),
                                  chunk=128, dtype=t_dt, device="cpu")
    want = ref_vg.three_semivariograms(f_c, f_m, gx, gy, r_bins, 400,
                                       np.random.RandomState(42), chunk=128,
                                       dtype=None if dtype == "float64" else j_dt)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:4], want[1:4]):
        assert _rel(g, w) <= (1e-9 if dtype == "float64" else 1e-3)
    for n, w in zip(got[4:], want[4:]):
        assert n.dtype == np.int64
        np.testing.assert_array_equal(n, np.asarray(w).astype(np.int64))
    assert int(got[4].sum()) > 0 and int(got[6].sum()) > int(got[4].sum())


def test_grid_and_cross_semivariogram_draw_like_the_reference(fields):
    """Each function alone, on the global numpy stream when rng is None."""
    f_c, f_m, gx, gy, r_bins = fields
    np.random.seed(5)
    got = vg.grid_semivariogram(f_c, gx, gy, r_bins, 300, chunk=100, device="cpu")
    np.random.seed(5)
    want = ref_vg.grid_semivariogram(f_c, gx, gy, r_bins, 300, chunk=100)
    assert _rel(got[1], want[1]) <= 1e-9
    np.testing.assert_array_equal(got[2], np.asarray(want[2]).astype(np.int64))
    got = vg.cross_semivariogram(f_c, f_m, gx, gy, r_bins, 300, np.random.RandomState(9),
                                 chunk=100, device="cpu")
    want = ref_vg.cross_semivariogram(f_c, f_m, gx, gy, r_bins, 300,
                                      np.random.RandomState(9), chunk=100)
    assert _rel(got[1], want[1]) <= 1e-9
    np.testing.assert_array_equal(got[2], np.asarray(want[2]).astype(np.int64))
    assert int(got[2].sum()) <= 300 * 300


def test_fits_range_and_detrend_equal_reference(fields):
    f_c, _, gx, gy, _ = fields
    r = np.linspace(0.02, 1.3, 35)
    gamma = 0.1 + 0.8 * (1 - np.exp(-r / 0.4))
    gamma[3] = np.nan
    got, want = vg.fit_exponential_variogram(r, gamma), ref_vg.fit_exponential_variogram(r, gamma)
    assert {k: got[k] for k in ("nugget", "sill", "a")} == \
        {k: want[k] for k in ("nugget", "sill", "a")}
    assert got["model"](0.5) == want["model"](0.5)
    assert vg.fit_exponential_variogram(r[:4], gamma[:4])["model"] is None
    assert vg.variogram_range(r, gamma) == ref_vg.variogram_range(r, gamma)
    assert vg.variogram_range(r, np.full(35, np.nan)) is None
    resid, fit = vg.detrend_poly2d(f_c, gx, gy)
    r_resid, r_fit = ref_vg.detrend_poly2d(f_c, gx, gy)
    np.testing.assert_array_equal(resid, r_resid)
    np.testing.assert_array_equal(fit, r_fit)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_variograms_vs_reference(dtype, tmp_path):
    """The slice as a whole at a small grid. The f32 escape potential is
    chaotic near the boundary (a pixel's escape step can differ between the
    two f32 implementations), so U_M is held where it counts: through the
    gammas."""
    csv_path = str(tmp_path / "out" / "vg.csv")
    got = pv.run_variograms(pv.VariogramConfig(vario_dtype=dtype, field_dtype=dtype, **SMALL),
                            csv_path, device="cpu")
    want = ref_pv.run_variograms(ref_pv.VariogramConfig(vario_dtype=dtype, field_dtype=dtype,
                                                        **SMALL))
    assert got["n_construct"] == want["n_construct"] == 60
    assert got["n_boundary"] == want["n_boundary"] > 100
    np.testing.assert_array_equal(got["r"], want["r"])
    f64 = dtype == "float64"
    for key in GAMMAS:
        assert _rel(got[key], want[key]) <= (1e-9 if f64 else 1e-3), key
    assert _rel(got["U_C"], want["U_C"]) <= (1e-9 if f64 else 1e-4)
    if f64:
        assert _rel(got["U_M"], want["U_M"]) <= 1e-8
    assert got["U_C"].shape == got["U_M"].shape == (36, 40)
    pairs = 500 * 499 // 2
    assert 0 < got["counts_construct"].sum() <= pairs
    assert 0 < got["counts_cross"].sum() <= 500 * 500
    assert set(got["stage_times"]) == {"cloud", "boundary", "potentials", "variograms"}
    rows = np.loadtxt(csv_path, delimiter=",", skiprows=1)
    with open(csv_path) as f:
        assert f.readline().strip() == "r_center,gamma_Construct,gamma_Mandelbrot,gamma_cross"
    np.testing.assert_array_equal(rows[:, 1], got["gamma_construct"])
    with open(os.path.splitext(csv_path)[0] + "_meta.txt") as f:
        meta = f.read()
    assert f"vario_dtype={dtype}" in meta and "boundary_grid=64" in meta


def test_run_variograms_options_and_errors():
    cfg = pv.VariogramConfig(detrend=True, fit_model=True, **SMALL)
    got = pv.run_variograms(cfg, device="cpu")
    want = ref_pv.run_variograms(ref_pv.VariogramConfig(detrend=True, fit_model=True, **SMALL))
    for key in GAMMAS:
        assert _rel(got[key], want[key]) <= 1e-8, key
    for key in ("fit_construct", "fit_mandelbrot"):
        for p in ("nugget", "sill", "a"):
            assert got[key][p] == pytest.approx(want[key][p], rel=1e-6, abs=1e-9)
    with pytest.raises(ValueError, match="dtype"):
        pv.run_variograms(pv.VariogramConfig(vario_dtype="float16"), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        pv.run_variograms(pv.VariogramConfig(**SMALL))  # no card here: no fallback


def test_config_defaults_equal_reference():
    import dataclasses

    assert dataclasses.asdict(pv.VariogramConfig()) == dataclasses.asdict(
        ref_pv.VariogramConfig())


def test_cli_variograms(tmp_path, monkeypatch, capsys):
    from cmtci_torch import cli

    seen = {}
    real = pv.run_variograms

    def small_run(cfg, out_csv, device, mesh=None):
        seen["cfg"] = cfg
        import dataclasses

        return real(dataclasses.replace(cfg, **SMALL), out_csv, device=device, mesh=mesh)

    monkeypatch.setattr(pv, "run_variograms", small_run)
    out = str(tmp_path / "run")
    cli.main(["variograms", "--device", "cpu", "--grid", "40", "--detrend", "--out", out])
    assert "variograms: 60 C pts" in capsys.readouterr().out
    cfg = seen["cfg"]
    assert (cfg.grid_nx, cfg.detrend, cfg.fit_model) == (40, True, False)
    # a CPU session defaults both dtypes to f64; an explicit flag wins
    assert (cfg.vario_dtype, cfg.field_dtype) == ("float64", "float64")
    assert os.path.exists(out + "_variograms.csv")
    assert os.path.exists(out + "_variograms_meta.txt")
    cli.main(["variograms", "--device", "cpu", "--vario-dtype", "float32", "--out", out])
    assert (seen["cfg"].vario_dtype, seen["cfg"].field_dtype) == ("float32", "float64")
