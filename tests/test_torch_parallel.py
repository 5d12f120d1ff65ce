"""cmtci_torch.parallel: the sharded heads and steps on spawned gloo groups.

Each world size (2 and 3 CPU ranks) is one group, spawned once for the
module by ``parallel.launch.run``; every rank runs the same list of calls
(the heads of ``parallel.sharded``, the library functions that take a
``mesh=``, the tracker and analysis steps and the dry run) on the same
inputs, made here with numpy from a seed. Each result is held to the port's
single-device function in this process (a one-rank Mesh, which touches no
process group) and to ``cmtci.parallel.sharded`` on as many of the 8
virtual CPU devices: bitwise where the reference's own tests are bitwise,
else at their thresholds (rtol 1e-12 on f64 sums reduced over ranks, 1e-10
on the Green rows, >= 99% equal pixels on the synthesized f32 dwell grid),
and at rel 1e-9 against the reference on f64 paths. The uneven splits (101
grid rows, 997 points, 193 matcher rows, 37 angles over 2 and 3 ranks)
exercise the padding.
"""

import numpy as np
import pytest
import torch

from cmtci_torch.kernels import companion as pcomp
from cmtci_torch.kernels import mandelbrot as pmb
from cmtci_torch.parallel import sharded
from cmtci_torch.parallel.launch import Call

DOMAIN = (-2.25, 1.25, -1.75, 1.75)
TRACKER_DOMAIN = (-2.2, 1.2, -1.6, 1.6)
SIZES = (2, 3)
NS = [5, 8, 11, 14, 17, 20, 23, 26, 29, 32]
STEP = dict(ns=list(range(4, 84, 4)), domain=DOMAIN, grid_n=96, n_samples=400, bins=16,
            max_iter=32, sigma_bins=1.0, alpha=0.1, t_steps=5, chunk=64)
STEP_KEYS = (0, 1, 2, 3, 4)
ANALYSIS = dict(ns=[5, 8, 11, 14, 17, 20, 23, 26], domain=DOMAIN, grid_n=48, bins=16,
                max_iter=40)


def _inputs():
    rng = np.random.default_rng(0)
    gx, gy = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
    g20 = np.linspace(0, 1, 20)
    vx, vy = np.meshgrid(g20, g20)
    return {
        "hist_x": rng.uniform(-3, 2, 997), "hist_y": rng.uniform(-2, 2, 997),
        "sv_coords": np.column_stack([gx.ravel(), gy.ravel()]),
        "sv_vals": rng.normal(size=256), "sv_edges": np.linspace(0, 0.9, 10),
        "c1": rng.uniform(size=(200, 2)), "v1": rng.normal(size=200),
        "c2": rng.uniform(size=(150, 2)), "v2": rng.normal(size=150),
        "bsd_edges": np.linspace(0, 1.2, 9),
        "pv_locs": rng.uniform(size=(257, 2)), "pv_vals": rng.normal(size=257),
        "shell_pts": rng.uniform(size=(919, 2)),
        "knn_xy": rng.normal(size=(500, 2)),
        "sym_pts": rng.normal(size=(200, 2)),
        "green_pts": (rng.uniform(-2, 1, 400) + 1j * rng.uniform(-1.5, 1.5, 400)),
        "pot_pts": rng.uniform(-1.5, 1.0, size=(501, 2)),
        "match_a": rng.normal(size=(193, 2)), "match_b": rng.normal(size=(89, 2)),
        "cloud": rng.uniform(-2, 1, 1000) + 1j * rng.uniform(-1.5, 1.5, 1000),
        "mx": rng.normal(size=300) + 1j * rng.normal(size=300),
        "my": rng.normal(size=300) + 1j * rng.normal(size=300),
        "emb_pts": rng.normal(size=(300, 2)),
        "vfc": np.sin(6 * vx) + 0.1 * vy, "vfm": np.cos(5 * vy) - 0.2 * vx,
        "vgx": vx, "vgy": vy,
    }


X = _inputs()
S = "cmtci_torch.parallel.sharded:"
CALLS = {
    "dwell_grid": Call(S + "sharded_dwell_grid", (DOMAIN, 64, 66, 50)),
    "dwell_field": Call(S + "sharded_dwell_field", (DOMAIN, 64, 101, 50)),
    "de_field": Call(S + "sharded_de_tci_field", (DOMAIN, 101), {"max_iter": 40}),
    "eigensweep": Call(S + "sharded_eigensweep", (NS,)),
    "histogram": Call(S + "sharded_histogram", (X["hist_x"], X["hist_y"], 32, DOMAIN)),
    "semivariogram": Call(S + "sharded_semivariogram",
                          (X["sv_coords"], X["sv_vals"], X["sv_edges"]), {"chunk": 16}),
    "bsd_upper": Call(S + "sharded_binned_sq_diff",
                      (X["c1"], X["v1"], X["c1"], X["v1"], X["bsd_edges"]),
                      {"upper": True, "chunk": 16}),
    "bsd_cross": Call(S + "sharded_binned_sq_diff",
                      (X["c1"], X["v1"], X["c2"], X["v2"], X["bsd_edges"]),
                      {"upper": False, "chunk": 16}),
    "pv_values": Call(S + "sharded_point_variogram", (X["pv_locs"], X["pv_vals"]),
                      {"nbins": 14, "chunk": 16}),
    "pv_coords": Call(S + "sharded_point_variogram", (X["pv_locs"], None),
                      {"nbins": 14, "chunk": 16}),
    "pv_maxdist": Call(S + "sharded_point_variogram", (X["pv_locs"], X["pv_vals"]),
                       {"max_dist": 0.7, "nbins": 14, "chunk": 16}),
    "shells64": Call(S + "sharded_shell_counts", (X["shell_pts"], 0.5, 0.05), {"chunk": 64}),
    "shells32": Call(S + "sharded_shell_counts", (X["shell_pts"], 0.5, 0.05),
                     {"chunk": 64, "dtype": torch.float32}),
    "knn": Call(S + "sharded_knn", (X["knn_xy"], 10), {"chunk": 32}),
    "angles": Call(S + "sharded_score_angles",
                   (X["sym_pts"], np.linspace(0, np.pi, 37), 0.05)),
    "green": Call(S + "sharded_green_cloud", (X["green_pts"],),
                  {"max_iter": 600, "stage_iters": 128}),
    "green32": Call(S + "sharded_green_cloud_f32", (X["green_pts"],), {"max_iter": 600}),
    "pot64": Call(S + "sharded_cloud_potential", (DOMAIN, 48, 48, X["pot_pts"]),
                  {"sign": 1, "dtype": torch.float64, "chunk": 128}),
    "pot32": Call(S + "sharded_cloud_potential", (DOMAIN, 48, 48, X["pot_pts"]),
                  {"sign": 1, "dtype": torch.float32, "chunk": 128}),
    "pot_neg": Call(S + "sharded_cloud_potential", (DOMAIN, 48, 48, X["pot_pts"]),
                    {"sign": -1, "dtype": torch.float64, "chunk": 128}),
    "match": Call(S + "sharded_argmax_match", (X["match_a"], X["match_b"], 0.8),
                  {"chunk": 16}),
    # the library functions' mesh= routes
    "mollified": Call("cmtci_torch.transport.histogram:mollified_histogram",
                      (X["cloud"], 32, TRACKER_DOMAIN, 3.0)),
    "entropic": Call("cmtci_torch.transport.sinkhorn:entropic_argmax_match",
                     (X["mx"], X["my"]), {"eps": 0.8, "rng": np.random.RandomState(3)}),
    "sample": Call("cmtci_torch.kernels.mandelbrot:sample_boundary_quantile",
                   (TRACKER_DOMAIN, 120, 400),
                   {"max_iter": 60, "rng": np.random.RandomState(3), "impl": "torch"}),
    "three": Call("cmtci_torch.stats.variogram:three_semivariograms",
                  (X["vfc"], X["vfm"], X["vgx"], X["vgy"], np.linspace(0, 0.9, 10), 250,
                   np.random.RandomState(7))),
    "shell_route": Call("cmtci_torch.stats.pointstats:_shell_counts",
                        (X["shell_pts"], 0.8, 0.05)),
    "axis": Call("cmtci_torch.stats.symmetry:best_reflection_axis",
                 (X["sym_pts"], X["sym_pts"] * 0.99), {"n_angles": 37}),
    "diffusion": Call("cmtci_torch.stats.embeddings:diffusion_map", (X["emb_pts"],),
                      {"k": 10}),
    # the steps and the dry run
    **{f"step{k}": Call(S + "tracker_train_step", (), dict(STEP, key=k)) for k in STEP_KEYS},
    "analysis": Call(S + "analysis_step", (), ANALYSIS),
    "dryrun": Call("cmtci_torch.parallel.dryrun:dryrun_rank", (None,)),
}
NAMES = list(CALLS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in the other torch test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{world size: one dict per rank} of the calls above."""
    from cmtci_torch.parallel import launch

    out = {}
    for n in SIZES:
        calls = [Call(c.fn, (n,), c.kwargs) if name == "dryrun" else c
                 for name, c in CALLS.items()]
        out[n] = launch.run(n, calls, device="cpu", threads=1,
                            workdir=tmp_path_factory.mktemp(f"group{n}"))
    return out


def got(groups, n, name):
    return groups[n][0]["results"][NAMES.index(name)]


ONE = sharded.Mesh(group=None, rank=0, size=1, device=torch.device("cpu"), backend="gloo")


def ref_mesh(n):
    from cmtci.parallel import sharded as rs

    return rs.device_mesh(n)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a if k != "lines")
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")
    if isinstance(a, float) and np.isnan(a):
        return np.isnan(b)
    return a == b


@pytest.mark.parametrize("n", SIZES)
def test_every_rank_returns_the_full_result_and_holds_no_jax(groups, n):
    ranks = groups[n]
    assert [r["rank"] for r in ranks] == list(range(n))
    for r in ranks:
        assert r["foreign_modules"] == [], r["foreign_modules"]
        for name, a, b in zip(NAMES, ranks[0]["results"], r["results"]):
            assert _same(a, b), (name, r["rank"])


@pytest.mark.parametrize("n", SIZES)
def test_dwell_grid(groups, n):
    got_ = got(groups, n, "dwell_grid")
    ref_one = sharded.sharded_dwell_grid(DOMAIN, 64, 66, 50, ONE).numpy()
    np.testing.assert_array_equal(got_, ref_one)
    from cmtci.parallel import sharded as rs

    want = np.asarray(rs.sharded_dwell_grid(DOMAIN, 64, 66, 50, ref_mesh(n)))
    assert (got_ == want).mean() > 0.99  # the reference's own f32 threshold


@pytest.mark.parametrize("n", SIZES)
def test_dwell_field(groups, n):
    """K2's rows on each rank (the twin on CPU ranks), 101 rows over 2 and
    3 ranks: bitwise the single-device K2 field; the reference's f32 dwell
    loop on the same f32 nodes at its own threshold."""
    import jax.numpy as jnp

    from cmtci.kernels import mandelbrot as rmb
    from cmtci_torch.kernels import mandelbrot_cuda as mc

    got_ = got(groups, n, "dwell_field")
    np.testing.assert_array_equal(got_, mc.mandelbrot_field(DOMAIN, 64, 101, 50,
                                                            device="cpu").numpy())
    cr, ci = (jnp.asarray(c.numpy()) for c in mc._grid_coords(DOMAIN, 64, 101, "cpu"))
    assert (got_ == np.asarray(rmb.dwell_grid(cr, ci, 50))).mean() > 0.99


@pytest.mark.parametrize("row0,rows", [(0, 33), (33, 34), (67, 34), (100, 1), (101, 0)])
def test_dwell_rows_are_the_grids_rows(row0, rows):
    """dwell_rows (K2's row entry; its twin here) is bitwise the rows
    [row0, row0 + rows) of the whole K2 grid, and dwell.cu's kernel takes
    its rows' ci from the whole grid's nodes."""
    from pathlib import Path

    from cmtci_torch.kernels import mandelbrot_cuda as mc

    whole = mc.mandelbrot_field(DOMAIN, 64, 101, 50, device="cpu")
    block = mc.dwell_rows(DOMAIN, 64, 101, row0, rows, max_iter=50, device="cpu")
    assert block.shape == (rows, 64)
    assert torch.equal(block, whole[row0 : row0 + rows])
    text = (Path(mc.__file__).parent.parent / "csrc" / "dwell.cu").read_text()
    assert "const float ci = ymin + (float)(row0 + row) * dy;" in text
    assert "return dwell_rows_launch(out, nx, ny, 0, xmin, ymin, dx, dy, max_iter, stream);" \
        in text
    with pytest.raises(ValueError, match="outside a grid"):
        mc.dwell_rows(DOMAIN, 64, 101, row0, 102 - row0, device="cpu")


@pytest.mark.parametrize("n", SIZES)
def test_de_tci_field(groups, n):
    import jax.numpy as jnp

    from cmtci.parallel import sharded as rs

    esc, d = got(groups, n, "de_field")
    cr, ci = pmb.complex_grid(DOMAIN, 101, 101, device="cpu")
    e1, d1, _, _ = pmb.de_field_tci(cr, ci, max_iter=40)
    np.testing.assert_array_equal(esc, e1.numpy())
    np.testing.assert_array_equal(d, d1.numpy())
    er, dr = rs.sharded_de_tci_field(DOMAIN, 101, ref_mesh(n), max_iter=40,
                                     grid=(jnp.asarray(cr.numpy()), jnp.asarray(ci.numpy())))
    np.testing.assert_array_equal(esc, er)
    np.testing.assert_allclose(d, dr, rtol=1e-9, atol=0)


@pytest.mark.parametrize("n", SIZES)
def test_eigensweep(groups, n):
    from cmtci.parallel import sharded as rs

    zr, zi, valid = got(groups, n, "eigensweep")
    r1, i1, v1 = pcomp.eigvals_batched(NS, device="cpu")
    np.testing.assert_array_equal(valid, v1.numpy())
    np.testing.assert_array_equal(zr, r1.numpy())
    np.testing.assert_array_equal(zi, i1.numpy())
    rr, ri, rv = (np.asarray(a) for a in rs.sharded_eigensweep(NS, mesh=ref_mesh(n)))
    np.testing.assert_array_equal(valid, rv)
    np.testing.assert_allclose(zr[valid], rr[rv], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(zi[valid], ri[rv], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", SIZES)
def test_histogram(groups, n):
    import jax.numpy as jnp

    from cmtci.parallel import sharded as rs
    from cmtci_torch.transport.histogram import _histogram2d_np

    h = got(groups, n, "histogram")
    np.testing.assert_array_equal(h, _histogram2d_np(X["hist_x"], X["hist_y"], 32, DOMAIN))
    pad = -len(X["hist_x"]) % n  # the reference's shard_map needs a mesh multiple
    want = rs.sharded_histogram(jnp.pad(jnp.asarray(X["hist_x"]), (0, pad),
                                        constant_values=DOMAIN[1] + 1.0),
                                jnp.pad(jnp.asarray(X["hist_y"]), (0, pad),
                                        constant_values=DOMAIN[3] + 1.0), 32, DOMAIN,
                                ref_mesh(n))
    np.testing.assert_array_equal(h, np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
def test_semivariogram(groups, n):
    from cmtci.parallel import sharded as rs
    from cmtci_torch.stats import variogram as vg

    g, c = got(groups, n, "semivariogram")
    f = X["sv_vals"].reshape(16, 16)
    gx, gy = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
    _, g1, c1 = vg.grid_semivariogram(f, gx, gy, X["sv_edges"], m_target=256,
                                      rng=np.random.RandomState(0), device="cpu")
    np.testing.assert_array_equal(c, c1)
    np.testing.assert_allclose(g, g1, rtol=1e-12)
    gr, cr_ = rs.sharded_semivariogram(X["sv_coords"], X["sv_vals"], X["sv_edges"],
                                       ref_mesh(n), chunk=16)
    np.testing.assert_array_equal(c, cr_)
    np.testing.assert_allclose(g, gr, rtol=1e-9)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["bsd_upper", "bsd_cross"])
def test_binned_sq_diff(groups, n, kind):
    from cmtci.parallel import sharded as rs
    from cmtci_torch.stats.variogram import _binned_sq_diff

    upper = kind == "bsd_upper"
    c2, v2 = (X["c1"], X["v1"]) if upper else (X["c2"], X["v2"])
    s, c = got(groups, n, kind)
    t = [torch.as_tensor(a) for a in (X["c1"], X["v1"], c2, v2, X["bsd_edges"])]
    s1, c1 = _binned_sq_diff(*t[:4], t[4], 8, 64, upper)
    np.testing.assert_array_equal(c, c1.numpy())
    np.testing.assert_allclose(s, s1.numpy(), rtol=1e-12)
    sr, cr_ = rs.sharded_binned_sq_diff(X["c1"], X["v1"], c2, v2, X["bsd_edges"],
                                        ref_mesh(n), upper=upper, chunk=16)
    np.testing.assert_array_equal(c, cr_)
    np.testing.assert_allclose(s, sr, rtol=1e-9)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["pv_values", "pv_coords", "pv_maxdist"])
def test_point_variogram(groups, n, kind):
    from cmtci.parallel import sharded as rs
    from cmtci_torch.stats import variogram as vg

    values = None if kind == "pv_coords" else X["pv_vals"]
    max_dist = 0.7 if kind == "pv_maxdist" else None
    centers, gamma, counts = got(groups, n, kind)
    c1, g1, n1 = vg.point_variogram_device(X["pv_locs"], values, max_dist=max_dist,
                                           nbins=14, chunk=16, device="cpu")
    np.testing.assert_array_equal(counts, n1)
    np.testing.assert_array_equal(centers, c1)
    np.testing.assert_allclose(gamma, g1, rtol=1e-12)
    cr_, gr, nr = rs.sharded_point_variogram(X["pv_locs"], values, max_dist=max_dist,
                                             nbins=14, mesh=ref_mesh(n), chunk=16)
    np.testing.assert_array_equal(counts, nr)
    np.testing.assert_allclose(centers, cr_, rtol=1e-12)
    nz = nr > 0
    np.testing.assert_allclose(gamma[nz], gr[nz], rtol=1e-9)
    assert np.isnan(gamma[~nz]).all()


@pytest.mark.parametrize("n", SIZES)
def test_shell_counts(groups, n):
    from cmtci.parallel import sharded as rs
    from cmtci_torch.stats import pointstats as ps

    r, c, n_pts, rho = got(groups, n, "shells64")
    r1, c1, n1, rho1 = ps._shell_counts(X["shell_pts"], 0.5, 0.05, device="cpu")
    np.testing.assert_array_equal(r, r1)
    np.testing.assert_array_equal(c, c1)
    assert (n_pts, rho) == (n1, rho1)
    _, c32, _, _ = got(groups, n, "shells32")
    _, c32_1, _, _ = ps._shell_counts(X["shell_pts"], 0.5, 0.05, dtype=torch.float32,
                                      device="cpu")
    np.testing.assert_array_equal(c32, c32_1)
    rr, cr_, nr, rhor = rs.sharded_shell_counts(X["shell_pts"], 0.5, 0.05, ref_mesh(n),
                                                chunk=64)
    np.testing.assert_array_equal(c, cr_)
    assert n_pts == nr and rho == rhor
    # the tuple drops into the stats wrappers unchanged
    _, g_mesh = ps.pair_correlation(X["shell_pts"], 0.5, 0.05, _shells=(r, c, n_pts, rho))
    _, g_one = ps.pair_correlation(X["shell_pts"], 0.5, 0.05, device="cpu")
    np.testing.assert_array_equal(g_mesh, g_one)


@pytest.mark.parametrize("n", SIZES)
def test_knn(groups, n):
    from cmtci.parallel import sharded as rs
    from cmtci_torch.stats.embeddings import _knn

    d, i = got(groups, n, "knn")
    d1, i1 = _knn(torch.as_tensor(X["knn_xy"]), 10, chunk=32)
    np.testing.assert_array_equal(i, i1.numpy())
    np.testing.assert_array_equal(d, d1.numpy())
    dr, ir = rs.sharded_knn(X["knn_xy"], 10, ref_mesh(n), chunk=32)
    np.testing.assert_array_equal(i, ir)
    np.testing.assert_allclose(d, dr, rtol=1e-9)


@pytest.mark.parametrize("n", SIZES)
def test_score_angles(groups, n):
    from cmtci.parallel import sharded as rs
    from cmtci_torch.stats.symmetry import _score_angles

    angles = np.linspace(0, np.pi, 37)
    f = got(groups, n, "angles")
    np.testing.assert_array_equal(f, _score_angles(X["sym_pts"], angles, 0.05, device="cpu"))
    np.testing.assert_allclose(f, rs.sharded_score_angles(X["sym_pts"], angles, 0.05,
                                                          ref_mesh(n)), rtol=1e-9)


@pytest.mark.parametrize("n", SIZES)
def test_green_cloud(groups, n):
    from cmtci.parallel import sharded as rs

    g, k, phi = got(groups, n, "green")
    g1, k1, p1 = pmb.green_potential_compacted(X["green_pts"], max_iter=600,
                                               stage_iters=128, device="cpu")
    np.testing.assert_array_equal(k, k1)
    np.testing.assert_allclose(g, g1, rtol=1e-10, atol=0)
    np.testing.assert_allclose(phi, p1, rtol=1e-10, atol=0)
    gr, kr, _ = rs.sharded_green_cloud(X["green_pts"], max_iter=600, mesh=ref_mesh(n),
                                       stage_iters=128)
    np.testing.assert_array_equal(k, kr)
    # atol: the deep escapers' g runs down to 1e-53 (log|z_k| 2^-k), where
    # XLA's contracted f64 orbit differs from the port's in the last bits
    np.testing.assert_allclose(g, gr, rtol=1e-9, atol=1e-30)


@pytest.mark.parametrize("n", SIZES)
def test_green_cloud_f32(groups, n):
    """The f32 K3 head on each rank's block of points (the twin on CPU
    ranks): bitwise the single-device head."""
    from cmtci_torch.kernels import mandelbrot_cuda as mc

    g, k, phi = got(groups, n, "green32")
    g1, k1, p1 = mc.green_cloud_f32(X["green_pts"], max_iter=600, device="cpu")
    assert k.dtype == k1.dtype and phi.dtype == p1.dtype
    np.testing.assert_array_equal(k, k1)
    np.testing.assert_array_equal(g, g1)
    np.testing.assert_array_equal(phi, p1)


def _synth_grid(dt):
    xmin, xmax, ymin, ymax = DOMAIN
    cols, rows = torch.arange(48, dtype=dt), torch.arange(48, dtype=dt)
    gx = (xmin + cols[None, :] * ((xmax - xmin) / 47)).expand(48, 48).numpy()
    gy = (ymin + rows[:, None] * ((ymax - ymin) / 47)).expand(48, 48).numpy()
    return gx, gy


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["pot64", "pot32", "pot_neg"])
def test_cloud_potential(groups, n, kind):
    import jax.numpy as jnp

    from cmtci.parallel import sharded as rs
    from cmtci_torch.kernels.potential import cloud_log_potential

    dt = torch.float32 if kind == "pot32" else torch.float64
    sign = -1 if kind == "pot_neg" else 1
    u = got(groups, n, kind)
    gx, gy = _synth_grid(dt)
    u1 = cloud_log_potential(gx, gy, X["pot_pts"], sign=sign, chunk=128, device="cpu")
    np.testing.assert_array_equal(u, u1.numpy())
    want = np.asarray(rs.sharded_cloud_potential(
        DOMAIN, 48, 48, X["pot_pts"], ref_mesh(n), sign=sign,
        dtype=jnp.float32 if kind == "pot32" else jnp.float64, chunk=128))
    if kind == "pot32":  # XLA contracts the f32 sums; one f32 rounding of the sum
        np.testing.assert_allclose(u, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(u, want, rtol=1e-9)


def test_cloud_potential_on_a_given_grid():
    """grid= slices the caller's nodes: the coupling's meshgrid, bitwise."""
    from cmtci_torch.kernels.potential import cloud_log_potential

    gx, gy = np.meshgrid(np.linspace(-2, 1, 30), np.linspace(-1.5, 1.5, 29))
    u = sharded.sharded_cloud_potential(None, 30, 29, X["pot_pts"], ONE, grid=(gx, gy))
    np.testing.assert_array_equal(
        u.numpy(), cloud_log_potential(gx, gy, X["pot_pts"], device="cpu").numpy())


@pytest.mark.parametrize("n", SIZES)
def test_argmax_match(groups, n):
    from cmtci.parallel import sharded as rs
    from cmtci_torch.transport.sinkhorn import _argmax_kernel_rows, _blocked_mean_dist

    m = got(groups, n, "match")
    a, b = torch.as_tensor(X["match_a"]), torch.as_tensor(X["match_b"])
    # the single-device blocked matcher with the same chunks: bitwise
    want = _argmax_kernel_rows(a, b, _blocked_mean_dist(a, b, chunk=16), 0.8, chunk=16)
    np.testing.assert_array_equal(m, want.numpy())
    np.testing.assert_array_equal(m, rs.sharded_argmax_match(X["match_a"], X["match_b"],
                                                             0.8, ref_mesh(n), chunk=16))


@pytest.mark.parametrize("n", SIZES)
def test_library_mesh_routes(groups, n):
    """The library functions' mesh= routes equal their single-device paths."""
    from cmtci_torch.stats import embeddings as emb
    from cmtci_torch.stats import pointstats as ps
    from cmtci_torch.stats import symmetry as sym
    from cmtci_torch.stats import variogram as vg
    from cmtci_torch.transport import histogram as hg
    from cmtci_torch.transport.sinkhorn import entropic_argmax_match

    np.testing.assert_array_equal(got(groups, n, "mollified"),
                                  hg.mollified_histogram(X["cloud"], 32, TRACKER_DOMAIN, 3.0))
    m, c = got(groups, n, "entropic")
    m1, c1 = entropic_argmax_match(X["mx"], X["my"], eps=0.8, rng=np.random.RandomState(3),
                                   device="cpu")
    np.testing.assert_array_equal(m, m1)
    np.testing.assert_array_equal(c, c1)
    np.testing.assert_array_equal(
        got(groups, n, "sample"),
        pmb.sample_boundary_quantile(TRACKER_DOMAIN, 120, 400, max_iter=60,
                                     rng=np.random.RandomState(3), impl="torch",
                                     device="cpu"))
    three = got(groups, n, "three")
    three1 = vg.three_semivariograms(X["vfc"], X["vfm"], X["vgx"], X["vgy"],
                                     np.linspace(0, 0.9, 10), 250, np.random.RandomState(7),
                                     device="cpu")
    np.testing.assert_array_equal(three[0], three1[0])
    for k in (1, 2, 3):
        np.testing.assert_allclose(three[k], three1[k], rtol=1e-12, atol=1e-15)
    for k in (4, 5, 6):
        np.testing.assert_array_equal(three[k], three1[k])
    for a, b in zip(got(groups, n, "shell_route"),
                    ps._shell_counts(X["shell_pts"], 0.8, 0.05, device="cpu")):
        np.testing.assert_array_equal(a, b)
    axis = got(groups, n, "axis")
    axis1 = sym.best_reflection_axis(X["sym_pts"], X["sym_pts"] * 0.99, n_angles=37,
                                     device="cpu")
    assert axis["angle"] == axis1["angle"]
    np.testing.assert_array_equal(axis["scan_score"], axis1["scan_score"])
    assert (axis["frac_a"], axis["frac_b"]) == (axis1["frac_a"], axis1["frac_b"])
    vals, _, sigma = got(groups, n, "diffusion")
    vals1, _, sigma1 = emb.diffusion_map(X["emb_pts"], k=10, device="cpu")
    assert sigma == sigma1
    np.testing.assert_allclose(vals, vals1, rtol=1e-12)


def test_tracker_train_step_bitwise_across_world_sizes(groups):
    for k in STEP_KEYS:
        one = sharded.tracker_train_step(ONE, key=k, **STEP)
        for n in SIZES:
            assert got(groups, n, f"step{k}") == one, (k, n)
        assert 0 < STEP["n_samples"] <= min(one["n_escaped"], one["n_valid_roots"])
        assert one["kl_initial"] >= one["delta_n"] >= 0.0


def test_tracker_train_step_host_cloud_and_flow():
    """cloud= (host_tracker_cloud, the f64 sweep on the host) gives the
    in-step sweep's diagnostics within rtol 1e-6 (the reference's own
    threshold), and more GI steps contract the flow further."""
    small = dict(STEP, ns=list(range(4, 68, 4)), grid_n=64, n_samples=64, chunk=8)
    a = sharded.tracker_train_step(ONE, key=0, **small)
    b = sharded.tracker_train_step(ONE, key=0, cloud=sharded.host_tracker_cloud(small["ns"]),
                                   **small)
    for k in a:
        assert b[k] == pytest.approx(a[k], rel=1e-6), k
    c = sharded.tracker_train_step(ONE, key=0, **{**small, "t_steps": 20})
    assert a["kl_initial"] == c["kl_initial"] > a["delta_n"] > c["delta_n"] >= 0.0


def test_tracker_train_step_against_the_reference(groups):
    """jax.random's Gumbel draws cannot be reproduced: the step is held to
    the reference's statistically, each key's diagnostics averaged over five
    keys, in the sampler's bands (delta_n within 50%, TV and overlap within
    25%), with the deterministic counts equal."""
    import jax

    from cmtci.parallel import sharded as rs

    mesh = ref_mesh(2)
    step = jax.jit(lambda key: rs.tracker_train_step(mesh, key=key, **STEP))
    refs = [{k: float(v) for k, v in step(jax.random.key(k)).items()} for k in STEP_KEYS]
    ours = [got(groups, 2, f"step{k}") for k in STEP_KEYS]

    def mean(rows, key):
        return float(np.mean([r[key] for r in rows]))

    assert ours[0]["n_valid_roots"] == refs[0]["n_valid_roots"]
    assert abs(ours[0]["n_escaped"] - refs[0]["n_escaped"]) <= 0.01 * refs[0]["n_escaped"]
    for key, band in (("delta_n", 0.5), ("kl_initial", 0.5), ("tv_XT_PM", 0.25),
                      ("tv_PC_PM", 0.25), ("overlap_mass_PC_PM", 0.25)):
        assert abs(mean(ours, key) - mean(refs, key)) <= band * mean(refs, key), key


def test_analysis_step(groups):
    from cmtci.parallel import sharded as rs

    one = sharded.analysis_step(mesh=ONE, **ANALYSIS)
    for n in SIZES:
        assert got(groups, n, "analysis") == one, n
    assert one["n_roots"] == sum(ANALYSIS["ns"])
    assert 0.0 < one["escaped_frac"] < 1.0 and one["kl"] > 0
    # the reference's f32 dwell grid comes from XLA, which contracts
    # xmin + i*dx into an FMA: a few pixels flip, and the escape-proxy
    # histogram's KL moves by them
    ref = {k: float(v) for k, v in rs.analysis_step(mesh=ref_mesh(2), **ANALYSIS).items()}
    assert one["n_roots"] == ref["n_roots"]
    assert abs(one["escaped_frac"] - ref["escaped_frac"]) <= 1e-3
    assert abs(one["kl"] - ref["kl"]) <= 1e-2 * ref["kl"]


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_rank(groups, n):
    out = got(groups, n, "dryrun")
    assert out["lines"][0].startswith(f"[dryrun_multichip] n={n} ")
    assert out["pairs"] > 0 and out["shells"] > 0 and np.isfinite(out["u_mean"])


def test_dryrun_multichip_spawns_its_own_group(tmp_path, capsys):
    from cmtci_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, workdir=str(tmp_path))
    assert "[dryrun_multichip] n=2 " in capsys.readouterr().out
    assert out["n_escaped"] > 16 and 0.0 <= out["delta_n"] <= out["kl_initial"]


def test_refusals():
    """Outside a group a mesh of several ranks cannot be made; the heads
    that synthesize rows need a mesh multiple; the f32 device paths and the
    kernel head are single-device."""
    two = sharded.Mesh(group=None, rank=0, size=2, device=torch.device("cpu"),
                       backend="gloo")
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        sharded.device_mesh(2)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        sharded.sharded_dwell_grid(DOMAIN, 16, 13, 10, two)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        sharded.sharded_cloud_potential((-1, 1, -1, 1), 16, 13, np.zeros((4, 2)), two)
    from cmtci_torch.stats.embeddings import build_sparse_kernel
    from cmtci_torch.stats.symmetry import best_reflection_axis

    with pytest.raises(ValueError, match="mutually exclusive"):
        build_sparse_kernel(X["emb_pts"], mesh=ONE, dtype=torch.float32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        best_reflection_axis(X["sym_pts"], X["sym_pts"], mesh=ONE, dtype=torch.float64)
    with pytest.raises(ValueError, match="single-device kernel head"):
        pmb.sample_boundary_quantile(TRACKER_DOMAIN, 64, 100, impl="cuda", mesh=ONE)


def test_masked_quantile():
    vals = torch.tensor([3.0, 1.0, 2.0])
    q = sharded._masked_quantile(vals, torch.zeros(3, dtype=torch.bool), 0.25)
    assert torch.isinf(q) and q > 0  # the empty-mask sentinel
    m = torch.tensor([True, False, True])
    assert float(sharded._masked_quantile(vals, m, 0.25)) == np.quantile([3.0, 2.0], 0.25)
