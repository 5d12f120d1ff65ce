"""cmtci_torch's file-bus I/O and geometry against cmtci (the JAX reference)
on the CPU: the loaders and writers, the alpha shape, the resamplers, the
polygon (its blocked distance scan in torch against the exact numpy path),
export_lucas_boundary (defaults, skip_if_exists, cache_dir) and
construct_boundary.

io/loaders.py, geometry/{alpha_shape,resample}.py and the polygon's queries
are copies of numpy and scipy code, so they are held bitwise; the Lucas
boundary depends on the port's Aberth cloud, which differs in the last bits.
"""

import os

import numpy as np
import pytest
import torch

from cmtci.geometry import alpha_shape as ref_alpha
from cmtci.geometry import polygon as ref_polygon
from cmtci.geometry import resample as ref_resample
from cmtci.io import loaders as ref_loaders
from cmtci.io import writers as ref_writers
from cmtci.kernels import companion as ref_companion
from cmtci.pipelines import lucas_boundary as ref_lucas
from cmtci_torch.geometry import alpha_shape, polygon, resample
from cmtci_torch.io import loaders, writers
from cmtci_torch.kernels import companion
from cmtci_torch.pipelines import lucas_boundary as lucas


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
def cloud():
    """The stage-1 construct cloud (n = 2..40) as (N, 2)."""
    z = companion.inverse_cloud(list(range(2, 41)), tol=1e-12, device="cpu")
    return np.column_stack([z.real, z.imag])


def _ring(n=300, seed=4):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = 1 + 0.2 * np.cos(5 * t) + 0.01 * rng.standard_normal(n)
    return np.column_stack([r * np.cos(t), r * np.sin(t)])


def _hausdorff(a, b) -> float:
    from scipy.spatial.distance import directed_hausdorff

    return max(directed_hausdorff(a, b)[0], directed_hausdorff(b, a)[0])


@pytest.mark.parametrize("layout", ["header", "headerless", "one_col", "two_col",
                                    "swapped", "truncated"])
def test_loaders_against_cmtci(tmp_path, layout):
    pts = _ring(50)
    idx = np.random.default_rng(1).integers(0, 40, size=50)
    path = str(tmp_path / "f.csv")
    if layout == "header":
        np.savetxt(path, pts, delimiter=",", header="x,y", comments="")
    elif layout == "headerless":
        np.savetxt(path, pts, delimiter=",")
    elif layout in ("one_col", "truncated"):
        np.savetxt(path, idx, delimiter=",", fmt="%d")
    elif layout == "two_col":
        np.savetxt(path, np.c_[np.arange(50), idx], delimiter=",", fmt="%d")
    else:
        np.savetxt(path, np.c_[idx, np.arange(50)], delimiter=",", fmt="%d")
    if layout in ("header", "headerless"):
        got = loaders.load_points(path)
        np.testing.assert_array_equal(got, ref_loaders.load_points(path))
        np.testing.assert_array_equal(got, pts)
    else:
        n = 30 if layout == "truncated" else None
        got = loaders.load_matches(path, n)
        np.testing.assert_array_equal(got, ref_loaders.load_matches(path, n))
        np.testing.assert_array_equal(got, idx[:n])


def test_load_points_rejects_three_columns(tmp_path):
    path = str(tmp_path / "f.csv")
    np.savetxt(path, np.ones((4, 3)), delimiter=",")
    with pytest.raises(ValueError, match="2 columns"):
        loaders.load_points(path)


@pytest.mark.parametrize("writer", ["points", "matches", "curvature", "hist", "xy"])
def test_writers_byte_equal_cmtci(tmp_path, writer):
    p = _ring(40)
    rng = np.random.default_rng(6)
    k = rng.uniform(size=40)
    aux = {key: rng.normal(size=40) for key in ("xprime", "yprime", "x2", "y2")}
    args = {"points": (p[:, 0] + 1j * p[:, 1],), "matches": (rng.integers(0, 9, 40),),
            "curvature": (p, k, -k, k + 1, aux),
            "hist": (np.r_[k, np.nan, np.inf], 12), "xy": (p,)}[writer]
    name = {"xy": "write_xy_csv"}.get(writer, f"write_{writer}_csv")
    got = getattr(writers, name)(str(tmp_path / "port" / "f.csv"), *args)
    ref = getattr(ref_writers, name)(str(tmp_path / "ref" / "f.csv"), *args)
    assert open(got, "rb").read() == open(ref, "rb").read()


def test_alpha_shape_against_cmtci(cloud):
    for alpha in (4.5, 65.0):
        edges = alpha_shape.alpha_shape_edges(cloud, alpha)
        np.testing.assert_array_equal(edges, ref_alpha.alpha_shape_edges(cloud, alpha))
        got = alpha_shape.trace_boundary(cloud, edges)
        ref = ref_alpha.trace_boundary(cloud, edges)
        assert got[1] == ref[1] and list(got[0]) == list(ref[0])
    poly = alpha_shape.alpha_shape_polygon(cloud, 4.5)
    np.testing.assert_array_equal(poly.xy, ref_alpha.alpha_shape_polygon(cloud, 4.5).xy)
    with pytest.raises(RuntimeError, match="no triangles"):
        alpha_shape.alpha_shape_polygon(cloud, 1e6)


def test_resample_against_cmtci():
    ring = _ring(200)
    cw = ring[::-1]
    np.testing.assert_array_equal(resample.enforce_ccw(cw), ref_resample.enforce_ccw(cw))
    np.testing.assert_array_equal(resample.densify_boundary(ring, 700),
                                  ref_resample.densify_boundary(ring, 700))
    np.testing.assert_array_equal(resample.resample_closed_polyline(ring, 333),
                                  ref_resample.resample_closed_polyline(ring, 333))
    got = resample.sample_polygon_boundary(polygon.Polygon(cw), 250)
    ref = ref_resample.sample_polygon_boundary(ref_polygon.Polygon(cw), 250)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_polygon_queries_against_cmtci():
    ring = _ring(120)
    poly, ref = polygon.Polygon(ring), ref_polygon.Polygon(ring)
    rng = np.random.default_rng(8)
    q = rng.uniform(-1.4, 1.4, size=(500, 2))
    np.testing.assert_array_equal(poly.contains(q), ref.contains(q))
    np.testing.assert_array_equal(poly.contains(q, include_boundary=True, tol=0.02),
                                  ref.contains(q, include_boundary=True, tol=0.02))
    np.testing.assert_array_equal(poly.project(q), ref.project(q))
    np.testing.assert_array_equal(poly.interpolate([0.1, 2.0, 7.5]),
                                  ref.interpolate([0.1, 2.0, 7.5]))
    assert poly.centroid == ref.centroid and poly.area == ref.area
    np.testing.assert_array_equal(poly.exterior_distance(q[:100], device="cpu"),
                                  ref.exterior_distance(q[:100]))
    z = polygon.sample_interior_points(poly, 200, seed=3)
    z_ref = ref_polygon.sample_interior_points(ref, 200, seed=3)
    np.testing.assert_array_equal(z[0], z_ref[0])
    assert z[1] == z_ref[1]


@pytest.mark.parametrize("n_pts", [1024, 5000])
def test_distances_blocked_against_exact_path(n_pts):
    """The blocked torch scan (one block, and blocks with a remainder)
    against the exact numpy nearest-segment path and against cmtci's jitted
    scan."""
    ring = _ring(300)
    poly = polygon.Polygon(ring)
    q = np.random.default_rng(n_pts).uniform(-1.5, 1.5, size=(n_pts, 2))
    got = poly.exterior_distance(q, device="cpu")
    exact, _, _ = poly._nearest(q)
    np.testing.assert_allclose(got, exact, rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(got, ref_polygon.Polygon(ring).exterior_distance(q),
                               rtol=1e-14, atol=1e-15)


def test_distances_blocked_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    poly = polygon.Polygon(_ring(100))
    with pytest.raises(RuntimeError, match="cuda"):
        poly.exterior_distance(np.zeros((2000, 2)))


@pytest.fixture(scope="module")
def lucas_defaults():
    return (lucas.export_lucas_boundary(lucas.LucasBoundaryConfig(), device="cpu"),
            ref_lucas.export_lucas_boundary(ref_lucas.LucasBoundaryConfig()))


def test_export_lucas_boundary_defaults_against_cmtci(lucas_defaults):
    got, ref = lucas_defaults
    assert got.shape == (2000, 2)
    assert np.max(np.abs(got - ref)) <= 1e-12


def test_export_lucas_boundary_files_and_resume(tmp_path, lucas_defaults, monkeypatch):
    cfg = lucas.LucasBoundaryConfig()
    out = str(tmp_path / "run_lucas_points.npy")
    ref_out = str(tmp_path / "ref_lucas_points.npy")
    got = lucas.export_lucas_boundary(cfg, out, cache_dir=str(tmp_path / "cache"), device="cpu")
    np.testing.assert_array_equal(got, lucas_defaults[0])
    ref_writers.write_config_meta(f"{ref_out}_meta.txt", ref_lucas.LucasBoundaryConfig(),
                                  extra={"n_boundary_points": 2000})
    assert open(f"{out}_meta.txt").read() == open(f"{ref_out}_meta.txt").read()
    # each package reads the other's npy
    np.save(ref_out, lucas_defaults[1])
    np.testing.assert_array_equal(np.load(out), got)
    np.testing.assert_array_equal(np.load(ref_out), lucas_defaults[1])
    (entry,) = os.listdir(tmp_path / "cache")
    assert entry.startswith("lucas_boundary_")

    def no_compute(*a, **k):
        raise AssertionError("recomputed")

    monkeypatch.setattr(lucas, "_compute_lucas_boundary", no_compute)
    again = lucas.export_lucas_boundary(cfg, str(tmp_path / "b.npy"),
                                        cache_dir=str(tmp_path / "cache"), device="cpu")
    np.testing.assert_array_equal(again, got)
    np.testing.assert_array_equal(
        lucas.export_lucas_boundary(cfg, out, skip_if_exists=True, device="cpu"), got)
    # the reference's entry under the same config is another file
    ref_lucas.export_lucas_boundary(ref_lucas.LucasBoundaryConfig(n_max=20),
                                    cache_dir=str(tmp_path / "cache"))
    assert len(os.listdir(tmp_path / "cache")) == 2


def test_export_lucas_boundary_center_clip_against_cmtci():
    """With a center and a clip the two clouds' last bits move qhull's
    triangle order, and the alpha polygon starts at another vertex: the same
    polygon up to its start, and the resampled curves within one spacing."""
    kw = dict(n_max=40, alpha=3.0, n_boundary=400, center=-0.25 + 0.0j, radial_clip=1.5)
    got = lucas.export_lucas_boundary(lucas.LucasBoundaryConfig(**kw), device="cpu")
    ref = ref_lucas.export_lucas_boundary(ref_lucas.LucasBoundaryConfig(**kw))
    assert got.shape == ref.shape == (400, 2)
    polys = []
    for z in (companion.inverse_cloud(list(range(2, 41)), device="cpu"),
              ref_companion.inverse_cloud(list(range(2, 41)))):
        z = z + 0.25
        polys.append(alpha_shape.alpha_shape_polygon(z[np.abs(z) <= 1.5], 3.0).xy)
    start = int(np.argmin(np.abs(polys[1] - polys[0][0]).sum(axis=1)))
    assert np.max(np.abs(np.roll(polys[1], -start, axis=0) - polys[0])) <= 1e-12
    spacing = polygon.Polygon(ref).length / 400
    assert _hausdorff(got, ref) <= spacing


def test_construct_boundary_against_cmtci(tmp_path, cloud):
    cfg = lucas.ConstructBoundaryConfig()
    with pytest.warns(UserWarning, match="traced"):
        got, closed = lucas.construct_boundary(cloud, cfg, str(tmp_path / "port"))
    with pytest.warns(UserWarning, match="traced"):
        ref, ref_closed = ref_lucas.construct_boundary(
            cloud, ref_lucas.ConstructBoundaryConfig(), str(tmp_path / "ref"))
    assert got.shape == (1500, 2) and closed == ref_closed
    assert np.max(np.abs(got - ref)) <= 1e-12
    for suffix in ("_boundary.csv", "_meta.txt"):
        assert (open(tmp_path / f"port{suffix}", "rb").read()
                == open(tmp_path / f"ref{suffix}", "rb").read())
    with pytest.raises(RuntimeError, match="no boundary edges"):
        lucas.construct_boundary(cloud, lucas.ConstructBoundaryConfig(alpha=1e6))


def test_lucas_boundary_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        lucas.export_lucas_boundary(lucas.LucasBoundaryConfig(n_max=10))
