"""cmtci_torch's boundary slice against cmtci (the JAX reference), on the CPU:
the K2 dwell twin, the f64 dwell grid, the copied contour and laws modules,
run_boundary and the CLI.

The K2 kernel itself (csrc/dwell.cu) runs only on the card, where
chip_smoke.py holds it bitwise to dwell_field_torch; here the twin is held to
the Pallas kernel in interpret mode, at the size tests/test_pallas_kernel.py
uses.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.distance import directed_hausdorff

from cmtci.geometry import contour as ref_contour
from cmtci.io import writers as ref_writers
from cmtci.kernels import mandelbrot as ref_mb
from cmtci.kernels.mandelbrot_pallas import mandelbrot_field_pallas
from cmtci.pipelines import boundary as ref_boundary
from cmtci.stats import laws as ref_laws
from cmtci_torch import cli
from cmtci_torch.geometry import contour
from cmtci_torch.io import writers
from cmtci_torch.kernels import _build
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels import mandelbrot_cuda as mc
from cmtci_torch.pipelines import boundary
from cmtci_torch.stats import laws
from oracles import dwell_grid_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOM = (-2.1, 0.9, -1.5, 1.5)
NY, NX, ITERS = 64, 256, 100


def _hausdorff(a, b):
    return max(directed_hausdorff(a, b)[0], directed_hausdorff(b, a)[0])


@pytest.fixture(scope="module")
def twin():
    return mc.dwell_field_torch(DOM, NX, NY, ITERS, device="cpu").numpy()


def test_k2_twin_matches_pallas_interpret(twin):
    # XLA on the CPU may contract a*b+c into an FMA inside the interpreted
    # kernel, which flips an ulp-borderline pixel; the twin rounds each op:
    # at least 99.9% of pixels equal
    ref = np.asarray(mandelbrot_field_pallas(DOM, NX, NY, max_iter=ITERS, kind="dwell",
                                             tile=(32, 256)))
    assert twin.dtype == np.float32 and twin.shape == (NY, NX)
    assert (twin == ref).mean() >= 0.999


@pytest.mark.parametrize("shape,max_iter", [((NY, NX), ITERS), ((37, 61), 400),
                                            ((48, 96), 1000)])
def test_k2_twin_matches_f64_dwell(shape, max_iter):
    # the contract of test_pallas_kernel.py:12-18: above 99% of pixels equal,
    # here also on grids that are no tile multiple and at deeper max_iter
    ny, nx = shape
    twin = mc.dwell_field_torch(DOM, nx, ny, max_iter, device="cpu").numpy()
    cr, ci = ref_mb.complex_grid(DOM, nx, ny)
    ref = np.asarray(ref_mb.dwell_grid(np.asarray(cr), np.asarray(ci), max_iter=max_iter))
    assert (twin == ref).mean() > 0.99


@pytest.mark.parametrize("shape", [(64, 256), (50, 77)])
def test_f64_dwell_grid_is_integer_exact(shape):
    ny, nx = shape
    cr, ci = ref_mb.complex_grid(DOM, nx, ny)
    cr, ci = np.array(cr), np.array(ci)
    got = mb.dwell_grid(torch.from_numpy(cr), torch.from_numpy(ci), max_iter=ITERS).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(ref_mb.dwell_grid(cr, ci, max_iter=ITERS)))
    np.testing.assert_array_equal(got, dwell_grid_np(cr, ci, ITERS))


def test_mandelbrot_field_routes_on_cpu(twin):
    np.testing.assert_array_equal(
        mc.mandelbrot_field(DOM, NX, NY, max_iter=ITERS, device="cpu").numpy(), twin)
    with pytest.raises(ValueError, match="2 x 2"):
        mc.mandelbrot_field(DOM, 1, 32, device="cpu")
    # no launch on the CPU, whatever kernel libraries the port has
    assert mc.launches and all(v == 0 for v in mc.launches.values()), mc.launches


def test_mandelbrot_field_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mc.mandelbrot_field(DOM, 32, 32)


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    k1 = _build.source_digest("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    k2 = _build.source_digest("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    assert len({k1, k2, _build.source_digest("k")}) == 3


def test_contour_is_the_reference_copy(twin):
    xs = np.linspace(DOM[0], DOM[1], NX)
    ys = np.linspace(DOM[2], DOM[3], NY)
    level = 0.96 * ITERS
    np.testing.assert_array_equal(contour.contour_segments(xs, ys, twin, level),
                                  ref_contour.contour_segments(xs, ys, twin, level))
    got = contour.extract_contour(xs, ys, twin, level)
    np.testing.assert_array_equal(got, ref_contour.extract_contour(xs, ys, twin, level))
    np.testing.assert_array_equal(contour.dwell_boundary(xs, ys, twin, ITERS),
                                  ref_contour.dwell_boundary(xs, ys, twin, ITERS))


def test_laws_are_the_reference_copy():
    rng = np.random.RandomState(3)
    g = np.where(rng.uniform(size=500) < 0.2, 0.0, rng.exponential(0.1, 500))
    assert laws.summarize_g(g) == ref_laws.summarize_g(g)
    assert laws.summarize_outside(g[g > 0], 600) == ref_laws.summarize_outside(g[g > 0], 600)
    got, want = laws.compare_reference_laws(g), ref_laws.compare_reference_laws(g)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert laws.compare_reference_laws(g[:20]) is None
    grid = np.linspace(0, 0.5, 50)
    np.testing.assert_array_equal(laws.kde_or_smooth_hist(g, grid),
                                  ref_laws.kde_or_smooth_hist(g, grid))


def test_writers_match_reference(tmp_path):
    xy = np.random.RandomState(0).normal(size=(20, 2))
    rows = [{"a": 1, "b": 2.5}, {"a": 3, "c": "x"}]
    for mod, tag in ((writers, "port"), (ref_writers, "ref")):
        mod.write_xy_csv(str(tmp_path / tag / "b.csv"), xy)
        mod.write_dict_rows_csv(str(tmp_path / tag / "r.csv"), rows)
    for name in ("b.csv", "r.csv"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())
    assert (tmp_path / "port" / "b.csv").read_text().splitlines()[0] == "x,y"


@pytest.fixture(scope="module")
def ref_run():
    return ref_boundary.run_boundary(ref_boundary.BoundaryConfig(res=300, max_iter=120,
                                                                 backend="xla"))


def test_run_boundary_torch_vs_reference(ref_run, tmp_path):
    # the port builds its f64 grid on np.linspace nodes, the reference on
    # jnp.linspace nodes: vertex count within 1% and a symmetric Hausdorff of
    # at most one pixel spacing
    ref_path, ref_z = ref_run
    cfg = boundary.BoundaryConfig(res=300, max_iter=120, backend="torch")
    prefix = str(tmp_path / "mandel")
    path, z = boundary.run_boundary(cfg, prefix, device="cpu")
    assert abs(len(path) - len(ref_path)) <= 0.01 * len(ref_path)
    assert _hausdorff(path, ref_path) <= 3.0 / 299
    assert (z == ref_z).mean() > 0.999
    lines = open(f"{prefix}_boundary.csv").read().splitlines()
    assert lines[0] == "x,y" and len(lines) == len(path) + 1
    meta = open(f"{prefix}_meta.txt").read()
    assert "res=300" in meta and "max_iter=120" in meta
    assert os.path.getsize(f"{prefix}_boundary.png") > 0


def test_run_boundary_kernel_backend_on_cpu(ref_run):
    # backend="cuda" on a CPU device runs the K2 twin in f32: >= 99% of
    # pixels equal to f64, vertex count within 2%, Hausdorff <= 5 spacings
    ref_path, ref_z = ref_run
    cfg = boundary.BoundaryConfig(res=300, max_iter=120, backend="cuda")
    path, z = boundary.run_boundary(cfg, device="cpu")
    assert z.dtype == np.float32
    assert (z == ref_z).mean() >= 0.99
    assert abs(len(path) - len(ref_path)) <= 0.02 * len(ref_path)
    assert _hausdorff(path, ref_path) <= 5 * 3.0 / 299
    assert mc.launches["dwell"] == 0


def test_run_boundary_short_contour_raises():
    cfg = boundary.BoundaryConfig(xlim=(-0.2, 0.0), ylim=(-0.1, 0.1), res=40, max_iter=50)
    with pytest.raises(RuntimeError, match="usable contour"):
        boundary.run_boundary(cfg, device="cpu")


def test_backend_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert boundary.resolve_backend("auto", cpu) == "torch"
    assert boundary.resolve_backend("auto", cuda) == "cuda"
    assert boundary.resolve_backend("cuda", cpu) == "cuda"
    with pytest.raises(ValueError, match="backend"):
        boundary.resolve_backend("pallas", cpu)


def test_missing_matplotlib_names_no_plots(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = boundary.BoundaryConfig(res=100, max_iter=50)
    with pytest.raises(ImportError, match="--no-plots"):
        boundary.run_boundary(cfg, str(tmp_path / "m"), device="cpu")
    assert not os.path.exists(tmp_path / "m_boundary.csv")
    path, _ = boundary.run_boundary(cfg, str(tmp_path / "m"), plots=False, device="cpu")
    assert os.path.exists(tmp_path / "m_boundary.csv")
    assert not os.path.exists(tmp_path / "m_boundary.png")


def test_cli_boundary_session_defaults():
    args = cli._parser().parse_args(["boundary"])
    cli._resolve_platform_defaults(args)
    assert (args.device, args.backend) == ("cuda", "cuda")
    for extra in (["--parity"], ["--device", "cpu"]):
        args = cli._parser().parse_args(["boundary", *extra])
        cli._resolve_platform_defaults(args)
        assert args.backend == "torch"
    args = cli._parser().parse_args(["boundary", "--device", "cpu", "--backend", "cuda"])
    cli._resolve_platform_defaults(args)
    assert args.backend == "cuda"


def test_cli_boundary_writes_files(tmp_path):
    out = tmp_path / "mandel"
    proc = subprocess.run(
        [sys.executable, "-m", "cmtci_torch.cli", "boundary", "--device", "cpu",
         "--res", "200", "--max-iter", "80", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "vertices ->" in proc.stdout
    for suffix in ("_boundary.csv", "_meta.txt", "_boundary.png"):
        assert os.path.exists(f"{out}{suffix}"), suffix


def test_k2_periodicity_twin_equals_plain_and_pallas_option():
    """K2's periodicity option at the shape of the reference's own test
    (tests/test_green_compacted.py:32-40): the port's periodic twin is
    bitwise its plain twin, as the reference's periodic kernel is bitwise its
    plain one; against the interpreted Pallas kernel with periodicity=True at
    least 99.9% of pixels are equal (XLA contracts FMAs there)."""
    plain = mc.mandelbrot_field(DOM, 256, 32, max_iter=120, device="cpu")
    periodic = mc.mandelbrot_field(DOM, 256, 32, max_iter=120, device="cpu", periodicity=True)
    assert torch.equal(periodic, plain)
    assert torch.equal(mc.dwell_field_torch(DOM, 256, 32, 120, periodicity=True), plain)
    ref = np.asarray(mandelbrot_field_pallas(DOM, 256, 32, max_iter=120, kind="dwell",
                                             tile=(32, 256), periodicity=True))
    assert (periodic.numpy() == ref).mean() >= 0.999
    # the other kinds ignore the switch, as in the reference
    de = mc.mandelbrot_field(DOM, 64, 32, 60, "de", device="cpu", periodicity=True)
    assert torch.equal(de, mc.mandelbrot_field(DOM, 64, 32, 60, "de", device="cpu"))
    assert all(v == 0 for v in mc.launches.values()) and "dwell_periodic" in mc.launches


def _brent_hit_step(cr, ci, max_iter):
    """Steps one f32 lane takes until Brent's check fires (escape.cuh's
    schedule: the checkpoint moves when the steps taken are a power of two);
    max_iter + 1 when it never does, 0 for an escaping lane."""
    f32 = np.float32
    zr = zi = f32(0.0)
    pr, pi, nxt = f32(1e30), f32(0.0), 1
    for n in range(max_iter):
        zr, zi = zr * zr - zi * zi + cr, f32(2.0) * zr * zi + ci
        if not zr * zr + zi * zi <= f32(4.0):
            return 0
        if zr == pr and zi == pi:
            return n + 1
        if n + 1 == nxt:
            pr, pi, nxt = zr, zi, nxt * 2
    return max_iter + 1


def test_k2_periodicity_on_a_window_of_bounded_lanes():
    """A window across the period-3 bulb at c = -0.125 + 0.745i, which the
    analytic cardioid and period-2 tests do not cover: its lanes are bounded
    and iterate to max_iter 2000 without the check. The periodic twin is
    still bitwise the plain one, and the check is not vacuous there: f32
    orbits of the window do return to a checkpoint well before 2000 steps."""
    dom = (-0.26, 0.02, 0.66, 0.92)
    nx, ny, max_iter = 28, 26, 2000
    plain = mc.dwell_field_torch(dom, nx, ny, max_iter)
    periodic = mc.dwell_field_torch(dom, nx, ny, max_iter, periodicity=True)
    assert torch.equal(periodic, plain)
    cr, ci = mc._grid_coords(dom, nx, ny, torch.device("cpu"))
    bounded = (plain == max_iter) & ~mc._interior_mask_torch(cr, ci)
    assert 0.2 < float(bounded.float().mean()) < 0.8
    hits = np.array([_brent_hit_step(np.float32(cr[r, c]), np.float32(ci[r, c]), max_iter)
                     for r, c in bounded.nonzero().tolist()])
    assert (hits > 0).all()  # a lane that cycles is a bounded lane
    assert (hits <= max_iter).mean() > 0.5 and np.median(hits) < max_iter / 2
