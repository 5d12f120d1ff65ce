"""cmtci_torch's uniformize-fem pipeline, plot_k_bins and CLI against cmtci's,
live on the CPU.

Both packages build the Lucas polygon from the host LAPACK cloud
(cloud_backend "lapack", the numpy oracle in both), so they mesh the same
domain: on the SuperLU path results.json, results_compact.csv and meta.txt
at levels L0 and L1 within 1e-9 relative of cmtci's; the device path (dense
f64 Cholesky, here on the CPU) within rtol 1e-7 of SuperLU, the tolerance of
tests/test_fem_device.py:223-244 (its u/v differ from SuperLU's by ~1e-13,
which can move the rounding dedupe of the cardioid uv nodes before qhull).
"""

import json
import os

import numpy as np
import pytest
import torch

from cmtci.pipelines import uniformize_fem as ref
from cmtci_torch import cli
from cmtci_torch.geometry.polygon import Polygon
from cmtci_torch.io import plots
from cmtci_torch.pipelines import uniformize_fem as pipe

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "data", "goldens")
LEVELS = pipe.REFINEMENT_LEVELS[:2]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numbers_close(got, want, rtol, path="") -> None:
    """Every number of two JSON-like trees within rtol (NaN equal to NaN)."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            numbers_close(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            numbers_close(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, (int, float)):
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= rtol * abs(want), \
            (path, got, want)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def spsolve_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fem")
    want = ref.run_fem_uniformization(
        ref.FEMUniformizeConfig(cloud_backend="lapack", solver="spsolve"), str(d / "ref"), LEVELS)
    got = pipe.run_fem_uniformization(
        pipe.FEMUniformizeConfig(cloud_backend="lapack", solver="spsolve"), str(d / "port"),
        LEVELS, device="cpu")
    return want, got, d


def test_spsolve_results_match_the_reference(spsolve_runs):
    want, got, _ = spsolve_runs
    numbers_close(json.loads(json.dumps(got, default=str)),
                  json.loads(json.dumps(want, default=str)), 1e-9)


@pytest.mark.parametrize("name", ["results.json", "results_compact.csv", "meta.txt"])
def test_spsolve_files_match_the_reference(spsolve_runs, name):
    _, _, d = spsolve_runs
    port, refd = d / "port" / name, d / "ref" / name
    if name == "results.json":
        numbers_close(json.loads(port.read_text()), json.loads(refd.read_text()), 1e-9)
    elif name == "meta.txt":
        assert port.read_text() == refd.read_text()
    else:
        a = [line.split(",") for line in port.read_text().splitlines()]
        b = [line.split(",") for line in refd.read_text().splitlines()]
        assert a[0] == b[0] and len(a) == len(b) == 3
        for ra, rb in zip(a[1:], b[1:]):
            assert ra[0] == rb[0]
            numbers_close([float(x) for x in ra[1:]], [float(x) for x in rb[1:]], 1e-9)


def test_k_bin_figures_written(spsolve_runs):
    _, got, d = spsolve_runs
    for r in got:
        for name in ("K_bins", "bin_counts"):
            assert (d / "port" / f"{name}_{r['tag']}.png").exists()
    assert got[-1]["all"]["K_median"] < got[0]["all"]["K_median"]


def test_device_path_matches_spsolve(spsolve_runs):
    _, want, _ = spsolve_runs
    got = pipe.run_fem_uniformization(
        pipe.FEMUniformizeConfig(cloud_backend="lapack", solver="device"), None, LEVELS,
        device="cpu")
    for g, w in zip(got, want):
        assert g["tag"] == w["tag"]
        for key in ("K_median", "mu_L2", "angle_median"):
            assert np.isclose(g["all"][key], w["all"][key], rtol=1e-7, atol=1e-10), key
        assert np.isclose(g["cr"]["lucas"]["abs_med"], w["cr"]["lucas"]["abs_med"], rtol=1e-7)
        for side in ("lucas", "cardioid"):
            assert abs(g["period_mismatch"][side] - w["period_mismatch"][side]) <= 1e-9


@pytest.mark.parametrize("solver", ["device", "cg"])
def test_dispatch_finish_matches_run_level(solver):
    """tests/test_fem_device.py:223-244 on its four-lobed polygon."""
    t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
    r = 1.0 + 0.15 * np.cos(4 * t)
    poly = Polygon(np.column_stack([r * np.cos(t), r * np.sin(t)]))
    cfg = pipe.FEMUniformizeConfig(solver="spsolve", theta_iters=3)
    want = pipe.run_level(cfg, 0.15, 0.15, 0.12, "T", poly_l=poly, device="cpu")
    cfg_dev = pipe.FEMUniformizeConfig(solver=solver, theta_iters=3)
    got = pipe.finish_level(
        cfg_dev, pipe.dispatch_level(cfg_dev, 0.15, 0.15, 0.12, "T", poly, device="cpu"))
    assert got["tag"] == want["tag"]
    for key in ("K_median", "mu_L2", "angle_median"):
        assert np.isclose(got["all"][key], want["all"][key], rtol=1e-7, atol=1e-10), key
    assert np.isclose(got["cr"]["lucas"]["abs_med"], want["cr"]["lucas"]["abs_med"], rtol=1e-7)
    assert np.isclose(got["period_mismatch"]["lucas"], want["period_mismatch"]["lucas"],
                      atol=1e-9)


def test_mesh_bundle_cache_hit():
    t = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    poly = Polygon(np.column_stack([np.cos(t), np.sin(t)]))
    a = pipe._mesh_bundle(poly, 0.3, 0.24)
    n0 = len(pipe._MESH_CACHE)
    b = pipe._mesh_bundle(poly, 0.3, 0.24)
    assert len(pipe._MESH_CACHE) == n0 and a[0] is b[0]


@pytest.mark.parametrize("solver,device,want", [
    (None, "cpu", "spsolve"), ("cg", "cpu", "cg"), ("device", "cpu", "device"),
    ("spsolve", "cpu", "spsolve"),
])
def test_resolved_solver(solver, device, want):
    assert pipe.FEMUniformizeConfig(solver=solver).resolved_solver(device) == want


def test_plot_k_bins_against_the_goldens(tmp_path):
    """tests/test_plots_golden.py:137-142's bins against its goldens (read
    only: a missing golden fails)."""
    import matplotlib.image as mpimg

    bins = [(0.0, 0.1, 1.05, 120), (0.1, 0.2, 1.03, 240), (0.2, 0.3, 1.02, 200),
            (0.3, 0.4, 1.015, 90)]
    paths = plots.plot_k_bins(bins, "L0", str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["K_bins_L0.png", "bin_counts_L0.png"]
    for path, name in zip(paths, ("K_bins.png", "bin_counts.png")):
        golden = os.path.join(GOLDEN_DIR, name)
        assert os.path.exists(golden), name
        got, want = mpimg.imread(path), mpimg.imread(golden)
        assert got.shape == want.shape, name
        diff = np.abs(got.astype(float) - want.astype(float))
        assert diff.mean() < 0.002 and (diff > 0.1).mean() < 0.01, name
    assert plots.plot_k_bins([], "L0", str(tmp_path)) == []


def test_cli_writes_the_reference_files(tmp_path, capsys):
    cli.main(["uniformize-fem", "--device", "cpu", "--levels", "1", "--out",
              str(tmp_path / "out")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["levels"] == 1 and 1.0 < line["K_median_L0"] < 1.1
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == ["K_bins_L0.png", "bin_counts_L0.png", "meta.txt", "results.json",
                     "results_compact.csv"]
    assert "solver=spsolve" in (tmp_path / "out" / "meta.txt").read_text()
    cli.main(["uniformize-fem", "--device", "cpu", "--levels", "1", "--no-plots",
              "--solver", "device", "--out", str(tmp_path / "np")])
    assert not [n for n in os.listdir(tmp_path / "np") if n.endswith(".png")]
    assert "solver=device" in (tmp_path / "np" / "meta.txt").read_text()


@pytest.mark.parametrize("argv,want", [
    ([], "device"), (["--parity"], "spsolve"), (["--device", "cpu"], "spsolve"),
    (["--solver", "cg"], "cg"), (["--parity", "--solver", "device"], "device"),
    (["--solver", "auto", "--device", "cpu"], "spsolve"),
])
def test_cli_session_defaults(argv, want):
    args = cli._parser().parse_args(["uniformize-fem", *argv])
    if args.solver == "auto":
        args.solver = None
    cli._resolve_platform_defaults(args)
    assert args.solver == want


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pipe.run_fem_uniformization(pipe.FEMUniformizeConfig(), levels=LEVELS[:1])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["uniformize-fem", "--levels", "1", "--no-plots"])
