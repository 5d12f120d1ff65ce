"""mesh= through the port's pipelines and the CLI's --devices, on spawned gloo
groups of 2 and 3 CPU ranks.

One group per world size runs every pipeline that takes a mesh (library
calls) and every subcommand of cli._MESH_COMMANDS (cli.main with --devices N
inside the group), each rank on the same inputs; the results and the files
are held to the single-device runs in this process, bitwise where the
reference's tests are bitwise (boundary, tracker rows, shell counts) and
otherwise at their thresholds (rtol 1e-10 on the variogram and Green rows,
1e-12 on the coupling cloud and the spatial stats, 1e-8 on the coupling
rows). One more group is spawned by the CLI itself (the user's path:
`--devices 3` with no launcher), and one rank that fails makes the command
fail. The refusals need no group.
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from cmtci_torch import cli
from cmtci_torch.parallel.launch import Call
from cmtci_torch.pipelines.boundary import BoundaryConfig
from cmtci_torch.pipelines.coupling import CouplingConfig
from cmtci_torch.pipelines.equipotential import EquipotentialConfig
from cmtci_torch.pipelines.tracker import TrackerConfig
from cmtci_torch.pipelines.variograms import VariogramConfig

SIZES = (2, 3)
BOUNDARY = BoundaryConfig(res=97, max_iter=80, backend="torch")
TRACKER = TrackerConfig(bins_start=16, bins_max=16, construct_max_start=60,
                        mandelbrot_grid_start=101, mandelbrot_samples_start=397, max_iter=50,
                        sigma_bins=2.0, t_fixed=4, field_dtype="float64", de_impl="torch")
TRACKER2 = dataclasses.replace(TRACKER, bins_max=32, mandelbrot_grid_start=100,
                               mandelbrot_samples_start=300, max_iter=60, t_fixed=5,
                               construct_max_growth=1.3, mandelbrot_grid_growth=1.1,
                               mandelbrot_samples_growth=1.2)
EQUIP = EquipotentialConfig(n_min=2, n_max=15, max_iter=300, run_family_comparison=False)
VARIO = VariogramConfig(n_list=(10, 20, 30), boundary_grid=96, grid_nx=48, grid_ny=48,
                        boundary_max_iter=120, potential_max_iter=120, m_target=400, nbins=8)
COUPLING = CouplingConfig(n_iter=2, grid_res=48, max_iter_mb=60, vario_bins=10)


def _clouds():
    rng = np.random.default_rng(0)
    return {"ss_c": rng.uniform(size=(300, 2)), "ss_m": rng.uniform(size=(280, 2)),
            "cp_c": rng.uniform(-0.8, 0.2, size=(150, 2)),
            "cp_m": rng.uniform(-0.9, 0.3, size=(170, 2)),
            "cp_matches": rng.integers(0, 170, size=150)}


X = _clouds()
CPU = {"device": "cpu"}
LIBRARY = {
    "boundary": Call("cmtci_torch.pipelines.boundary:run_boundary", (BOUNDARY,), CPU),
    "dwell32": Call("cmtci_torch.pipelines.boundary:compute_dwell",
                    (dataclasses.replace(BOUNDARY, backend="cuda"),)),
    "tracker": Call("cmtci_torch.pipelines.tracker:run_tracker", (TRACKER, 1), CPU),
    "tracker32": Call("cmtci_torch.pipelines.tracker:run_tracker",
                      (dataclasses.replace(TRACKER, field_dtype="float32"), 1), CPU),
    "tracker2": Call("cmtci_torch.pipelines.tracker:run_tracker", (TRACKER2,), CPU),
    "equip": Call("cmtci_torch.pipelines.equipotential:run_equipotential", (EQUIP,),
                  {"with_per_n": False, **CPU}),
    "equip32": Call("cmtci_torch.pipelines.equipotential:run_equipotential",
                    (dataclasses.replace(EQUIP, potential_dtype="float32"),),
                    {"with_per_n": False, **CPU}),
    "variograms": Call("cmtci_torch.pipelines.variograms:run_variograms", (VARIO,), CPU),
    "spatial": Call("cmtci_torch.pipelines.analysis:run_spatial_stats",
                    (X["ss_c"], X["ss_m"]), {"r_max": 0.8, "dr": 0.1, **CPU}),
    "coupling": Call("cmtci_torch.pipelines.coupling:run_coupling",
                     (X["cp_c"], X["cp_m"], X["cp_matches"], COUPLING), CPU),
}


def _argvs(bus, out, n):
    """The _MESH_COMMANDS subcommands' argv at small sizes; out/<name> is the
    prefix, --devices n when n > 1."""
    dev = ["--device", "cpu"] + (["--devices", str(n)] if n > 1 else [])
    trk = ["--sigma-bins", "3.0", "--t-fixed", "2", "--bins-start", "16", "--bins-max", "16",
           "--de-impl", "torch", "--field-dtype", "float64"]
    return {
        "boundary": ["boundary", "--res", "97", "--max-iter", "80", "--no-plots",
                     "--out", f"{out}/b"],
        "tracker": ["tracker", *trk, "--out", f"{out}/t"],
        "equipotential": ["equipotential", "--n-max", "12", "--max-iter", "300", "--no-plots",
                          "--out", f"{out}/e"],
        "variograms": ["variograms", "--grid", "24", "--out", f"{out}/v"],
        "spatial-stats": ["spatial-stats", "--busdir", bus, "--no-plots",
                          "--out", f"{out}/ss"],
        "coupling": ["coupling", "--busdir", bus, "--no-plots", "--out", f"{out}/cp"],
        "suite": ["suite", "--busdir", bus, "--no-plots", "--out", f"{out}/su"],
    }, dev


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bus") / "bus")
    assert cli.main(["stage1", "--device", "cpu", "--no-plots", "--max-n", "12",
                     "--boundary-samples", "80", "--out", path]) == 0
    return path


@pytest.fixture(scope="module")
def single(bus, tmp_path_factory):
    """The single-device CLI runs, file by file."""
    out = str(tmp_path_factory.mktemp("single"))
    argvs, dev = _argvs(bus, out, 1)
    for argv in argvs.values():
        assert cli.main([*argv, *dev]) == 0
    return out


#: the subcommands each group runs through the CLI: all seven on 2 ranks; on
#: 3 the four whose runs are short (variograms' 700² boundary proxy alone
#: takes 13 s a rank on one thread; suite runs spatial-stats and coupling)
CLI_RUNS = {2: cli._MESH_COMMANDS, 3: ("boundary", "tracker", "equipotential", "suite")}


@pytest.fixture(scope="module")
def groups(bus, tmp_path_factory):
    """{n: (one dict per rank, the CLI runs' output directory)}."""
    from cmtci_torch.parallel import launch

    res = {}
    for n in SIZES:
        out = str(tmp_path_factory.mktemp(f"mesh{n}"))
        argvs, dev = _argvs(bus, out, n)
        calls = list(LIBRARY.values()) + [
            Call("cmtci_torch.cli:main", ([*argvs[cmd], *dev],), mesh=False)
            for cmd in CLI_RUNS[n]]
        res[n] = (launch.run(n, calls, device="cpu", threads=1,
                             workdir=tmp_path_factory.mktemp(f"ranks{n}")), out)
    return res


def got(groups, n, name):
    return groups[n][0][0]["results"][list(LIBRARY).index(name)]


def _rows(rows):
    return [{k: v for k, v in dataclasses.asdict(r).items() if k != "runtime_sec"}
            for r in rows]


@pytest.mark.parametrize("n", SIZES)
def test_no_rank_holds_jax_and_the_cli_runs_end(groups, n):
    ranks, _ = groups[n]
    assert len(ranks) == n
    for r in ranks:
        assert r["foreign_modules"] == []
        assert r["results"][len(LIBRARY):] == [0] * len(CLI_RUNS[n])


@pytest.mark.parametrize("n", SIZES)
def test_run_boundary(groups, n):
    from cmtci_torch.pipelines.boundary import run_boundary

    path, z = got(groups, n, "boundary")
    ref_path, ref_z = run_boundary(BOUNDARY, device="cpu")
    np.testing.assert_array_equal(z, ref_z)  # the same f64 linspace nodes: bitwise
    np.testing.assert_array_equal(path, ref_path)


@pytest.mark.parametrize("n", SIZES)
def test_compute_dwell_f32(groups, n):
    """Backend "cuda" on a mesh: K2's row entry on each rank's block (its
    twin on a CPU rank), bitwise the single-device K2 grid."""
    from cmtci_torch.pipelines.boundary import compute_dwell

    cfg = dataclasses.replace(BOUNDARY, backend="cuda")
    single = compute_dwell(cfg, device="cpu")
    assert single.dtype == np.float32
    np.testing.assert_array_equal(got(groups, n, "dwell32"), single)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", ["tracker", "tracker32", "tracker2"])
def test_run_tracker(groups, n, name):
    from cmtci_torch.pipelines.tracker import run_tracker

    cfg, stages = {"tracker": (TRACKER, 1), "tracker32": (
        dataclasses.replace(TRACKER, field_dtype="float32"), 1), "tracker2": (TRACKER2, None)}[name]
    rows, _ = got(groups, n, name)
    ref_rows, _ = run_tracker(cfg, max_stages=stages, device="cpu")
    assert len(rows) == len(ref_rows) == (2 if name == "tracker2" else 1)
    assert _rows(rows) == _rows(ref_rows)


@pytest.mark.parametrize("n", SIZES)
def test_run_equipotential(groups, n):
    from cmtci_torch.pipelines.equipotential import run_equipotential

    out = got(groups, n, "equip")
    ref = run_equipotential(EQUIP, with_per_n=False, device="cpu")
    for k, v in ref["summary"].items():
        np.testing.assert_allclose(out["summary"][k], v, rtol=1e-10, atol=0, err_msg=k)


@pytest.mark.parametrize("n", SIZES)
def test_run_equipotential_f32(groups, n):
    """potential_dtype float32 on a mesh: the K3 head on each rank's block
    of the cloud (its twin on a CPU rank), the single device's summary
    bitwise."""
    from cmtci_torch.pipelines.equipotential import run_equipotential

    out = got(groups, n, "equip32")
    ref = run_equipotential(dataclasses.replace(EQUIP, potential_dtype="float32"),
                            with_per_n=False, device="cpu")
    assert out["summary"] == ref["summary"]


@pytest.mark.parametrize("n", SIZES)
def test_run_variograms(groups, n):
    from cmtci_torch.pipelines.variograms import run_variograms

    out = got(groups, n, "variograms")
    ref = run_variograms(VARIO, device="cpu")
    for k in ("gamma_construct", "gamma_mandelbrot", "gamma_cross"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-10, atol=1e-14, err_msg=k)
    for k in ("counts_construct", "counts_mandelbrot", "counts_cross", "U_C", "U_M"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("n", SIZES)
def test_run_spatial_stats(groups, n):
    from cmtci.parallel import sharded as rs
    from cmtci.pipelines.analysis import run_spatial_stats as ref_spatial
    from cmtci_torch.pipelines.analysis import run_spatial_stats

    out = got(groups, n, "spatial")
    one = run_spatial_stats(X["ss_c"], X["ss_m"], r_max=0.8, dr=0.1, device="cpu")
    ref = ref_spatial(X["ss_c"], X["ss_m"], r_max=0.8, dr=0.1, mesh=rs.device_mesh(n))
    for k in ("g_construct", "g_mandel", "K_construct", "K_mandel"):
        np.testing.assert_allclose(out[k], one[k], rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-9, err_msg=k)
    assert out["hausdorff"] == one["hausdorff"]
    assert out["hausdorff"] == pytest.approx(ref["hausdorff"], rel=1e-9)
    # a mesh times the same stages and counts nothing
    assert list(out["stage_times"]) == list(one["stage_times"])
    assert out["counts"] == {} and set(one["counts"]) == {"spatial_stats.distances",
                                                           "spatial_stats.in_shells"}


@pytest.mark.parametrize("n", SIZES)
def test_run_coupling(groups, n):
    from cmtci_torch.pipelines.coupling import run_coupling

    rows, c = got(groups, n, "coupling")
    ref_rows, ref_c = run_coupling(X["cp_c"], X["cp_m"], X["cp_matches"], COUPLING,
                                   device="cpu")
    np.testing.assert_allclose(c, ref_c, rtol=1e-12)
    for rr, gr in zip(ref_rows, rows):
        for k in ("vario_range_a", "sigma_px", "corr_pot", "corr_lap", "d_mean", "d_median"):
            np.testing.assert_allclose(gr[k], rr[k], rtol=1e-8, atol=1e-12, err_msg=k)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _numbers(path):
    """A file's content as comparable values: arrays for .npy, numbers (or
    the text) for each CSV cell, the text of anything else."""
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=False)
    with open(path, encoding="utf-8") as f:
        if not path.endswith(".csv"):
            return f.read()
        return list(csv.reader(f))


#: tracker columns and meta files that record wall times
_TIMED = ("runtime_sec",)


def _same_file(a, b, rel):
    va, vb = _numbers(a), _numbers(b)
    if isinstance(va, np.ndarray):
        np.testing.assert_allclose(va, vb, rtol=rel, atol=0, err_msg=a)
        return
    if isinstance(va, str):
        if a.endswith(".json"):  # the tracker's meta: times and the device differ
            return
        assert va == vb, a
        return
    assert len(va) == len(vb), a
    head = va[0]
    for ra, rb in zip(va, vb):
        for col, x, y in zip(head, ra, rb):
            if col in _TIMED or x == y:
                continue
            np.testing.assert_allclose(float(x), float(y), rtol=rel, atol=1e-12,
                                       err_msg=f"{a}:{col}")


@pytest.mark.parametrize("n", SIZES)
def test_cli_mesh_commands_write_the_single_device_files(groups, single, n):
    """Every _MESH_COMMANDS subcommand through cli.main with --devices n:
    rank 0 writes the single-device run's files (boundary, tracker and
    spatial-stats equal, the Green, variogram, coupling and suite files at
    rtol 1e-10)."""
    _, out = groups[n]
    assert _files(out) and set(_files(out)) <= set(_files(single))
    if n == 2:
        assert _files(out) == _files(single)
    for f in _files(out):
        exact = f.startswith(("b_", "t.", "t_", "ss_"))
        _same_file(os.path.join(out, f), os.path.join(single, f), 0.0 if exact else 1e-10)


def test_cli_spawns_its_own_ranks(tmp_path, single):
    """No launcher: `--devices 3 --device cpu` spawns three ranks itself."""
    assert cli.main(["boundary", "--res", "97", "--max-iter", "80", "--no-plots",
                     "--device", "cpu", "--devices", "3", "--out", f"{tmp_path}/b"]) == 0
    for f in ("b_boundary.csv", "b_meta.txt"):
        with open(f"{tmp_path}/{f}") as a, open(f"{single}/{f}") as b:
            assert a.read() == b.read(), f


def test_tracker_mesh_devices_one_is_a_one_rank_group(tmp_path):
    """--mesh-devices 1 runs the tracker on a one-rank group started in this
    process (no file, no launcher), with the single device's rows."""
    import torch.distributed as dist

    argv = ["tracker", "--device", "cpu", "--sigma-bins", "3.0", "--t-fixed", "2",
            "--bins-start", "16", "--bins-max", "16", "--de-impl", "torch"]
    try:
        assert cli.main([*argv, "--mesh-devices", "1", "--out", f"{tmp_path}/one"]) == 0
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert cli.main([*argv, "--out", f"{tmp_path}/plain"]) == 0
    with open(f"{tmp_path}/one.csv") as a, open(f"{tmp_path}/plain.csv") as b:
        drop = [r[:-1] for r in csv.reader(a)], [r[:-1] for r in csv.reader(b)]
    assert drop[0] == drop[1]  # runtime_sec, the last column, aside


def test_a_failing_rank_fails_the_command(tmp_path):
    with pytest.raises(Exception, match="FileNotFoundError|No such file"):
        cli.main(["equipotential", "--device", "cpu", "--devices", "2", "--no-plots",
                  "--curve-npy", f"{tmp_path}/missing.npy", "--out", f"{tmp_path}/e"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_mesh_without_card_raises(monkeypatch):
    """No card: a mesh, a joined group and the launcher default to the card
    and raise; a CPU group comes only from an explicit device "cpu"."""
    import torch.distributed as dist

    from cmtci_torch.parallel import distributed, launch, sharded

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        sharded.device_mesh()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        sharded.device_mesh(1)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        sharded.sharded_eigensweep([5, 8])
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        distributed.initialize(require=True, device_type="cuda")
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="needs 2 devices"):
        launch.run(2, [])


def _subcommands():
    return list(cli._parser()._subparsers._group_actions[0].choices)


def test_the_cli_has_the_references_subcommands():
    import cmtci.cli as ref_cli

    ref = {"boundary", "lucas-boundary", "construct-boundary", "curvature", "stage1",
           "tracker", "tci", "equipotential", "variograms", *ref_cli._SUITE_STAGES, "suite",
           "uniformize-fem", "uniformize-green", "doctor"}
    assert len(ref) == 20 and set(_subcommands()) == ref | {"bench"}
    assert cli._MESH_COMMANDS == ref_cli._MESH_COMMANDS


REQUIRED = {"construct-boundary": ["--input-csv", "x.csv"], "curvature": ["--input-csv", "x.csv"]}


@pytest.mark.parametrize("cmd", sorted(set(_subcommands()) - {"bench"}))
def test_devices_on_every_subcommand(cmd, tmp_path):
    """--devices parses on every subcommand; N > 1 outside _MESH_COMMANDS is
    refused, never ignored."""
    args = cli._parser().parse_args([cmd, *REQUIRED.get(cmd, []), "--devices", "2"])
    assert args.devices == 2
    if cmd not in cli._MESH_COMMANDS:
        with pytest.raises(SystemExit, match="no mesh-sharded stage"):
            cli.main([cmd, *REQUIRED.get(cmd, []), "--devices", "2", "--device", "cpu"])


def test_trace_dir_and_mesh_devices_flags():
    traced = {"lucas-boundary", "tracker", "equipotential", "suite", "uniformize-green"}
    for cmd in sorted(set(_subcommands()) - {"bench"}):
        argv = [cmd, *REQUIRED.get(cmd, [])]
        if cmd in traced:
            assert cli._parser().parse_args([*argv, "--trace-dir", "t"]).trace_dir == "t"
        else:
            with pytest.raises(SystemExit):
                cli._parser().parse_args([*argv, "--trace-dir", "t"])
    assert cli._parser().parse_args(["tracker", "--mesh-devices", "2"]).mesh_devices == 2
    with pytest.raises(SystemExit):
        cli._parser().parse_args(["boundary", "--mesh-devices", "2"])


def test_refusals(tmp_path):
    """More ranks than cards is refused (never a silent CPU group); --device
    cuda without a card raises; the K1 head refuses a mesh."""
    with pytest.raises(SystemExit, match="needs 99 devices"):
        cli.main(["boundary", "--res", "64", "--max-iter", "30", "--devices", "99",
                  "--out", f"{tmp_path}/m"])
    with pytest.raises(SystemExit, match="needs 2 devices"):
        cli.main(["tracker", "--devices", "2", "--de-impl", "torch", "--out", f"{tmp_path}/t"])
    with pytest.raises(SystemExit, match="needs 2 devices"):
        cli.main(["tracker", "--mesh-devices", "2", "--out", f"{tmp_path}/t"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main(["tracker", "--t-fixed", "2", "--bins-max", "64", "--out",
                      f"{tmp_path}/t"])
    from cmtci_torch.parallel.sharded import Mesh
    from cmtci_torch.pipelines.tracker import run_tracker

    one = Mesh(None, 0, 1, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="single-device kernel head"):
        run_tracker(dataclasses.replace(TRACKER, de_impl="cuda"), max_stages=1, mesh=one)
