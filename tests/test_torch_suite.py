"""The bus analyses through cmtci_torch.cli.main on the CPU: `suite` and the
seven standalone subcommands on a stage-1 bus (`stage1 --max-n 12
--boundary-samples 80`), held to `cmtci suite` on the same bus
(tests/test_cli_smoke.py:48 drives the reference's); the CUDA-session
defaults; the figures against their goldens in tests/data/goldens/, which
are only read.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from cmtci.cli import main as ref_main
from cmtci_torch import cli
from cmtci_torch.io import plots
from test_plots_golden import GOLDEN_DIR, _clouds

STAGES = ("spectral", "multifractal", "embeddings", "symmetry", "spatial-stats", "report",
          "coupling")
SUMMARY_KEYS = ("power_slope_construct", "spectral_distance", "best_axis_deg", "hausdorff",
                "coupling_d_mean")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's bus and its suite on the CPU, and `cmtci suite` on it."""
    out = str(tmp_path_factory.mktemp("suite"))
    bus = f"{out}/bus"
    cli.main(["stage1", "--device", "cpu", "--no-plots", "--max-n", "12",
              "--boundary-samples", "80", "--out", bus])
    import contextlib
    import io

    lines = {}
    for name, fn, args in (
            ("port", cli.main, ["suite", "--device", "cpu", "--no-plots"]),
            ("ref", ref_main, ["suite"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn([*args, "--busdir", bus, "--out", f"{out}/{name}"]) == 0
        lines[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return out, bus, lines


def test_suite_summary_against_cmtci_suite(runs):
    _, _, lines = runs
    port, ref = lines["port"], lines["ref"]
    assert list(port["stages"]) == list(ref["stages"]) == list(STAGES)
    assert port["wall_s"] > 0
    assert set(port) == set(ref)
    for key in SUMMARY_KEYS:
        if isinstance(ref[key], str):  # a NaN the JSON carries as a string
            assert port[key] == ref[key], key
        else:
            assert port[key] == pytest.approx(ref[key], rel=1e-9, abs=1e-12), key


def test_suite_writes_the_reference_files(runs):
    out, _, _ = runs
    port, ref = sorted(os.listdir(f"{out}/port")), sorted(os.listdir(f"{out}/ref"))
    assert port == [f for f in ref if not f.endswith(".png")]
    for f in ("spectral_slopes.txt", "spectral_meta.txt", "multifractal_meta.txt",
              "multifractal_construct_multifractal.csv", "spatial-stats_spatial_stats.csv",
              "symmetry_symmetry_report_bestaxis.csv", "coupling_meta.txt",
              "coupling_1_variogram_construct.csv", "coupling_4_variogram_construct.csv"):
        assert open(f"{out}/port/{f}").read() == open(f"{out}/ref/{f}").read(), f


@pytest.mark.parametrize("stage", STAGES)
def test_standalone_subcommand_writes_what_the_suite_stage_writes(runs, stage, capsys):
    out, bus, _ = runs
    solo = f"{out}/solo/{stage}"
    assert cli.main([stage, "--device", "cpu", "--no-plots", "--busdir", bus,
                     "--out", solo]) == 0
    capsys.readouterr()
    names = sorted(f for f in os.listdir(f"{out}/port") if f.startswith(stage + "_"))
    assert names
    for f in names:
        assert (open(f"{out}/port/{f}", "rb").read()
                == open(f"{out}/solo/{f}", "rb").read()), f


def test_suite_accel_paths_on_the_cpu(runs, capsys):
    """--stage-paths accel runs every stage's f32/device path (here on the
    CPU): the summary within the f32 paths' agreement with the host one."""
    out, bus, lines = runs
    assert cli.main(["suite", "--device", "cpu", "--stage-paths", "accel", "--no-plots",
                     "--busdir", bus, "--out", f"{out}/accel"]) == 0
    got, host = _last_json(capsys), lines["port"]
    assert list(got["stages"]) == list(STAGES)
    assert got["spectral_distance"] == pytest.approx(host["spectral_distance"], abs=1e-4)
    assert got["hausdorff"] == pytest.approx(host["hausdorff"], rel=1e-6)
    assert got["coupling_d_mean"] == pytest.approx(host["coupling_d_mean"], rel=1e-6)
    assert got["power_slope_construct"] == host["power_slope_construct"]


def test_suite_stage_subset_and_unknown_stage(runs, capsys):
    out, bus, _ = runs
    assert cli.main(["suite", "--device", "cpu", "--no-plots", "--busdir", bus,
                     "--stages", "report,spectral", "--out", f"{out}/sub"]) == 0
    assert list(_last_json(capsys)["stages"]) == ["report", "spectral"]
    with pytest.raises(SystemExit, match="unknown stage.*nope"):
        cli.main(["suite", "--device", "cpu", "--busdir", bus, "--stages", "report,nope",
                  "--out", f"{out}/x"])


def test_coupling_without_matches_raises(runs, tmp_path):
    _, bus, _ = runs
    for f in ("construct_points.csv", "mandel_boundary_sample.csv", "construct_aligned.csv"):
        (tmp_path / f).write_bytes(open(f"{bus}/{f}", "rb").read())
    with pytest.raises(ValueError, match="requires matches"):
        cli.main(["coupling", "--device", "cpu", "--no-plots", "--busdir", str(tmp_path),
                  "--out", str(tmp_path / "c")])


@pytest.mark.parametrize("cmd", [*STAGES, "suite"])
def test_cuda_without_card_raises(runs, cmd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out, bus, _ = runs
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([cmd, "--busdir", bus, "--no-plots", "--out", f"{out}/nocard/{cmd}"])
    assert not os.path.exists(f"{out}/nocard")


@pytest.mark.parametrize("flag", [["--trace-dir", "t"], ["--devices", "2"],
                                  ["--mesh-devices", "2"], ["--device", "accel"]])
@pytest.mark.parametrize("cmd", [*STAGES, "suite"])
def test_reference_only_flags_rejected(cmd, flag, capsys):
    """Flags the port does not have fail in argparse, never accepted and
    ignored; suite's reference --device {host,accel} is --stage-paths here,
    and --device accel names no torch device."""
    if flag[0] == "--device":
        with pytest.raises(RuntimeError, match="accel"):
            cli.main([cmd, *flag, "--busdir", "nowhere"])
        return
    with pytest.raises(SystemExit):
        cli.main([cmd, *flag])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_help_lists_eighteen_subcommands():
    """Eighteen with the bus analyses; the conformal maps made it twenty
    (bench among them; doctor is the reference's one left)."""
    sub = next(a for a in cli._parser()._actions if isinstance(a, argparse._SubParsersAction))
    assert len(sub.choices) == 20
    assert set(STAGES) | {"suite", "uniformize-green", "uniformize-fem"} <= set(sub.choices)
    assert "doctor" not in sub.choices


@pytest.mark.parametrize("cmd, device, parity, want", [
    ("symmetry", "cuda", False, {"scan_dtype": "float32"}),
    ("spatial-stats", "cuda", False, {"stat_dtype": "float32"}),
    ("multifractal", "cuda", False, {"box_backend": "device", "box_dtype": "float32"}),
    ("embeddings", "cuda", False, {"eig_backend": "device", "eig_dtype": "float32",
                                   "knn_dtype": "float32"}),
    ("coupling", "cuda", False, {"coupling_field_dtype": "float32",
                                 "coupling_vario_dtype": "float32"}),
    ("suite", "cuda", False, {"stage_paths": "accel"}),
    ("suite", "cuda", True, {"stage_paths": "host"}),
    ("suite", "cpu", False, {"stage_paths": "host"}),
    ("embeddings", "cuda", True, {"eig_backend": "scipy", "eig_dtype": "float64",
                                  "knn_dtype": "float64"}),
    ("multifractal", "cpu", False, {"box_backend": "host", "box_dtype": "float64"}),
    ("coupling", "cpu", False, {"coupling_field_dtype": "float64",
                                "coupling_vario_dtype": "float64"}),
])
def test_session_defaults(cmd, device, parity, want):
    """cmtci/cli.py:60-79's accel defaults on a CUDA session; --parity and
    --device cpu select the host/f64 paths."""
    ns = argparse.Namespace(cmd=cmd, device=device, parity=parity, **dict.fromkeys(want))
    cli._resolve_platform_defaults(ns)
    assert {k: getattr(ns, k) for k in want} == want
    if cmd in cli._ACCEL_STAGE_OPTS and device == "cuda" and not parity:
        opts = cli._ACCEL_STAGE_OPTS[cmd]
        assert cli._bus_stage_opts_from_args(cmd, ns) == opts


def test_explicit_flag_wins():
    ns = cli._parser().parse_args(["coupling", "--field-dtype", "float64"])
    cli._resolve_platform_defaults(ns)
    assert (ns.coupling_field_dtype, ns.coupling_vario_dtype) == ("float64", "float32")


def _figures(tmp_path):
    """(rendered path, golden name) of every figure the bus stages draw, on
    tests/test_plots_golden.py's inputs."""
    c, m = _clouds()
    q = np.linspace(-5, 5, 20)
    res_c = {"q": q, "Dq": 1.2 - 0.02 * q, "alpha": 1.2 - 0.04 * q,
             "f_alpha": 1.2 - 0.01 * q**2}
    res_m = {"q": q, "Dq": 1.3 - 0.03 * q, "alpha": 1.3 - 0.05 * q,
             "f_alpha": 1.3 - 0.012 * q**2}
    gx, gy = np.meshgrid(np.linspace(-2, 1, 48), np.linspace(-1.5, 1.5, 48))
    kc = 1 + 5 * np.abs(np.sin(np.linspace(0, 8 * np.pi, len(c))))
    km = 1 + 3 * np.abs(np.cos(np.linspace(0, 6 * np.pi, len(m))))
    p_dq, p_fa = plots.plot_multifractal_compare(res_c, res_m, str(tmp_path / "mf"))
    return {
        "Dq_compare.png": p_dq, "falpha_compare.png": p_fa,
        "fft_reconstructions.png": plots.plot_fft_reconstructions(
            c, m, str(tmp_path / "fft.png"), modes=(5, 10, 30, 100)),
        "embedding_scatter.png": plots.plot_embedding_scatter(
            c, np.sin(np.linspace(0, 4 * np.pi, len(c))), str(tmp_path / "e.png"),
            title="construct embedding"),
        "spectra_compare.png": plots.plot_eigenvalue_spectra(
            np.exp(-0.3 * np.arange(8)), np.exp(-0.35 * np.arange(8)), str(tmp_path / "s.png")),
        "local_correlation_panels.png": plots.plot_local_correlation_panels(
            np.log(1 + gx**2 + gy**2), np.log(1.2 + gx**2 + 0.8 * gy**2), np.tanh(gx * gy),
            (-2, 1, -1.5, 1.5), str(tmp_path / "p.png")),
        "match_distance_hist.png": plots.plot_match_distance_hist(
            np.abs(np.random.default_rng(3).normal(0.3, 0.1, 500)), str(tmp_path / "mh.png")),
        "curvature_hotspots.png": plots.plot_curvature_hotspots(
            c, m, kc, km, str(tmp_path / "ch.png")),
    }


def test_figures_against_their_goldens(tmp_path):
    """The golden-pixel check of tests/test_plots_golden.py, never writing a
    golden: a missing golden fails."""
    import matplotlib.image as mpimg

    for name, path in _figures(tmp_path).items():
        golden = os.path.join(GOLDEN_DIR, name)
        assert os.path.exists(golden), name
        got, ref = mpimg.imread(path), mpimg.imread(golden)
        assert got.shape == ref.shape, (name, got.shape, ref.shape)
        diff = np.abs(got.astype(float) - ref.astype(float))
        assert diff.mean() < 0.002, (name, diff.mean())
        assert (diff > 0.1).mean() < 0.01, (name, (diff > 0.1).mean())
