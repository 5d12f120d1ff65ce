"""The file-bus chain through cmtci_torch.cli.main on the CPU, as
tests/test_cli_smoke.py:11 drives cmtci's: boundary -> curvature -> stage1
-> construct-boundary -> lucas-boundary at small sizes, each held to the
reference CLI's files on the same arguments."""

import json
import os

import numpy as np
import pytest
import torch

from cmtci.cli import main as ref_main
from cmtci_torch import cli
from cmtci_torch.io.loaders import load_matches, load_points

BUS = ("construct_points.csv", "mandel_boundary_sample.csv", "construct_aligned.csv",
       "matches_indices.csv", "meta.txt")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bus_chain_against_cmtci_cli(tmp_path, capsys):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    cli.main(["boundary", "--device", "cpu", "--res", "200", "--max-iter", "80",
              "--no-plots", "--out", f"{port}/m"])
    cli.main(["curvature", "--device", "cpu", "--input-csv", f"{port}/m_boundary.csv",
              "--neighbors", "5", "--no-plots", "--out", f"{port}/c"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_main(["curvature", "--input-csv", f"{port}/m_boundary.csv",
                     "--neighbors", "5", "--out", f"{ref}/c"]) == 0
    ref_summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n"] == ref_summary["n"]
    for key in ("mean", "median", "std", "q95", "max"):
        assert summary[key] == pytest.approx(ref_summary[key], rel=1e-8), key

    args = ["--max-n", "12", "--boundary-samples", "80"]
    cli.main(["stage1", "--device", "cpu", "--no-plots", *args, "--out", f"{port}/bus"])
    assert ref_main(["stage1", *args, "--out", f"{ref}/bus"]) == 0
    assert sorted(os.listdir(f"{port}/bus")) == sorted(BUS)
    for name in ("mandel_boundary_sample.csv", "matches_indices.csv", "meta.txt"):
        assert (open(f"{port}/bus/{name}", "rb").read()
                == open(f"{ref}/bus/{name}", "rb").read()), name
    for name in ("construct_points.csv", "construct_aligned.csv"):
        assert np.max(np.abs(load_points(f"{port}/bus/{name}")
                             - load_points(f"{ref}/bus/{name}"))) <= 1e-10, name
    assert len(load_matches(f"{port}/bus/matches_indices.csv")) == 77

    args = ["--input-csv", f"{port}/bus/construct_points.csv", "--alpha", "5",
            "--target-n", "300"]
    with pytest.warns(UserWarning, match="traced"):
        cli.main(["construct-boundary", "--device", "cpu", *args, "--out", f"{port}/cb"])
    with pytest.warns(UserWarning, match="traced"):
        assert ref_main(["construct-boundary", *args, "--out", f"{ref}/cb"]) == 0
    assert open(f"{port}/cb_boundary.csv").read() == open(f"{ref}/cb_boundary.csv").read()
    assert "closed=True" in capsys.readouterr().out

    args = ["--n-max", "30", "--n-boundary", "300"]
    cli.main(["lucas-boundary", "--device", "cpu", *args, "--out", f"{port}/lb",
              "--cache-dir", f"{port}/cache"])
    assert ref_main(["lucas-boundary", *args, "--out", f"{ref}/lb"]) == 0
    got, want = np.load(f"{port}/lb_lucas_points.npy"), np.load(f"{ref}/lb_lucas_points.npy")
    assert got.shape == (300, 2) and np.max(np.abs(got - want)) <= 1e-12
    assert len(os.listdir(f"{port}/cache")) == 1


@pytest.mark.parametrize("flag", [["--trace-dir", "t"], ["--devices", "2"]])
@pytest.mark.parametrize("cmd", ["stage1", "lucas-boundary", "curvature", "construct-boundary"])
def test_reference_only_flags_rejected(cmd, flag, capsys):
    """Flags the reference lacks on a subcommand fail in argparse, never
    accepted and ignored. The reference's own flags are the port's too:
    --trace-dir on lucas-boundary, and --devices, which these subcommands
    refuse above 1 (they have no mesh-sharded stage)."""
    extra = ["--input-csv", "x.csv"] if cmd in ("curvature", "construct-boundary") else []
    if flag[0] == "--devices":
        with pytest.raises(SystemExit, match="no mesh-sharded stage"):
            cli.main([cmd, "--device", "cpu", *extra, *flag])
        return
    if cmd == "lucas-boundary":
        assert cli._parser().parse_args([cmd, *flag]).trace_dir == "t"
        return
    with pytest.raises(SystemExit) as exc:
        cli.main([cmd, "--device", "cpu", *extra, *flag])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_parity_flag_accepted(tmp_path):
    args = cli._parser().parse_args(["stage1", "--parity"])
    cli._resolve_platform_defaults(args)
    assert args.parity and args.device == "cuda" and not args.no_plots
    assert "stage1" not in cli._PLATFORM_FLAGS


@pytest.mark.parametrize("cmd", [["stage1", "--max-n", "6"], ["lucas-boundary", "--n-max", "8"],
                                 ["curvature", "--input-csv", "m.csv"],
                                 ["construct-boundary", "--input-csv", "c.csv"]])
def test_cuda_without_card_raises(tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pts = np.column_stack([np.cos(np.linspace(0, 6, 40)), np.sin(np.linspace(0, 6, 40))])
    np.savetxt(tmp_path / "m.csv", pts, delimiter=",")
    np.savetxt(tmp_path / "c.csv", pts, delimiter=",")
    cmd = [a if not a.endswith(".csv") else str(tmp_path / a) for a in cmd]
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([*cmd, "--out", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o_summary.txt")
