"""StageTimer's profiler ranges and counters, and the stages and shell-scan
counters of run_spatial_stats, on the CPU at tiny sizes: the statistics are
those of the same calls made straight through, and the counters are what
the scans' shapes and shell counts say."""

import json
import os

import numpy as np
import pytest
import torch

from cmtci_torch import cli
from cmtci_torch.pipelines import analysis
from cmtci_torch.stats import curvature as curv
from cmtci_torch.stats import pointstats as ps
from cmtci_torch.utils.artifacts import StageTimer

STAGES = ["spatial_stats.shells_construct", "spatial_stats.shells_mandel",
          "spatial_stats.hausdorff", "spatial_stats.curvature", "spatial_stats.boxdim"]
R_MAX, DR = 0.8, 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 2))


def _trace_events(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path, encoding="utf-8") as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_stage_is_a_user_annotation_and_stages_nest(tmp_path):
    timer = StageTimer("cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.stage("outer"):
            with timer.stage("inner"):
                torch.ones(8).sum()
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"])
             for e in _trace_events(prof, tmp_path / "t.json") if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= set(spans)
    assert spans["outer"][0] <= spans["inner"][0] and spans["inner"][1] <= spans["outer"][1]
    assert set(timer.times) == {"outer", "inner"}


def test_count_accumulates():
    timer = StageTimer("cpu")
    assert timer.counts == {}
    timer.count("a", 3)
    timer.count("a", 4)
    timer.count("b", 0)
    assert timer.counts == {"a": 7, "b": 0}


def _straight(c, m, dtype):
    """run_spatial_stats' statistics by the same calls, in the same order,
    with no timer."""
    sc = ps._shell_counts(c, R_MAX, DR, dtype=dtype, device="cpu")
    sm = ps._shell_counts(m, R_MAX, DR, dtype=dtype, device="cpu")
    out = {"r": ps.pair_correlation(c, R_MAX, DR, _shells=sc)[0],
           "g_construct": ps.pair_correlation(c, R_MAX, DR, _shells=sc)[1],
           "g_mandel": ps.pair_correlation(m, R_MAX, DR, _shells=sm)[1],
           "K_construct": ps.ripley_k(c, R_MAX, DR, _shells=sc)[1],
           "K_mandel": ps.ripley_k(m, R_MAX, DR, _shells=sm)[1],
           "hausdorff": ps.hausdorff(c, m, dtype=dtype, device="cpu"),
           "curv_construct": curv.gradient_curvature(c, device="cpu"),
           "curv_mandel": curv.gradient_curvature(m, device="cpu"),
           "fractal_dim_construct": ps.fractal_dimension(c, device="cpu")[0],
           "fractal_dim_mandel": ps.fractal_dimension(m, device="cpu")[0]}
    return out, (sc[1], sm[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("own_timer", [False, True], ids=["own", "caller"])
def test_run_spatial_stats_stages_and_statistics(dtype, own_timer):
    c, m = _cloud(300, 1), _cloud(260, 2)
    timer = StageTimer("cpu") if own_timer else None
    got = analysis.run_spatial_stats(c, m, r_max=R_MAX, dr=DR, stat_dtype=dtype, plots=False,
                                     device="cpu", timer=timer)
    want, (sc, sm) = _straight(c, m, dtype)
    assert list(got["stage_times"]) == STAGES
    assert all(t >= 0 for t in got["stage_times"].values())
    assert set(got) == set(want) | {"stage_times", "counts"}
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    assert got["counts"]["spatial_stats.in_shells"] == int(sc.sum() + sm.sum())
    assert got["counts"]["spatial_stats.distances"] == 300 * 300 + 260 * 260  # one block each
    if timer is not None:
        assert got["stage_times"] == timer.times and got["counts"] == timer.counts


def _blocks(n, chunk):
    """Σ over the blocks of rows × the columns from the block's first row on."""
    return sum(min(chunk, n - i) * (n - i) for i in range(0, n, chunk))


@pytest.mark.parametrize("n,chunk", [(64, 16), (100, 25), (97, 16), (1100, 1024)])
def test_distances_counter_is_the_blocks_closed_form(n, chunk):
    timer = StageTimer("cpu")
    xy = torch.as_tensor(_cloud(n, 3))
    edges = torch.as_tensor(np.arange(0.0, 0.9, 0.1))
    counts = ps._pair_hist(xy, edges, len(edges) - 1, chunk=chunk, count=timer.count)
    assert timer.counts == {"spatial_stats.distances": _blocks(n, chunk)}
    np.testing.assert_array_equal(counts, ps._pair_hist(xy, edges, len(edges) - 1, chunk=chunk))


@pytest.mark.parametrize("n", [150, 1100])
def test_in_shells_counter_is_the_sum_of_the_shell_counts(n):
    timer = StageTimer("cpu")
    pts = _cloud(n, 4)
    r, counts, n_out, rho = ps._shell_counts(pts, R_MAX, DR, device="cpu", count=timer.count)
    assert timer.counts["spatial_stats.in_shells"] == int(counts.sum())
    assert timer.counts["spatial_stats.distances"] == _blocks(n, 1024)
    plain = ps._shell_counts(pts, R_MAX, DR, device="cpu")
    np.testing.assert_array_equal(counts, plain[1])
    assert (n_out, rho) == plain[2:]


def _bus(root):
    os.makedirs(root)
    for name, pts in (("construct_points", _cloud(240, 5)), ("construct_aligned", _cloud(240, 6)),
                      ("mandel_boundary_sample", _cloud(200, 7))):
        np.savetxt(f"{root}/{name}.csv", pts, delimiter=",", header="x,y", comments="")
    return root


def test_cli_spatial_stats_fills_the_layers_timer(tmp_path):
    bus = _bus(str(tmp_path / "bus"))
    argv = ["spatial-stats", "--device", "cpu", "--no-plots", "--busdir", bus]
    timer = StageTimer("cpu")
    assert cli.main([*argv, "--out", str(tmp_path / "layers" / "ss")], layers=timer) == 0
    assert cli.main([*argv, "--out", str(tmp_path / "plain" / "ss")]) == 0
    assert list(timer.times) == STAGES
    assert set(timer.counts) == {"spatial_stats.distances", "spatial_stats.in_shells"}
    files = sorted(os.listdir(tmp_path / "plain"))
    assert files and sorted(os.listdir(tmp_path / "layers")) == files
    for f in files:
        assert (tmp_path / "layers" / f).read_bytes() == (tmp_path / "plain" / f).read_bytes(), f
