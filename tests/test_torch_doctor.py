"""`cmtci-torch doctor`, --trace-dir (torch.profiler traces through
StageTimer), the three figures no pipeline draws against their goldens, and
parallel.distributed's single-process behaviour, on the CPU.

The goldens in tests/data/goldens/ are the reference's renders, compared as
tests/test_plots_golden.py compares them (mean pixel difference < 0.002,
under 1% of the pixels off by more than 0.1) and only read. A traced run
writes bit-identical files to an untraced one.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from cmtci_torch import cli
from cmtci_torch.io import plots
from cmtci_torch.utils.artifacts import StageTimer

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "data", "goldens")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _doctor(capsys, *argv):
    assert cli.main(["doctor", *argv]) == 0
    return json.loads(capsys.readouterr().out)


def test_doctor_reports_the_environment(capsys):
    out = _doctor(capsys, "--device", "cpu")
    assert out["torch"] == torch.__version__ and out["cuda"] == torch.version.cuda
    assert out["cuda_available"] == torch.cuda.is_available()
    for key in ("card", "nvcc"):  # present, or degraded to <key>_error
        assert (key in out) != (f"{key}_error" in out), key
    assert out["build"]["dir"].endswith(os.path.join("build", "cmtci_torch"))
    assert out["process_group"]["initialized"] is False
    assert out["process_group"]["process_count"] == 1
    assert "smoke" not in out and "smoke_error" not in out


def test_doctor_smoke_checksum(capsys):
    """--smoke on the CPU runs K2's twin on the 512² grid at max_iter 200:
    its checksum is the twin's dwell sum on that grid."""
    from cmtci_torch.kernels.mandelbrot_cuda import dwell_field_torch

    smoke = _doctor(capsys, "--smoke", "--device", "cpu")["smoke"]
    want = float(dwell_field_torch((-2.1, 0.9, -1.5, 1.5), 512, 512, 200)
                 .sum(dtype=torch.float64))
    assert smoke["checksum"] == want
    assert smoke["grid"] == "512x512 dwell, max_iter=200" and smoke["kernel"] == "K2's twin"
    assert smoke["compile_and_run_s"] > 0 and smoke["warm_s"] > 0


def test_doctor_degrades_a_field_instead_of_failing(capsys):
    out = _doctor(capsys, "--smoke")  # --device cuda
    if torch.cuda.is_available():
        assert out["smoke"]["kernel"] == "K2 csrc/dwell.cu"
    else:
        assert "torch.cuda.is_available() is False" in out["smoke_error"]
        assert "smoke" not in out


def test_doctor_refuses_devices():
    with pytest.raises(SystemExit, match="no mesh-sharded stage"):
        cli.main(["doctor", "--devices", "2"])


def _traces(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _events(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


def test_lucas_boundary_trace_writes_the_same_file(tmp_path, capsys):
    argv = ["lucas-boundary", "--device", "cpu", "--n-max", "20", "--n-boundary", "300"]
    assert cli.main([*argv, "--out", f"{tmp_path}/plain"]) == 0
    assert cli.main([*argv, "--out", f"{tmp_path}/traced", "--trace-dir",
                     f"{tmp_path}/tr"]) == 0
    a = np.load(f"{tmp_path}/plain_lucas_points.npy")
    b = np.load(f"{tmp_path}/traced_lucas_points.npy")
    assert a.tobytes() == b.tobytes()
    assert _traces(f"{tmp_path}/tr") == ["000_lucas_boundary.pt.trace.json"]
    assert any(e.get("name", "").startswith("aten::") for e in
               _events(f"{tmp_path}/tr/000_lucas_boundary.pt.trace.json"))


def _csv_rows(path, drop=("runtime_sec",)):
    with open(path, encoding="utf-8") as f:
        return [{k: v for k, v in r.items() if k not in drop} for r in csv.DictReader(f)]


def test_tracker_trace_one_file_a_stage(tmp_path):
    argv = ["tracker", "--device", "cpu", "--sigma-bins", "3.0", "--t-fixed", "2",
            "--bins-start", "16", "--bins-max", "16", "--de-impl", "torch"]
    assert cli.main([*argv, "--out", f"{tmp_path}/plain"]) == 0
    assert cli.main([*argv, "--out", f"{tmp_path}/traced", "--trace-dir",
                     f"{tmp_path}/tr"]) == 0
    assert _csv_rows(f"{tmp_path}/plain.csv") == _csv_rows(f"{tmp_path}/traced.csv")
    with open(f"{tmp_path}/traced.json") as f:
        stages = list(json.load(f)["stage_times"])
    names = _traces(f"{tmp_path}/tr")
    assert len(names) == len(stages) == 5  # cloud, sample, match, hist, giflow
    assert [n.split("_", 1)[1] for n in names] == [f"{s}.pt.trace.json" for s in stages]


def test_equipotential_trace_writes_the_same_files(tmp_path):
    argv = ["equipotential", "--device", "cpu", "--n-max", "12", "--max-iter", "300",
            "--no-plots"]
    assert cli.main([*argv, "--out", f"{tmp_path}/plain"]) == 0
    assert cli.main([*argv, "--out", f"{tmp_path}/traced", "--trace-dir",
                     f"{tmp_path}/tr"]) == 0
    for f in sorted(os.listdir(f"{tmp_path}/plain")):
        with open(f"{tmp_path}/plain/{f}", "rb") as a, open(f"{tmp_path}/traced/{f}",
                                                            "rb") as b:
            assert a.read() == b.read(), f
    assert [n.split("_", 1)[1] for n in _traces(f"{tmp_path}/tr")] == [
        f"{s}.pt.trace.json" for s in ("cloud", "potential", "per_n", "families")]


def test_stage_timer_traces_the_outer_stage_only(tmp_path):
    timer = StageTimer("cpu", trace_dir=str(tmp_path))
    with timer.stage("outer"):
        with timer.stage("inner"):
            torch.ones(8).sum()
    with timer.stage("again"):
        pass
    assert set(timer.times) == {"outer", "inner", "again"}
    assert _traces(str(tmp_path)) == ["000_outer.pt.trace.json", "001_again.pt.trace.json"]
    assert StageTimer("cpu").trace_dir is None


def _check(rendered_path, name):
    import matplotlib.image as mpimg

    got = mpimg.imread(rendered_path)
    ref = mpimg.imread(os.path.join(GOLDEN_DIR, name))
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    diff = np.abs(got.astype(float) - ref.astype(float))
    assert diff.mean() < 0.002, (name, diff.mean())
    assert (diff > 0.1).mean() < 0.01, (name, (diff > 0.1).mean())


def _clouds():
    t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
    rng = np.random.default_rng(42)
    c = np.column_stack([np.cos(t) + 0.05 * rng.standard_normal(400),
                         np.sin(t) + 0.05 * rng.standard_normal(400)])
    m = np.column_stack([(1 + 0.2 * np.cos(5 * t)) * np.cos(t),
                         (1 + 0.2 * np.cos(5 * t)) * np.sin(t)])
    return c, m


def test_plot_matches(tmp_path):
    c, m = _clouds()
    p = plots.plot_matches(c, m, np.arange(len(c)) % len(m), str(tmp_path / "m.png"),
                           preserved_mask=(np.arange(len(c)) % 3 > 0))
    _check(p, "matches.png")


def test_plot_boundary_correspondence(tmp_path):
    t = np.linspace(0, 2 * np.pi, 300, endpoint=False)
    z = (1 + 0.1 * np.cos(4 * t)) * np.exp(1j * t)
    w = np.exp(1j * (t + 0.2 * np.sin(t)))
    _check(plots.plot_boundary_correspondence(z, w, str(tmp_path / "bc.png")),
           "boundary_correspondence.png")


def test_plot_variograms(tmp_path):
    r = np.linspace(0.05, 1.0, 20)
    p = plots.plot_variograms(r, {"C": 1 - np.exp(-r / 0.3),
                                  "M": 0.8 * (1 - np.exp(-r / 0.2))},
                              str(tmp_path / "v.png"))
    _check(p, "variograms.png")


def test_distributed_initialize_rules(monkeypatch):
    """The reference's rules: a failed autodetection returns False; an
    explicit argument or require=True raises."""
    from cmtci_torch.parallel import distributed

    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device_type="cpu") is False
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        distributed.initialize(require=True, device_type="cpu")
    with pytest.raises(ValueError, match="together"):
        distributed.initialize(num_processes=2, device_type="cpu")
    info = distributed.process_info()
    assert (info["process_index"], info["process_count"]) == (0, 1)
    assert distributed.backend_for([torch.device("cpu")] * 2) == "gloo"
    assert distributed.backend_for([torch.device("cuda", 0), torch.device("cuda", 1)]) == "nccl"
    assert distributed.backend_for([torch.device("cuda", 0)] * 2) == "gloo"
