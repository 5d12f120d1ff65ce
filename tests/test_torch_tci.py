"""cmtci_torch's TCI slice (`cmtci-torch tci`) against cmtci (the JAX
reference), on the CPU: the Hausdorff, curvature and spectral statistics,
the probability histogram and the TCI flow, run_tci on every sampler
implementation, the frozen default-config numbers and the CLI.

Inputs are made with numpy from a seed and handed to both packages; run_tci
gets its config from one dict (tci_config_from_reference).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cmtci.pipelines import analysis as ref_analysis
from cmtci.stats import curvature as ref_curv
from cmtci.stats import pointstats as ref_ps
from cmtci.stats import spectral as ref_sp
from cmtci.transport import giflow as ref_giflow
from cmtci.transport import histogram as ref_hg
from cmtci_torch import cli
from cmtci_torch.pipelines.analysis import TCIConfig, run_tci, tci_config_from_reference
from cmtci_torch.stats import curvature, pointstats, spectral
from cmtci_torch.transport import giflow
from cmtci_torch.transport import histogram as hg

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(construct_ns=(20, 40, 60), mandelbrot_grid=150, mandelbrot_samples=2000,
             grid_bins=32, t_steps=10)
DOMAIN = (-2.25, 1.25, -1.75, 1.75)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed, n, scale=0.6):
    r = np.random.default_rng(seed)
    return r.normal(scale=scale, size=n) + 1j * r.normal(scale=scale, size=n)


def _grid_sample(seed, n, nodes=60):
    """n distinct nodes of a square grid: the Mandelbrot sample's shape, with
    many equal neighbour distances. The nodes are dyadic (k/16), so every
    squared distance is exact and equal distances are ties in both packages
    (on np.linspace nodes they differ in the last ulps, and XLA's FMA
    contraction of dx*dx + dy*dy then orders them otherwise)."""
    r = np.random.default_rng(seed)
    xs = -2.0 + np.arange(nodes) / 16.0
    flat = r.choice(nodes * nodes, n, replace=False)
    return xs[flat % nodes] + 1j * xs[flat // nodes]


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_hausdorff_matches_reference(seed):
    a, b = _cloud(seed, 700), _cloud(seed + 10, 1300, scale=0.8)
    want = ref_ps.hausdorff(a, b)
    assert pointstats.hausdorff(a, b, device="cpu") == pytest.approx(want, rel=1e-9)
    # blocks of 1024 rows: a 2500-point side crosses two block edges
    big = _cloud(seed + 20, 2500)
    assert pointstats.hausdorff(big, b, device="cpu") == pytest.approx(
        ref_ps.hausdorff(big, b), rel=1e-9)
    # f32 on request: squared distances in f32, ~1e-7 relative
    assert pointstats.hausdorff(a, b, dtype=torch.float32, device="cpu") == pytest.approx(
        want, rel=1e-5)


@pytest.mark.parametrize("pts", [_cloud(3, 900), _grid_sample(4, 900), _grid_sample(5, 2500)],
                         ids=["gaussian", "grid", "grid-two-blocks"])
def test_pca_eccentricity_matches_reference(pts):
    """The k nearest neighbours are lax.top_k's choice even among equal
    distances (grid nodes), so every point's eccentricity agrees."""
    want = np.asarray(ref_curv.pca_eccentricity(pts, 6))
    got = curvature.pca_eccentricity(pts, 6, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-15)


def test_pca_eccentricity_f32_matches_reference_f32():
    import jax.numpy as jnp

    pts = _cloud(6, 800)
    want = np.asarray(ref_curv.pca_eccentricity(pts, 6, dtype=jnp.float32))
    got = curvature.pca_eccentricity(pts, 6, dtype=torch.float32, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_knn_ties_go_to_the_lower_index():
    d2 = torch.tensor([[0.0, 2.0, 1.0, 1.0, 1.0, 3.0],
                       [1.0, 0.0, 1.0, 1.0, 1.0, 1.0]], dtype=torch.float64)
    idx = curvature._knn_indices(d2, 3)
    assert idx.tolist() == [[0, 2, 3], [1, 0, 2]]


@pytest.mark.parametrize("seed", [0, 1])
def test_spectral_distance_matches_reference(seed):
    x, y = _cloud(seed, 300, scale=0.3), _cloud(seed + 5, 250, scale=0.3)
    want = ref_sp.spectral_distance(x, y, 30, 0.05)
    assert spectral.spectral_distance(x, y, 30, 0.05, device="cpu") == pytest.approx(
        want, rel=1e-9)


def test_to_prob_matches_reference():
    """Counts bitwise (np.histogram2d semantics on np.linspace edges, points
    on the edges and outside the domain included); probabilities rel 1e-12."""
    xs = np.linspace(DOMAIN[0], DOMAIN[1], 33)
    ys = np.linspace(DOMAIN[2], DOMAIN[3], 33)
    cloud = np.concatenate([_cloud(7, 3000, scale=1.0), xs + 1j * ys[::-1],
                            np.array([DOMAIN[1] + 1j * DOMAIN[3], 3.0 + 0j])])
    counts = hg._histogram2d_np(cloud.real, cloud.imag, 32, DOMAIN)
    want = np.asarray(ref_hg.histogram2d(cloud.real, cloud.imag, 32, DOMAIN))
    np.testing.assert_array_equal(counts, want)
    p = hg.to_prob(cloud, 32, DOMAIN)
    np.testing.assert_allclose(p, np.asarray(ref_hg.to_prob(cloud, 32, DOMAIN)),
                               rtol=1e-12, atol=0.0)
    assert p.sum() == pytest.approx(1.0, rel=1e-12)


def test_tci_flow_matches_reference():
    r = np.random.default_rng(11)
    p = r.dirichlet(np.ones(32 * 32)).reshape(32, 32)
    x0 = r.dirichlet(np.ones(32 * 32)).reshape(32, 32)
    kls, traj = giflow.tci_flow(p, x0, 0.2, 15)
    rkls, rtraj = ref_giflow.tci_flow(p, x0, 0.2, 15)
    assert kls.shape == (16,) and len(traj) == 16
    np.testing.assert_allclose(kls, rkls, rtol=1e-9)
    np.testing.assert_array_equal(traj[0], x0)
    np.testing.assert_allclose(traj[-1], np.asarray(rtraj[-1]), rtol=1e-12)
    assert np.all(np.diff(kls) <= 0)


# ---------------------------------------------------------------------------
# run_tci
# ---------------------------------------------------------------------------


def _both(de_impl, **extra):
    """run_tci of cmtci and of the port from one config dict."""
    ref_cfg = ref_analysis.TCIConfig(**SMALL, de_impl=de_impl, **extra)
    ref = ref_analysis.run_tci(ref_cfg)
    got = run_tci(tci_config_from_reference(dataclasses.asdict(ref_cfg)), device="cpu")
    return ref, got


def test_run_tci_numpy_parity_with_reference():
    (ref, rkls, rtraj), (out, kls, traj) = _both("numpy")
    assert kls[0] == pytest.approx(rkls[0], rel=1e-9)
    assert kls[-1] == pytest.approx(rkls[-1], rel=1e-6)
    np.testing.assert_allclose(kls, rkls, rtol=1e-6)
    for key in ("Hausdorff_before", "Curvature_corr", "KL_initial"):
        assert out[key] == pytest.approx(ref[key], rel=1e-9), key
    # 2000 samples: under the 8000-point guard, so both compute the spectrum
    assert out["Spectral_L2"] == pytest.approx(ref["Spectral_L2"], rel=1e-9)
    assert len(traj) == len(rtraj) == SMALL["t_steps"] + 1
    assert set(out) == set(ref)


@pytest.mark.parametrize("de_impl", ["torch", "cuda"])
def test_run_tci_device_samplers_track_reference(de_impl):
    """The plain-torch f64 field and the K1 twin (with the band and the
    subsample on the device) against cmtci's "jax" run: KL non-increasing,
    KL_final < KL_initial, KL_initial within 20% (test_pipelines.py:207-222).
    Not bitwise: the port's grid has np.linspace nodes and cmtci's jnp.linspace
    nodes, so the band differs, and with it every later rng.choice (ROADMAP
    Queue 3, grid nodes); the "cuda" sampler is a new realization."""
    ref_cfg = ref_analysis.TCIConfig(**SMALL, de_impl="jax")
    ref, _, _ = ref_analysis.run_tci(ref_cfg)
    cfg = tci_config_from_reference({**dataclasses.asdict(ref_cfg), "de_impl": de_impl})
    assert cfg.de_impl == de_impl
    out, kls, _ = run_tci(cfg, device="cpu")
    assert np.all(np.diff(kls) <= 1e-12)
    assert out["KL_final"] < out["KL_initial"]
    assert abs(out["KL_initial"] - ref["KL_initial"]) < 0.2 * ref["KL_initial"]
    assert np.isfinite(out["Hausdorff_before"]) and np.isfinite(out["Curvature_corr"])


def test_run_tci_default_config_vs_frozen_reference():
    """The port's f64 run (numpy sampler) at the default config — 600² DE
    grid, 25,000 samples, T = 60 — against cmtci's numbers in
    tests/data/tci_default_numpy.json: KL at rel 1e-9 at its start and 1e-6
    at its end (the small end value carries the cancellation of the flow),
    Hausdorff and curvature correlation at rel 1e-9, Spectral_L2 NaN by the
    reference's 8000-point guard."""
    with open(os.path.join(DATA, "tci_default_numpy.json")) as f:
        ref = json.load(f)
    cfg = tci_config_from_reference(ref["config"])
    assert cfg == TCIConfig(de_impl="numpy")
    out, kls, _ = run_tci(cfg, device="cpu")
    want = np.asarray(ref["kls"])
    assert kls[0] == pytest.approx(want[0], rel=1e-9)
    assert kls[-1] == pytest.approx(want[-1], rel=1e-6)
    np.testing.assert_allclose(kls, want, rtol=1e-6)
    for key in ("Hausdorff_before", "Curvature_corr"):
        assert out[key] == pytest.approx(ref["out"][key], rel=1e-9), key
    assert ref["out"]["Spectral_L2"] is None and np.isnan(out["Spectral_L2"])


def test_tci_config_from_reference_round_trip():
    ref_cfg = ref_analysis.TCIConfig(de_impl="pallas", mandelbrot_grid=2400, seed=3)
    cfg = tci_config_from_reference(dataclasses.asdict(ref_cfg))
    assert cfg.de_impl == "cuda" and cfg.mandelbrot_grid == 2400 and cfg.seed == 3
    assert ([f.name for f in dataclasses.fields(TCIConfig)]
            == [f.name for f in dataclasses.fields(ref_analysis.TCIConfig)])
    d, d_ref = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    assert {k: v for k, v in d.items() if k != "de_impl"} == {
        k: v for k, v in d_ref.items() if k != "de_impl"}
    js = json.loads(json.dumps({**d_ref, "de_impl": "jax"}))  # lists, not tuples
    assert tci_config_from_reference(js) == TCIConfig(mandelbrot_grid=2400, seed=3)


def test_run_tci_rejects_unknown_impl():
    with pytest.raises(ValueError, match="de_impl"):
        run_tci(TCIConfig(de_impl="pallas"), device="cpu")


def test_run_tci_writes_outputs_and_times_layers(tmp_path):
    from cmtci_torch.utils.artifacts import StageTimer

    timer = StageTimer("cpu")
    out_json = str(tmp_path / "run_tci_results.json")
    out, _, _ = run_tci(TCIConfig(**SMALL), out_json, plots=False, timer=timer,
                        device="cpu")
    assert set(timer.times) == {"cloud", "sample", "match", "stats", "hist", "flow"}
    with open(out_json) as f:
        assert json.load(f) == pytest.approx(out)
    assert os.path.exists(str(tmp_path / "run_tci_results_meta.txt"))
    assert not os.path.exists(str(tmp_path / "run_tci_results_KL_descent.png"))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_tci_session_defaults():
    def resolved(*argv):
        args = cli._parser().parse_args(["tci", *argv])
        cli._resolve_platform_defaults(args)
        return args.de_impl

    assert resolved() == "cuda"
    assert resolved("--device", "cpu") == "torch"
    assert resolved("--parity") == "numpy"
    assert resolved("--device", "cpu", "--parity") == "numpy"
    assert resolved("--parity", "--de-impl", "torch") == "torch"


def test_cli_tci_writes_results(tmp_path):
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "cmtci_torch.cli", "tci", "--device", "cpu", "--grid", "96",
         "--samples", "800", "--t-steps", "5", "--no-plots", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    printed = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(f"{out}_tci_results.json") as f:
        written = json.load(f)
    keys = {"Hausdorff_before", "Curvature_corr", "Spectral_L2", "KL_initial", "KL_final",
            "runtime_sec"}
    assert set(written) == set(printed) == keys
    assert written["KL_final"] < written["KL_initial"]


def test_cli_tci_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["tci", "--grid", "96", "--samples", "800", "--t-steps", "2",
                  "--no-plots", "--out", os.devnull])
