"""cmtci_torch's equipotential slice against cmtci (the JAX reference), on the
CPU: the K3 cloud Green twin and its host wrapper, the f64 compacted Green
loop, run_equipotential and the CLI.

The K3 kernel itself (csrc/cloud_green.cu) runs only on the card, where
chip_smoke.py holds it bitwise to cloud_green_torch; here the twin is held
to the Pallas kernel in interpret mode on the cloud of
tests/test_pallas_kernel.py:135-170.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cmtci.kernels import mandelbrot as ref_mb
from cmtci.kernels.mandelbrot_pallas import green_cloud_f32 as ref_green_cloud_f32
from cmtci.pipelines import equipotential as ref_eq
from cmtci.utils import artifacts as ref_artifacts
from cmtci_torch import cli
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels import mandelbrot_cuda as mc
from cmtci_torch.pipelines import equipotential as eq
from cmtci_torch.utils.artifacts import StageTimer
from oracles import green_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 2000
SMALL = dict(n_min=2, n_max=30, max_iter=500)
SUMMARY_KEYS = ("count", "escaped", "escaped_frac", "g_median", "g_mean", "g_std",
                "g_p10", "g_p90")


def _cloud():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-2.2, 1.2, 400) + 1j * rng.uniform(-1.6, 1.6, 400)
    # deep escapers near the cardioid cusp (k ~ 200-360 >> the f32 exp range)
    return np.concatenate([pts, [0.25 + (np.pi / 200) ** 2, 0.2501, -0.7501 + 0.001j]])


@pytest.fixture(scope="module")
def cloud():
    return _cloud()


@pytest.fixture(scope="module")
def twin_out(cloud):
    return mc.green_cloud_f32(cloud, max_iter=ITERS, escape_r=2.0, device="cpu")


def test_k3_twin_matches_pallas_interpret(cloud, twin_out):
    # identical escape set, k equal on above 99% of points, median g rel err
    # below 1e-6, deep escapers (k > 126) keep g > 0, phi NaN exactly where
    # nothing escaped
    g, k, phi = twin_out
    g_ref, k_ref, phi_ref = ref_green_cloud_f32(cloud, max_iter=ITERS, escape_r=2.0,
                                                stage_iters=512)
    esc = k_ref < ITERS
    np.testing.assert_array_equal(k < ITERS, esc)
    assert (k[esc] == k_ref[esc]).mean() > 0.99
    m = esc & (k == k_ref)
    assert np.median(np.abs(g[m] - g_ref[m]) / g_ref[m]) < 1e-6
    deep = esc & (k > 126)
    assert deep.sum() >= 3 and (g[deep] > 0).all()
    np.testing.assert_array_equal(np.isnan(phi), ~esc)
    assert (g[~esc] == 0).all()


def test_k3_twin_tracks_f64(cloud, twin_out):
    # the contract of test_pallas_kernel.py:135-166 against the f64 path
    g, k, phi = twin_out
    g64, k64, p64 = mb.green_potential_compacted(cloud, max_iter=ITERS, device="cpu")
    esc = k64 < ITERS
    np.testing.assert_array_equal(k < ITERS, esc)
    same = esc & (k == k64)
    assert same.sum() > 0.99 * esc.sum()
    assert np.median(np.abs(g[same] - g64[same]) / g64[same]) < 1e-6
    deep = esc & (k64 > 126)
    assert np.all(np.abs(np.log2(g[deep]) + k[deep]) < 2.0)
    assert np.nanmax(np.abs(phi[esc] - p64[esc])) < 1e-5


@pytest.mark.parametrize("stage_iters", [512, 7])
def test_k3_staged_equals_single_launch(cloud, twin_out, stage_iters):
    got = mc.green_cloud_f32(cloud, max_iter=ITERS, escape_r=2.0,
                             stage_iters=stage_iters, device="cpu")
    for a, b in zip(got, twin_out):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="stage_iters"):
        mc.green_cloud_f32(cloud, max_iter=10, stage_iters=0, device="cpu")
    with pytest.raises(ValueError, match="stage_iters"):
        mb.green_potential_compacted(cloud, max_iter=10, stage_iters=0, device="cpu")


def test_k3_interior_short_circuit_and_twin_rows():
    inside = np.array([0.0 + 0.0j, -1.0 + 0.05j, 0.2 + 0.1j])
    g, k, phi = mc.green_cloud_f32(inside, max_iter=64, device="cpu")
    assert (g == 0).all() and (k == 64).all() and np.isnan(phi).all()
    # the twin itself: an interior c starts inactive and keeps its z state;
    # c = 1 escapes at step 2 (z = 1, 2, 5) and freezes there
    cr = np.array([0.0, 1.0], np.float32)
    ci = np.zeros(2, np.float32)
    z0 = np.array([0.5, 0.0], np.float32)
    out = mc.cloud_green_torch(cr, ci, z0, np.zeros(2, np.float32), 10, 2.0, device="cpu")
    assert out.shape == (6, 2) and out.dtype == torch.float32
    np.testing.assert_array_equal(out[:, 0].numpy(), [0, 0, 0, 0.5, 0, 0])
    np.testing.assert_array_equal(out[:, 1].numpy(), [3, 5, 0, 5, 0, 0])
    assert mc.launches["cloud_green"] == 0


def test_f64_green_compacted_vs_reference():
    # XLA contracts FMAs in the reference's f64 orbit, the port rounds every
    # op: k identical on >= 99.9% of points; g within rel 1e-12 on >= 98% of
    # the points where k agrees. The rest escape late (k 33-866 here), where
    # the chaotic orbit amplifies the contraction; there the port equals the
    # scalar numpy oracle to rel 1e-12
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.1, 1.0, 700) + 1j * rng.uniform(-1.6, 1.6, 700)
    g, k, phi = mb.green_potential_compacted(pts, max_iter=1500, device="cpu")
    g_ref, k_ref, phi_ref = ref_mb.green_potential_compacted(pts, max_iter=1500)
    assert (k == k_ref).mean() >= 0.999
    m = (k == k_ref) & (g_ref > 0)
    rel = np.abs(g[m] - g_ref[m]) / g_ref[m]
    assert (rel <= 1e-12).mean() >= 0.98
    off = np.flatnonzero(m)[rel > 1e-12]
    g_np, k_np, _ = green_np(pts[off], max_iter=1500)
    np.testing.assert_array_equal(k[off], k_np)
    np.testing.assert_allclose(g[off], g_np, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(np.isnan(phi), np.isnan(phi_ref))


def test_f64_green_vs_numpy_oracle():
    # the scalar loop of lucas_equipotential_test_v3.py:124-162 in numpy:
    # k identical, g and phi within rel 1e-12 (log/exp may differ by an ulp)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2.1, 1.0, 250) + 1j * rng.uniform(-1.6, 1.6, 250)
    g, k, phi = mb.green_potential_compacted(pts, max_iter=1500, stage_iters=100,
                                             device="cpu")
    g_np, k_np, phi_np = green_np(pts, max_iter=1500)
    np.testing.assert_array_equal(k, k_np)
    np.testing.assert_allclose(g, g_np, rtol=1e-12, atol=0)
    esc = k < 1500
    np.testing.assert_allclose(phi[esc], phi_np[esc], rtol=1e-12)


@pytest.mark.parametrize("stage_iters", [7, 64])
def test_f64_green_compacted_staging_is_exact(stage_iters):
    # compaction resumes each survivor's own f64 orbit, so any staging gives
    # bitwise the records of one stage over the whole budget
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2.1, 1.0, 300) + 1j * rng.uniform(-1.6, 1.6, 300)
    one = mb.green_potential_compacted(pts, max_iter=600, stage_iters=600, device="cpu")
    got = mb.green_potential_compacted(pts, max_iter=600, stage_iters=stage_iters,
                                       device="cpu")
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b)
    assert 0 < (one[1] < 600).sum() < 300


@pytest.fixture(scope="module")
def small_runs():
    port = eq.run_equipotential(eq.EquipotentialConfig(**SMALL), device="cpu")
    ref = ref_eq.run_equipotential(ref_eq.EquipotentialConfig(**SMALL), None)
    return port, ref


def _check_summary(got, want):
    assert got.get("family") == want.get("family")
    for key in SUMMARY_KEYS:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


def test_run_equipotential_f64_vs_reference(small_runs):
    # the lucas summary within rel 1e-12, with each side's own cloud
    port, ref = small_runs
    _check_summary(port["summary"], ref["summary"])
    assert [r["count"] for r in port["per_n"]] == [r["count"] for r in ref["per_n"]]
    assert [r["escaped"] for r in port["per_n"]] == [r["escaped"] for r in ref["per_n"]]
    assert set(port["stage_times"]) == {"cloud", "potential", "per_n", "families"}


def test_run_equipotential_families_vs_reference(monkeypatch):
    # every family row within rel 1e-12 on the reference's clouds. With each
    # side's own Aberth cloud the sparser family differs: its double root
    # lambda = 1 resolves only to ~1e-9, and c ~ 1 sits on the knife edge
    # |z_2|^2 = 4, so the two clouds' copies escape at k = 2 and k = 3
    ref_split = ref_eq.companion.inverse_cloud_split
    ref_cloud = ref_eq.companion.inverse_cloud
    monkeypatch.setattr(eq.companion, "inverse_cloud_split",
                        lambda ns, fam, tol, backend, device: ref_split(ns, fam, tol=tol))
    monkeypatch.setattr(eq.companion, "inverse_cloud",
                        lambda ns, fam, tol, backend, device: ref_cloud(ns, fam, tol=tol))
    port = eq.run_equipotential(eq.EquipotentialConfig(**SMALL), with_per_n=False,
                                device="cpu")
    ref = ref_eq.run_equipotential(ref_eq.EquipotentialConfig(**SMALL), None,
                                   with_per_n=False)
    assert len(port["family_summary"]) == 4
    for got, want in zip(port["family_summary"], ref["family_summary"]):
        _check_summary(got, want)


def test_per_n_and_cumulative_rows_equal_reference():
    cfg = eq.EquipotentialConfig(**SMALL)
    rng = np.random.RandomState(5)
    per_n_g = [(n, np.where(rng.uniform(size=n) < 0.3, 0.0, rng.exponential(0.1, n)))
               for n in range(cfg.n_min, cfg.n_max + 1)]
    ref_cfg = ref_eq.EquipotentialConfig(**SMALL)
    assert eq.per_n_stats(cfg, per_n_g=per_n_g) == ref_eq.per_n_stats(ref_cfg,
                                                                        per_n_g=per_n_g)
    assert eq.cumulative_stats(cfg, per_n_g=per_n_g) == ref_eq.cumulative_stats(
        ref_cfg, per_n_g=per_n_g)


def test_run_equipotential_f32_twin_vs_f64(small_runs):
    # the contract of test_pallas_kernel.py:173-187
    o64, _ = small_runs
    o32 = eq.run_equipotential(eq.EquipotentialConfig(**SMALL, potential_dtype="float32",
                                                      run_family_comparison=False),
                               with_per_n=False, device="cpu")
    assert o32["summary"]["escaped"] == o64["summary"]["escaped"]
    for key in ("g_median", "g_mean", "g_p90"):
        assert abs(o32["summary"][key] - o64["summary"][key]) < 1e-5


def test_curve_npy(tmp_path):
    xy = np.column_stack([np.linspace(-2.0, 0.4, 200), np.linspace(-0.9, 0.9, 200)])
    path = str(tmp_path / "curve.npy")
    np.save(path, xy)
    cfg = eq.EquipotentialConfig(n_min=2, n_max=8, max_iter=300, curve_npy=path,
                                 run_family_comparison=False)
    out = eq.run_equipotential(cfg, str(tmp_path / "out"), with_per_n=False, plots=False,
                               device="cpu")
    g_c, _, _ = eq.batch_potential(xy[:, 0] + 1j * xy[:, 1], 300, 2.0, device="cpu")
    np.testing.assert_array_equal(out["curve_g"], g_c)
    assert out["curve_summary"] == ref_eq.laws.summarize_g(g_c)
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "g_curve.npy"), g_c)
    assert "stored_curve" in out["stage_times"]

    timer = StageTimer()
    missing = eq.EquipotentialConfig(curve_npy=str(tmp_path / "nope.npy"))
    with pytest.raises(FileNotFoundError):
        eq.run_equipotential(missing, timer=timer, device="cpu")
    assert timer.times == {}


def test_batch_potential_cache_key_differs_from_reference(tmp_path):
    # the port's f64 results differ from the reference's in the last bits
    # (ROADMAP Queue 3), so a shared --cache-dir must never hand one
    # implementation's entry to the other: the reference's own
    # batch_potential, run on the same cache, adds a second entry
    pts = _cloud()[:50]
    cache = tmp_path / "cache"
    for dtype in ("float32", "float64"):
        eq.batch_potential(pts, 200, 2.0, cache_dir=str(cache), dtype=dtype, device="cpu")
    port_files = sorted(p.name for p in cache.iterdir())
    assert len(port_files) == 2 and all(f.startswith("green_potential_") for f in port_files)
    ref_eq.batch_potential(pts, 200, 2.0, cache_dir=str(cache))
    ref_key = ref_artifacts.config_key({"stage": "green_potential",
                                        "cloud": ref_artifacts.array_digest(pts),
                                        "max_iter": 200, "escape_r": 2.0})
    assert f"green_potential_{ref_key}.npz" not in port_files
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [*port_files, f"green_potential_{ref_key}.npz"])
    g1, k1, _ = eq.batch_potential(pts, 200, 2.0, cache_dir=str(cache), dtype="float32",
                                   device="cpu")
    g2, k2, _ = eq.batch_potential(pts, 200, 2.0, cache_dir=str(cache), dtype="float32",
                                   device="cpu")
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(k1, k2)
    with pytest.raises(ValueError, match="dtype"):
        eq.batch_potential(pts, 200, 2.0, dtype="bfloat16", device="cpu")


def test_stored_default_reference_numbers():
    # tests/data/equipotential_default_f64.json holds cmtci's f64 numbers at
    # the CLI defaults, which chip_smoke.py holds the card's f64 run to
    with open(os.path.join(REPO, "tests", "data", "equipotential_default_f64.json")) as f:
        doc = json.load(f)
    s = doc["summary"]
    assert (s["count"], s["escaped"]) == (20099, 18484)
    assert s["escaped_frac"] == 18484 / 20099
    assert [r["family"] for r in doc["family_summary"]] == list(eq.EquipotentialConfig.families)
    assert sum(r["count"] for r in doc["family_summary"]) == 80395


def test_cli_equipotential_session_defaults():
    args = cli._parser().parse_args(["equipotential"])
    cli._resolve_platform_defaults(args)
    assert (args.device, args.green_dtype) == ("cuda", "float32")
    for extra in (["--parity"], ["--device", "cpu"]):
        args = cli._parser().parse_args(["equipotential", *extra])
        cli._resolve_platform_defaults(args)
        assert args.green_dtype == "float64"
    args = cli._parser().parse_args(["equipotential", "--device", "cpu",
                                     "--green-dtype", "float32"])
    cli._resolve_platform_defaults(args)
    assert args.green_dtype == "float32"


def test_cli_equipotential_writes_files(tmp_path):
    out = tmp_path / "eq"
    proc = subprocess.run(
        [sys.executable, "-m", "cmtci_torch.cli", "equipotential", "--device", "cpu",
         "--n-max", "12", "--max-iter", "300", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["count"] > 0
    for name in ("meta.txt", "C_lucas.npy", "g_lucas.npy", "it_lucas.npy", "phi_lucas.npy",
                 "per_n_stats.csv", "cumulative_stats.csv", "family_summary.csv",
                 "equipotential_g_density_compare.png",
                 "equipotential_Phi_density_logunif.png", "family_kde_overlay.png"):
        assert os.path.exists(out / name), name
