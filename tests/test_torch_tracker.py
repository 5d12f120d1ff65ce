"""cmtci_torch's Appendix-A tracker against the checked-in oracles and
against cmtci (the JAX reference), on the CPU.

tests/data/v3_*.csv are the reference repo's frozen gi_assumption_tracker_v3
outputs (seed 7); the contracts are tests/test_tracker_regression.py's.
"""

import csv
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from cmtci.pipelines import tracker as ref_tracker
from cmtci.utils import artifacts as ref_artifacts
from cmtci_torch import cli
from cmtci_torch.pipelines.tracker import (TrackerConfig, config_from_reference,
                                           run_tracker, write_outputs)
from cmtci_torch.utils import artifacts

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK_KEYS = [
    "kl_initial", "delta_n", "kl_PM_PC", "tv_XT_PM", "tv_PC_PM",
    "overlap_mass_PC_PM", "tv_bound_PC_PM", "compound",
]
EXACT_KEYS = ["n_construct_pts", "n_mandel_pts", "T_n", "bins", "stop_reason"]
DENSE = dict(sigma_bins=3.0, t_fixed=25, bins_start=64, bins_max=512,
             construct_max_growth=1.6, mandelbrot_samples_growth=1.6,
             mandelbrot_samples_max=300000)
TINY = dict(sigma_bins=3.0, t_fixed=3, bins_start=16, bins_max=32,
            mandelbrot_grid_start=96, construct_max_start=60,
            mandelbrot_samples_start=400)


def _ref_rows(name):
    with open(os.path.join(DATA, name)) as f:
        return list(csv.DictReader(f))


def _check_exact(r, ref):
    for k in EXACT_KEYS:
        got = getattr(r, k)
        want = type(got)(ref[k]) if not isinstance(got, str) else ref[k]
        assert got == want, k


def test_parity_fixed_t_stage1_vs_oracle():
    ref = _ref_rows("v3_T25_sigma3_dense.csv")[0]
    rows, _ = run_tracker(TrackerConfig(**DENSE, parity=True), max_stages=1, device="cpu")
    r = rows[0]
    for k in CHECK_KEYS:
        assert float(getattr(r, k)) == pytest.approx(float(ref[k]), rel=1e-9), k
    _check_exact(r, ref)
    assert r.mass_outside_domain_C == 0.0 and r.mass_outside_domain_M == 0.0


def test_parity_adaptive_stage1_vs_oracle():
    ref = _ref_rows("v3_adaptive.csv")[0]
    cfg = TrackerConfig(sigma_bins=1.0, t_fixed=-1, bins_start=64, bins_max=512,
                        parity=True)
    rows, _ = run_tracker(cfg, max_stages=1, device="cpu")
    r = rows[0]
    assert r.T_n == int(ref["T_n"]) == 87
    assert r.stop_reason == "kl_threshold_met"
    for k in CHECK_KEYS:
        assert float(getattr(r, k)) == pytest.approx(float(ref[k]), rel=1e-9), k


@pytest.fixture(scope="module")
def f64_torch_rows():
    rows, meta = run_tracker(TrackerConfig(**DENSE), max_stages=2, device="cpu")
    return rows, meta


def test_f64_torch_path_stage1_vs_oracle(f64_torch_rows):
    ref = _ref_rows("v3_T25_sigma3_dense.csv")[0]
    r = f64_torch_rows[0][0]
    for k in CHECK_KEYS:
        assert float(getattr(r, k)) == pytest.approx(float(ref[k]), rel=2e-3), k
    _check_exact(r, ref)


def test_f64_torch_path_stage2_vs_oracle(f64_torch_rows):
    ref = _ref_rows("v3_T25_sigma3_dense.csv")[1]
    rows, meta = f64_torch_rows
    r = rows[1]
    assert r.bins == 128 and r.n_construct_pts == 6000
    for k in ("delta_n", "tv_PC_PM", "overlap_mass_PC_PM"):
        assert float(getattr(r, k)) == pytest.approx(float(ref[k]), rel=0.05), k
    assert meta["device"] == "cpu"
    assert {"bins64_cloud", "bins64_sample", "bins64_match", "bins128_giflow"} <= set(
        meta["stage_times"])


def _rows_equal(r1, r2):
    for a, b in zip(r1, r2):
        assert dataclasses.asdict(a) == {**dataclasses.asdict(b),
                                         "runtime_sec": a.runtime_sec}


def test_kernel_path_on_cpu_tracks_reference():
    """de_impl="cuda" on a CPU device runs the K1 twin with the band and the
    subsample on the device: deterministic run to run, and its TV(P_C, P_M)
    within 1.25x the f64 seed-to-seed spread of cmtci's pallas-interpret run
    (a new realization of the sampler, held statistically)."""
    cfg = TrackerConfig(**TINY, field_dtype="float32", de_impl="cuda")
    r1, _ = run_tracker(cfg, device="cpu")
    r2, _ = run_tracker(cfg, device="cpu")
    _rows_equal(r1, r2)

    ref_rows, _ = ref_tracker.run_tracker(ref_tracker.TrackerConfig(
        **TINY, field_dtype="float32", de_impl="pallas"))
    spread_runs = [run_tracker(TrackerConfig(**TINY, seed=s), device="cpu")[0]
                   for s in (7, 8, 9, 10)]
    assert len(r1) == len(ref_rows) == 2
    for i, (got, want) in enumerate(zip(r1, ref_rows)):
        tvs = [rows[i].tv_PC_PM for rows in spread_runs]
        spread = max(tvs) - min(tvs)
        assert spread > 0
        assert abs(got.tv_PC_PM - want.tv_PC_PM) <= 1.25 * spread, (i, got.tv_PC_PM,
                                                                    want.tv_PC_PM, tvs)
        assert got.n_construct_pts == want.n_construct_pts


def test_output_schema_matches_reference(tmp_path):
    rows, meta = run_tracker(TrackerConfig(sigma_bins=3.0, t_fixed=2, bins_start=16,
                                           bins_max=16, mandelbrot_grid_start=120,
                                           mandelbrot_samples_start=2000,
                                           construct_max_start=60), device="cpu")
    csv_path, json_path = write_outputs(rows, meta, str(tmp_path / "out"))
    got_header = open(csv_path).readline().strip().split(",")
    ref_header = open(os.path.join(DATA, "v3_adaptive.csv")).readline().strip().split(",")
    assert got_header == ref_header
    assert [f.name for f in dataclasses.fields(ref_tracker.TrackerRow)] == got_header
    assert os.path.exists(json_path) and os.path.exists(str(tmp_path / "out_meta.txt"))


def test_config_from_reference_round_trip():
    ref_cfg = ref_tracker.TrackerConfig(sigma_bins=3.0, t_fixed=25, de_impl="pallas",
                                        field_dtype="float32", seed=11)
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    assert cfg.de_impl == "cuda" and cfg.field_dtype == "float32" and cfg.seed == 11
    assert ([f.name for f in dataclasses.fields(TrackerConfig)]
            == [f.name for f in dataclasses.fields(ref_tracker.TrackerConfig)])
    d = dataclasses.asdict(cfg)
    d_ref = dataclasses.asdict(ref_cfg)
    assert {k: v for k, v in d.items() if k != "de_impl"} == {
        k: v for k, v in d_ref.items() if k != "de_impl"}
    # the reference's JSON meta (domain as a list) maps too
    meta_cfg = config_from_reference({**d_ref, "domain": list(ref_cfg.domain),
                                      "de_impl": "jax", "rows": []})
    assert meta_cfg.domain == ref_cfg.domain and meta_cfg.de_impl == "torch"


def test_rng_state_round_trips_with_reference():
    a = np.random.RandomState(7)
    a.choice(1000, 50, replace=False)
    a.normal()  # leaves a cached gaussian in the state
    b = np.random.RandomState(0)
    artifacts.restore_rng_state(b, ref_artifacts.rng_state_arrays(a))
    assert a.randint(0, 2**31 - 1) == b.randint(0, 2**31 - 1)
    c = np.random.RandomState(1)
    ref_artifacts.restore_rng_state(c, artifacts.rng_state_arrays(b))
    assert b.normal() == c.normal()
    assert set(artifacts.rng_state_arrays(b)) == set(ref_artifacts.rng_state_arrays(b))


def test_cache_dir_resumes_identically(tmp_path):
    cfg = TrackerConfig(**TINY)
    r1, _ = run_tracker(cfg, cache_dir=str(tmp_path), device="cpu")
    assert len(list(tmp_path.glob("tracker_stage_*.npz"))) == 2
    r2, _ = run_tracker(cfg, cache_dir=str(tmp_path), device="cpu")
    _rows_equal(r1, r2)


def test_cli_session_defaults():
    args = cli._parser().parse_args(["tracker"])
    cli._resolve_platform_defaults(args)
    assert (args.device, args.field_dtype, args.de_impl) == ("cuda", "float32", "cuda")
    for extra in (["--parity"], ["--device", "cpu"]):
        args = cli._parser().parse_args(["tracker", *extra])
        cli._resolve_platform_defaults(args)
        assert (args.field_dtype, args.de_impl) == ("float64", "torch")
    args = cli._parser().parse_args(["tracker", "--device", "cpu", "--de-impl", "cuda"])
    cli._resolve_platform_defaults(args)
    assert args.de_impl == "cuda"


def test_cli_tracker_writes_files(tmp_path):
    out = tmp_path / "trk"
    proc = subprocess.run(
        [sys.executable, "-m", "cmtci_torch.cli", "tracker", "--device", "cpu",
         "--sigma-bins", "3.0", "--t-fixed", "2", "--bins-start", "16",
         "--bins-max", "16", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "tracker: 1 stages" in proc.stdout
    rows = list(csv.DictReader(open(f"{out}.csv")))
    assert len(rows) == 1 and rows[0]["bins"] == "16"
    assert os.path.exists(f"{out}.json") and os.path.exists(f"{out}_meta.txt")


def test_cli_cuda_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["tracker", "--bins-start", "16", "--bins-max", "16"])
