"""cmtci_torch's run_equipotential against the benchmark's plain reference of
the Green-function statistics (benchmarks/reference/equipotential.py, numpy
only), on the CPU at a small size: n = 2..14, 400 steps, and a stored curve
of 300 points from the band of a 200 x 200 grid.

The program keeps every limit of the cell equipotential_default.f64 with
every escape step equal; its counters are numpy's counts of the records it
returns; the control (the reference one precision step down) fails g_gap;
and each fault of the returned records breaks a limit.
"""

import copy

import numpy as np
import pytest
import torch

from benchmarks.harness import files
from benchmarks.inputs.mandel_band import Band
from benchmarks.reference import equipotential as reference
from cmtci_torch.pipelines import equipotential as eq

CELL = "equipotential_default.f64"
LIMITS = files.workload(CELL)["limits"]
SEEDS = (7, 2**31 + 5)
SMALL = {"n_max": 14, "max_iter": 400}
CURVE_POINTS = 300


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers on
    the CPU at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    config = files.config(files.workload(CELL)["config"])
    return {**config["equipotential"], **SMALL}


@pytest.fixture(scope="module")
def band():
    rule = {**files.config(files.workload(CELL)["config"])["curve"]["mandel_band"], "res": 200}
    return Band(rule, torch.device("cpu"))


def _run(cfg, curve, tmp, out_dir=None):
    path = tmp / "curve.npy"
    np.save(path, curve)
    fields = {k: v for k, v in cfg.items() if k != "with_per_n"}
    ecfg = eq.EquipotentialConfig(**{**fields, "families": tuple(fields["families"]),
                                     "curve_npy": str(path)})
    return eq.run_equipotential(ecfg, out_dir, with_per_n=True, plots=False, device="cpu")


@pytest.fixture(scope="module", params=SEEDS)
def runs(request, cfg, band, tmp_path_factory):
    """(program result, stated reference, curve) for one seed's curve."""
    curve = band.draw(request.param, CURVE_POINTS)
    out = _run(cfg, curve, tmp_path_factory.mktemp("eq"))
    return out, reference.equipotential(curve, cfg, "stated"), curve


def _judged(numbers):
    return {name: numbers[name] <= limit for name, limit in LIMITS.items()}


def test_program_keeps_every_limit(runs, cfg):
    out, ref, _ = runs
    numbers = reference.compare(out, ref, cfg)
    assert set(numbers) == set(LIMITS)
    assert all(_judged(numbers).values()), numbers
    assert numbers["k_moved"] == 0.0
    # the small run holds the rows the comparison reads: escapes on both
    # sides, every family, both laws
    assert out["laws"] is not None and out["curve_laws"] is not None
    assert [r["family"] for r in out["family_summary"]] == list(cfg["families"])
    assert len(out["per_n"]) == len(out["cumulative"]) == 13


def test_counters_are_numpy_counts_of_the_records(runs, cfg):
    out, _, _ = runs
    pts = out["points"]
    assert list(pts["families"]) == list(cfg["families"])
    k = np.concatenate([rec["k"] for rec in (*pts["families"].values(), pts["curve"])])
    max_iter = cfg["max_iter"]
    assert out["counts"] == {
        "equipotential.green_points": k.size,
        "equipotential.green_unescaped": int(np.count_nonzero(k == max_iter)),
        "equipotential.green_escape_steps": int(k[k < max_iter].sum()),
    }
    assert 0 < out["counts"]["equipotential.green_unescaped"] < k.size
    assert set(out["stage_times"]) == {"cloud", "potential", "per_n", "families",
                                       "stored_curve"}


def test_points_are_the_records_the_run_writes(cfg, band, tmp_path):
    curve = band.draw(11, CURVE_POINTS)
    out = _run(cfg, curve, tmp_path, out_dir=str(tmp_path))
    lucas = out["points"]["families"]["lucas_all_ones"]
    np.testing.assert_array_equal(lucas["c"], np.load(tmp_path / "C_lucas.npy"))
    np.testing.assert_array_equal(lucas["g"], np.load(tmp_path / "g_lucas.npy"))
    np.testing.assert_array_equal(lucas["k"], np.load(tmp_path / "it_lucas.npy"))
    np.testing.assert_array_equal(out["points"]["curve"]["g"], np.load(tmp_path / "g_curve.npy"))
    np.testing.assert_array_equal(out["points"]["curve"]["c"], curve)
    for fam, row in zip(out["points"]["families"].values(), out["family_summary"]):
        assert row["count"] == fam["c"].size == fam["g"].size == fam["k"].size


def test_control_fails_g_gap(runs, cfg):
    out, ref, curve = runs
    control = reference.as_output(reference.equipotential(curve, cfg, "lower"), cfg)
    numbers = reference.compare(control, ref, cfg)
    assert numbers["g_gap"] > LIMITS["g_gap"], numbers
    assert not all(_judged(numbers).values())


def _escaped(rec, max_iter):
    return int(np.flatnonzero((np.asarray(rec["k"]) < max_iter) & (rec["g"] > 0))[0])


def _k_off_by_one(out, max_iter):
    rec = out["points"]["families"]["lucas_all_ones"]
    rec["k"][_escaped(rec, max_iter)] += 1


def _g_scaled(out, max_iter):
    rec = out["points"]["curve"]
    rec["g"][_escaped(rec, max_iter)] *= 1 + 1e-6


def _root_dropped(out, max_iter):
    rec = out["points"]["families"]["pell_like_all_twos"]
    for key in ("c", "g", "k"):
        rec[key] = rec[key][1:]


def _escaped_count_off(out, max_iter):
    out["per_n"][3]["escaped"] += 1


@pytest.mark.parametrize("fault, number", [
    (_k_off_by_one, "k_moved"), (_g_scaled, "g_gap"), (_root_dropped, "cloud_gap"),
    (_escaped_count_off, "rows_count_gap")], ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_breaks_its_limit(runs, cfg, fault, number):
    out, ref, _ = runs
    bad = copy.deepcopy(out)
    fault(bad, cfg["max_iter"])
    numbers = reference.compare(bad, ref, cfg)
    assert numbers[number] > LIMITS[number], numbers
