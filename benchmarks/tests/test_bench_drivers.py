"""The job drivers at a tiny size on the CPU against the plain reference,
and the control (the reference one precision step below) against the same
limits: the program passes every limit, the control fails one."""

import math

import numpy as np
import pytest

from benchmarks import control
from benchmarks.harness import files
from benchmarks.tests import tiny
from benchmarks.reference import lucas

SEEDS = (3, 2**31 + 11)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_program_within_limits_and_control_outside(cell):
    wl, cfg = tiny.CELLS[cell]()
    lines = list(control.readings(cell, SEEDS, tiny.CPU, workload=wl, config=cfg))
    assert [(x["seed"], x["side"]) for x in lines] == [
        (s, side) for s in SEEDS for side in ("program", "control")]
    for x in lines:
        assert set(x["checks"]) == set(wl["limits"])
        assert x["correct"] == (x["side"] == "program"), x


def test_tracker_reference_rows_are_the_programs():
    wl, cfg = tiny.tracker_cell()
    job = files.driver(wl["driver"]).Job(cfg, wl, tiny.CPU)
    rows, stages = job.run(77)
    ref = job.reference(77, "stated")
    assert [r["bins"] for r in rows] == [16, 32, 64, 128]
    assert job.compare(rows, ref) == {"rows_count_gap": 0.0, "rows_gap": 0.0}
    assert job.compare(rows[:-1], ref) == {"rows_count_gap": math.inf, "rows_gap": math.inf}
    fewer = [dict(r) for r in rows]
    fewer[2]["n_mandel_pts"] -= 1
    assert job.compare(fewer, ref) == {"rows_count_gap": 1.0, "rows_gap": 0.0}
    lost = [dict(r) for r in rows]
    lost[1]["delta_n"] = float("nan")
    assert job.compare(lost, ref)["rows_gap"] == math.inf
    assert {k.split("_", 1)[1] for k in stages} == {"cloud", "sample", "match", "hist", "giflow"}


@pytest.mark.parametrize("n", [2, 3, 20, 101])
def test_lucas_roots_are_the_companion_eigenvalues(n):
    top = np.zeros((n, n))
    top[0, :] = 1.0
    top[np.arange(1, n), np.arange(n - 1)] = 1.0
    assert lucas.set_gap(np.linalg.eigvals(top), lucas.roots(n)) < 1e-13


def test_cloud_gap_sees_a_missing_or_doubled_root():
    ref = lucas.inverse_cloud(range(2, 12))
    cloud = np.concatenate(ref)
    assert lucas.cloud_gap(cloud, ref) == 0.0
    assert math.isinf(lucas.cloud_gap(cloud[:-1], ref))
    doubled = cloud.copy()
    doubled[5] = doubled[6]
    assert lucas.cloud_gap(doubled, ref) > 1e-2


def test_in_order_puts_the_reference_roots_in_the_programs_order():
    ref = lucas.inverse_cloud(range(2, 12))
    rng = np.random.default_rng(5)
    shuffled = [r[rng.permutation(len(r))] for r in ref]
    program = np.concatenate(shuffled) + 1e-13
    assert np.array_equal(lucas.in_order(program, ref), np.concatenate(shuffled))
    assert lucas.in_order(program[:-1], ref) is None
    doubled = program.copy()
    doubled[5] = doubled[6]
    assert lucas.in_order(doubled, ref) is None
