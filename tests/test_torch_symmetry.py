"""cmtci_torch's symmetry analysis and the `symmetry` pipeline against cmtci
(the JAX reference) on the CPU.

The op images are numpy copies and must be equal. The f64 scan scores must
equal the reference's on a test bus (a stage-1 bus's C_aligned and M at a
small size); the f32 scan within 0.02 of the f64 one
(tests/test_stats_more.py:371).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtci.pipelines import analysis as ref_analysis
from cmtci.pipelines.stage1 import Stage1Config, run_stage1
from cmtci.stats import symmetry as ref
from cmtci_torch.pipelines import analysis
from cmtci_torch.stats import symmetry as sym


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bus():
    """A stage-1 bus at a small size (cmtci's; the port's equals it)."""
    out = run_stage1(Stage1Config(max_n=16, boundary_samples=150))
    return out["C_aligned"], out["M"], out["matches"]


def test_reflect_and_ops_equal(rng):
    pts = rng.normal(size=(100, 2))
    for angle, origin in ((0.7, np.array([0.1, -0.2])), (2.9, None)):
        np.testing.assert_array_equal(sym.reflect_across_line(pts, angle, origin),
                                      ref.reflect_across_line(pts, angle, origin))
    for op in ("identity", "reflect_x", "reflect_y", "rot_pi"):
        np.testing.assert_array_equal(sym.apply_symmetry_op(pts, op),
                                      ref.apply_symmetry_op(pts, op))
    np.testing.assert_array_equal(sym.apply_symmetry_op(pts, "reflect_angle", 1.1),
                                  ref.apply_symmetry_op(pts, "reflect_angle", 1.1))
    with pytest.raises(ValueError, match="angle"):
        sym.apply_symmetry_op(pts, "reflect_angle")
    with pytest.raises(ValueError, match="Unknown op"):
        sym.apply_symmetry_op(pts, "shear")


def test_nearest_distances_against_cmtci(rng, monkeypatch):
    a, b = rng.normal(size=(700, 2)), rng.normal(size=(333, 2))
    want = np.asarray(ref.nearest_distances(jnp.asarray(a), jnp.asarray(b)))
    got = sym.nearest_distances(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    # blocks of a few rows, and a stack of images, give the same distances
    monkeypatch.setattr(sym, "_BLOCK_ELEMS", 1000)
    stacked = sym.nearest_distances(torch.as_tensor(np.stack([a, a[::-1]])),
                                    torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(stacked[0], got)
    np.testing.assert_array_equal(stacked[1], got[::-1])


def test_f64_scan_scores_equal_to_cmtci(bus):
    ca, m, _ = bus
    angles = np.linspace(0, np.pi, 361)
    for pts in (ca, m):
        got = sym._score_angles(pts, angles, 0.05, device="cpu")
        want = ref._score_angles(pts, angles, 0.05)
        np.testing.assert_array_equal(got, want)


def test_f32_scan_close_to_f64(rng):
    """tests/test_stats_more.py:371: an x-symmetric cloud, 91 angles."""
    pts = rng.normal(size=(300, 2))
    pts = np.vstack([pts, pts @ np.array([[1, 0], [0, -1.0]])])
    b64 = sym.best_reflection_axis(pts, pts, tol=0.05, n_angles=91, device="cpu")
    b32 = sym.best_reflection_axis(pts, pts, tol=0.05, n_angles=91, dtype=torch.float32,
                                   device="cpu")
    np.testing.assert_allclose(b32["scan_score"], b64["scan_score"], atol=0.02)
    assert abs(b32["frac_a"] - b64["frac_a"]) < 0.02


def test_f32_refine_against_cmtci(bus):
    """The f32 device refine (two 128-angle grid stages) picks the
    reference's angle on the test bus."""
    ca, m, _ = bus
    got = sym.best_reflection_axis(ca, m, dtype=torch.float32, device="cpu")
    want = ref.best_reflection_axis(ca, m, dtype=jnp.float32)
    np.testing.assert_allclose(got["scan_score"], want["scan_score"], atol=0.02)
    assert got["angle"] == pytest.approx(want["angle"], abs=1e-3)
    assert abs(got["frac_a"] - want["frac_a"]) < 0.02


def test_symmetry_report_f64_equal_to_cmtci(bus):
    ca, m, matches = bus
    rows, best = sym.symmetry_report(ca, m, matches, device="cpu")
    want_rows, want_best = ref.symmetry_report(ca, m, matches)
    assert best["angle"] == want_best["angle"]
    np.testing.assert_array_equal(best["scan_score"], want_best["scan_score"])
    assert len(rows) == len(want_rows) == 5
    for r, w in zip(rows, want_rows):
        assert r.keys() == w.keys()
        for k in r:
            if k.startswith("mean_dist"):
                assert r[k] == pytest.approx(w[k], rel=1e-14), k
            else:
                assert r[k] == w[k], k


def test_run_symmetry_files_against_cmtci(tmp_path, bus):
    ca, m, matches = bus
    port, want = str(tmp_path / "p"), str(tmp_path / "r")
    got = analysis.run_symmetry(ca, m, matches, out_prefix=port, device="cpu")
    ref_analysis.run_symmetry(ca, m, matches, out_prefix=want)
    assert open(f"{port}_meta.txt").read() == open(f"{want}_meta.txt").read()
    a = open(f"{port}_symmetry_report_bestaxis.csv").read().splitlines()
    b = open(f"{want}_symmetry_report_bestaxis.csv").read().splitlines()
    assert a[0] == b[0] and a[-1] == b[-1]  # header, and the best axis row
    assert got["rows"][-1]["op"] == "reflect_best_angle"


def test_symmetry_cuda_without_card_raises(bus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sym.symmetry_report(bus[0], bus[1])
