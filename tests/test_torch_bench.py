"""cmtci_torch's bench path on the CPU: K7's plain twin against the Pallas
kernel of the reference's bench.py, the roofline step accounting, and
cmtci_torch.bench end to end at small sizes.

The kernel itself (csrc/fma_peak.cu) runs only on the card, where
chip_smoke.py holds it bitwise to the twin at the full 16,777,216 elements
x 8192 steps.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cmtci_torch import bench
from cmtci_torch.kernels import fma_peak as fp
from cmtci_torch.kernels import mandelbrot_cuda as mc
from cmtci_torch.pipelines.coupling import CouplingConfig
from cmtci_torch.pipelines.stage1 import Stage1Config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pallas_fma_chain(th, tw, tiles, k):
    """The reference's K7 (bench.py:238-248, `kern` nested in
    _bench_vpu_peak and so not importable), restated line for line and run
    through pl.pallas_call in interpret mode."""

    def kern(o_ref):
        a = jnp.float32(0.9999999)
        b = jnp.float32(1e-7)

        def body(i, x):
            for _ in range(16):
                x = x * a + b
            return x

        o_ref[:] = jax.lax.fori_loop(
            0, k // 16, body, jnp.full((th, tw), 1.0000001, jnp.float32))

    with jax.enable_x64(False):
        out = pl.pallas_call(
            kern,
            grid=(tiles,),
            out_specs=pl.BlockSpec((th, tw), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((tiles * th, tw), jnp.float32),
            interpret=True,
        )()
        return np.asarray(out)


def test_k7_constants_are_the_f32_values_of_the_reference():
    assert fp.A == float(np.float32(0.9999999)) == 1.0 - 2.0 ** -23
    assert fp.X0 == float(np.float32(1.0000001)) == 1.0 + 2.0 ** -23
    assert fp.B == float(np.float32(1e-7))
    assert fp.N_ELEMS == 64 * 256 * 1024 == 16_777_216 and fp.K_STEPS == 8192


@pytest.mark.parametrize("k", [16, 8192])
def test_k7_twin_equals_pallas_interpret_bitwise(k):
    ref = _pallas_fma_chain(8, 128, 2, k)
    twin = fp.fma_chain(ref.size, k, device="cpu").numpy()
    assert twin.dtype == np.float32 and twin.shape == (ref.size,)
    np.testing.assert_array_equal(twin.view(np.int32), ref.ravel().view(np.int32))


def test_k7_fixed_point_fused_and_unfused():
    """Every element is 0x3F800001 whether a step rounds once (the kernel's
    __fmaf_rn: the exact product and sum, computed here in f64, rounded once)
    or twice (the twin), so kernel and twin can be held bitwise."""
    out = fp.fma_chain_torch(257, 8192).numpy()
    assert (out.view(np.int32) == fp.FIXED_POINT_BITS).all()
    fused = np.float32(np.float64(fp.X0) * np.float64(fp.A) + np.float64(fp.B))
    assert fused.view(np.int32) == fp.FIXED_POINT_BITS
    unfused = np.float32(np.float32(fp.X0) * np.float32(fp.A)) + np.float32(fp.B)
    assert np.float32(unfused).view(np.int32) == fp.FIXED_POINT_BITS


def test_k7_wrapper_on_cpu_runs_twin_and_counts_no_launch():
    before = dict(mc.launches)
    out = fp.fma_chain(100, 32, device="cpu")
    assert torch.equal(out, fp.fma_chain_torch(100, 32))
    assert fp.fma_chain(0, 5, device="cpu").shape == (0,)
    assert mc.launches == before and "fma_peak" in mc.launches
    with pytest.raises(ValueError, match=">= 0"):
        fp.fma_chain(-1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        fp.fma_chain(8, 8, device="cuda")  # no card here: raises, no fallback


def test_dwell_step_counts_on_planted_array():
    """2 rows x 40 columns, max_iter 100: row 0 escapes at dwell 4 except one
    bounded lane (column 3) and one interior lane (column 35); row 1 is
    interior throughout. On the row layout the warps are columns 0-31 and the
    ragged 32-39 of each row; on K2's own footprint (the default) a warp holds
    patch_w columns x patch_h rows and tests its exit every c steps."""
    dwell = torch.full((2, 40), 4.0)
    interior = torch.zeros((2, 40), dtype=torch.bool)
    dwell[0, 3] = 100.0
    interior[0, 35] = True
    dwell[0, 35] = 100.0
    interior[1] = True
    dwell[1] = 100.0
    useful, executed = bench.dwell_step_counts(dwell, interior, 100, bench.ROW_WARP)
    assert useful == 38 * 5 + 100
    assert executed == 32 * 100 + 32 * 5
    f = mc.DWELL_FOOTPRINT
    useful, executed = bench.dwell_step_counts(dwell, interior, 100)
    assert useful == 38 * 5 + 100
    trips = [100 if x0 <= 3 else 5 for x0 in range(0, 40, f["patch_w"])]
    assert executed == sum(32 * -(-t // f["c"]) * f["c"] for t in trips)
    # a lane that escapes at the last step iterates max_iter steps, not more
    assert bench.dwell_step_counts(torch.full((1, 32), 99.0),
                                   torch.zeros((1, 32), dtype=torch.bool), 100,
                                   bench.ROW_WARP) == (3200.0, 3200.0)


def test_escape_lane_steps_agree_with_the_dwell_and_grow_with_the_radius():
    """At radius 2 the per-lane trips are the ones dwell_step_counts reads off
    K2's output; at K4's radius 4 no lane takes fewer and some take more."""
    dom, n, max_iter = bench.DOM, 64, 60
    cr, ci = mc._grid_coords(dom, n, n, torch.device("cpu"))
    interior = mc._interior_mask_torch(cr, ci)
    dwell = mc.dwell_field_torch(dom, n, n, max_iter)
    lane2 = bench.escape_lane_steps(cr, ci, max_iter, 4.0)
    assert lane2.dtype == torch.int32 and lane2.shape == (n, n)
    assert (lane2[interior] == 0).all() and int(lane2.max()) == max_iter
    useful, executed = bench.dwell_step_counts(dwell, interior, max_iter, bench.ROW_WARP)
    assert float(lane2.sum()) == useful
    assert bench.warp_executed_steps(lane2) == executed
    lane4 = bench.escape_lane_steps(cr, ci, max_iter, 16.0)
    assert (lane4 >= lane2).all() and int((lane4 > lane2).sum()) > 0
    assert float((lane4 - lane2)[lane2 < max_iter].float().mean()) < 2.0


def _executed_brute(lane: np.ndarray, f: dict, max_steps=None) -> float:
    """32 lanes x each warp's trips, warp by warp over the patches."""
    ny, nx = lane.shape
    total = 0
    for y0 in range(0, ny, f["patch_h"]):
        for x0 in range(0, nx, f["patch_w"]):
            longest = int(lane[y0:y0 + f["patch_h"], x0:x0 + f["patch_w"]].max())
            trips = -(-longest // f["c"]) * f["c"]
            total += 32 * (trips if max_steps is None else min(trips, max_steps))
    return float(total)


@pytest.mark.parametrize("shape", [(37, 61), (9, 5), (64, 64)])
def test_de_executed_steps_on_k4s_footprint_against_a_brute_force_count(shape):
    """K4's executed steps as bench_mfu counts them: its own orbits to radius
    4 (escape_lane_steps) on DE_FOOTPRINT, warp by warp on a ragged grid."""
    ny, nx = shape
    max_iter = 60
    cr, ci = mc._grid_coords(bench.DOM, nx, ny, torch.device("cpu"))
    lane = bench.escape_lane_steps(cr, ci, max_iter, bench.DE_ESCAPE_R ** 2)
    got = bench.warp_executed_steps(lane, mc.DE_FOOTPRINT)
    assert got == _executed_brute(lane.numpy(), mc.DE_FOOTPRINT) >= float(lane.sum())
    if ny * nx > 1000:
        assert got != bench.warp_executed_steps(lane, bench.ROW_WARP)


@pytest.mark.parametrize("max_iter", [30, 32])
def test_tci_lane_steps_of_k1s_two_passes(max_iter):
    """K1's first pass runs z alone until the lane has escaped and z is
    non-finite, a few steps past the radius; the second pass belongs to the
    few late escapers, which hold every pixel with d > 0; K1's chunks never
    pass max_iter, which max_steps says."""
    n = 48
    dom = (-2.2, 1.2, -1.6, 1.6)
    cr, ci = mc._grid_coords(dom, n, n, torch.device("cpu"))
    first, second = bench.tci_lane_steps(cr, ci, max_iter, 62500.0)
    to_radius = bench.escape_lane_steps(cr, ci, max_iter, 62500.0)
    assert first.dtype == second.dtype == torch.int32 and (first >= to_radius).all()
    assert int((first > to_radius).sum()) > 0 and int(first.max()) == max_iter
    assert int((first - to_radius).max()) <= 8
    assert (first[mc._interior_mask_torch(cr, ci)] == 0).all()
    late = second > 0
    d = mc.tci_de_field_torch(dom, n, max_iter, 250.0)
    assert 0 < int((d > 0).sum()) <= int(late.sum()) < 0.05 * n * n
    assert late[d > 0].all() and (d[late] >= 0).all() and (first[late] == max_iter).all()
    assert int(second.max()) == max_iter
    f = mc.TCI_FOOTPRINT
    capped = bench.warp_executed_steps(first, f, max_iter)
    assert capped == _executed_brute(first.numpy(), f, max_iter)
    if max_iter % f["c"]:
        assert capped < bench.warp_executed_steps(first, f)


def _step_ops(body: str):
    """(mul, add/sub, compare) counted from the text of a step's body."""
    return (body.count(" * "), body.count(" + ") + body.count(" - "),
            body.count(" > ") + body.count("<="))


def _csrc(name: str) -> str:
    return (Path(mc.__file__).resolve().parents[1] / "csrc" / name).read_text()


def test_ops_per_step_of_k4_and_k1_count_their_steps():
    """de_std.cu iterates its de_bare_step, 9 mul, 7 add/sub, 1 compare;
    tci_de.cu iterates escape.cuh:bare_step in its first pass, 4 mul, 4
    add/sub, 1 compare, and the step-by-step (z, dz) loop of late_escaper in
    its second, 12 mul, 7 add/sub, 3 compares (the radius and the two halves
    of dz). OPS_PER_STEP states each."""
    text = _csrc("de_std.cu")
    body = text[text.index("void de_bare_step("):]
    body = body[body.index("const float tr"):body.index("\n}\n")]
    assert _step_ops(body) == (9, 7, 1) and mc.OPS_PER_STEP["de_std"] == 17
    assert text.count("de_bare_step(zr, zi, zr2, zi2, dzr, dzi, hit, cr, ci, r2);") == 1
    text = _csrc("escape.cuh")
    body = text[text.index("void bare_step("):]
    body = body[body.index("const float nzr"):body.index("\n}\n")]
    assert _step_ops(body) == (4, 4, 1) and mc.OPS_PER_STEP["tci_de"] == 9
    text = _csrc("tci_de.cu")
    assert text.count("bare_step(zr, zi, zr2, zi2, hit, cr, ci, r2);") == 2  # chunk and tail
    body = text[text.index("float late_escaper("):]
    body = body[body.index("const float tr"):body.index("break;")]
    mul, add, cmp = _step_ops(body)
    assert (mul, add, cmp + body.count("isfinite(")) == (12, 7, 3)
    assert mc.OPS_PER_STEP["tci_de_late"] == 22


def test_padded_domain_keeps_the_headline_spacing():
    sizes = bench.BenchSizes()
    dom = bench.padded_domain(sizes)
    dx = 3.0 / 1999
    assert dom[0] == -2.1 and dom[2] == -1.5
    np.testing.assert_allclose([dom[1], dom[3]], [-2.1 + dx * 2047, -1.5 + dx * 2047],
                               rtol=1e-15)


def test_bench_sizes_defaults_are_the_reference_configs():
    s = bench.BenchSizes()
    assert (s.res, s.max_iter, s.reps, s.mfu_res) == (2000, 500, 50, 2048)
    assert s.scale_grids == ((4096, 12), (8192, 3)) and s.cloud_points == 150_000
    assert s.knn_k == 20 and s.stage4_ns == tuple(range(20, 1221, 20))
    t = s.tracker
    assert (t.sigma_bins, t.t_fixed, t.bins_start, t.bins_max) == (3.0, 25, 64, 512)
    assert (t.construct_max_growth, t.mandelbrot_samples_growth,
            t.mandelbrot_samples_max) == (1.6, 1.6, 300000)
    assert (t.field_dtype, t.de_impl) == ("float32", "cuda")
    assert s.equipotential.potential_dtype == "float32"
    assert (s.variograms.vario_dtype, s.variograms.field_dtype) == ("float32", "float32")
    assert (s.tci.mandelbrot_grid, s.tci.de_impl) == (2400, "cuda")
    assert s.coupling_bus == Stage1Config()
    assert s.coupling == CouplingConfig(field_dtype="float32")


PORTED = ("value", "dwell_tflops", "vpu_peak_tflops", "dwell_mfu", "dwell_mfu_useful",
          "de_tflops", "de_mfu", "escape_grid_res128_mpix_s", "escape_grid_res160_mpix_s",
          "spatial_stats_150k_s", "knn_150k_s", "eigensweep_s", "tracker_warm_s",
          "equipotential_s", "variograms_s", "tci_4x_s", "coupling_s")


@pytest.fixture(scope="module")
def small_run():
    return bench.run(bench.small_sizes(), device="cpu")


def test_bench_run_small_has_every_ported_key_finite(small_run):
    assert not [k for k in small_run if k.endswith("_error")], small_run
    for key in PORTED:
        assert np.isfinite(small_run[key]) and small_run[key] >= 0, key
    assert small_run["value"] > 0 and small_run["unit"] == "Mpix/s"
    assert small_run["metric"] == "escape_grid_res96_mi60_throughput"
    assert small_run["device"] == "cpu"
    # the card's ceiling is read only on a card
    assert "fp32_fma_bound_tflops" not in small_run


def test_dwell_entry_time_is_a_card_key(small_run):
    """dwell_entry_ms, K2's own ctypes entry timed as `value` is, exists only
    on the card: a CPU run has no kernel to call, prints no such key and no
    error for it, and keeps `value` as it was defined (Mpix/s through
    mandelbrot_field)."""
    assert "dwell_entry_ms" not in small_run and "dwell_entry_error" not in small_run
    assert small_run["unit"] == "Mpix/s" and small_run["value"] > 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.bench_dwell_entry_ms(bench.small_sizes(), torch.device("cpu"))


def test_bench_run_names_what_waits_and_what_is_omitted(small_run):
    assert small_run["not_ported"] == ["uniformize_green_s", "uniformize_fem_s"]
    assert not [k for k in small_run if "_vs_" in k or k.startswith("vs_")]
    omitted = small_run["omitted"]
    assert "vs_baseline" in omitted["keys"] and "tracker_vs_reference" in omitted["keys"]
    assert "another machine" in omitted["reason"]
    assert all(k not in small_run for k in small_run["not_ported"])
    json.dumps(small_run)  # one JSON line


def test_bench_main_exits_nonzero_when_a_key_throws(monkeypatch, capsys):
    def boom(sizes, dev):
        raise RuntimeError("planted failure")

    keys = tuple((n, boom if n == "eigensweep_s" else f, d) for n, f, d in bench.PIPELINE_KEYS)
    monkeypatch.setattr(bench, "PIPELINE_KEYS", keys)
    monkeypatch.setattr(bench, "bench_scale", boom)
    rc = bench.main(["--device", "cpu", "--small"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert "planted failure" in out["eigensweep_s_error"] and "eigensweep_s" not in out
    assert "planted failure" in out["scale_error"] and "knn_150k_s" not in out
    # the other keys still ran
    assert np.isfinite(out["tracker_warm_s"]) and out["value"] > 0


def test_bench_without_a_card_raises_unless_cpu_is_asked_for():
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run(bench.small_sizes())


def test_cli_bench_forwards_to_the_bench(monkeypatch):
    from cmtci_torch import cli

    seen = {}
    monkeypatch.setattr(bench, "main", lambda argv: seen.setdefault("argv", argv) and 0)
    with pytest.raises(SystemExit) as exc:
        cli.main(["bench", "--device", "cpu", "--small"])
    assert seen["argv"] == ["--device", "cpu", "--small"] and exc.value.code == 0
