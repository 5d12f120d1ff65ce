"""The schedules of K2 (csrc/dwell.cu, plain entry) and K3
(csrc/cloud_green.cu), modelled on the CPU.

The kernels run only on the card, where chip_smoke.py holds them bitwise to
their plain twins. Their control flow is new (K2: a latched orbit with an
exit test every C steps, the dwell added up after the loop and clamped; K3:
speculative branch-free chunks with a replay from the saved state), so each is
restated here as a scalar numpy-f32 model, line by line from the .cu, with the
tuning constants read out of the .cu text, and held to the twin with exact
equality on every pixel and every output row. Exact, because kernel, model and
twin run one f32 op sequence on the same values; the schedule does not enter
the result.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cmtci_torch import bench
from cmtci_torch.kernels import mandelbrot_cuda as mc

CSRC = Path(mc.__file__).resolve().parents[1] / "csrc"
F = np.float32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def quiet_overflow():
    with np.errstate(over="ignore", invalid="ignore"):
        yield


def constants(name: str) -> dict:
    """The `constexpr int KEY = V;` lines of csrc/<name>.cu."""
    text = (CSRC / f"{name}.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


K2 = constants("dwell")
K3 = constants("cloud_green")


def interior_model(cr, ci) -> bool:
    """escape.cuh:interior_mask in scalar f32."""
    xm = cr - F(0.25)
    q = xm * xm + ci * ci
    in_cardioid = q * (q + xm) <= F(0.25) * ci * ci - F(1e-5)
    xp = cr + F(1.0)
    in_bulb = xp * xp + ci * ci <= F(0.0625 - 1e-5)
    return bool(in_cardioid or in_bulb)


# ---------------------------------------------------------------------------
# K3: speculative chunks with exact replay
# ---------------------------------------------------------------------------


def cloud_green_model(cr, ci, zr, zi, iters: int, r2, s_chunk: int):
    """One thread of cloud_green_kernel: the six outputs of one point."""
    cr, ci, zr, zi, r2 = F(cr), F(ci), F(zr), F(zi), F(r2)
    k, zer, zei = F(0), F(0), F(0)
    act = not interior_model(cr, ci)
    chunks = replays = 0
    if act:
        n = 0
        sr, si = zr, zi
        hit = False
        while n + s_chunk <= iters:
            sr, si = zr, zi
            zr2, zi2 = zr * zr, zi * zi
            for _ in range(s_chunk):  # bare_step
                nzr = zr2 - zi2 + cr
                nzi = F(2.0) * zr * zi + ci
                zr, zi = nzr, nzi
                zr2, zi2 = nzr * nzr, nzi * nzi
                hit = hit or bool(zr2 + zi2 > r2)
            chunks += 1
            if hit:
                break
            n += s_chunk
        if hit:
            replays += 1
            zr, zi = sr, si
        stop = n + s_chunk if hit else iters
        while n < stop:
            nzr = zr * zr - zi * zi + cr
            nzi = F(2.0) * zr * zi + ci
            zr, zi = nzr, nzi
            if zr * zr + zi * zi > r2:
                k = F(n + 1)
                zer, zei = zr, zi
                act = False
                break
            n += 1
        assert not (hit and act), "the replay did not find the step the flag saw"
    return np.array([k, zer, zei, zr, zi, F(1.0 if act else 0.0)], dtype=F), chunks, replays


def cloud_model_rows(cr, ci, zr0, zi0, iters, escape_r, s_chunk):
    r2 = F(escape_r * escape_r)
    cols = [cloud_green_model(a, b, c, d, iters, r2, s_chunk)[0]
            for a, b, c, d in zip(cr, ci, zr0, zi0)]
    return np.stack(cols, axis=1)


def assert_rows_bitwise(model: np.ndarray, twin: torch.Tensor):
    twin = twin.numpy()
    assert model.shape == twin.shape and twin.dtype == np.float32
    for name, a, b in zip(("k", "zer", "zei", "zr", "zi", "act"), model, twin):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=name)


def escape_step(c: float) -> int:
    """1-based step at which the real point c leaves the radius-2 disc."""
    c, z = F(c), F(0)
    for n in range(1, 100_000):
        z = z * z + c
        if z * z > F(4.0):
            return n
    raise AssertionError(c)


def real_point_escaping_at(step: int) -> float:
    """A real c past the cusp whose escape step is exactly `step` (the step
    falls as c grows, about pi/sqrt(c - 1/4)), found by bisection."""
    lo, hi = 0.25 + (3.0 / step) ** 2 / 4, 0.25 + (3.3 / step) ** 2 * 4
    assert escape_step(lo) > step > escape_step(hi)
    for _ in range(60):
        mid = float(F(0.5 * (lo + hi)))
        got = escape_step(mid)
        if got == step:
            return mid
        lo, hi = (mid, hi) if got > step else (lo, mid)
    raise AssertionError(step)


def cloud_pool():
    """c values whose escape steps cover the chunk's edges (real points past
    the cusp that leave exactly at S - 1, S, S + 1, 2S and 2S + 1), a sweep of
    the real axis, the far field (step 1 and 2), interior points, bounded
    points outside the analytic interior, and a seeded complex cloud."""
    rng = np.random.default_rng(7)
    s = K3["S"]
    edges = [real_point_escaping_at(k) for k in (s - 1, s, s + 1, 2 * s, 2 * s + 1)]
    real = np.concatenate([edges, np.linspace(0.26, 0.9, 80), [2.5, 3.0, 1e3, -2.5]])
    cplx = rng.uniform(-2.2, 1.0, 120) + 1j * rng.uniform(-1.4, 1.4, 120)
    inside = np.array([0.0, -1.0, -0.1 + 0.1j, -1.0 + 0.05j, 0.2])
    # centres of the period-3, -4 and -5 bulbs and windows: bounded, not analytic
    bounded = np.array([-1.7549, -1.3107, -0.1226 + 0.7449j, -0.1226 - 0.7449j,
                        0.2823 + 0.5301j, -0.5044 + 0.5627j, 0.3795 + 0.3350j, 0.25])
    pts = np.concatenate([real.astype(complex), cplx, inside, bounded, [3.0 + 3.0j]])
    return pts.real.astype(F), pts.imag.astype(F)


S = K3["S"]


LONG = 3 * S + 7  # three whole chunks and a tail


@pytest.mark.parametrize("iters", [1, S - 1, S, S + 1, 2 * S, 3 * S + 5, LONG])
def test_k3_chunk_and_replay_model_equals_twin(iters):
    cr, ci = cloud_pool()
    z0 = np.zeros_like(cr)
    twin = mc.cloud_green_torch(cr, ci, z0, z0, iters, 2.0)
    assert_rows_bitwise(cloud_model_rows(cr, ci, z0, z0, iters, 2.0, S), twin)


def test_k3_pool_escapes_on_every_edge_of_a_chunk():
    """The pool has points that escape at step 1, on the last step of a chunk
    (S, 2S), on the first of the next (S + 1, 2S + 1) and at S - 1, points
    that never escape, and interior points."""
    cr, ci = cloud_pool()
    z0 = np.zeros_like(cr)
    out = mc.cloud_green_torch(cr, ci, z0, z0, LONG, 2.0).numpy()
    ks = set(out[0].astype(int).tolist())
    assert {1, 2, S - 1, S, S + 1, 2 * S, 2 * S + 1} <= ks, sorted(ks)
    assert (out[5] == 1).sum() >= 8  # still active after LONG steps
    interior = mc._interior_mask_torch(torch.as_tensor(cr), torch.as_tensor(ci)).numpy()
    assert interior.sum() >= 4 and (out[0][interior] == 0).all()


@pytest.mark.parametrize("s_chunk", [1, 3, 8, 32])
def test_k3_model_result_does_not_depend_on_the_chunk(s_chunk):
    cr, ci = cloud_pool()
    z0 = np.zeros_like(cr)
    twin = mc.cloud_green_torch(cr, ci, z0, z0, 70, 2.0)
    assert_rows_bitwise(cloud_model_rows(cr, ci, z0, z0, 70, 2.0, s_chunk), twin)


def test_k3_overflow_to_inf_and_nan_inside_a_chunk_after_the_hit():
    """c = 3 + 3i leaves at step 1; the chunk's later bare steps overflow to
    inf and then NaN. The flag keeps the hit and the replay returns the exact
    record; one chunk, one replay."""
    r2 = F(4.0)
    rec, chunks, replays = cloud_green_model(3.0, 3.0, 0.0, 0.0, 200, r2, S)
    assert (chunks, replays) == (1, 1)
    assert rec.tolist() == [1.0, 3.0, 3.0, 3.0, 3.0, 0.0]
    # the bare chunk really does reach NaN
    zr, zi = F(0), F(0)
    for _ in range(S):
        zr, zi = zr * zr - zi * zi + F(3), F(2) * zr * zi + F(3)
    assert np.isnan(zr) or np.isnan(zi)
    twin = mc.cloud_green_torch([3.0], [3.0], [0.0], [0.0], 200, 2.0)
    assert_rows_bitwise(rec[:, None], twin)


def test_k3_first_and_last_step_of_a_chunk():
    """A point that escapes at step S is flagged on the last step of the first
    chunk and replays all of it; one that escapes at S + 1 passes the first
    chunk unflagged and is flagged on the first step of the second."""
    cr, ci = cloud_pool()
    z0 = np.zeros_like(cr)
    k = mc.cloud_green_torch(cr, ci, z0, z0, LONG, 2.0)[0].numpy().astype(int)
    for want, chunks in ((S, 1), (S + 1, 2), (2 * S, 2), (2 * S + 1, 3)):
        i = int(np.flatnonzero(k == want)[0])
        rec, n_chunks, replays = cloud_green_model(cr[i], ci[i], 0, 0, LONG, F(4.0), S)
        assert (int(rec[0]), n_chunks, replays) == (want, chunks, 1)


@pytest.mark.parametrize("first,second", [(7, 50), (S, S), (S + 1, 2 * S - 1), (40, 1)])
def test_k3_resumed_state(first, second):
    """Two launches, the second resumed from the first's z rows on the lanes
    still active, give the single launch's record (k offset by the first
    launch's length), in the model as in the twin."""
    cr, ci = cloud_pool()
    z0 = np.zeros_like(cr)
    one = mc.cloud_green_torch(cr, ci, z0, z0, first, 2.0).numpy()
    keep = one[5] == 1
    zr1, zi1 = one[3][keep], one[4][keep]
    twin = mc.cloud_green_torch(cr[keep], ci[keep], zr1, zi1, second, 2.0)
    model = cloud_model_rows(cr[keep], ci[keep], zr1, zi1, second, 2.0, S)
    assert_rows_bitwise(model, twin)
    whole = mc.cloud_green_torch(cr, ci, z0, z0, first + second, 2.0).numpy()[:, keep]
    hit = model[0] > 0
    np.testing.assert_array_equal(model[0][hit] + first, whole[0][hit])
    np.testing.assert_array_equal(model[1:3].view(np.int32), whole[1:3].view(np.int32))


def test_k3_resumed_state_already_outside_and_non_finite_inputs():
    """A resumed z beyond the radius, inf and NaN states, and NaN and inf
    coordinates: the flag and the replay follow the twin's comparisons (a NaN
    |z|^2 is no escape; an inf one is)."""
    cr = np.array([0.5, 0.5, 0.5, 0.5, np.nan, np.inf, -np.inf, 0.5, 0.0, 0.5], dtype=F)
    ci = np.array([0.1, 0.1, 0.1, 0.1, 0.0, 0.0, 1.0, np.nan, 0.0, 0.1], dtype=F)
    zr = np.array([3.0, 1e20, np.inf, np.nan, 0.0, 0.0, 0.0, 0.0, 5.0, -2.0001], dtype=F)
    zi = np.array([0.0, 1e20, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 5.0, 0.0], dtype=F)
    for iters in (1, S, 2 * S + 3):
        twin = mc.cloud_green_torch(cr, ci, zr, zi, iters, 2.0)
        assert_rows_bitwise(cloud_model_rows(cr, ci, zr, zi, iters, 2.0, S), twin)
    out = mc.cloud_green_torch(cr, ci, zr, zi, 5, 2.0).numpy()
    assert out[0][0] == 1 and out[0][9] == 1  # outside already: the first step escapes
    assert out[0][8] == 0 and out[5][8] == 0  # interior c: inactive whatever z0 is


# ---------------------------------------------------------------------------
# K2: a latched orbit a thread, an exit test every C steps, the dwell added up
# from the newest chunk's latches after the loop, a final clamp
# ---------------------------------------------------------------------------


def dwell_thread_model(col, row, params, max_iter, c_steps):
    """One thread of dwell_kernel: the value it stores for pixel (row, col)."""
    xmin, ymin, dx, dy = (F(v) for v in params)
    cr = xmin + F(col) * dx
    ci = ymin + F(row) * dy
    dwell = max_iter
    if not interior_model(cr, ci) and max_iter > 0:
        zr, zi, zr2, zi2 = F(0), F(0), F(0), F(0)
        inside = True
        up = [False] * c_steps
        n = 0
        while True:
            for c in range(c_steps):
                nzr = zr2 - zi2 + cr
                nzi = F(2.0) * zr * zi + ci
                zr, zi = nzr, nzi
                zr2, zi2 = nzr * nzr, nzi * nzi
                inside = inside and bool(zr2 + zi2 <= F(4.0))
                up[c] = inside
            n += c_steps
            if not (inside and n < max_iter):
                break
        dwell = min(n - c_steps + sum(up), max_iter)
    return F(dwell)


def dwell_grid_model(nx, ny, params, max_iter, consts=K2):
    """dwell_launch's grid of blocks, warps and lanes over (ny, nx); every
    pixel must be stored exactly once."""
    c = consts["C"]
    pw, ph, warps = consts["PATCH_W"], consts["PATCH_H"], consts["WARPS"]
    out = np.full((ny, nx), np.nan, dtype=F)
    block_cols = warps * pw
    for by in range((ny + ph - 1) // ph):
        for bx in range((nx + block_cols - 1) // block_cols):
            for tid in range(32 * warps):
                lane, warp = tid & 31, tid >> 5
                col = (bx * warps + warp) * pw + lane % pw
                row = by * ph + lane // pw
                if col >= nx or row >= ny:
                    continue
                assert np.isnan(out[row, col]), "a pixel was stored twice"
                out[row, col] = dwell_thread_model(col, row, params, max_iter, c)
    assert not np.isnan(out).any(), "a pixel was never stored"
    return out


C = K2["C"]
DOM = (-2.1, 0.9, -1.5, 1.5)


@pytest.mark.parametrize("ny,nx,max_iter", [
    (2, 2, 1), (3, 5, 3), (9, 37, C - 1), (9, 37, C), (9, 37, C + 1), (7, 33, 50),
    (5, 131, 2 * C + 1), (8, 64, 30), (13, 17, 500), (6, 9, 0)])
def test_k2_latched_slots_model_equals_twin(ny, nx, max_iter):
    """Ragged nx (no multiple of a patch's or a block's width), ny no multiple
    of the patch height, max_iter below, at and off a multiple of C; the grid
    covers interior, bounded and escaping pixels."""
    twin = mc.dwell_field_torch(DOM, nx, ny, max_iter).numpy()
    model = dwell_grid_model(nx, ny, mc._params(DOM, nx, ny), max_iter)
    np.testing.assert_array_equal(model.view(np.int32), twin.view(np.int32))
    if max_iter >= 30 and nx * ny >= 200:
        assert (twin == max_iter).any() and (twin < 5).any()


@pytest.mark.parametrize("consts", [
    dict(C=1, PATCH_W=32, PATCH_H=1, WARPS=8), dict(C=3, PATCH_W=4, PATCH_H=8, WARPS=2),
    dict(C=8, PATCH_W=16, PATCH_H=2, WARPS=1)])
def test_k2_model_result_does_not_depend_on_the_schedule(consts):
    ny, nx, max_iter = 9, 41, 37
    twin = mc.dwell_field_torch(DOM, nx, ny, max_iter).numpy()
    model = dwell_grid_model(nx, ny, mc._params(DOM, nx, ny), max_iter, consts)
    np.testing.assert_array_equal(model.view(np.int32), twin.view(np.int32))


@pytest.mark.parametrize("domain", [
    (float("nan"), 1.0, -1.0, 1.0), (-1e20, 1e20, -1e20, 1e20), (-3e38, 3e38, -1.0, 1.0),
    (-2.0, 2.0, float("-inf"), 1.0)])
def test_k2_nan_and_inf_coordinates(domain):
    """Non-finite and overflowing coordinates: a NaN |z|^2 drops the latch at
    once, and a pixel that has left iterates on to inf and NaN unseen."""
    with np.errstate(over="ignore", invalid="ignore"):
        params = mc._params(domain, 9, 6)
    twin = mc.dwell_field_torch(domain, 9, 6, 11).numpy()
    model = dwell_grid_model(9, 6, params, 11)
    np.testing.assert_array_equal(model.view(np.int32), twin.view(np.int32))


def test_k2_escape_past_max_iter_inside_the_last_chunk_is_clamped():
    """A pixel whose first escape falls between max_iter and the end of the
    last chunk counts up to it; the clamp returns max_iter, as the twin does."""
    cr, ci = cloud_pool()
    z0 = np.zeros_like(cr)
    k = mc.cloud_green_torch(cr, ci, z0, z0, 150, 2.0)[0].numpy().astype(int)
    assert C >= 2
    i = int(np.flatnonzero((k % C == 0) & (k > 2 * C))[0])  # dwell k-1 = -1 mod C
    max_iter = int(k[i]) - 2  # the escape step is the last but one of its chunk
    params = np.array([cr[i], ci[i], 1.0, 1.0], dtype=F)  # pixel (0, 0) is c
    got = dwell_thread_model(0, 0, params, max_iter, C)
    unclamped = dwell_thread_model(0, 0, params, 10_000, C)
    assert got == max_iter and unclamped == k[i] - 1 > max_iter - 1


# ---------------------------------------------------------------------------
# the step accounting and the footprint constants
# ---------------------------------------------------------------------------


def executed_brute(lane: np.ndarray, f: dict) -> float:
    ny, nx = lane.shape
    w, h = f["patch_w"], f["patch_h"]
    total = 0
    for y0 in range(0, ny, h):
        for x0 in range(0, nx, w):
            longest = int(lane[y0:y0 + h, x0:x0 + w].max())
            trips = -(-longest // f["c"]) * f["c"]
            total += 32 * trips
    return float(total)


@pytest.mark.parametrize("footprint", [
    mc.DWELL_FOOTPRINT, bench.ROW_WARP, dict(c=3, patch_w=8, patch_h=4),
    dict(c=8, patch_w=16, patch_h=2)])
@pytest.mark.parametrize("shape", [(11, 45), (4, 32), (1, 7), (64, 256)])
def test_warp_executed_steps_against_a_brute_force_count(footprint, shape):
    rng = np.random.default_rng(3)
    lane = rng.integers(0, 60, size=shape)
    lane[rng.random(shape) < 0.3] = 0
    got = bench.warp_executed_steps(torch.as_tensor(lane, dtype=torch.int32), footprint)
    assert got == executed_brute(lane, footprint)
    assert got >= float(lane.sum())


def test_dwell_step_counts_follow_the_kernels_footprint():
    """K2's executed steps are counted on DWELL_FOOTPRINT by default, never
    below the useful ones, and on the row layout for the kernels that keep
    it."""
    n, max_iter = 96, 60
    cr, ci = mc._grid_coords(DOM, n, n, torch.device("cpu"))
    interior = mc._interior_mask_torch(cr, ci)
    dwell = mc.dwell_field_torch(DOM, n, n, max_iter)
    useful, executed = bench.dwell_step_counts(dwell, interior, max_iter)
    lane = torch.where(interior, 0.0, (dwell + 1).clamp(max=max_iter)).numpy().astype(int)
    assert useful == float(lane.sum())
    assert executed == executed_brute(lane, mc.DWELL_FOOTPRINT) >= useful
    _, row = bench.dwell_step_counts(dwell, interior, max_iter, bench.ROW_WARP)
    assert row == executed_brute(lane, bench.ROW_WARP) != executed


def test_footprint_constants_equal_the_constexpr_values_of_dwell_cu():
    assert mc.DWELL_FOOTPRINT == {"c": K2["C"], "patch_w": K2["PATCH_W"],
                                  "patch_h": K2["PATCH_H"]}
    assert K2["PATCH_W"] * K2["PATCH_H"] == 32
    text = (CSRC / "dwell.cu").read_text()
    # dwell_footprint() returns them in the order dwell_footprint_built reads
    order = re.findall(r"out3\[(\d)\] = (\w+);", text)
    assert order == [("0", "C"), ("1", "PATCH_W"), ("2", "PATCH_H")]


def test_ops_per_step_count_the_cu_bodies():
    """4 mul, 4 add/sub and 1 compare in the step of dwell.cu's plain kernel
    and of cloud_green.cu's chunk."""
    for name, start, stop in (("dwell", "for (int c = 0; c < C; ++c)", "up[c] = inside;"),
                              ("cloud_green", "void bare_step(", "\n}\n")):
        text = (CSRC / f"{name}.cu").read_text()
        body = text[text.index(start):]
        body = body[body.index("const float nzr"):body.index(stop)]
        muls = body.count(" * ")
        adds = body.count(" + ") + body.count(" - ")
        compares = body.count("<=") + body.count(" > ")
        assert (muls, adds, compares) == (4, 4, 1), (name, muls, adds, compares)
        assert mc.OPS_PER_STEP[name] == muls + adds + compares


@pytest.mark.parametrize("name,variants", [("dwell", "K2_VARIANTS"),
                                           ("cloud_green", "K3_VARIANTS")])
def test_sweep_variants_name_constants_the_sources_have(name, variants):
    """Every variant of cmtci_torch.sweep_schedules rewrites `constexpr int`
    lines that csrc/<name>.cu really has, once each, and nothing else."""
    from cmtci_torch import sweep_schedules as sweep

    text = (CSRC / f"{name}.cu").read_text()
    for label, consts in getattr(sweep, variants).items():
        new = sweep.rewrite(text, consts)
        got = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", new)}
        assert got == {**constants(name), **consts}, label
        assert len(new.splitlines()) == len(text.splitlines())
    with pytest.raises(ValueError, match="NO_SUCH"):
        sweep.rewrite(text, {"NO_SUCH": 1})
    alts = sweep.parse_alts([f"here={CSRC}:C=2,WARPS=8", "gone=/nonexistent"], "dwell")
    assert alts == [("here", CSRC, {"C": 2, "WARPS": 8})]


def test_wrappers_raise_without_a_card():
    with pytest.raises(RuntimeError, match="cuda"):
        mc.mandelbrot_field(DOM, 8, 8, 5, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        mc.cloud_green([0.3], [0.1], [0.0], [0.0], 5, device="cuda")
