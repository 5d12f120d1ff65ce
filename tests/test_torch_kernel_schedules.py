"""The schedules of K2 (csrc/dwell.cu, both entries), K3
(csrc/cloud_green.cu), K4 (csrc/de_std.cu), K1 (csrc/tci_de.cu), K5
(csrc/green_grid.cu) and K6 (csrc/dwell_ms.cu), modelled on the CPU.

The kernels run only on the card, where chip_smoke.py holds them bitwise to
their plain twins. Their control flow is new (K2: a latched orbit with an
exit test every C steps, the dwell added up after the loop and clamped; K3:
speculative branch-free chunks with a replay from the saved state; K4, K1 and
K5: chunks of a branch-free step with a sticky flag, the state at the first
escape picked from the newest chunk's snapshots, K4 and K5 overshooting
max_iter and K1 ending on a step-by-step tail), so each is restated here as a
scalar numpy-f32 model, line by line from the .cu, with the tuning constants
read out of the .cu text, and held to the twin with exact equality on every
pixel and every output row. Exact, because kernel, model and twin run one f32
op sequence on the same values; the schedule does not enter the result.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cmtci_torch import bench
from cmtci_torch.kernels import mandelbrot_cuda as mc
from cmtci_torch.transport import sinkhorn

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
K4 = constants("de_std")
K1 = constants("tci_de")
K5 = constants("green_grid")


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


def escape_step(c: float, r2: float = 4.0) -> int:
    """1-based step at which the real point c leaves the disc of squared
    radius r2 (by default the radius-2 disc)."""
    c, z = F(c), F(0)
    for n in range(1, 100_000):
        z = z * z + c
        if z * z > F(r2):
            return n
    raise AssertionError(c)


def real_point_escaping_at(step: int, r2: float = 4.0) -> float:
    """A real c past the cusp whose escape step is exactly `step` (the step
    falls as c grows, about pi/sqrt(c - 1/4)), found by bisection."""
    lo, hi = 0.25 + (3.0 / step) ** 2 / 4, 0.25 + (3.3 / step) ** 2 * 4
    assert escape_step(lo, r2) > step > escape_step(hi, r2)
    for _ in range(60):
        mid = float(F(0.5 * (lo + hi)))
        got = escape_step(mid, r2)
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
# K2's periodic entry and K6's fine pass on K2's loop (escape.cuh:
# dwell_chunked): the periodic entry adds a Brent cycle check whose checkpoint
# moves only at chunk ends, K6 a per-tile fill flag read once a thread; both
# on the compact warp footprint of escape.cuh:patch_pixel
# ---------------------------------------------------------------------------


K2P = {k[2:]: v for k, v in K2.items() if k.startswith("P_")}  # the periodic entry's
K6 = constants("dwell_ms")
#: c = -2 and c = +-i exactly: orbits periodic within two steps
EXACT_CYCLES = (-2.0, 0.0, -1.0, 1.0)
#: around the centre of the period-3 bulb: orbits periodic in f32 within a
#: few steps
PERIOD3_CENTRE = (-0.1326, -0.1126, 0.7349, 0.7549)
#: the window of tests/test_torch_boundary.py across the period-3 bulb
PERIOD3_WINDOW = (-0.26, 0.02, 0.66, 0.92)


def dwell_chunked_model(cr, ci, max_iter, c_steps, periodic=False):
    """escape.cuh:dwell_chunked<C, PERIODIC> in scalar f32:
    (the dwell it returns, the step the orbit stopped on, the step of the
    checkpoint a cycle was caught against). The stop is the escape step or the
    step that caught the cycle, at most max_iter (0 for an interior c); the
    checkpoint step is 0 where no cycle was caught by step max_iter."""
    cr, ci = F(cr), F(ci)
    if interior_model(cr, ci) or max_iter <= 0:
        return F(max_iter), 0, 0
    zr, zi, zr2, zi2 = F(0), F(0), F(0), F(0)
    pr, pi = F(1e30), F(0)
    nxt, moved = 1, 0
    inside, cyc = True, False
    stop, caught = max_iter, 0
    up = [False] * c_steps
    n = 0
    while True:
        for c in range(c_steps):
            nzr = zr2 - zi2 + cr
            nzi = F(2.0) * zr * zi + ci
            zr, zi = nzr, nzi
            zr2, zi2 = nzr * nzr, nzi * nzi
            was = inside
            inside = inside and bool(zr2 + zi2 <= F(4.0))
            up[c] = inside
            if was and not inside:
                stop = min(n + c + 1, max_iter)
        n += c_steps
        if periodic:
            if inside and zr == pr and zi == pi:
                cyc = True
                if n <= max_iter:
                    stop, caught = n, moved
            if n >= nxt:
                pr, pi, moved = zr, zi, n
                nxt = 1 << n.bit_length()  # 2u << (31 - __clz(n))
        if not (inside and not cyc and n < max_iter):
            break
    dwell = max_iter if cyc else min(n - c_steps + sum(up), max_iter)
    return F(dwell), stop, caught


def patch_grid_model(nx, ny, pw, ph, warps, pixel):
    """A launch of the compact footprint over (ny, nx): ceil(nx / (warps *
    pw)) x ceil(ny / ph) blocks of 32 * warps threads, the rows of blocks
    from the middle outwards, each thread at escape.cuh:patch_pixel's (col,
    row) storing pixel(col, row); every pixel must be stored exactly once."""
    out = np.full((ny, nx), np.nan, dtype=F)
    block_cols = warps * pw
    grid_y = (ny + ph - 1) // ph
    for r in range(grid_y):
        by = (grid_y - 1) // 2 + ((r + 1) // 2 if r & 1 else -(r // 2))
        for bx in range((nx + block_cols - 1) // block_cols):
            for tid in range(32 * warps):
                lane, warp = tid & 31, tid >> 5
                col = (bx * warps + warp) * pw + lane % pw
                row = by * ph + lane // pw
                if col >= nx or row >= ny:
                    continue
                assert np.isnan(out[row, col]), "a pixel was stored twice"
                out[row, col] = pixel(col, row)
    assert not np.isnan(out).any(), "a pixel was never stored"
    return out


def periodic_grid_model(nx, ny, params, max_iter, consts=K2P):
    """dwell_periodic_launch over (ny, nx) with the periodic entry's
    constants (P_* without the prefix)."""
    xmin, ymin, dx, dy = (F(v) for v in params)

    def pixel(col, row):
        return dwell_chunked_model(xmin + F(col) * dx, ymin + F(row) * dy, max_iter,
                                   consts["C"], True)[0]

    return patch_grid_model(nx, ny, consts["PATCH_W"], consts["PATCH_H"], consts["WARPS"], pixel)


def fine_pass_model(nx, ny, params, fill, tile, max_iter, consts=K6):
    """dwell_ms_launch over (ny, nx): a thread reads its tile's flag once and
    stores it where it is >= 0, else runs K2's loop."""
    xmin, ymin, dx, dy = (F(v) for v in params)
    th, tw = tile
    flags = np.asarray(fill, dtype=F).reshape(-1)

    def pixel(col, row):
        fv = flags[(row // th) * (nx // tw) + col // tw]
        if fv >= 0:
            return fv
        return dwell_chunked_model(xmin + F(col) * dx, ymin + F(row) * dy, max_iter,
                                   consts["C"])[0]

    return patch_grid_model(nx, ny, consts["PATCH_W"], consts["PATCH_H"], consts["WARPS"], pixel)


def assert_bitwise(model: np.ndarray, twin: torch.Tensor):
    np.testing.assert_array_equal(model.view(np.int32), twin.numpy().view(np.int32))


PC = K2P["C"]
POW2 = 1 << PC.bit_length()  # the least power of two above C


@pytest.mark.parametrize("domain,ny,nx,max_iter", [
    (DOM, 2, 2, 1), (DOM, 9, 37, PC - 1), (DOM, 9, 37, PC), (DOM, 9, 37, PC + 1),
    (DOM, 13, 17, 300), (DOM, 6, 9, 0), (DOM, 7, 131, 2 * PC + 1),
    (EXACT_CYCLES, 3, 3, PC), (EXACT_CYCLES, 3, 3, PC + 1), (EXACT_CYCLES, 3, 3, POW2),
    (EXACT_CYCLES, 3, 3, POW2 + 1), (EXACT_CYCLES, 3, 3, 40),
    (PERIOD3_CENTRE, 11, 13, 2 * POW2 + 1), (PERIOD3_CENTRE, 11, 13, 200)])
def test_k2p_chunked_model_equals_twin(domain, ny, nx, max_iter):
    """The periodic entry as committed (C, patch, warps and block order read
    out of dwell.cu) on ragged grids, max_iter below, at and
    off a chunk, and grids whose cycles the first checkpoints catch: bitwise
    the periodic twin and the plain one."""
    twin = mc.dwell_field_torch(domain, nx, ny, max_iter, periodicity=True)
    assert torch.equal(twin, mc.dwell_field_torch(domain, nx, ny, max_iter))
    assert_bitwise(periodic_grid_model(nx, ny, mc._params(domain, nx, ny), max_iter), twin)


@pytest.mark.parametrize("consts", [
    dict(C=1, PATCH_W=32, PATCH_H=1, WARPS=8),
    dict(C=3, PATCH_W=8, PATCH_H=4, WARPS=2),
    dict(C=4, PATCH_W=8, PATCH_H=4, WARPS=1),
    dict(C=4, PATCH_W=4, PATCH_H=8, WARPS=4),
    dict(C=6, PATCH_W=2, PATCH_H=16, WARPS=1),
    dict(C=12, PATCH_W=16, PATCH_H=2, WARPS=8)])
def test_k2p_model_result_does_not_depend_on_the_schedule(consts):
    for domain, ny, nx, max_iter in ((DOM, 9, 41, 37), (PERIOD3_CENTRE, 10, 12, 45),
                                     (EXACT_CYCLES, 3, 3, 2 * consts["C"] + 1)):
        twin = mc.dwell_field_torch(domain, nx, ny, max_iter, periodicity=True)
        assert_bitwise(periodic_grid_model(nx, ny, mc._params(domain, nx, ny), max_iter,
                                           consts), twin)


def _catches(c_steps, cases, modulus):
    """(positions in a chunk of `modulus` steps, checkpoint steps) of the
    cycles the model with chunks of c_steps catches on the grids of `cases`
    ((domain, ny, nx, max_iter))."""
    positions, checkpoints = set(), set()
    for domain, ny, nx, max_iter in cases:
        cr, ci = mc._grid_coords(domain, nx, ny, torch.device("cpu"))
        for a, b in zip(cr.reshape(-1).tolist(), ci.reshape(-1).tolist()):
            _, stop, caught = dwell_chunked_model(a, b, max_iter, c_steps, True)
            if caught:
                positions.add((stop - 1) % modulus)
                checkpoints.add(caught)
    return positions, checkpoints


@pytest.mark.parametrize("c_steps", [3, 4, 6])
def test_k2p_catches_cycles_on_every_step_of_a_chunk(c_steps):
    """The step-by-step schedule (C = 1, the twin's) catches cycles on every
    step of a chunk of c_steps (the period-3 centre alone has periods that
    are multiples of 3, so a boundary grid joins it); chunks of c_steps catch
    them all on a chunk's last step, against the first checkpoint (step C)
    and against checkpoints that moved at or after the first chunk end past
    the power of two above C."""
    first_past = -(-(1 << c_steps.bit_length()) // c_steps) * c_steps
    cases = [(EXACT_CYCLES, 3, 3, 40), (PERIOD3_CENTRE, 32, 32, 40), (DOM, 40, 80, 200)]
    positions, _ = _catches(1, cases, c_steps)
    assert positions == set(range(c_steps))
    positions, checkpoints = _catches(c_steps, cases, c_steps)
    assert positions == {c_steps - 1}
    assert c_steps in checkpoints and max(checkpoints) >= first_past


@pytest.mark.parametrize("c_steps", [1, 3, 4, 6, 8])
def test_periodic_lane_steps_follow_the_chunked_model(c_steps):
    """bench.periodic_lane_steps, which chip_smoke.py counts K2p's steps
    with, stops every lane on the model's step and reports the model's
    checkpoint, on grids with exact cycles, fast and slow catches, escapes
    and interior pixels."""
    for domain, ny, nx, max_iter in ((EXACT_CYCLES, 3, 3, 40), (PERIOD3_CENTRE, 12, 14, 70),
                                     (DOM, 17, 23, 300), (PERIOD3_WINDOW, 6, 7, 100)):
        cr, ci = mc._grid_coords(domain, nx, ny, torch.device("cpu"))
        lane, caught = bench.periodic_lane_steps(cr, ci, max_iter, c_steps)
        want = [dwell_chunked_model(a, b, max_iter, c_steps, True)[1:]
                for a, b in zip(cr.reshape(-1).tolist(), ci.reshape(-1).tolist())]
        assert lane.reshape(-1).tolist() == [s for s, _ in want], domain
        assert caught.reshape(-1).tolist() == [k for _, k in want], domain


@pytest.mark.parametrize("c_steps", [PC, 1])
def test_k2p_chunk_schedule_catches_cycles_on_the_bounded_window(c_steps):
    """The bounded-lane window of tests/test_torch_boundary.py at max_iter
    2000, under the committed C with the checkpoint moved and compared at
    chunk ends, and under the step-by-step schedule: the model's dwell is the
    plain twin's, and the check fires on most bounded lanes well before
    max_iter, on chunk ends."""
    nx, ny, max_iter = 28, 26, 2000
    plain = mc.dwell_field_torch(PERIOD3_WINDOW, nx, ny, max_iter).numpy()
    cr, ci = mc._grid_coords(PERIOD3_WINDOW, nx, ny, torch.device("cpu"))
    bounded = (plain == max_iter) & ~mc._interior_mask_torch(cr, ci).numpy()
    out = [dwell_chunked_model(a, b, max_iter, c_steps, True)
           for a, b in zip(cr.reshape(-1).tolist(), ci.reshape(-1).tolist())]
    dwell = np.array([d for d, _, _ in out], dtype=F).reshape(ny, nx)
    assert_bitwise(dwell, torch.as_tensor(plain))
    stops = np.array([s for _, s, _ in out]).reshape(ny, nx)[bounded]
    caught = np.array([k for _, _, k in out]).reshape(ny, nx)[bounded]
    assert 0.2 < bounded.mean() < 0.8
    assert (caught > 0).mean() > 0.5 and np.median(stops) < max_iter / 2
    assert (stops[caught > 0] % c_steps == 0).all()


def _random_flags(shape, seed, max_iter):
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, max_iter + 1, size=shape).astype(F)
    flags[rng.random(shape) < 0.5] = -1.0
    return flags


def _straddles(nx, ny, tile, consts=K6) -> bool:
    """Whether some block of K6's launch holds pixels of two tiles."""
    th, tw = tile
    bw, bh = consts["WARPS"] * consts["PATCH_W"], consts["PATCH_H"]
    return any(len({(r // th, c // tw) for r in range(y0, min(y0 + bh, ny))
                    for c in range(x0, min(x0 + bw, nx))}) > 1
               for y0 in range(0, ny, bh) for x0 in range(0, nx, bw))


@pytest.mark.parametrize("ny,nx,tile,max_iter", [
    (24, 48, (4, 8), 60), (24, 48, (12, 24), 60), (8, 12, (2, 2), K6["C"] + 1),
    (16, 80, (8, 40), K6["C"] - 1), (24, 48, (24, 48), 30)])
def test_k6_fine_pass_model_equals_twin_on_tiles_that_blocks_straddle(ny, nx, tile, max_iter):
    """Flags drawn from a seed, half of them -1, on tiles that are no multiple
    of a block (and one tile the size of the grid): each thread reads its own
    tile's flag, so the output is the twin's whether a block straddles tiles
    or not."""
    flags = _random_flags((ny // tile[0], nx // tile[1]), ny * nx, max_iter)
    if tile != (ny, nx):
        assert _straddles(nx, ny, tile)
    twin = mc.dwell_fill_torch(DOM, nx, ny, torch.as_tensor(flags), tile, max_iter)
    assert_bitwise(fine_pass_model(nx, ny, mc._params(DOM, nx, ny), flags, tile, max_iter),
                   twin)


def test_k6_fine_pass_model_on_the_coarse_pass_flags():
    """The flags dwell_field_ms decides (fill_flags over a coarse K2 pass at
    stride 4 on (8, 32) tiles, which hold whole blocks): the model is the twin
    and, where a tile is filled, K2's own output."""
    ny, nx, stride, tile, max_iter = 64, 256, 4, (8, 32), 60
    assert not _straddles(nx, ny, tile)
    out, stats = mc.dwell_field_ms(DOM, nx, ny, max_iter, stride, tile, device="cpu")
    assert 0 < stats["filled"] < stats["tiles"]
    coarse = mc._dwell(mc._coarse_params(DOM, nx, ny, stride), nx // stride, ny // stride,
                       max_iter, torch.device("cpu"))
    fill = mc.fill_flags(coarse, tile[0] // stride, tile[1] // stride)
    model = fine_pass_model(nx, ny, mc._params(DOM, nx, ny), fill.numpy(), tile, max_iter)
    assert_bitwise(model, out)
    assert_bitwise(model, mc.dwell_field_torch(DOM, nx, ny, max_iter))


@pytest.mark.parametrize("consts", [
    dict(C=1, PATCH_W=32, PATCH_H=1, WARPS=8),
    dict(C=3, PATCH_W=8, PATCH_H=4, WARPS=2),
    dict(C=6, PATCH_W=2, PATCH_H=16, WARPS=1),
    dict(C=8, PATCH_W=16, PATCH_H=2, WARPS=4)])
def test_k6_model_result_does_not_depend_on_the_schedule(consts):
    ny, nx, tile, max_iter = 24, 48, (6, 12), 45
    flags = _random_flags((ny // tile[0], nx // tile[1]), 5, max_iter)
    twin = mc.dwell_fill_torch(DOM, nx, ny, torch.as_tensor(flags), tile, max_iter)
    assert_bitwise(fine_pass_model(nx, ny, mc._params(DOM, nx, ny), flags, tile, max_iter,
                                   consts), twin)


def test_k2_k2p_and_k6_run_the_one_chunked_loop():
    """dwell.cu's two kernels and dwell_ms.cu's call escape.cuh:dwell_chunked
    with their own constants, and they, de_std.cu and tci_de.cu call
    escape.cuh:patch_pixel with their own footprint; the per-step loop of the
    earlier design is gone."""
    dwell, ms = (CSRC / "dwell.cu").read_text(), (CSRC / "dwell_ms.cu").read_text()
    assert "dwell_chunked<C, false>(cr, ci, max_iter)" in dwell
    assert "dwell_chunked<P_C, true>(cr, ci, max_iter)" in dwell
    assert "patch_pixel<PATCH_W, PATCH_H, WARPS, false>(col, row)" in dwell
    assert "patch_pixel<P_PATCH_W, P_PATCH_H, P_WARPS, true>(col, row)" in dwell
    assert "dwell_chunked<C, false>(cr, ci, max_iter)" in ms
    assert "patch_pixel<PATCH_W, PATCH_H, WARPS, true>(col, row)" in ms
    for name in ("de_std", "tci_de"):
        text = (CSRC / f"{name}.cu").read_text()
        assert "patch_pixel<PATCH_W, PATCH_H, WARPS, true>(col, row)" in text, name
        assert "blockIdx" not in text, name
    for src in CSRC.iterdir():
        assert "dwell_count" not in src.read_text(), src.name


# ---------------------------------------------------------------------------
# K4 and K1: chunks of escape.cuh:de_bare_step with a sticky flag; the state
# at the first escape from the newest chunk's snapshots
# ---------------------------------------------------------------------------


def de_bare_step_model(st, cr, ci, r2):
    """escape.cuh:de_bare_step on st = [zr, zi, zr2, zi2, dzr, dzi, hit]."""
    zr, zi, zr2, zi2, dzr, dzi, hit = st
    tr = F(2.0) * zr
    ti = F(2.0) * zi
    ndzr = tr * dzr - ti * dzi + F(1.0)
    ndzi = tr * dzi + ti * dzr
    nzr = zr2 - zi2 + cr
    nzi = tr * zi + ci
    zr2 = nzr * nzr
    zi2 = nzi * nzi
    hit = hit or bool(zr2 + zi2 > r2)
    return [nzr, nzi, zr2, zi2, ndzr, ndzi, hit]


def pixel_c(col, row, params):
    xmin, ymin, dx, dy = (F(v) for v in params)
    return xmin + F(col) * dx, ymin + F(row) * dy


def de_std_thread_model(col, row, params, max_iter, r2, c_steps):
    """One thread of de_std_kernel up to its formula: (esc, lzr, lzi, ldr,
    ldi, chunks run); the thread stores 0 when esc is False (an interior
    pixel, or none escaped) and the formula of the latches when it is True."""
    cr, ci = pixel_c(col, row, params)
    esc, lzr, lzi, ldr, ldi = False, F(0), F(0), F(1), F(0)
    chunks = 0
    if not interior_model(cr, ci) and max_iter > 0:
        st = [F(0), F(0), F(0), F(0), F(1), F(0), False]
        snap = [None] * c_steps
        n = 0
        while True:
            for c in range(c_steps):
                st = de_bare_step_model(st, cr, ci, r2)
                snap[c] = (st[0], st[1], st[4], st[5], st[6])
            n += c_steps
            chunks += 1
            if not (not st[6] and n < max_iter):
                break
        first = c_steps
        for c in range(c_steps - 1, -1, -1):
            if snap[c][4]:
                first = c
                lzr, lzi, ldr, ldi = snap[c][:4]
        esc = st[6] and n - c_steps + first < max_iter
    return esc, lzr, lzi, ldr, ldi, chunks


def bare_step_model(st, cr, ci, r2):
    """escape.cuh:bare_step on st = [zr, zi, zr2, zi2, hit]."""
    zr, zi, zr2, zi2, hit = st
    nzr = zr2 - zi2 + cr
    nzi = F(2.0) * zr * zi + ci
    zr2 = nzr * nzr
    zi2 = nzi * nzi
    hit = hit or bool(zr2 + zi2 > r2)
    return [nzr, nzi, zr2, zi2, hit]


def late_escaper_model(cr, ci, max_iter, r2):
    """tci_de.cu:late_escaper up to its formula: (esc, lzr, lzi, dzr, dzi)."""
    zr, zi, dzr, dzi, lzr, lzi = F(0), F(0), F(1), F(0), F(0), F(0)
    esc = False
    for _ in range(max_iter):
        tr = F(2.0) * zr
        ti = F(2.0) * zi
        ndzr = tr * dzr - ti * dzi + F(1.0)
        ndzi = tr * dzi + ti * dzr
        nzr = zr * zr - zi * zi + cr
        nzi = F(2.0) * zr * zi + ci
        dzr, dzi, zr, zi = ndzr, ndzi, nzr, nzi
        a2 = zr * zr + zi * zi
        if not esc and a2 > r2:
            esc = True
            lzr, lzi = zr, zi
        if esc and not (np.isfinite(dzr) and np.isfinite(dzi)):
            break
    return esc, lzr, lzi, dzr, dzi


def tci_de_thread_model(col, row, params, max_iter, r2, c_steps):
    """One thread of tci_de_kernel: (what it stores, z-only steps taken).
    What it stores is -1.0 (not escaped), 0.0 (escaped and z seen non-finite
    before the last step), or the tuple (esc, lzr, lzi, dzr, dzi) that
    late_escaper hands to the formula."""
    cr, ci = pixel_c(col, row, params)
    steps = 0
    if interior_model(cr, ci):
        return F(-1.0), steps
    st = [F(0), F(0), F(0), F(0), False]
    dead_at = max_iter
    n = 0
    while n + c_steps <= max_iter:  # whole chunks
        for _ in range(c_steps):
            st = bare_step_model(st, cr, ci, r2)
        steps += c_steps
        if st[4] and not (np.isfinite(st[0]) and np.isfinite(st[1])):
            dead_at = n + c_steps
            n = max_iter
            break
        n += c_steps
    while n < max_iter:  # the last max_iter mod C steps, one by one
        st = bare_step_model(st, cr, ci, r2)
        steps += 1
        if st[4] and not (np.isfinite(st[0]) and np.isfinite(st[1])):
            dead_at = n + 1
            break
        n += 1
    if not st[4]:
        return F(-1.0), steps
    if dead_at < max_iter:
        return F(0.0), steps
    return late_escaper_model(cr, ci, max_iter, r2), steps


def patch_threads(nx, ny, consts):
    """(row, col) of every thread the launchers of de_std.cu, tci_de.cu and
    green_grid.cu start that passes the bounds test, over their grid of
    blocks, warps and lanes (the rows of blocks from the middle outwards);
    every pixel must come exactly once."""
    pw, ph, warps = consts["PATCH_W"], consts["PATCH_H"], consts["WARPS"]
    assert pw * ph == 32
    seen = np.zeros((ny, nx), dtype=bool)
    block_cols = warps * pw
    grid_y = (ny + ph - 1) // ph
    for r in range(grid_y):  # blockIdx.y
        by = (grid_y - 1) // 2 + ((r + 1) // 2 if r & 1 else -(r // 2))
        for bx in range((nx + block_cols - 1) // block_cols):
            for tid in range(32 * warps):
                lane, warp = tid & 31, tid >> 5
                col = (bx * warps + warp) * pw + lane % pw
                row = by * ph + lane // pw
                if col >= nx or row >= ny:
                    continue
                assert not seen[row, col], "a pixel was stored twice"
                seen[row, col] = True
                yield row, col
    assert seen.all(), "a pixel was never stored"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def de_std_formula(lzr, lzi, ldr, ldi):
    """de_std_kernel's formula on tensors of latches. Its sqrt, log and
    division are torch's (on the CPU numpy's f32 sqrt and log differ from
    torch's by an ulp on some inputs; on the card kernel and twin both call
    CUDA's); the point here is the loop."""
    az = torch.sqrt(lzr * lzr + lzi * lzi)
    pr = 2.0 * (lzr * ldr - lzi * ldi)
    pi = 2.0 * (lzr * ldi + lzi * ldr)
    num = torch.log(torch.maximum(az, az.new_tensor(1.0))) * az
    den = torch.maximum(torch.sqrt(pr * pr + pi * pi), az.new_tensor(1e-14))
    return num / den


def tci_de_formula(lzr, lzi, dzr, dzi):
    """tci_de_kernel's formula on tensors, as de_std_formula."""
    az = torch.sqrt(lzr * lzr + lzi * lzi)
    pr = 2.0 * lzr * dzr - 2.0 * lzi * dzi
    pi = 2.0 * lzr * dzi + 2.0 * lzi * dzr
    den = torch.maximum(torch.sqrt(pr * pr + pi * pi), az.new_tensor(1e-12))
    num = torch.log(torch.maximum(az, az.new_tensor(1.0))) * az
    d = num / den
    return torch.where(torch.isfinite(d), d, az.new_tensor(0.0))


def de_std_grid_model(nx, ny, params, max_iter, escape_r, consts=K4):
    """de_std_launch over (ny, nx): the threads' latches from the scalar
    model, then what each thread stores: the formula where it escaped, else
    0."""
    r2 = F(escape_r * escape_r)
    esc = np.zeros((ny, nx), dtype=bool)
    lat = np.zeros((4, ny, nx), dtype=F)
    for row, col in patch_threads(nx, ny, consts):
        e, *latches, _ = de_std_thread_model(col, row, params, max_iter, r2, consts["C"])
        esc[row, col] = e
        lat[:, row, col] = latches
    d = de_std_formula(*(_t(a) for a in lat))
    return torch.where(_t(esc), d, d.new_tensor(0.0)).numpy()


def tci_de_grid_model(n, params, max_iter, escape_r, consts=K1):
    """tci_de_launch over (n, n): what each thread stores, the late
    escapers' through late_escaper's formula (as de_std_grid_model, on the
    whole grid). Returns (field, late escapers)."""
    r2 = F(escape_r * escape_r)
    out = np.full((n, n), np.nan, dtype=F)
    late = np.zeros((n, n), dtype=bool)
    esc = np.zeros((n, n), dtype=bool)
    lat = np.zeros((4, n, n), dtype=F)
    for row, col in patch_threads(n, n, consts):
        stored, _ = tci_de_thread_model(col, row, params, max_iter, r2, consts["C"])
        if isinstance(stored, tuple):
            late[row, col] = True
            esc[row, col] = stored[0]
            lat[:, row, col] = stored[1:]
        else:
            out[row, col] = stored
    d = tci_de_formula(*(_t(a) for a in lat))
    d = torch.where(_t(esc), d, d.new_tensor(-1.0))
    return torch.where(_t(late), d, _t(out)).numpy(), late


def assert_same_bits(model: np.ndarray, twin: torch.Tensor):
    twin = twin.numpy()
    assert model.shape == twin.shape and model.dtype == twin.dtype == np.float32
    both_nan = np.isnan(model) & np.isnan(twin)
    np.testing.assert_array_equal(np.where(both_nan, 0, model.view(np.int32)),
                                  np.where(both_nan, 0, twin.view(np.int32)))


C4, C1 = K4["C"], K1["C"]
TRACKER_DOM = (-2.2, 1.2, -1.6, 1.6)


@pytest.mark.parametrize("ny,nx,max_iter", [
    (2, 2, 1), (3, 5, C4 - 1), (9, 37, C4), (9, 37, C4 + 1), (7, 33, 2 * C4 - 1),
    (9, 5, 30), (5, 67, 2 * C4 + 1), (17, 23, 61), (45, 70, 500), (6, 9, 0)])
def test_k4_chunked_snapshot_model_equals_twin(ny, nx, max_iter):
    """Ragged grids (no multiple of a patch or a block, one row or column
    more than a patch) across the boundary; max_iter below, at and above C
    and not a multiple of it."""
    twin = mc.de_field_std_torch(DOM, nx, ny, max_iter, 4.0)
    model = de_std_grid_model(nx, ny, mc._params(DOM, nx, ny), max_iter, 4.0)
    assert_same_bits(model, twin)
    if max_iter >= 30:
        assert (model > 0).any() and (model == 0).any()


@pytest.mark.parametrize("consts", [
    dict(C=1, PATCH_W=32, PATCH_H=1, WARPS=8), dict(C=3, PATCH_W=8, PATCH_H=4, WARPS=2),
    dict(C=8, PATCH_W=2, PATCH_H=16, WARPS=1)])
def test_k4_and_k1_model_results_do_not_depend_on_the_schedule(consts):
    ny, nx, max_iter = 9, 21, 37
    twin = mc.de_field_std_torch(DOM, nx, ny, max_iter, 4.0)
    model = de_std_grid_model(nx, ny, mc._params(DOM, nx, ny), max_iter, 4.0, consts)
    assert_same_bits(model, twin)
    for max_iter in (16, 37):  # a multiple of each C but 3, and of none
        twin = mc.tci_de_field_torch(TRACKER_DOM, 13, max_iter, 250.0)
        model, _ = tci_de_grid_model(13, mc._params(TRACKER_DOM, 13), max_iter, 250.0, consts)
        assert_same_bits(model, twin)


def lane_steps(dom, nx, ny, max_iter, r2):
    cr, ci = mc._grid_coords(dom, nx, ny, torch.device("cpu"))
    return bench.escape_lane_steps(cr, ci, max_iter, r2).numpy()


def test_k4_first_escape_on_every_position_of_a_chunk_and_at_the_edge_of_max_iter():
    """Pixels whose first escape falls on each position of a chunk; and for
    one of each, max_iter equal to the escape step (the escape counts: the
    twin's d, not 0) and one below it (it does not: 0, though the chunk runs
    over it and raises the flag)."""
    nx, ny, r2 = 41, 19, F(16.0)
    params = mc._params(DOM, nx, ny)
    steps = lane_steps(DOM, nx, ny, 200, 16.0)  # 1-based escape step; 200 if none
    for pos in range(C4):
        rows, cols = np.nonzero((steps % C4 == pos) & (steps > C4) & (steps < 200))
        assert rows.size, f"no pixel escapes on position {pos} of a chunk"
        row, col, k = int(rows[0]), int(cols[0]), int(steps[rows[0], cols[0]])
        esc, *_, chunks = de_std_thread_model(col, row, params, k, r2, C4)
        assert esc and chunks == -(-k // C4)
        esc, *_, chunks = de_std_thread_model(col, row, params, k - 1, r2, C4)
        assert not esc and chunks == -(-(k - 1) // C4)
        # the same two counts on the grid: the twin agrees at that pixel
        for max_iter, escaped in ((k, True), (k - 1, False)):
            twin = mc.de_field_std_torch(DOM, nx, ny, max_iter, 4.0)
            model = de_std_grid_model(nx, ny, params, max_iter, 4.0)
            assert_same_bits(model, twin)
            assert (twin[row, col] != 0) == escaped


@pytest.mark.parametrize("domain", [
    (float("nan"), 1.0, -1.0, 1.0), (-1e20, 1e20, -1e20, 1e20), (-3e38, 3e38, -1.0, 1.0),
    (-2.0, 2.0, float("-inf"), 1.0)])
def test_k4_and_k1_nan_and_inf_coordinates(domain):
    """Non-finite and overflowing coordinates: a NaN |z|^2 never raises the
    flag, an inf one does, and the steps after a hit run on to inf and NaN
    unread."""
    with np.errstate(over="ignore", invalid="ignore"):
        params = mc._params(domain, 7, 5)
        twin = mc.de_field_std_torch(domain, 7, 5, 11, 4.0)
        assert_same_bits(de_std_grid_model(7, 5, params, 11, 4.0), twin)
        params = mc._params(domain, 5)
        twin = mc.tci_de_field_torch(domain, 5, 11, 250.0)
        assert_same_bits(tci_de_grid_model(5, params, 11, 250.0)[0], twin)


@pytest.mark.parametrize("n,max_iter", [
    (2, 1), (5, C1 - 1), (9, C1), (9, C1 + 1), (13, 2 * C1 - 1), (33, 2 * C1 + 1), (17, 30),
    (21, 61), (11, 250), (57, 250), (64, 48), (7, 0)])
def test_k1_two_pass_model_equals_twin(n, max_iter):
    """Ragged grids across the boundary on the tracker's domain; max_iter
    below, at and above C, a multiple of it and not (the tracker's 250 is
    none of 6)."""
    twin = mc.tci_de_field_torch(TRACKER_DOM, n, max_iter, 250.0)
    model, _ = tci_de_grid_model(n, mc._params(TRACKER_DOM, n), max_iter, 250.0)
    assert_same_bits(model, twin)
    if max_iter >= 30:
        assert (model == -1).any() and (model == 0).any()


def test_k1_only_late_escapers_have_a_positive_d_and_they_take_the_second_pass():
    """The pixels that escape with dz still finite at max_iter are the only
    ones with d > 0 and decide the q25 band. Each is a late escaper in the
    model: it runs the step-by-step (z, dz) orbit, exactly max_iter dz steps,
    whatever max_iter mod C is, and its d is bitwise the twin's. The second
    pass is rare, and an early escaper never iterates dz."""
    n = 61
    params = mc._params(TRACKER_DOM, n)
    r2 = F(250.0 * 250.0)
    for max_iter in (13, 14, 15, 16):
        twin = mc.tci_de_field_torch(TRACKER_DOM, n, max_iter, 250.0)
        model, late = tci_de_grid_model(n, params, max_iter, 250.0)
        assert_same_bits(model, twin)
        assert (model > 0).sum() >= 3 and late[model > 0].all()
        assert late.sum() < 0.1 * n * n
        for row, col in zip(*np.nonzero(model > 0)):
            esc, _, _, dzr, dzi = late_escaper_model(*pixel_c(col, row, params), max_iter, r2)
            assert esc and np.isfinite(dzr) and np.isfinite(dzi)
        # an early escaper stores 0 from the first pass and leaves it at a
        # chunk's end, or on the step-by-step tail
        rows, cols = np.nonzero((model == 0) & ~late)
        stored, steps = tci_de_thread_model(cols[0], rows[0], params, max_iter, r2, C1)
        assert stored == 0.0 and not isinstance(stored, tuple)
        assert steps < max_iter and (steps % C1 == 0 or steps > max_iter - max_iter % C1)


def first_pass_exit(c, max_iter, r2=F(62500.0)):
    """(escape step, step after which z is non-finite) of the z-only orbit of
    c, 1-based; None where it does not happen within max_iter steps."""
    cr, ci = F(c.real), F(c.imag)
    zr, zi = F(0), F(0)
    k = s = None
    for n in range(1, max_iter + 1):
        zr, zi = zr * zr - zi * zi + cr, F(2.0) * zr * zi + ci
        if k is None and zr * zr + zi * zi > r2:
            k = n
        if k is not None and not (np.isfinite(zr) and np.isfinite(zi)):
            s = n
            break
    return k, s


def test_k1_the_edge_between_the_two_passes():
    """For pixels whose z turns non-finite at step s: with max_iter = s + C
    the first pass sees it before the last step and proves d = 0 (the next
    step makes dz non-finite); with max_iter = s + 1 it does so if a test
    falls on a step before the last, else the pixel takes the second pass;
    with max_iter = s, and down to its escape step, it takes the second pass;
    below that it has not escaped. Each is bitwise the twin's, for s on every
    position of a chunk."""
    n = 33
    params = mc._params(TRACKER_DOM, n)
    r2 = F(250.0 * 250.0)
    seen = set()
    for row, col in patch_threads(n, n, K1):
        cr, ci = pixel_c(col, row, params)
        k, s = first_pass_exit(complex(cr, ci), 40)
        if s is None or s % C1 in seen or k < 3:
            continue
        seen.add(s % C1)
        assert k < s <= k + 7
        for max_iter, want in ((s + C1, ("zero",)), (s + 1, ("zero", "late")), (s, ("late",)),
                               (k, ("late",)), (k - 1, ("none",))):
            stored, _ = tci_de_thread_model(col, row, params, max_iter, r2, C1)
            kind = ("late" if isinstance(stored, tuple) else
                    "zero" if stored == 0.0 else "none")
            assert kind in want, (s, max_iter)
            twin = mc.tci_de_field_torch(TRACKER_DOM, n, max_iter, 250.0)
            assert_same_bits(tci_de_grid_model(n, params, max_iter, 250.0)[0], twin)
    assert seen == set(range(C1))


@pytest.mark.parametrize("c", [-2.0 + 0.0j, 1.0j, -1.5436890126920764 + 0.0j])
def test_k1_dz_overflows_before_z_escapes(c):
    """A bounded z with |2z| > 1 step after step: the twin's dz overflows
    while z stays inside; the pixel runs max_iter out (no early exit without
    an escape) and outputs -1, in the model as in the twin. The pixel is
    (0, 0) of a 2 x 2 grid whose corner is c."""
    dom = (c.real, c.real + 1.0, c.imag, c.imag + 1.0)
    params = mc._params(dom, 2)
    max_iter = 250
    stored, steps = tci_de_thread_model(0, 0, params, max_iter, F(62500.0), C1)
    assert stored == -1.0 and steps == max_iter
    esc, _, _, dzr, dzi = late_escaper_model(*pixel_c(0, 0, params), max_iter, F(62500.0))
    assert not esc and not (np.isfinite(dzr) and np.isfinite(dzi))
    twin = mc.tci_de_field_torch(dom, 2, max_iter, 250.0)
    assert_same_bits(tci_de_grid_model(2, params, max_iter, 250.0)[0], twin)
    assert twin[0, 0] == -1.0


def test_the_outputs_stored_without_the_formula_are_the_formulas():
    """K4 stores 0 for an analytically interior pixel, which counts as
    escaped with the latches z = 0, dz = 1: the formula there is +0. K1
    stores 0 for an escaped pixel whose dz has a non-finite half, whatever
    the latched z beyond the radius is: the formula there is +0 too."""
    one, zero = torch.ones(1), torch.zeros(1)
    d = de_std_formula(zero, zero, one, zero)
    assert d.item() == 0.0 and not np.signbit(d.numpy())[0]
    inf, nan = float("inf"), float("nan")
    lz = [0.0, -0.0, 251.0, -251.0, 1446.0, 1e19, -3e38, inf, -inf]
    dz = [inf, -inf, nan, 0.0, 1.0, -1e30, 3e38]
    lzr, lzi, dzr, dzi = (a.reshape(-1) for a in torch.meshgrid(
        *(torch.tensor(v, dtype=torch.float32) for v in (lz, lz, dz, dz)), indexing="ij"))
    beyond = lzr * lzr + lzi * lzi > 62500.0  # a latched z is beyond the radius
    dead = ~(torch.isfinite(dzr) & torch.isfinite(dzi))
    d = tci_de_formula(lzr, lzi, dzr, dzi)[beyond & dead]
    assert d.numel() > 1000 and (d == 0).all() and not np.signbit(d.numpy()).any()


def test_k1_nan_dz_gives_zero_distance():
    """The input of test_nan_dz_gives_zero_distance
    (tests/test_torch_mandelbrot.py): c = 2 escapes at step 4, and at step 8
    its z turns inf and its dz (inf, 0), so |2 z dz| is NaN (0 * inf). With
    two chunks to spare the model's first pass sees the inf z and stores 0; at
    max_iter 8 the pixel takes the second pass, whose max_nan keeps the NaN
    and whose d is 0 too; at 7 its dz is still finite. Each bitwise the
    twin's."""
    dom = (2.0, 3.0, 0.0, 1.0)
    params = mc._params(dom, 2)
    r2 = F(62500.0)
    assert first_pass_exit(2.0 + 0.0j, 12) == (4, 8)
    for max_iter in (12, 9, 8, 7, 5, 4, 3):
        twin = mc.tci_de_field_torch(dom, 2, max_iter)
        assert_same_bits(tci_de_grid_model(2, params, max_iter, 250.0)[0], twin)
    assert float(mc.tci_de_field_torch(dom, 2, 12)[0, 0]) == 0.0
    stored, steps = tci_de_thread_model(0, 0, params, 8 + 2 * C1, r2, C1)
    assert not isinstance(stored, tuple) and stored == 0.0 and steps == -(-8 // C1) * C1
    esc, lzr, lzi, dzr, dzi = tci_de_thread_model(0, 0, params, 8, r2, C1)[0]
    assert esc and (lzr, lzi) == (F(1446.0), F(0.0)) and np.isinf(dzr) and dzi == 0
    assert np.isfinite(tci_de_thread_model(0, 0, params, 7, r2, C1)[0][3])


# ---------------------------------------------------------------------------
# K5: chunks of escape.cuh:bare_step with a sticky flag; |z|^2 at the first
# escape from the newest chunk's snapshots, the formula once after the loop
# ---------------------------------------------------------------------------


C5 = K5["C"]


def green_grid_thread_model(col, row, params, max_iter, r2, c_steps):
    """One thread of green_grid_kernel up to its formula: (esc, a2, k, chunks
    run), with a2 = |z|^2 at the first escape and k its 0-based step; the
    thread stores 0 when esc is False and the formula of (a2, k) when it is
    True."""
    cr, ci = pixel_c(col, row, params)
    esc, a2, k = False, F(0), 0
    chunks = 0
    if not interior_model(cr, ci) and max_iter > 0:
        st = [F(0), F(0), F(0), F(0), False]
        sa2, up = [F(0)] * c_steps, [False] * c_steps
        n = 0
        while True:
            for c in range(c_steps):
                st = bare_step_model(st, cr, ci, r2)
                sa2[c] = st[2] + st[3]
                up[c] = st[4]
            n += c_steps
            chunks += 1
            if not (not st[4] and n < max_iter):
                break
        first = c_steps
        for c in range(c_steps - 1, -1, -1):
            if up[c]:
                first = c
                a2 = sa2[c]
        k = n - c_steps + first
        esc = st[4] and k < max_iter
    return esc, a2, k, chunks


def green_formula(a2, k):
    """green_grid_kernel's formula on a tensor of |z|^2 at the first escape
    and an array of its 0-based steps: 2^-(k+1) as ldexpf makes it (exact,
    subnormal or 0), the log torch's, as the twin's (see de_std_formula)."""
    scale = _t(np.ldexp(F(1.0), -(np.asarray(k) + 1)).astype(F))
    val = 0.5 * torch.log(torch.maximum(a2, a2.new_tensor(1e-30))) * scale
    return torch.maximum(val, val.new_tensor(0.0))


def green_grid_model(nx, ny, params, max_iter, escape_r, consts=K5):
    """green_grid_launch over (ny, nx): the threads' (a2, k) from the scalar
    model on the launcher's patch_pixel mapping, then what each thread
    stores: the formula where it escaped, else 0."""
    r2 = F(escape_r * escape_r)
    esc = np.zeros((ny, nx), dtype=bool)
    a2 = np.zeros((ny, nx), dtype=F)
    k = np.zeros((ny, nx), dtype=np.int64)
    for row, col in patch_threads(nx, ny, consts):
        esc[row, col], a2[row, col], k[row, col], _ = green_grid_thread_model(
            col, row, params, max_iter, r2, consts["C"])
    g = green_formula(_t(a2), k)
    return torch.where(_t(esc), g, g.new_tensor(0.0)).numpy()


@pytest.mark.parametrize("ny,nx,max_iter", [
    (2, 2, 1), (3, 5, C5 - 1), (9, 37, C5), (9, 37, C5 + 1), (7, 33, 2 * C5 - 1),
    (5, 3, 60), (17, 23, 60), (9, 17, 500), (45, 70, 500), (6, 9, 0)])
def test_k5_chunked_snapshot_model_equals_twin(ny, nx, max_iter):
    """Ragged grids (smaller than a patch, no multiple of a patch or a block,
    one row or column more than a patch) across the boundary; max_iter below,
    at and above C and not a multiple of it."""
    twin = mc.green_field_torch(DOM, nx, ny, max_iter, 4.0)
    model = green_grid_model(nx, ny, mc._params(DOM, nx, ny), max_iter, 4.0)
    assert_same_bits(model, twin)
    if max_iter >= 60:
        assert (model > 0).any() and (model == 0).any()


@pytest.mark.parametrize("consts", [
    dict(C=1, PATCH_W=32, PATCH_H=1, WARPS=8),
    dict(C=3, PATCH_W=8, PATCH_H=4, WARPS=2),
    dict(C=6, PATCH_W=16, PATCH_H=2, WARPS=4),
    dict(C=8, PATCH_W=2, PATCH_H=16, WARPS=1)])
def test_k5_model_results_do_not_depend_on_the_schedule(consts):
    ny, nx = 9, 21
    for max_iter in (24, 37):  # a multiple of every C here, and of none but 1
        twin = mc.green_field_torch(DOM, nx, ny, max_iter, 4.0)
        model = green_grid_model(nx, ny, mc._params(DOM, nx, ny), max_iter, 4.0, consts)
        assert_same_bits(model, twin)


def test_k5_first_escape_on_every_position_of_a_chunk_and_at_the_edge_of_max_iter():
    """Pixels whose first escape falls on each position of a chunk; and for
    one of each, max_iter equal to the escape step (the escape counts: the
    twin's g, not 0) and one below it (it does not: 0, though the chunk runs
    over it and raises the flag)."""
    nx, ny, r2 = 41, 19, F(16.0)
    params = mc._params(DOM, nx, ny)
    steps = lane_steps(DOM, nx, ny, 200, 16.0)  # 1-based escape step; 200 if none
    for pos in range(C5):
        rows, cols = np.nonzero((steps % C5 == pos) & (steps > C5) & (steps < 200))
        assert rows.size, f"no pixel escapes on position {pos} of a chunk"
        row, col, k = int(rows[0]), int(cols[0]), int(steps[rows[0], cols[0]])
        esc, _, kk, chunks = green_grid_thread_model(col, row, params, k, r2, C5)
        assert esc and kk == k - 1 and chunks == -(-k // C5)
        esc, _, _, chunks = green_grid_thread_model(col, row, params, k - 1, r2, C5)
        assert not esc and chunks == -(-(k - 1) // C5)
        for max_iter, escaped in ((k, True), (k - 1, False)):
            twin = mc.green_field_torch(DOM, nx, ny, max_iter, 4.0)
            model = green_grid_model(nx, ny, params, max_iter, 4.0)
            assert_same_bits(model, twin)
            assert bool(twin[row, col] != 0) == escaped


@pytest.mark.parametrize("step", [126, 127, 149, 150])
def test_k5_deep_escapers_where_the_power_of_two_turns_subnormal_and_then_0(step):
    """A real c escaping at the 1-based step k + 1: 2^-(k+1) is the least
    normal power at 126, subnormal at 127 and 149 (the least subnormal), and
    0 at 150, so g is normal, subnormal, subnormal and 0 (not NaN: |z|^2 is
    finite there); bitwise the twin's. The pixel is (0, 0) of a 2 x 2 grid
    whose corner is c."""
    c = real_point_escaping_at(step, 16.0)
    dom = (c, c + 1.0, 0.0, 1.0)
    params = mc._params(dom, 2)
    esc, a2, k, _ = green_grid_thread_model(0, 0, params, 500, F(16.0), C5)
    assert esc and k + 1 == step and np.isfinite(a2)
    twin = mc.green_field_torch(dom, 2, 2, 500, 4.0)
    assert_same_bits(green_grid_model(2, 2, params, 500, 4.0), twin)
    g = float(twin[0, 0])
    tiny = float(np.finfo(F).tiny)
    assert (g > 0) == (step < 150) and (g >= tiny) == (step == 126)


@pytest.mark.parametrize("domain", [
    (float("nan"), 1.0, -1.0, 1.0), (-1e20, 1e20, -1e20, 1e20), (-3e38, 3e38, -1.0, 1.0),
    (-2.0, 2.0, float("-inf"), 1.0)])
def test_k5_nan_and_inf_coordinates(domain):
    """Non-finite and overflowing coordinates: a NaN |z|^2 never raises the
    flag (g 0), an inf one does (g inf), and the steps after a hit run on to
    inf and NaN unread."""
    with np.errstate(over="ignore", invalid="ignore"):
        params = mc._params(domain, 7, 5)
        twin = mc.green_field_torch(domain, 7, 5, 11, 4.0)
        assert_same_bits(green_grid_model(7, 5, params, 11, 4.0), twin)


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
    dict(c=8, patch_w=16, patch_h=2), dict(c=2, patch_w=2, patch_h=16)])
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


#: each Python mirror of a csrc `constexpr int`: (module, name, key of a
#: footprint or None, csrc/<source>.cu, the constant)
MIRRORS = [
    *[(mc, name, key, source, prefix + const)
      for name, source, prefix in (("DWELL_FOOTPRINT", "dwell", ""),
                                   ("DWELL_PERIODIC_FOOTPRINT", "dwell", "P_"),
                                   ("DWELL_MS_FOOTPRINT", "dwell_ms", ""),
                                   ("DE_FOOTPRINT", "de_std", ""),
                                   ("TCI_FOOTPRINT", "tci_de", ""),
                                   ("GREEN_FOOTPRINT", "green_grid", ""))
      for key, const in (("c", "C"), ("patch_w", "PATCH_W"), ("patch_h", "PATCH_H"))],
    (sinkhorn, "SINKHORN_THREADS", None, "sinkhorn", "THREADS"),
    (sinkhorn, "SINKHORN_RING", None, "sinkhorn", "RING"),
    (sinkhorn, "SINKHORN_CTAS_PER_SM", None, "sinkhorn", "CTAS_PER_SM"),
]


@pytest.mark.parametrize("module,name,key,source,const", MIRRORS,
                         ids=[f"{m[1]}.{m[2]}" if m[2] else m[1] for m in MIRRORS])
def test_python_mirror_equals_the_csrc_constant(module, name, key, source, const):
    """The step accounting and the launch plans read these mirrors in place
    of the built library, so each must equal the constant its .cu is built
    with."""
    mirror = getattr(module, name)
    assert (mirror if key is None else mirror[key]) == constants(source)[const]


def test_footprint_constants_equal_the_constexpr_values_of_dwell_cu():
    assert K2["PATCH_W"] * K2["PATCH_H"] == 32
    text = (CSRC / "dwell.cu").read_text()
    body = text[text.index('extern "C" void dwell_footprint(int* out3)'):]
    body = body[:body.index("\n}\n")]
    # dwell_footprint() returns them in the order footprint_built reads
    order = re.findall(r"out3\[(\d)\] = (\w+);", body)
    assert order == [("0", "C"), ("1", "PATCH_W"), ("2", "PATCH_H")]


@pytest.mark.parametrize("name,consts,entry", [("DE_FOOTPRINT", K4, "de_footprint"),
                                               ("TCI_FOOTPRINT", K1, "tci_footprint"),
                                               ("GREEN_FOOTPRINT", K5, "green_footprint")])
def test_de_and_tci_footprints_equal_the_constexpr_values(name, consts, entry):
    assert set(getattr(mc, name)) == {"c", "patch_w", "patch_h"}
    assert consts["PATCH_W"] * consts["PATCH_H"] == 32
    lib, c_entry = mc.FOOTPRINT_ENTRY[name]
    assert c_entry == entry
    text = (CSRC / f"{lib}.cu").read_text()
    body = text[text.index(f'extern "C" void {entry}(int* out3)'):]
    order = re.findall(r"out3\[(\d)\] = (\w+);", body)
    assert order == [("0", "C"), ("1", "PATCH_W"), ("2", "PATCH_H")]
    # no compare-and-break in the steps of the chunk: the unrolled loop calls
    # the branch-free step and nothing that branches
    chunk = text[text.index("#pragma unroll\n            for (int c = 0; c < C; ++c)"):]
    chunk = chunk[:chunk.index(";\n" if lib == "tci_de" else "\n            }")]
    assert "bare_step(" in chunk and "break" not in chunk and "if (" not in chunk
    # the launcher's grid is the one patch_threads models
    assert "patch_pixel<PATCH_W, PATCH_H, WARPS, " in text
    assert ("const dim3 grid((nx + block_cols - 1) / block_cols, (ny + PATCH_H - 1) / PATCH_H);"
            in text or lib == "tci_de")


def _chunk_step(text: str) -> str:
    """The text of one step of escape.cuh:dwell_chunked's unrolled chunk."""
    body = text[text.index("int dwell_chunked("):]
    body = body[body.index("for (int c = 0; c < C; ++c)"):]
    return body[body.index("const float nzr"):body.index("\n            }\n")]


def test_ops_per_step_count_the_cu_bodies():
    """4 mul, 4 add/sub and 1 compare in the step of escape.cuh:dwell_chunked,
    the loop of dwell.cu's plain kernel and of dwell_ms.cu, and in
    escape.cuh:bare_step, the step of cloud_green.cu's chunks, of tci_de.cu's
    first pass and of green_grid.cu's chunks (whose snapshot of |z|^2 is the
    sum the radius test takes); the periodic entry's compares with the
    checkpoint run once a chunk, outside the step, and are not counted."""
    header = (CSRC / "escape.cuh").read_text()
    step = _chunk_step(header)
    plain = step[:step.index("up[c] = inside;")]
    bare = header[header.index("void bare_step("):]
    bare = bare[bare.index("const float nzr"):bare.index("\n}\n")]
    for name, body in (("dwell", plain), ("dwell_ms", plain), ("cloud_green", bare),
                       ("tci_de", bare), ("green_grid", bare)):
        muls = body.count(" * ")
        adds = body.count(" + ") + body.count(" - ")
        compares = body.count("<=") + body.count(" > ")
        assert (muls, adds, compares) == (4, 4, 1), (name, muls, adds, compares)
        assert mc.OPS_PER_STEP[name] == muls + adds + compares
        if body is bare:
            assert (CSRC / f"{name}.cu").read_text().count(
                "bare_step(zr, zi, zr2, zi2, hit, cr, ci, r2);") >= 1
    assert step[step.index("up[c] = inside;"):].strip() == "up[c] = inside;"
    assert " == " not in step
    chunk_end = header[header.index("n += C;"):header.index("} while (")]
    assert chunk_end.count("cyc = inside && zr == pr && zi == pi;") == 1
    assert mc.OPS_PER_STEP["dwell_periodic"] == mc.OPS_PER_STEP["dwell"] == 9
    assert "hit = hit || (zr2 + zi2 > r2);" in bare
    green = (CSRC / "green_grid.cu").read_text()
    assert green.count("sa2[c] = zr2 + zi2;") == 1 and mc.OPS_PER_STEP["green_grid"] == 9


def test_periodic_and_fine_pass_footprints_equal_the_constexpr_values():
    """The footprint entries of dwell.cu's periodic entry and of dwell_ms.cu
    write the P_* constants and dwell_ms.cu's in the order footprint_built
    reads them (test_python_mirror_equals_the_csrc_constant compares the
    values)."""
    assert set(mc.DWELL_PERIODIC_FOOTPRINT) == set(mc.DWELL_MS_FOOTPRINT) == {
        "c", "patch_w", "patch_h"}
    for name, keys in (("DWELL_PERIODIC_FOOTPRINT", ["P_C", "P_PATCH_W", "P_PATCH_H"]),
                       ("DWELL_MS_FOOTPRINT", ["C", "PATCH_W", "PATCH_H"])):
        lib, entry = mc.FOOTPRINT_ENTRY[name]
        text = (CSRC / f"{lib}.cu").read_text()
        body = text[text.index(f'extern "C" void {entry}(int* out3)'):]
        order = re.findall(r"out3\[(\d)\] = (\w+);", body)
        assert order == [(str(i), k) for i, k in enumerate(keys)], name


def test_wrappers_raise_without_a_card():
    with pytest.raises(RuntimeError, match="cuda"):
        mc.mandelbrot_field(DOM, 8, 8, 5, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        mc.cloud_green([0.3], [0.1], [0.0], [0.0], 5, device="cuda")
