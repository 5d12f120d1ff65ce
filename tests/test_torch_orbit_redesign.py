"""csrc/orbit.cu's orbit_dwell and orbit_de_tci as redesigned for Hopper, on
the CPU.

The kernels run only on the card, where chip_smoke.py (phase 23) holds them
to their twins. Here:
  (a) torch models of the two schedules, written from orbit.cu line by line
      with the constants read out of its text (the f64 analytic interior
      skipped, branch-free chunks with a latch and one exit test a chunk;
      for de_tci the z-only first pass with the latch by a select or by a
      replay of the flagged chunk, the late escapers' second pass, the
      squared threshold), are held bitwise to dwell_grid_torch and
      de_field_tci_torch: the loop state under the contract
      _de_tci_loop_cuda states, and the public outputs through the shared
      epilogue, in f64 and f32, on ragged grids, at max_iter 0 to 300, on a
      1-D input and on NaN, +-inf and huge coordinates. The footprint (warp
      patches, the order of the blocks) is left out: no result depends on it;
  (b) the squared threshold: sqrt(s) > R exactly when s > t, on every value
      within 2^16 ulps of t and on 0, inf and NaN;
  (c) the f64 mask: orbits of seeded points on the mask's rim stay below
      |z|^2 = 4 for 5,000 steps, and the model is held to cmtci's
      de_field_tci and dwell_grid on grids that cross the rim.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cmtci.kernels import mandelbrot as ref_mb
from cmtci_torch.kernels import _launch
from cmtci_torch.kernels import mandelbrot as mb

ORBIT_CU = Path(__file__).resolve().parents[1] / "cmtci_torch" / "csrc" / "orbit.cu"
CONSTS = {k: int(v) for k, v in
          re.findall(r"constexpr int (\w+) = (\d+);", ORBIT_CU.read_text())}
#: orbit.cu's skips_interior: the f64 analytic interior takes no step
SKIP_SRC = ("    if constexpr (std::is_same<T, double>::value)\n"
            "        return interior_f64(cr, ci);")
DOM = (-2.2, 1.2, -1.6, 1.6)
F64, F32 = torch.float64, torch.float32
SHAPES = ((3, 5), (1, 7), (37, 61), (129, 33))
ITERS = (1, 2, 7, 300)
#: the chunk lengths the models are held to the twins at
CHUNKS = (4, 6, 8)
#: the cardioid-bulb junction chip_smoke.py holds both entries on
JUNCTION = (-0.80, -0.70, -0.05, 0.05)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def in_cardioid(cr, ci):
    xm = cr - 0.25
    q = xm * xm + ci * ci
    return q * (q + xm) <= 0.25 * ci * ci - 1e-5


def in_bulb(cr, ci):
    xp = cr + 1.0
    return xp * xp + ci * ci <= 0.0625 - 1e-5


def interior_f64(cr, ci):
    """orbit.cu's interior_f64 (the reference's _interior_mask in f64, for
    |cr|, |ci| <= 2)."""
    return (cr.abs() <= 2.0) & (ci.abs() <= 2.0) & (in_cardioid(cr, ci) | in_bulb(cr, ci))


def carried_step(zr, zi, zr2, zi2, cr, ci):
    """orbit.cu's carried_step."""
    p = zr * zi
    nzr = zr2 - zi2 + cr
    nzi = p + p + ci
    return nzr, nzi, nzr * nzr, nzi * nzi


def frozen(active, new, old):
    """A step taken only by the active points (a thread that has left its
    loop takes none)."""
    return tuple(torch.where(active, a, b) for a, b in zip(new, old))


def skipped(cr, ci, skip: bool):
    """The points orbit.cu's skips_interior sends away without a step."""
    if skip and cr.dtype == F64:
        return interior_f64(cr, ci)
    return torch.zeros(cr.shape, dtype=torch.bool)


def dwell_model(cr, ci, max_iter: int, c: int = CONSTS["DWELL_C"], skip: bool = True):
    """orbit.cu's dwell_of on every point: chunks of c carried steps, the
    latch `inside` that falls at the first |z|^2 > 4, the latches of the
    newest chunk counted after the loop, min(n - c + in_chunk, max_iter)."""
    shape = cr.shape
    cr, ci = cr.reshape(-1), ci.reshape(-1)
    out = torch.full(cr.shape, max_iter, dtype=torch.int32)
    if max_iter <= 0:
        return out.reshape(shape)
    run = ~skipped(cr, ci, skip)
    z = (torch.zeros_like(cr),) * 4
    inside = torch.ones(cr.shape, dtype=torch.bool)
    n = torch.zeros(cr.shape, dtype=torch.int64)
    in_chunk = torch.zeros_like(n)
    active = run.clone()
    while bool(active.any()):  # do { ... } while (inside && n < max_iter)
        ups = torch.zeros_like(n)
        for _ in range(c):
            z = frozen(active, carried_step(*z, cr, ci), z)
            inside = torch.where(active, inside & ~(z[2] + z[3] > 4.0), inside)
            ups += active & inside
        in_chunk = torch.where(active, ups, in_chunk)
        n = torch.where(active, n + c, n)
        active = active & inside & (n < max_iter)
    dwell = torch.clamp(n - c + in_chunk, max=max_iter).to(torch.int32)
    return torch.where(run, dwell, out).reshape(shape)


def tci_model(cr, ci, max_iter: int, escape_r: float = 250.0, c: int = CONSTS["TCI_C"],
              skip: bool = True,
              replay: bool = bool(CONSTS["LATCH_BY_REPLAY"]), counts: dict | None = None):
    """orbit.cu's de_tci_kernel on every point: (esc, lr, li, dzr, dzi).
    All running points of the first pass stand at the same step (a thread
    only ever leaves it), so the chunks share one n. `counts`, if given,
    receives the steps of the first pass (z alone) and of the second
    ((z, dz)), a step counted where the kernel takes it."""
    shape = cr.shape
    cr, ci = cr.reshape(-1), ci.reshape(-1)
    t = mb.radius_threshold(float(escape_r), cr.dtype == F64)
    fast = t >= 4.0
    nan = torch.full_like(cr, float("nan"))
    zero = torch.zeros_like(cr)
    hit = torch.zeros(cr.shape, dtype=torch.bool)
    lr, li, dr, di = zero, zero, nan, nan
    first_steps = second_steps = 0
    if max_iter > 0:
        run = ~(skipped(cr, ci, skip) & fast)
        z = (zero,) * 4
        dead = torch.zeros_like(hit)

        def finite(z):
            return torch.isfinite(z[0]) & torch.isfinite(z[1])

        def step_and_latch(active, z, hit, lr, li):
            z = frozen(active, carried_step(*z, cr, ci), z)
            h = active & (z[2] + z[3] > t)
            first = h & ~hit
            return z, hit | h, torch.where(first, z[0], lr), torch.where(first, z[1], li)

        last = max_iter - 1
        n = 0
        while n + c <= last:  # whole chunks, none past step `last`
            active = run & ~dead
            first_steps += c * int(active.sum())
            if replay:
                start, was = z, hit
                for _ in range(c):
                    z = frozen(active, carried_step(*z, cr, ci), z)
                    hit = hit | (active & (z[2] + z[3] > t))
                flagged = active & hit & ~was
                r, found = start, torch.zeros_like(hit)
                for _ in range(c):  # the flagged chunk again, up to its first escape
                    r = carried_step(*r, cr, ci)
                    h = flagged & ~found & (r[2] + r[3] > t)
                    lr, li = torch.where(h, r[0], lr), torch.where(h, r[1], li)
                    found = found | h
            else:
                for _ in range(c):
                    z, hit, lr, li = step_and_latch(active, z, hit, lr, li)
            dead = dead | (active & hit & ~finite(z))
            n += c
        while n < last:  # the steps up to `last`, one by one
            active = run & ~dead
            first_steps += int(active.sum())
            z, hit, lr, li = step_and_latch(active, z, hit, lr, li)
            dead = dead | (active & hit & ~finite(z))
            n += 1
        active = run & ~dead & ~hit  # the last step decides the escape
        first_steps += int(active.sum())
        z, hit, lr, li = step_and_latch(active, z, hit, lr, li)
        hit = hit & run
        late = hit & ~dead
        # the second pass: the twin's (z, dz) body for max_iter steps
        idx = (hit & (late | (not fast))).nonzero()[:, 0]
        second_steps = max_iter * idx.numel()
        if idx.numel():
            c_r, c_i = cr[idx], ci[idx]
            zr, zi = torch.zeros_like(c_r), torch.zeros_like(c_i)
            dzr, dzi = torch.ones_like(c_r), torch.zeros_like(c_i)
            for _ in range(max_iter):
                tr, ti = 2.0 * zr, 2.0 * zi
                dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
                zr, zi = mb._zsq_add_c(zr, zi, c_r, c_i)
            keep = (torch.isfinite(dzr) & torch.isfinite(dzi)) if fast else \
                torch.ones(idx.shape, dtype=torch.bool)
            dr, di = dr.clone(), di.clone()
            dr[idx] = torch.where(keep, dzr, dr[idx])
            di[idx] = torch.where(keep, dzi, di[idx])
    if counts is not None:
        counts.update(first=first_steps, second=second_steps)
    return tuple(a.reshape(shape) for a in (hit, lr, li, dr, di))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def same_bits(a, b) -> bool:
    """Equal bit for bit (a +0.0 is not a -0.0), NaN equal to NaN."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = torch.int64 if a.dtype == F64 else torch.int32
    return torch.equal(na, nb) and torch.equal(a[~na].view(ints), b[~nb].view(ints))


def contract_holds(got, want, escape_r: float = 250.0) -> bool:
    """_de_tci_loop_cuda's contract: (esc, lr, li) the twin's bits; dz the
    twin's bits at an escaper whose twin dz is finite in both parts (for
    escape_r < 2: at every escaper), (NaN, NaN) everywhere else."""
    esc, lr, li, dr, di = got
    w_esc, w_lr, w_li, w_dr, w_di = want
    if not same_bits((esc, lr, li), (w_esc, w_lr, w_li)):
        return False
    keep = esc & (torch.isfinite(w_dr) & torch.isfinite(w_di) if escape_r >= 2 else True)
    return (same_bits((dr[keep], di[keep]), (w_dr[keep], w_di[keep]))
            and bool(torch.isnan(dr[~keep]).all()) and bool(torch.isnan(di[~keep]).all()))


def special_points(dtype):
    """NaN, +-inf, huge and tiny coordinates, the set's landmarks and points
    that sit on the f64 mask's rim, as a 1-D input."""
    huge = 1e300 if dtype == F64 else 3e38
    vals = [(float("nan"), 0.0), (0.0, float("nan")), (float("inf"), 0.0), (0.0, float("-inf")),
            (float("-inf"), float("inf")), (huge, 0.0), (0.0, -huge), (-huge, huge),
            (1e-300, -1e-300), (0.0, 0.0), (-2.0, 0.0), (0.25, 0.0), (-0.75, 0.0),
            (-1.25, 0.0), (-1.0, 0.0), (0.0, 1.0), (-0.1011, 0.9563), (2.0, 2.0),
            (-0.75, 1e-3), (0.2285, 0.0)]
    rim = rim_points(16, seed=5)
    vals += [(float(p.real), float(p.imag)) for p in rim]
    arr = np.array(vals)
    return (torch.as_tensor(arr[:, 0]).to(dtype), torch.as_tensor(arr[:, 1]).to(dtype))


def grid(shape, dtype, dom=DOM):
    ny, nx = shape
    return mb.complex_grid(dom, nx, ny, dtype=dtype, device="cpu")


# ---------------------------------------------------------------------------
# (a) the schedules, bitwise the twins
# ---------------------------------------------------------------------------


def test_models_read_the_committed_constants():
    """The constants the models default to are orbit.cu's, the f64 analytic
    interior is always skipped (the models' default), and the sources hold
    the two redesigned entries' launchers with (ny, nx)."""
    assert CONSTS["DWELL_C"] in CHUNKS and CONSTS["TCI_C"] in CHUNKS
    assert CONSTS["PATCH_W"] * CONSTS["PATCH_H"] == 32
    assert CONSTS["LATCH_BY_REPLAY"] in (0, 1) and "SKIP_INTERIOR" not in CONSTS
    text = ORBIT_CU.read_text()
    assert SKIP_SRC in text
    for entry in ("orbit_dwell", "orbit_de_tci"):
        sig = re.search(rf'extern "C" int {entry}_launch\(([^)]*)\)', text).group(1)
        assert "long long ny, long long nx" in " ".join(sig.split()), entry


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("c", CHUNKS)
def test_dwell_model_is_the_twin(dtype, c):
    """orbit_dwell's schedule, at each chunk length, with and without the f64
    interior skipped, bitwise dwell_grid_torch on ragged grids at max_iter
    0, 1, 2, 7 and 300, and on the special points as a 1-D input."""
    for shape in SHAPES:
        cr, ci = grid(shape, dtype)
        for it in (0, *ITERS):
            want = mb.dwell_grid_torch(cr, ci, it)
            for skip in (True, False):
                assert same_bits(dwell_model(cr, ci, it, c, skip), want), (shape, it, skip)
    cr, ci = special_points(dtype)
    for it in ITERS:
        want = mb.dwell_grid_torch(cr, ci, it)
        assert same_bits(dwell_model(cr, ci, it, c), want), it


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("replay", [False, True], ids=["select", "replay"])
def test_tci_model_is_the_twin(dtype, c, replay):
    """orbit_de_tci's schedule, at each chunk length and either latch, keeps
    _de_tci_loop_cuda's contract against _de_tci_loop_torch, and through the
    shared epilogue gives de_field_tci_torch's (esc, d, last_r, last_i) bit
    for bit, on ragged grids at max_iter 0 to 300 and on the special points
    as a 1-D input."""
    cases = [(grid(s, dtype), it) for s in SHAPES for it in (0, *ITERS)]
    cases += [(special_points(dtype), it) for it in ITERS]
    for (cr, ci), it in cases:
        want = mb._de_tci_loop_torch(cr, ci, it, 250.0)
        got = tci_model(cr, ci, it, 250.0, c, replay=replay)
        assert contract_holds(got, want), (tuple(cr.shape), it)
        assert same_bits(mb._de_tci_epilogue(*got, 1e-12), mb.de_field_tci_torch(cr, ci, it)), \
            (tuple(cr.shape), it)


@pytest.mark.parametrize("escape_r", [4.0, 2.0, 1.5, 0.5, -1.0, 1e6, float("inf")])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_tci_model_at_other_radii(escape_r, dtype):
    """Below R = 2 the interior is not skipped and every escaper takes the
    second pass; above it the fast path holds: the contract and the public
    outputs at radii on both sides, and where no point or every point
    escapes."""
    cr, ci = grid((37, 61), dtype)
    for it in (1, 7, 60):
        want = mb._de_tci_loop_torch(cr, ci, it, escape_r)
        got = tci_model(cr, ci, it, escape_r)
        assert contract_holds(got, want, escape_r), it
        assert same_bits(mb._de_tci_epilogue(*got, 1e-12),
                         mb.de_field_tci_torch(cr, ci, it, escape_r)), it


@pytest.mark.slow
@pytest.mark.parametrize("dtype", [F64, F32])
def test_models_at_the_tracker_grid(dtype):
    """The tracker's 600^2 grid at its 250 steps (slow: the twin's eager
    loop). The late escapers the model counts are the twin's: escaped, z
    finite after max_iter - 1 steps."""
    cr, ci = grid((600, 600), dtype)
    want = mb._de_tci_loop_torch(cr, ci, 250, 250.0)
    counts = {}
    got = tci_model(cr, ci, 250, counts=counts)
    assert contract_holds(got, want)
    assert counts["second"] == 250 * late_escapers(cr, ci, 250, 250.0)
    assert same_bits(dwell_model(cr, ci, 500), mb.dwell_grid_torch(cr, ci, 500))


def late_escapers(cr, ci, max_iter: int, escape_r: float) -> int:
    """Points of the twin's loop that escape within max_iter steps with z
    finite after max_iter - 1 steps."""
    zr, zi = torch.zeros_like(cr), torch.zeros_like(ci)
    esc = torch.zeros(cr.shape, dtype=torch.bool)
    fin = torch.ones_like(esc)
    for k in range(max_iter):
        if k == max_iter - 1:
            fin = torch.isfinite(zr) & torch.isfinite(zi)
        zr, zi = mb._zsq_add_c(zr, zi, cr, ci)
        esc = esc | (torch.sqrt(zr * zr + zi * zi) > escape_r)
    return int((esc & fin).sum())


def test_late_escapers_take_the_second_pass():
    """The second pass runs exactly for the twin's late escapers, and the
    finite dz of the model stand where the twin's escapers have one."""
    cr, ci = grid((129, 33), F64)
    for it in (2, 7, 60, 300):
        counts = {}
        got = tci_model(cr, ci, it, counts=counts)
        assert counts["second"] == it * late_escapers(cr, ci, it, 250.0), it
        want = mb._de_tci_loop_torch(cr, ci, it, 250.0)
        fin = got[0] & torch.isfinite(got[3]) & torch.isfinite(got[4])
        w_fin = want[0] & torch.isfinite(want[3]) & torch.isfinite(want[4])
        assert torch.equal(fin, w_fin), it


def test_the_interior_takes_no_step_in_f64_only():
    """Over the boundary's domain at 250 steps, the f64 mask leaves out
    exactly the steps its points would take, all of them (none escapes),
    and most of the steps; f32 points run every step."""
    cr, ci = grid((60, 60), F64, (-2.1, 0.9, -1.5, 1.5))
    skip, every = {}, {}
    tci_model(cr, ci, 250, counts=skip, skip=True)
    tci_model(cr, ci, 250, counts=every, skip=False)
    masked = int(interior_f64(cr, ci).sum())
    assert every["first"] - skip["first"] == 250 * masked
    assert 250 * masked > 0.6 * every["first"]
    f32 = cr.float(), ci.float()
    skip32, every32 = {}, {}
    tci_model(*f32, 250, counts=skip32, skip=True)
    tci_model(*f32, 250, counts=every32, skip=False)
    assert skip32 == every32


@pytest.mark.parametrize("dtype", [F64, F32])
def test_step_accounting_is_the_models(dtype):
    """bench's step accounting, which chip_smoke.py takes the redesign's
    bounds from, counts the model's steps at one step a
    chunk; its mask is the model's; _de_tci_contract is the model's loop
    state."""
    from cmtci_torch import bench

    for shape in SHAPES:
        cr, ci = grid(shape, dtype)
        assert torch.equal(bench.interior_f64_torch(cr.double(), ci.double()),
                           interior_f64(cr.double(), ci.double()))
        for it in ITERS:
            for radius in (250.0, 1.5):
                counts = {}
                state = tci_model(cr, ci, it, radius, c=1, counts=counts)
                first, second, late = bench.orbit_tci_lane_steps(cr, ci, it, radius)
                assert (int(first.sum()), int(second.sum())) == (counts["first"],
                                                                 counts["second"])
                twin = mb._de_tci_loop_torch(cr, ci, it, radius)
                assert same_bits(mb._de_tci_contract(twin, radius), state), (shape, it, radius)
            d = mb.dwell_grid_torch(cr, ci, it)
            lane = bench.orbit_dwell_lane_steps(cr, ci, d, it)
            skip = skipped(cr, ci, True)
            assert int(lane[skip].sum()) == 0
            assert torch.equal(lane[~skip], torch.where(d < it, d.long() + 1, it)[~skip])


def test_grid_shape():
    """The (ny, nx) the wrapper hands the two entries: the last dim across,
    the others down; a 0-D or 1-D input is one row."""
    assert mb._grid_shape(torch.zeros(5)) == (1, 5)
    assert mb._grid_shape(torch.zeros(())) == (1, 1)
    assert mb._grid_shape(torch.zeros(3, 7)) == (3, 7)
    assert mb._grid_shape(torch.zeros(2, 3, 7)) == (6, 7)
    assert mb._grid_shape(torch.zeros(4, 0)) == (0, 0)


def test_cpu_inputs_run_the_twins_and_launch_nothing():
    """A CPU tensor runs the twin (a 1-D input, a row slice); nothing
    launches."""
    _launch.reset_launches()
    cr, ci = grid((37, 61), F64)
    assert same_bits(mb.dwell_grid(cr[3:9], ci[3:9], 60), mb.dwell_grid_torch(cr[3:9], ci[3:9], 60))
    a, b = special_points(F64)
    assert same_bits(mb.de_field_tci(a, b, 60), mb.de_field_tci_torch(a, b, 60))
    assert sum(_launch.launches.values()) == 0


def test_second_passes_counter_is_checked():
    """_de_tci_loop_cuda refuses a counter it could not write through before
    it launches anything (a CUDA input without a card raises later)."""
    cr, ci = grid((3, 5), F64)
    for bad in (torch.zeros(1, dtype=torch.int64), torch.zeros(0, dtype=torch.int32)):
        with pytest.raises(ValueError, match="second_passes"):
            mb._de_tci_loop_cuda(cr, ci, 10, 250.0, second_passes=bad)


# ---------------------------------------------------------------------------
# (b) the squared threshold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("escape_r", [250.0, 4.0, 2.0, 1e6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_squared_threshold_is_the_sqrt_test(escape_r, dtype):
    """np.sqrt(s) > R in the dtype equals s > t on every value within 2^16
    ulps of t, and on 0, inf and NaN; torch's sqrt on the same values
    agrees."""
    ity = np.uint64 if dtype == np.float64 else np.uint32
    t = dtype(mb.radius_threshold(escape_r, dtype == np.float64))
    bits = np.array([t], dtype=dtype).view(ity)[0].astype(np.int64)
    s = (bits + np.arange(-(1 << 16), (1 << 16) + 1)).astype(ity).view(dtype)
    s = np.concatenate([s, np.array([0.0, np.inf, np.nan], dtype=dtype)])
    r = dtype(escape_r)
    np.testing.assert_array_equal(np.sqrt(s) > r, s > t)
    np.testing.assert_array_equal((torch.sqrt(torch.as_tensor(s)) > escape_r).numpy(), s > t)
    # t itself passes sqrt(t) <= R, its successor does not
    assert np.sqrt(t) <= r < np.sqrt(np.nextafter(t, dtype(np.inf)))


def test_squared_threshold_edges():
    assert mb.radius_threshold(250.0, True) == 62500.0
    assert mb.radius_threshold(float("nan"), True) == float("inf")
    assert mb.radius_threshold(float("inf"), False) == float("inf")
    assert mb.radius_threshold(1e200, False) == float("inf")  # inf as an f32 radius
    assert mb.radius_threshold(-1.0, True) == float("-inf")
    assert mb.radius_threshold(0.0, True) == 0.0
    assert mb.radius_threshold(2.0, True) >= 4.0 > mb.radius_threshold(np.nextafter(2.0, 0), True)


# ---------------------------------------------------------------------------
# (c) the f64 mask
# ---------------------------------------------------------------------------


def rim_points(n: int, seed: int) -> np.ndarray:
    """n seeded points on the f64 mask's rim: on rays from c = 0 (the
    cardioid) or from c = -1 (the bulb), the outermost f64 point the mask
    still accepts, found by bisection along the ray (the boundary curves
    moved inward just past the 1e-5 margin). Half on each."""
    rng = np.random.default_rng(seed)
    d = np.exp(1j * rng.uniform(0.0, 2.0 * np.pi, n))
    cardioid = np.arange(n) % 2 == 0
    center = np.where(cardioid, 0.0, -1.0)
    lo, hi = np.zeros(n), np.where(cardioid, 1.0, 0.3)  # accepted at lo, not at hi

    def accepted(r, test=None):
        p = center + r * d
        cr, ci = torch.as_tensor(p.real), torch.as_tensor(p.imag)
        if test is None:
            return interior_f64(cr, ci).numpy()
        # each component's own test along its rays (a ray from 0 that leaves
        # the cardioid at -3/4 enters the bulb)
        return torch.where(torch.as_tensor(cardioid), in_cardioid(cr, ci),
                           in_bulb(cr, ci)).numpy()

    for _ in range(60):
        mid = 0.5 * (lo + hi)
        inside = accepted(mid, "own")
        lo, hi = np.where(inside, mid, lo), np.where(inside, hi, mid)
    assert accepted(lo).all() and not accepted(hi, "own").any()
    assert (hi - lo).max() < 1e-15
    return center + lo * d


def test_mask_rim_orbits_stay_inside():
    """f64 orbits (the twin's op order) of 4,000 seeded points on the mask's
    rim never reach |z|^2 > 4 in 5,000 steps; the largest |z|^2 is about
    1.6, the margin the skip rests on."""
    pts = rim_points(4000, seed=17)
    cr, ci = pts.real.copy(), pts.imag.copy()
    zr, zi = np.zeros_like(cr), np.zeros_like(ci)
    top = 0.0
    for _ in range(5000):
        zr, zi = zr * zr - zi * zi + cr, zr * zi + zi * zr + ci
        top = max(top, float((zr * zr + zi * zi).max()))
    assert top < 2.0, top


@pytest.mark.parametrize("dom", [JUNCTION, (0.2, 0.3, -0.05, 0.05), (-1.3, -1.2, -0.05, 0.05)],
                         ids=["junction", "cusp", "bulb-left"])
def test_models_against_cmtci_across_the_rim(dom):
    """On f64 grids that cross the mask's rim (the cardioid-bulb junction,
    the cusp, the bulb's far side), the models with the interior skipped
    against cmtci: de_field_tci at test_torch_loops.py's thresholds (cmtci's
    XLA loop contracts FMAs), dwell_grid equal; and bitwise the twins."""
    cr, ci = mb.complex_grid(dom, 61, 47, device="cpu")
    got = tci_model(cr, ci, 120)
    esc, d, _, _ = mb._de_tci_epilogue(*got, 1e-12)
    r_esc, r_d, _, _ = ref_mb.de_field_tci(cr.numpy(), ci.numpy(), max_iter=120)
    np.testing.assert_array_equal(esc.numpy(), np.asarray(r_esc))
    np.testing.assert_allclose(d.numpy(), np.asarray(r_d), rtol=1e-12, atol=1e-15)
    assert contract_holds(got, mb._de_tci_loop_torch(cr, ci, 120, 250.0))
    # dwell: equal to cmtci's on the mask and on >= 99.5% of the grid (cmtci's
    # contracted FMAs move two dwells of the bulb's far side)
    dwell = dwell_model(cr, ci, 400).numpy()
    want = np.asarray(ref_mb.dwell_grid(cr.numpy(), ci.numpy(), max_iter=400))
    mask = interior_f64(cr, ci).numpy()
    assert mask.any() and not mask.all()
    np.testing.assert_array_equal(dwell[mask], want[mask])
    assert (dwell == want).mean() >= 0.995
    assert same_bits(torch.as_tensor(dwell), mb.dwell_grid_torch(cr, ci, 400))
