"""csrc/orbit.cu's orbit_de_stage1 as redesigned for Hopper, on the CPU.

The kernel runs only on the card, where chip_smoke.py (phase 23) holds it to
its twin. Here:
  (a) a torch model of its schedule, written from orbit.cu with the
      constants read out of its text (the f64 analytic interior skipped for
      R >= 2, first_escape's chunks with the band's conservative flag
      !(s < t_lo), a flagged chunk replayed one step at a time with the
      exact test, which calls hypot only inside the band or for a NaN s, or
      the first escape latched by a select on the exact test every step;
      dz carried in the first pass or rerun by the escapers), is held
      bitwise to _de_latched_loop_torch(..., by_hypot=True) and, through the
      shared epilogue, to de_field_stage1_torch, in f64 and f32, on ragged
      grids, at max_iter 0 to 200, on a 1-D input, on stage1's own 80 x 120
      grid and on NaN, +-inf and huge coordinates, at R 1e6 and 2 and at
      1e-200 and 1e300, which take the fallback band. The footprint (warp
      patches, the order of the blocks) is left out: no result depends on
      it;
  (b) mandelbrot.hypot_band's three-way test equals torch.hypot(zr, zi) > R
      (hypothesis: pairs on and a few ulps around the circle of radius R,
      non-finite, overflowing and subnormal pairs), and t_lo < R^2 < t_hi
      wherever the band is not the fallback;
  (c) the wrapper hands the entry the radius, the band and the (ny, nx) of
      the grid, and with the kernel replaced by the model gives the twin's
      outputs; bench's step and hypot-call accounting is the model's;
  (d) the model against cmtci's de_field_stage1 at test_torch_stage1.py's
      tolerance.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cmtci.kernels import mandelbrot as ref_mb
from cmtci_torch import bench
from cmtci_torch.kernels import _launch
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.pipelines import stage1

ORBIT_CU = Path(__file__).resolve().parents[1] / "cmtci_torch" / "csrc" / "orbit.cu"
CONSTS = {k: int(v) for k, v in
          re.findall(r"constexpr int (\w+) = (\d+);", ORBIT_CU.read_text())}
#: orbit.cu's skips_interior: the f64 analytic interior takes no step
SKIP_SRC = ("    if constexpr (std::is_same<T, double>::value)\n"
            "        return interior_f64(cr, ci);")
F64, F32 = torch.float64, torch.float32
SHAPES = ((3, 5), (1, 7), (37, 61), (129, 33))
#: max_iter on every shape; stage1's 200 on SHAPES[2] and on its own grid
ITERS = (0, 1, 2, 7, 61)
DEEP = 200
#: the chunk lengths the model is held to the twin at
CHUNKS = (4, 6, 8)


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
# the model
# ---------------------------------------------------------------------------


def walk_step(w, cr, ci, with_dz: bool):
    """orbit.cu's Walk::step on every point: dz from the old z (with_dz),
    then carried_step."""
    zr, zi, zr2, zi2, dzr, dzi = w
    if with_dz:
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
    p = zr * zi
    nzr = zr2 - zi2 + cr
    nzi = p + p + ci
    return (nzr, nzi, nzr * nzr, nzi * nzi, dzr, dzi)


class Band:
    """orbit.cu's HypotBand on every point: flag() !(s < t_lo); exact() the
    three-way test, counting into `calls` the points that call hypot."""

    def __init__(self, radius: float, double: bool):
        self.r = radius
        self.lo, self.hi = mb.hypot_band(radius, double)
        self.calls = 0

    def flag(self, w):
        return ~(w[2] + w[3] < self.lo)

    def exact(self, w, asked):
        s = w[2] + w[3]
        inside = ~(s > self.hi) & ~(s < self.lo)
        self.calls += int((asked & inside).sum())
        return (s > self.hi) | (inside & (torch.hypot(w[0], w[1]) > self.r))


def frozen(active, new, old):
    """A step taken only by the active points (a thread that has left its
    loop takes none)."""
    return tuple(torch.where(active, a, b) for a, b in zip(new, old))


def start(cr):
    zero = torch.zeros_like(cr)
    return (zero, zero, zero, zero, torch.ones_like(cr), zero)


def first_escape(cr, ci, max_iter: int, test, c: int, replay: bool, with_dz: bool, run,
                 counts: dict | None = None):
    """orbit.cu's first_escape on the points where `run` (the others keep
    the start): (k, w), k the 1-based step of the first exact test passed
    (0: none), w the state there, or after max_iter steps. All points of the
    chunk loop stand at the same step, so the chunks share one n; each point
    then runs its own one-by-one steps from where it left. counts["steps"]
    receives the steps taken, a replayed step counted again."""
    w = start(cr)
    k = torch.zeros(cr.shape, dtype=torch.int64)
    chunk = run.clone()
    n0 = torch.zeros_like(k)  # where a point starts its one-by-one steps
    steps = 0
    n = 0
    while n + c <= max_iter and bool(chunk.any()):
        steps += c * int(chunk.sum())
        if replay:
            first, hit = w, torch.zeros_like(chunk)
            for _ in range(c):
                w = frozen(chunk, walk_step(w, cr, ci, with_dz), w)
                hit = hit | (chunk & test.flag(w))
            w = frozen(hit, first, w)  # the flagged chunk again, one step at a time
            n0 = torch.where(hit, n, n0)
            chunk = chunk & ~hit
        else:
            at, got = w, torch.zeros_like(k)
            for s in range(c):
                w = frozen(chunk, walk_step(w, cr, ci, with_dz), w)
                asked = chunk & (got == 0)
                first = asked & test.exact(w, asked)
                at = frozen(first, w, at)
                got = torch.where(first, n + s + 1, got)
            done = got != 0
            w, k = frozen(done, at, w), torch.where(done, got, k)
            chunk = chunk & ~done
        n += c
    n0 = torch.where(chunk, n, n0)
    tail = run & (k == 0)
    for j in range(int(n0[tail].min()) if bool(tail.any()) else max_iter, max_iter):
        act = tail & (n0 <= j)
        steps += int(act.sum())
        w = frozen(act, walk_step(w, cr, ci, with_dz), w)
        hit = act & test.exact(w, act)
        k = torch.where(hit, j + 1, k)
        tail = tail & ~hit
    if counts is not None:
        counts["steps"] = counts.get("steps", 0) + steps
    return k, w


def de_stage1_model(cr, ci, max_iter: int, radius: float = 1e6, c: int = CONSTS["S1_C"],
                    replay: bool = bool(CONSTS["LATCH_BY_REPLAY"]),
                    second_pass: bool | None = None,
                    skip: bool = True, counts: dict | None = None):
    """orbit.cu's de_latched_kernel under HypotBand on every point: (esc,
    lzr, lzi, ldr, ldi); dz by a second pass of the escapers, or carried in
    the first pass (second_pass None: as S1_DZ_CARRIED_F64 or _F32 says for
    the dtype). `counts` receives the first pass's steps ("steps"), the
    second's ("second") and the calls of hypot ("hypot")."""
    shape = cr.shape
    cr, ci = cr.reshape(-1), ci.reshape(-1)
    double = cr.dtype == F64
    if second_pass is None:
        second_pass = not CONSTS["S1_DZ_CARRIED_F64" if double else "S1_DZ_CARRIED_F32"]
    test = Band(radius, double)
    run = torch.ones(cr.shape, dtype=torch.bool)
    if skip and double and np.float64(radius) >= 2.0:
        run = ~mb.interior_f64(cr, ci)
    second = 0
    if second_pass:
        k, _ = first_escape(cr, ci, max_iter, test, c, replay, False, run, counts)
        w = start(cr)
        for s in range(int(k.max()) if k.numel() else 0):  # the (z, dz) body, k steps
            w = frozen(s < k, walk_step(w, cr, ci, True), w)
        second = int(k.sum())
    else:
        k, w = first_escape(cr, ci, max_iter, test, c, replay, True, run, counts)
    if counts is not None:
        counts["second"] = second
        counts["hypot"] = test.calls
    e = k > 0
    zero, one = torch.zeros_like(cr), torch.ones_like(cr)
    out = (e, torch.where(e, w[0], zero), torch.where(e, w[1], zero),
           torch.where(e, w[4], one), torch.where(e, w[5], zero))
    return tuple(a.reshape(shape) for a in out)


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


def special_points(dtype):
    """NaN, +-inf, huge and tiny coordinates, the set's landmarks and points
    near the f64 mask's rim, as a 1-D input."""
    huge = 1e300 if dtype == F64 else 3e38
    nan, inf = float("nan"), float("inf")
    vals = [(nan, 0.0), (0.0, nan), (inf, 0.0), (0.0, -inf), (-inf, inf), (inf, inf),
            (inf, nan), (huge, 0.0), (0.0, -huge), (-huge, huge), (1e-300, -1e-300),
            (0.0, 0.0), (-2.0, 0.0), (0.25, 0.0), (-0.75, 0.0), (-1.25, 0.0), (-1.0, 0.0),
            (0.0, 1.0), (-0.1011, 0.9563), (2.0, 2.0), (-2.0, -2.0), (-0.75, 1e-3),
            (0.2285, 0.0), (-1.2499, 0.0), (0.2499, 0.0), (1e154, 0.5), (0.3, 0.5),
            (-0.5, 0.56), (1e3, 0.0), (999.9995, 0.0), (0.0, 1e6)]
    arr = np.array(vals)
    return (torch.as_tensor(arr[:, 0]).to(dtype), torch.as_tensor(arr[:, 1]).to(dtype))


def grid(shape, dtype, dom=stage1.BAND_DOMAIN):
    ny, nx = shape
    return mb.complex_grid(dom, nx, ny, dtype=dtype, device="cpu")


def stage1_grid(dtype=F64):
    """The (80, 120) meshgrid stage1.band_field passes de_field_stage1."""
    cfg = stage1.Stage1Config()
    gx, gy = np.meshgrid(np.linspace(*stage1.BAND_DOMAIN[:2], cfg.nx),
                         np.linspace(*stage1.BAND_DOMAIN[2:], cfg.ny), indexing="xy")
    return torch.as_tensor(gx).to(dtype), torch.as_tensor(gy).to(dtype)


def cases(dtype):
    """(cr, ci, max_iter): the ragged grids at ITERS, SHAPES[2] and stage1's
    grid at DEEP, and the special points as a 1-D input."""
    out = [(*grid(s, dtype), it) for s in SHAPES for it in ITERS]
    out.append((*grid(SHAPES[2], dtype), DEEP))
    out.append((*stage1_grid(dtype), DEEP))
    out += [(*special_points(dtype), it) for it in (1, 7, DEEP)]
    return out


_TWIN_CACHE: dict = {}


def twin_state(cr, ci, it, radius):
    """_de_latched_loop_torch(..., by_hypot=True), cached across the
    schedule variants of one input."""
    key = (cr.dtype, tuple(cr.shape), float(cr.nan_to_num().sum()),
           float(ci.nan_to_num().sum()), it, radius)
    if key not in _TWIN_CACHE:
        _TWIN_CACHE[key] = mb._de_latched_loop_torch(cr, ci, it, radius, True)
    return _TWIN_CACHE[key]


# ---------------------------------------------------------------------------
# (a) the schedule, bitwise the twin
# ---------------------------------------------------------------------------


def test_model_reads_the_committed_constants():
    """The constants the model defaults to are orbit.cu's, and the source's
    stage1 launcher takes (ny, nx), the radius, the band and the count."""
    assert CONSTS["S1_C"] in CHUNKS
    assert CONSTS["S1_PATCH_W"] * CONSTS["S1_PATCH_H"] == 32
    assert CONSTS["S1_WARPS"] in (1, 2, 4)
    assert CONSTS["S1_DZ_CARRIED_F64"] in (0, 1) and CONSTS["S1_DZ_CARRIED_F32"] in (0, 1)
    assert CONSTS["LATCH_BY_REPLAY"] in (0, 1) and "SKIP_INTERIOR" not in CONSTS
    text = ORBIT_CU.read_text()
    assert SKIP_SRC in text
    sig = re.search(r'extern "C" int orbit_de_stage1_launch\(([^)]*)\)', text).group(1)
    assert ("long long ny, long long nx, int max_iter, double radius, double t_lo, "
            "double t_hi, void* hypot_calls, int is_double, void* stream") in " ".join(sig.split())
    assert len(_launch.ARGTYPES["orbit_de_stage1"]) == 16
    assert "no exact squared form" not in text and "hypot_band" in text


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("replay", [False, True], ids=["select", "replay"])
@pytest.mark.parametrize("second_pass", [False, True], ids=["dz_carried", "dz_second_pass"])
def test_de_stage1_model_is_the_twin(dtype, c, replay, second_pass):
    """orbit_de_stage1's schedule, at each chunk length, either latch and
    either dz pass, gives _de_latched_loop_torch(..., by_hypot=True)'s loop
    state bit for bit on ragged grids at max_iter 0 to 200, on stage1's grid
    and on the special points as a 1-D input, and through the shared
    epilogue de_field_stage1_torch's outputs."""
    for cr, ci, it in cases(dtype):
        got = de_stage1_model(cr, ci, it, 1e6, c, replay, second_pass)
        assert same_bits(got, twin_state(cr, ci, it, 1e6)), (tuple(cr.shape), it)
    cr, ci = stage1_grid(dtype)
    assert same_bits(mb._de_stage1_epilogue(*de_stage1_model(cr, ci, DEEP, 1e6, c, replay,
                                                             second_pass)),
                     mb.de_field_stage1_torch(cr, ci, DEEP))


@pytest.mark.parametrize("radius", [2.0, 1e-200, 1e300, 0.5, 4.0, 1e3, float("nan"),
                                    float("inf"), -1.0, 0.0])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_model_at_other_radii(radius, dtype):
    """At R 2 (the skip's edge), at 1e-200 and 1e300 (the fallback band:
    every step calls hypot), and at radii where no point or every point
    escapes, the model is the twin bit for bit on a ragged grid and on the
    special points, in both latches."""
    pts = special_points(dtype)
    for cr, ci, it in ((*grid((37, 61), dtype), 7), (*grid((37, 61), dtype), 60),
                       (*pts, 1), (*pts, 60)):
        want = twin_state(cr, ci, it, radius)
        for replay in (True, False):
            assert same_bits(de_stage1_model(cr, ci, it, radius, replay=replay), want), \
                (tuple(cr.shape), it, replay)


def test_stage1_grid_calls_no_hypot():
    """On stage1's 80 x 120 f64 grid at 200 steps and R 1e6 the committed
    schedule calls hypot at no step, skips the 1,476 interior points and
    runs the twin's steps elsewhere; the fallback band calls hypot at every
    exact test, and the twin's bits stay."""
    cr, ci = stage1_grid()
    counts = {}
    got = de_stage1_model(cr, ci, DEEP, counts=counts)
    assert same_bits(got, twin_state(cr, ci, DEEP, 1e6))
    assert counts["hypot"] == 0
    assert int(mb.interior_f64(cr, ci).sum()) == 1476
    first, second = bench.orbit_de_stage1_lane_steps(cr, ci, DEEP, 1e6)
    assert int(first.sum()) == 400154 - DEEP * 1476
    assert int((first == DEEP).sum()) == 158 and int((second > 0).sum()) == 7966
    fallback = {}
    assert same_bits(de_stage1_model(cr, ci, DEEP, 1e300, counts=fallback),
                     twin_state(cr, ci, DEEP, 1e300))
    assert fallback["hypot"] > 0


def test_the_interior_takes_no_step_in_f64_only():
    """Over stage1's domain at 200 steps the f64 skip leaves out exactly the
    steps its points would take, all of them (none escapes); f32 points and
    a radius below 2 run every step."""
    cr, ci = grid((48, 48), F64)
    skip, every = {}, {}
    de_stage1_model(cr, ci, DEEP, counts=skip, c=1, replay=False, second_pass=True)
    de_stage1_model(cr, ci, DEEP, counts=every, skip=False, c=1, replay=False,
                    second_pass=True)
    masked = int(mb.interior_f64(cr, ci).sum())
    assert masked > 0 and every["steps"] - skip["steps"] == DEEP * masked
    assert skip["second"] == every["second"]
    for args in ((cr.float(), ci.float(), DEEP, 1e6), (cr, ci, DEEP, 1.5)):
        a, b = {}, {}
        de_stage1_model(*args, counts=a)
        de_stage1_model(*args, counts=b, skip=False)
        assert a == b


# ---------------------------------------------------------------------------
# (b) the band
# ---------------------------------------------------------------------------


def three_way(zr, zi, radius: float):
    """orbit.cu's exact test on tensors: s > t_hi, else s < t_lo fails, else
    hypot."""
    lo, hi = mb.hypot_band(radius, zr.dtype == F64)
    s = zr * zr + zi * zi
    return (s > hi) | (~(s < lo) & (torch.hypot(zr, zi) > radius))


def near_circle(radius: float, dtype, angles, ulps: int):
    """Points on the circle of radius R in the dtype at `angles`, each moved
    by -ulps..ulps ulps in each part (both parts and the rounding of R's own
    circle), as (zr, zi)."""
    r = float(np.asarray(radius, dtype=np.float64 if dtype == F64 else np.float32))
    t = torch.as_tensor(np.asarray(angles, dtype=np.float64))
    zr = (r * torch.cos(t)).to(dtype)
    zi = (r * torch.sin(t)).to(dtype)
    steps = torch.arange(-ulps, ulps + 1)
    ints = torch.int64 if dtype == F64 else torch.int32
    zr = (zr.view(ints)[:, None, None] + steps[None, :, None].to(ints)).view(dtype)
    zi = (zi.view(ints)[:, None, None] + steps[None, None, :].to(ints)).view(dtype)
    zr, zi = torch.broadcast_tensors(zr, zi)
    return zr.reshape(-1), zi.reshape(-1)


@settings(max_examples=60, deadline=None)
@given(radius=st.one_of(st.sampled_from([1e6, 2.0, 4.0, 1e3, 0.5, 2.0**-30, 2.0**30]),
                        st.floats(2.0**-38, 2.0**38)),
       angles=st.lists(st.floats(0.0, 6.2832), min_size=1, max_size=8),
       double=st.booleans())
def test_hypot_band_is_the_hypot_test_around_the_circle(radius, angles, double):
    """On points at and a few ulps around the circle of radius R, and around
    the circles of the band's edges, R sqrt(1 +- d), the three-way test
    equals torch.hypot(zr, zi) > R; points past each edge are decided by the
    band alone, and t_lo < R^2 < t_hi."""
    dtype = F64 if double else F32
    d = mb.HYPOT_BAND[double][0]
    lo, hi = mb.hypot_band(radius, double)
    for scale in (1.0, (1 + d) ** 0.5, (1 - d) ** 0.5):
        zr, zi = near_circle(radius * scale, dtype, angles, 3)
        assert torch.equal(three_way(zr, zi, radius), torch.hypot(zr, zi) > radius), scale
        s = zr * zr + zi * zi
        if scale > 1:
            assert bool((s > hi).any())
        elif scale < 1:
            assert bool((s < lo).any())
    r = float(np.asarray(radius, dtype=np.float64 if double else np.float32))
    assert lo < r * r < hi


FINITE = st.floats(allow_nan=False, allow_infinity=False, width=32)
ANY = st.floats(allow_nan=True, allow_infinity=True)


@settings(max_examples=200, deadline=None)
@given(pairs=st.lists(st.tuples(ANY, ANY), min_size=1, max_size=16),
       radius=st.one_of(st.sampled_from([1e6, 2.0, 1e-200, 1e300, 2.0**-400, 2.0**400,
                                         2.0**-40, 2.0**40, 0.0, -1.0, float("nan"),
                                         float("inf")]), FINITE),
       double=st.booleans())
def test_hypot_band_on_any_pair(pairs, radius, double):
    """On any pairs (non-finite, overflowing, subnormal) and any radius, the
    three-way test equals torch.hypot(zr, zi) > R."""
    dtype = F64 if double else F32
    arr = np.array(pairs, dtype=np.float64)
    with np.errstate(over="ignore"):
        zr, zi = (torch.as_tensor(arr[:, j].astype(np.float64 if double else np.float32))
                  for j in (0, 1))
    assert zr.dtype == dtype
    assert torch.equal(three_way(zr, zi, radius), torch.hypot(zr, zi) > radius)


@pytest.mark.parametrize("double", [True, False])
def test_hypot_band_on_special_pairs(double):
    """Every pairing of special values (NaN, +-inf, the dtype's largest and
    smallest normal and subnormal values, 0, the radii themselves and their
    neighbours) at R 1e6 and 2 and at the range's edges: the three-way test
    is the hypot test; outside the range the band is (-inf, +inf)."""
    ft = np.float64 if double else np.float32
    info = np.finfo(ft)
    vals = [np.nan, np.inf, -np.inf, info.max, -info.max, info.tiny, info.smallest_subnormal,
            0.0, -0.0, 1.0]
    smallest, largest = mb.HYPOT_BAND[double][1:]
    radii = (1e6, 2.0, smallest, largest)
    for r in radii:
        rr = ft(r)
        vals += [rr, np.nextafter(rr, ft(np.inf)), np.nextafter(rr, ft(0)), rr / ft(np.sqrt(2))]
    v = np.array(vals, dtype=ft)
    gx, gy = np.meshgrid(v, v)
    zr, zi = torch.as_tensor(gx.ravel()), torch.as_tensor(gy.ravel())
    for r in radii:
        assert torch.equal(three_way(zr, zi, r), torch.hypot(zr, zi) > r), r
        lo, hi = mb.hypot_band(r, double)
        assert lo < float(ft(r)) ** 2 < hi
    for r in (smallest / 2, largest * 2, 0.0, -2.0, float("nan"), float("inf"), 1e-200, 1e300):
        assert mb.hypot_band(r, double) == (float("-inf"), float("inf")), r


# ---------------------------------------------------------------------------
# (c) the wrapper and the accounting
# ---------------------------------------------------------------------------


def test_wrapper_hands_the_entry_the_band(monkeypatch):
    """With the kernel path taken on CPU tensors and the launch replaced by
    the model (fed the scalars the wrapper passes): de_field_stage1 passes
    orbit_de_stage1 max_iter, R, its band and no count on the (ny, nx) of
    the grid, and gives de_field_stage1_torch's outputs bitwise; a count of
    the wrong kind is refused."""
    seen = []

    def fake_orbit(entry, ins, outs, *scalars, grid=False):
        seen.append((entry, scalars, grid))
        it, radius, lo, hi, count = scalars
        assert (lo, hi) == mb.hypot_band(radius, ins[0].dtype == F64) and count is None
        return de_stage1_model(*ins, it, radius)

    monkeypatch.setattr(mb, "_orbit", fake_orbit)
    monkeypatch.setattr(mb, "_loop", lambda twin, kernel, *args: kernel(*args))
    for dtype in (F64, F32):
        cr, ci = stage1_grid(dtype)
        seen.clear()
        assert same_bits(mb.de_field_stage1(cr, ci, 20), mb.de_field_stage1_torch(cr, ci, 20))
        assert seen == [("orbit_de_stage1", (20, 1e6, *mb.hypot_band(1e6, dtype == F64), None),
                         True)]
    with pytest.raises(ValueError, match="hypot_calls"):
        mb._de_latched_loop_cuda(cr, ci, 20, 1e6, True, hypot_calls=torch.zeros(1))


def test_cpu_inputs_run_the_twin_and_launch_nothing():
    """A CPU tensor runs the twin (a row slice, a 1-D input); nothing
    launches."""
    _launch.reset_launches()
    cr, ci = stage1_grid()
    assert same_bits(mb.de_field_stage1(cr[3:9], ci[3:9], 60),
                     mb.de_field_stage1_torch(cr[3:9], ci[3:9], 60))
    a, b = special_points(F64)
    assert same_bits(mb.de_field_stage1(a, b, 60), mb.de_field_stage1_torch(a, b, 60))
    assert sum(_launch.launches.values()) == 0


@pytest.mark.parametrize("dtype", [F64, F32])
def test_step_accounting_is_the_models(dtype):
    """bench's accounting, which chip_smoke.py takes the bounds and the
    hypot count from, is the model's: orbit_de_stage1_lane_steps
    counts its z-only steps at one step a chunk with the select latch and
    its second pass's steps; orbit_de_stage1_hypot_calls its calls of hypot
    under the committed replay, the same at each chunk length."""
    pts = special_points(dtype)
    for cr, ci in (grid((37, 61), dtype), grid((3, 5), dtype), pts):
        for it in (1, 7, 61):
            for radius in (1e6, 2.0, 1.5, 1e300):
                counts = {}
                de_stage1_model(cr, ci, it, radius, c=1, replay=False, second_pass=True,
                                counts=counts)
                first, second = bench.orbit_de_stage1_lane_steps(cr, ci, it, radius)
                assert (int(first.sum()), int(second.sum())) == (counts["steps"],
                                                                 counts["second"])
                calls = int(bench.orbit_de_stage1_hypot_calls(cr, ci, it, radius).sum())
                for c in CHUNKS:
                    counts = {}
                    de_stage1_model(cr, ci, it, radius, c=c, replay=True, counts=counts)
                    assert calls == counts["hypot"], (tuple(cr.shape), it, radius, c)


# ---------------------------------------------------------------------------
# (d) against cmtci
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(80, 120), (30, 40)])
def test_model_against_cmtci(shape):
    """On stage1's grid and test_stage1_de.py's, the model with the interior
    skipped against cmtci's de_field_stage1 at test_torch_stage1.py's
    tolerance: the same escape set, d within 1e-8 relative (XLA contracts
    FMAs)."""
    cfg = stage1.Stage1Config(nx=shape[1], ny=shape[0])
    cr, ci, _ = stage1.band_field(cfg, device="cpu")
    esc, d = mb._de_stage1_epilogue(*de_stage1_model(torch.as_tensor(cr), torch.as_tensor(ci),
                                                     cfg.max_iter, cfg.bailout))
    esc_ref, d_ref = ref_mb.de_field_stage1(cr, ci, max_iter=cfg.max_iter, bailout=cfg.bailout)
    np.testing.assert_array_equal(esc.numpy(), np.asarray(esc_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-8, atol=0)
