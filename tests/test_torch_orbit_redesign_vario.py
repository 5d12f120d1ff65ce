"""csrc/orbit.cu's orbit_de_std and orbit_potential as redesigned for Hopper,
on the CPU.

The kernels run only on the card, where chip_smoke.py (phase 23) holds them
to their twins. Here:
  (a) torch models of the two schedules, written from orbit.cu line by line
      with the constants read out of its text (the f64 analytic interior
      skipped, first_escape's chunks with one exit test a chunk and the
      first escape latched by a replay of the flagged chunk or by a select,
      the remaining steps one by one; de_std's squared threshold and its dz
      by a second pass of the escapers or carried in the first pass), are
      held bitwise to de_field_std_torch on every output and to
      escape_potential_grid_torch: the loop state under
      _potential_contract, and g in all three normalizations, in f64 and
      f32, on ragged grids, at max_iter 0 to 600, on a 1-D input and on NaN,
      +-inf and huge coordinates. The footprint (warp patches, the order of
      the blocks) is left out: no result depends on it;
  (b) the wrappers hand the entries the schedule's arguments (the squared
      threshold, the (ny, nx) of the grid, the skip flag of the
      normalization), and with the kernel replaced by its model give the
      twins' outputs;
  (c) the models against cmtci's de_field_std and escape_potential_grid at
      the tolerances tests/test_torch_loops.py holds the port to, on grids
      that cross the f64 mask's rim.
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
#: max_iter on every shape; 600 (the variograms' de_std and U_M) on SHAPES[2]
ITERS = (0, 1, 2, 7, 61)
DEEP = 600
#: the chunk lengths the models are held to the twins at
CHUNKS = (4, 6, 8)
#: the cardioid-bulb junction chip_smoke.py holds the entries on
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


def walk_step(w, cr, ci, t, with_dz: bool):
    """orbit.cu's Walk::step on every point: dz from the old z (with_dz),
    then carried_step; returns the new state and whether |z|^2 passes t."""
    zr, zi, zr2, zi2, dzr, dzi = w
    if with_dz:
        tr, ti = 2.0 * zr, 2.0 * zi
        dzr, dzi = tr * dzr - ti * dzi + 1.0, tr * dzi + ti * dzr
    p = zr * zi
    nzr = zr2 - zi2 + cr
    nzi = p + p + ci
    w = (nzr, nzi, nzr * nzr, nzi * nzi, dzr, dzi)
    return w, w[2] + w[3] > t


def frozen(active, new, old):
    """A step taken only by the active points (a thread that has left its
    loop takes none)."""
    return tuple(torch.where(active, a, b) for a, b in zip(new, old))


def start(cr):
    zero = torch.zeros_like(cr)
    return (zero, zero, zero, zero, torch.ones_like(cr), zero)


def first_escape(cr, ci, max_iter: int, t, c: int, replay: bool, with_dz: bool, run,
                 counts: dict | None = None):
    """orbit.cu's first_escape on the points where `run` (the others keep
    the start): (k, w), k the 1-based step of the first |z|^2 > t (0: none),
    w the state there, or after max_iter steps. All points of the chunk
    loop stand at the same step (a thread only ever leaves it), so the
    chunks share one n; each point then runs its own one-by-one steps from
    where it left. `counts["steps"]`, if given, receives the steps taken,
    a replayed step counted again."""
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
                new, h = walk_step(w, cr, ci, t, with_dz)
                w = frozen(chunk, new, w)
                hit = hit | (chunk & h)
            w = frozen(hit, first, w)  # the flagged chunk again, one step at a time
            n0 = torch.where(hit, n, n0)
            chunk = chunk & ~hit
        else:
            at, got = w, torch.zeros_like(k)
            for s in range(c):
                new, h = walk_step(w, cr, ci, t, with_dz)
                w = frozen(chunk, new, w)
                first = chunk & h & (got == 0)
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
        new, h = walk_step(w, cr, ci, t, with_dz)
        w = frozen(act, new, w)
        hit = act & h
        k = torch.where(hit, j + 1, k)
        tail = tail & ~hit
    if counts is not None:
        counts["steps"] = counts.get("steps", 0) + steps
    return k, w


def interior_f64(cr, ci):
    """orbit.cu's interior_f64, in the reference's op order."""
    xm = cr - 0.25
    q = xm * xm + ci * ci
    in_cardioid = q * (q + xm) <= 0.25 * ci * ci - 1e-5
    xp = cr + 1.0
    in_bulb = xp * xp + ci * ci <= 0.0625 - 1e-5
    return (cr.abs() <= 2.0) & (ci.abs() <= 2.0) & (in_cardioid | in_bulb)


def skipped(cr, ci, skip: bool, t: float):
    """The points orbit.cu's skips_interior sends away without a step, for a
    squared threshold t."""
    if skip and cr.dtype == F64 and t >= 4.0:
        return interior_f64(cr, ci)
    return torch.zeros(cr.shape, dtype=torch.bool)


def de_std_model(cr, ci, max_iter: int, escape_r: float = 4.0, c: int = CONSTS["STD_C"],
                 replay: bool = bool(CONSTS["LATCH_BY_REPLAY"]),
                 second_pass: bool | None = None,
                 skip: bool = True, counts: dict | None = None):
    """orbit.cu's de_std_kernel on every point: (esc, lzr, lzi, ldr, ldi);
    dz by a second pass of the escapers, or carried in the first pass
    (second_pass None: as orbit.cu's STD_DZ_CARRIED_F64 or _F32 says for
    the dtype). `counts` receives the first pass's steps ("steps") and the
    second's ("second")."""
    shape = cr.shape
    cr, ci = cr.reshape(-1), ci.reshape(-1)
    if second_pass is None:
        second_pass = not CONSTS["STD_DZ_CARRIED_F64" if cr.dtype == F64
                                 else "STD_DZ_CARRIED_F32"]
    t = mb.radius_threshold(float(escape_r), cr.dtype == F64)
    run = ~skipped(cr, ci, skip, t)
    second = 0
    if second_pass:
        k, _ = first_escape(cr, ci, max_iter, t, c, replay, False, run, counts)
        w = start(cr)
        for s in range(int(k.max()) if k.numel() else 0):  # the (z, dz) body, k steps
            new, _ = walk_step(w, cr, ci, t, True)
            w = frozen(s < k, new, w)
        second = int(k.sum())
    else:
        k, w = first_escape(cr, ci, max_iter, t, c, replay, True, run, counts)
    if counts is not None:
        counts["second"] = second
    e = k > 0
    zero, one = torch.zeros_like(cr), torch.ones_like(cr)
    out = (e, torch.where(e, w[0], zero), torch.where(e, w[1], zero),
           torch.where(e, w[4], one), torch.where(e, w[5], zero))
    return tuple(a.reshape(shape) for a in out)


def potential_model(cr, ci, max_iter: int, r2: float, skip_interior: bool,
                    c: int = CONSTS["POT_C"], replay: bool = bool(CONSTS["LATCH_BY_REPLAY"]),
                    skip: bool = True, counts: dict | None = None):
    """orbit.cu's potential_kernel on every point: (esc, k, lzr, lzi)."""
    shape = cr.shape
    cr, ci = cr.reshape(-1), ci.reshape(-1)
    run = ~skipped(cr, ci, skip and skip_interior, r2)
    k, w = first_escape(cr, ci, max_iter, r2, c, replay, False, run, counts)
    esc = k > 0
    nan = torch.full_like(cr, float("nan"))
    out = (esc, torch.where(esc, k - 1, 0).to(torch.int32), torch.where(run, w[0], nan),
           torch.where(run, w[1], nan))
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
    near the f64 mask's rim and the junction, as a 1-D input."""
    huge = 1e300 if dtype == F64 else 3e38
    nan, inf = float("nan"), float("inf")
    vals = [(nan, 0.0), (0.0, nan), (inf, 0.0), (0.0, -inf), (-inf, inf), (inf, inf),
            (huge, 0.0), (0.0, -huge), (-huge, huge), (1e-300, -1e-300), (0.0, 0.0),
            (-2.0, 0.0), (0.25, 0.0), (-0.75, 0.0), (-1.25, 0.0), (-1.0, 0.0), (0.0, 1.0),
            (-0.1011, 0.9563), (2.0, 2.0), (-2.0, -2.0), (-0.75, 1e-3), (0.2285, 0.0),
            (-1.2499, 0.0), (-0.7501, 0.0), (0.2499, 0.0), (-0.125, 0.6495), (1e154, 0.5),
            (0.3, 0.5), (-0.5, 0.56)]
    arr = np.array(vals)
    return (torch.as_tensor(arr[:, 0]).to(dtype), torch.as_tensor(arr[:, 1]).to(dtype))


def grid(shape, dtype, dom=DOM):
    ny, nx = shape
    return mb.complex_grid(dom, nx, ny, dtype=dtype, device="cpu")


def cases(dtype):
    """(cr, ci, max_iter): the ragged grids at ITERS, SHAPES[2] at DEEP, and
    the special points as a 1-D input."""
    out = [(*grid(s, dtype), it) for s in SHAPES for it in ITERS]
    out.append((*grid(SHAPES[2], dtype), DEEP))
    out += [(*special_points(dtype), it) for it in (1, 7, DEEP)]
    return out


_TWIN_CACHE: dict = {}


def twin_state(name, cr, ci, it, radius):
    """The twin's loop state (de_std: _de_latched_loop_torch's; potential:
    _potential_loop_torch's at r2 = radius^2), cached across the schedule
    variants of one input."""
    key = (name, cr.dtype, tuple(cr.shape), float(cr.sum().nan_to_num()),
           float(ci.sum().nan_to_num()), it, radius)
    if key not in _TWIN_CACHE:
        if name == "de_std":
            _TWIN_CACHE[key] = mb._de_latched_loop_torch(cr, ci, it, radius, False)
        else:
            _TWIN_CACHE[key] = mb._potential_loop_torch(cr, ci, it, radius * radius)
    return _TWIN_CACHE[key]


# ---------------------------------------------------------------------------
# (a) the schedules, bitwise the twins
# ---------------------------------------------------------------------------


def test_models_read_the_committed_constants():
    """The constants the models default to are orbit.cu's, and the sources
    hold the redesigned entries' launchers with (ny, nx); orbit_de_stage1's
    takes them too, with the radius and its band."""
    assert CONSTS["STD_C"] in CHUNKS and CONSTS["POT_C"] in CHUNKS
    assert CONSTS["STD_DZ_CARRIED_F64"] in (0, 1) and CONSTS["STD_DZ_CARRIED_F32"] in (0, 1)
    assert CONSTS["LATCH_BY_REPLAY"] in (0, 1)
    assert CONSTS["ESC_PATCH_W"] * CONSTS["ESC_PATCH_H"] == 32
    # _potential_contract describes the skip, which is always on in f64
    assert "SKIP_INTERIOR" not in CONSTS
    text = ORBIT_CU.read_text()
    assert SKIP_SRC in text
    for entry, size in (("orbit_de_std", "long long ny, long long nx"),
                        ("orbit_potential", "long long ny, long long nx"),
                        ("orbit_de_stage1", "long long ny, long long nx, int max_iter, "
                                            "double radius, double t_lo, double t_hi")):
        sig = re.search(rf'extern "C" int {entry}_launch\(([^)]*)\)', text).group(1)
        assert size in " ".join(sig.split()), entry
    assert "double t," in text and "int skip_interior" in text


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("replay", [False, True], ids=["select", "replay"])
@pytest.mark.parametrize("second_pass", [False, True], ids=["dz_carried", "dz_second_pass"])
def test_de_std_model_is_the_twin(dtype, c, replay, second_pass):
    """orbit_de_std's schedule, at each chunk length, either latch and
    either dz pass, gives _de_latched_loop_torch's loop state bit for bit,
    and through the shared epilogue de_field_std_torch's outputs, on ragged
    grids at max_iter 0 to 600 and on the special points as a 1-D input."""
    for cr, ci, it in cases(dtype):
        want = twin_state("de_std", cr, ci, it, 4.0)
        got = de_std_model(cr, ci, it, 4.0, c, replay, second_pass)
        assert same_bits(got, want), (tuple(cr.shape), it)
    cr, ci, it = cases(dtype)[-1]
    assert same_bits(mb._de_std_epilogue(*de_std_model(cr, ci, it, 4.0, c, replay, second_pass),
                                         1e-14), mb.de_field_std_torch(cr, ci, it))


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("replay", [False, True], ids=["select", "replay"])
def test_potential_model_keeps_its_contract(dtype, c, replay):
    """orbit_potential's schedule, at each chunk length and either latch,
    with and without the skip, gives _potential_contract's state against
    _potential_loop_torch (the twin's own where nothing is skipped), and
    through the shared epilogue escape_potential_grid_torch's g in all
    three normalizations with the skip each asks for, on ragged grids at
    max_iter 0 to 600 and on the special points."""
    for cr, ci, it in cases(dtype):
        want = twin_state("potential", cr, ci, it, 4.0)
        for skip in (True, False):
            got = potential_model(cr, ci, it, 16.0, skip, c, replay)
            assert same_bits(got, mb._potential_contract(want, cr, ci, 16.0, skip)), \
                (tuple(cr.shape), it, skip)
        for norm in mb.POTENTIAL_NORMALIZATIONS:
            got = potential_model(cr, ci, it, 16.0, mb._skips_interior(norm), c, replay)
            assert same_bits(mb._potential_epilogue(*got, it, norm),
                             mb._potential_epilogue(*want, it, norm)), (tuple(cr.shape), it, norm)
    cr, ci, it = cases(dtype)[-1]
    for norm in mb.POTENTIAL_NORMALIZATIONS:
        got = potential_model(cr, ci, it, 16.0, mb._skips_interior(norm), c, replay)
        assert same_bits(mb._potential_epilogue(*got, it, norm),
                         mb.escape_potential_grid_torch(cr, ci, it, 4.0, norm)), norm


def test_the_skip_leaves_nan_only_in_the_f64_interior():
    """The contract's NaN stand exactly at the f64 mask's points for
    r2 >= 4 under a skipping normalization; f32, two_pow_k_break and a
    radius below 2 keep the twin's last z everywhere."""
    cr, ci = grid((129, 33), F64)
    want = mb._potential_loop_torch(cr, ci, 300, 16.0)
    got = mb._potential_contract(want, cr, ci, 16.0, True)
    mask = interior_f64(cr, ci)
    assert mask.any() and not mask.all()
    assert torch.equal(torch.isnan(got[2]), mask) and torch.equal(torch.isnan(got[3]), mask)
    assert not bool(got[0][mask].any())
    for args in ((cr.float(), ci.float(), 16.0, True), (cr, ci, 16.0, False),
                 (cr, ci, 2.25, True)):
        state = mb._potential_loop_torch(args[0], args[1], 300, args[2])
        assert mb._potential_contract(state, *args) is state
    assert [mb._skips_interior(n) for n in mb.POTENTIAL_NORMALIZATIONS] == [True, False, True]


@pytest.mark.parametrize("escape_r", [4.0, 10.0, 2.0, 1.5, 0.5, -1.0, 1e6, float("inf")])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_models_at_other_radii(escape_r, dtype):
    """The variograms' R 4 and coupling's R 10, and radii where the interior
    is not skipped (R < 2) or where no point or every point escapes: de_std
    bitwise the twin, the potential bitwise its contract, g in every
    normalization."""
    cr, ci = grid((37, 61), dtype)
    for it in (1, 7, 60):
        assert same_bits(de_std_model(cr, ci, it, escape_r),
                         mb._de_latched_loop_torch(cr, ci, it, escape_r, False)), it
        r2 = escape_r * escape_r
        want = mb._potential_loop_torch(cr, ci, it, r2)
        for norm in mb.POTENTIAL_NORMALIZATIONS:
            skip = mb._skips_interior(norm)
            got = potential_model(cr, ci, it, r2, skip)
            assert same_bits(got, mb._potential_contract(want, cr, ci, r2, skip)), (it, norm)
            assert same_bits(mb._potential_epilogue(*got, it, norm),
                             mb.escape_potential_grid_torch(cr, ci, it, escape_r, norm)), \
                (it, norm)


@pytest.mark.parametrize("escape_r", [4.0, 10.0])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_squared_threshold_at_the_variograms_radii(escape_r, dtype):
    """np.sqrt(s) > R in the dtype equals s > t on every value within 2^16
    ulps of t and on 0, inf and NaN, at de_std's R 4 and coupling's R 10;
    t >= 4, so the f64 interior may be skipped."""
    ity = np.uint64 if dtype == np.float64 else np.uint32
    t = dtype(mb.radius_threshold(escape_r, dtype == np.float64))
    bits = np.array([t], dtype=dtype).view(ity)[0].astype(np.int64)
    s = (bits + np.arange(-(1 << 16), (1 << 16) + 1)).astype(ity).view(dtype)
    s = np.concatenate([s, np.array([0.0, np.inf, np.nan], dtype=dtype)])
    np.testing.assert_array_equal(np.sqrt(s) > dtype(escape_r), s > t)
    np.testing.assert_array_equal((torch.sqrt(torch.as_tensor(s)) > escape_r).numpy(), s > t)
    assert t >= 4.0 and t >= escape_r * escape_r


def test_the_interior_takes_no_step_in_f64_only():
    """Over the variograms' domain at 600 steps, the f64 skip leaves out
    exactly the steps its points would take, all of them (none escapes),
    and most of the steps; f32 points run every step; de_std's second pass
    runs only the escapers' escape steps."""
    cr, ci = grid((48, 48), F64, (-2.25, 1.25, -1.75, 1.75))
    skip, every = {}, {}
    de_std_model(cr, ci, 600, counts=skip, c=1, replay=False, second_pass=True)
    de_std_model(cr, ci, 600, counts=every, skip=False, c=1, replay=False, second_pass=True)
    masked = int(interior_f64(cr, ci).sum())
    assert every["steps"] - skip["steps"] == 600 * masked
    assert 600 * masked > 0.6 * every["steps"]
    assert skip["second"] == every["second"]
    esc, k, _, _ = mb._potential_loop_torch(cr, ci, 600, mb.radius_threshold(4.0, True))
    assert skip["second"] == int((k[esc].long() + 1).sum())
    f32 = cr.float(), ci.float()
    skip32, every32 = {}, {}
    de_std_model(*f32, 600, counts=skip32)
    de_std_model(*f32, 600, counts=every32, skip=False)
    assert skip32 == every32


@pytest.mark.parametrize("dtype", [F64, F32])
def test_step_accounting_is_the_models(dtype):
    """bench's step accounting, which chip_smoke.py takes the redesign's
    bounds from, counts the models' steps at one step a chunk
    with the select latch (no replay): de_std's z-only steps and its second
    pass's (dz, z) steps, which a first pass that carries dz folds into its
    own."""
    from cmtci_torch import bench

    for shape in SHAPES:
        cr, ci = grid(shape, dtype)
        for it in (1, 7, 61):
            for radius in (4.0, 10.0, 1.5):
                counts = {}
                de_std_model(cr, ci, it, radius, c=1, replay=False, second_pass=True,
                             counts=counts)
                first, second = bench.orbit_de_std_lane_steps(cr, ci, it, radius)
                assert (int(first.sum()), int(second.sum())) == (counts["steps"],
                                                                 counts["second"])
                for skip in (True, False):
                    counts = {}
                    potential_model(cr, ci, it, radius * radius, skip, c=1, replay=False,
                                    counts=counts)
                    lane = bench.orbit_potential_lane_steps(cr, ci, it, radius * radius, skip)
                    assert int(lane.sum()) == counts["steps"], (shape, it, radius, skip)
    assert bench.interior_f64_torch is mb.interior_f64


# ---------------------------------------------------------------------------
# (b) the wrappers
# ---------------------------------------------------------------------------


def test_wrappers_hand_the_entries_the_schedule(monkeypatch):
    """With the kernel path taken on CPU tensors and the launch replaced by
    the model (fed the scalars the wrapper passes): de_field_std passes
    orbit_de_std the squared threshold and the grid; escape_potential_grid
    passes orbit_potential r2 and its normalization's skip flag; both give
    the twins' public outputs bitwise. orbit_de_stage1 takes the radius,
    its band (mandelbrot.hypot_band), no count and the grid."""
    seen = []

    def fake_orbit(entry, ins, outs, *scalars, grid=False):
        seen.append((entry, scalars, grid))
        cr, ci = ins
        if entry == "orbit_de_std":
            it, t = scalars
            assert t == mb.radius_threshold(4.0, cr.dtype == F64)
            return de_std_model(cr, ci, it, 4.0)
        if entry == "orbit_potential":
            it, r2, skip = scalars
            return potential_model(cr, ci, it, r2, bool(skip))
        return mb._de_latched_loop_torch(cr, ci, scalars[0], scalars[1], True)

    monkeypatch.setattr(mb, "_orbit", fake_orbit)
    monkeypatch.setattr(mb, "_loop", lambda twin, kernel, *args: kernel(*args))
    for dtype in (F64, F32):
        cr, ci = grid((37, 61), dtype)
        seen.clear()
        assert same_bits(mb.de_field_std(cr, ci, 61), mb.de_field_std_torch(cr, ci, 61))
        assert seen == [("orbit_de_std", (61, mb.radius_threshold(4.0, dtype == F64)), True)]
        for norm, skip in zip(mb.POTENTIAL_NORMALIZATIONS, (1, 0, 1)):
            seen.clear()
            assert same_bits(mb.escape_potential_grid(cr, ci, 61, 4.0, norm),
                             mb.escape_potential_grid_torch(cr, ci, 61, 4.0, norm)), norm
            assert seen == [("orbit_potential", (61, 16.0, skip), True)], norm
        seen.clear()
        mb.de_field_stage1(cr, ci, 20)
        assert seen == [("orbit_de_stage1",
                         (20, 1e6, *mb.hypot_band(1e6, dtype == F64), None), True)]


def test_cpu_inputs_run_the_twins_and_launch_nothing():
    """A CPU tensor runs the twins (a 1-D input, a row slice); nothing
    launches."""
    _launch.reset_launches()
    cr, ci = grid((37, 61), F64)
    assert same_bits(mb.de_field_std(cr[3:9], ci[3:9], 60),
                     mb.de_field_std_torch(cr[3:9], ci[3:9], 60))
    a, b = special_points(F64)
    for norm in mb.POTENTIAL_NORMALIZATIONS:
        assert same_bits(mb.escape_potential_grid(a, b, 60, 4.0, norm),
                         mb.escape_potential_grid_torch(a, b, 60, 4.0, norm))
    assert sum(_launch.launches.values()) == 0


# ---------------------------------------------------------------------------
# (c) against cmtci
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dom", [JUNCTION, (0.2, 0.3, -0.05, 0.05), (-1.3, -1.2, -0.05, 0.05),
                                 (-2.1, 0.9, -1.5, 1.5)],
                         ids=["junction", "cusp", "bulb-left", "fields"])
def test_models_against_cmtci(dom):
    """On f64 grids that cross the mask's rim (the cardioid-bulb junction,
    the cusp, the bulb's far side) and test_torch_fields.py's domain, the
    models with the interior skipped against cmtci at test_torch_loops.py's
    steps and tolerances (cmtci's XLA loops contract FMAs): de_field_std at
    80 steps (esc equal, d rtol 1e-8), escape_potential_grid at 60 (g == 0
    at the same points, rtol 1e-8) in each normalization at its radius."""
    cr, ci = mb.complex_grid(dom, 61, 47, device="cpu")
    esc, d, _, _ = mb._de_std_epilogue(*de_std_model(cr, ci, 80), 1e-14)
    r_esc, r_d, _, _ = ref_mb.de_field_std(cr.numpy(), ci.numpy(), max_iter=80)
    np.testing.assert_array_equal(esc.numpy(), np.asarray(r_esc))
    np.testing.assert_allclose(d.numpy(), np.asarray(r_d), rtol=1e-8, atol=0.0)
    for norm, escape_r in (("two_pow_n", 4.0), ("two_pow_k_break", 10.0), ("k_plus_1", 2.0)):
        state = potential_model(cr, ci, 60, escape_r * escape_r, mb._skips_interior(norm))
        g = mb._potential_epilogue(*state, 60, norm).numpy()
        ref = np.asarray(ref_mb.escape_potential_grid(cr.numpy(), ci.numpy(), max_iter=60,
                                                      escape_r=escape_r, normalization=norm))
        np.testing.assert_array_equal(g == 0, ref == 0)
        np.testing.assert_allclose(g, ref, rtol=1e-8, atol=0.0)
