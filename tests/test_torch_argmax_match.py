"""cmtci_torch's kernel-argmax matcher (kernels/argmax_match.py: the launch
plan and wrapper of csrc/argmax_match.cu; transport/sinkhorn.py: its twin)
on the CPU.

The kernels run only on the card, where chip_smoke.py holds the mean's f32
bits and the indices bitwise to the chain's. Here: the twin, whose mean now
sums in f64, against cmtci's _match_fused; the f32 mean against the correctly
rounded mean of the f32 distances; a torch model of the kernel's slab split
and ordered merge against the twin on ragged tiles and slabs; exact ties and
NaN; the launch plan at the tracker's sizes; the wrapper's refusals; the
tracker's card counter; the C signatures.
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cmtci.transport.sinkhorn import _match_fused as ref_match_fused
from cmtci_torch.kernels import _launch, argmax_match
from cmtci_torch.pipelines.tracker import TrackerConfig, run_tracker
from cmtci_torch.transport import sinkhorn
from cmtci_torch.utils.artifacts import StageTimer

CU = Path(argmax_match.__file__).resolve().parents[1] / "csrc" / "argmax_match.cu"
DTYPES = {"f32": torch.float32, "f64": torch.float64}
#: the tracker's matcher sizes (both clouds cut to C's), bins 64 to 1024
TRACKER_SIZES = (2400, 6000, 14820, 37820, 97020)
EPS = 0.8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers on
    the CPU at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring_and_blob(seed, n, m):
    """A ring of C-like points and a blob of M-like points (N, 2) in f64."""
    r = np.random.default_rng(seed)
    t = r.uniform(0, 2 * np.pi, n)
    a = np.stack([np.cos(t), np.sin(t)], 1) * r.uniform(0.9, 1.1, (n, 1))
    return a, r.normal(scale=0.7, size=(m, 2))


def _slab(s, m, slabs):
    """[c0, c1) of slab s, as argmax_match.cu's work() cuts m columns."""
    return s * m // slabs, (s + 1) * m // slabs


def _kernel_model(a, b, mean, eps, slabs):
    """The kernel's argmax in torch: each tile of argmax_match.TILE rows meets
    each slab of columns (_slab); within a slab the columns come in
    increasing j and only a strictly larger k replaces a row's best; then the
    slabs merge in slab order by the same rule, as the tile's last CTA does."""
    n, m = a.shape[0], b.shape[0]
    out = torch.empty(n, dtype=torch.int64)
    for i0 in range(0, n, argmax_match.TILE):
        rows = a[i0 : i0 + argmax_match.TILE]
        parts = []
        for s in range(slabs):
            c0, c1 = _slab(s, m, slabs)
            k = torch.nan_to_num(torch.exp(-(sinkhorn._pairwise_dist(rows, b[c0:c1]) / mean)
                                           / eps))
            best = torch.full((rows.shape[0],), -math.inf, dtype=a.dtype)
            arg = torch.full((rows.shape[0],), c0, dtype=torch.int64)
            for jj in range(c1 - c0):
                better = k[:, jj] > best
                best = torch.where(better, k[:, jj], best)
                arg = torch.where(better, c0 + jj, arg)
            parts.append((best, arg))
        best, arg = parts[0]
        for ks, js in parts[1:]:
            better = ks > best
            best, arg = torch.where(better, ks, best), torch.where(better, js, arg)
        out[i0 : i0 + rows.shape[0]] = arg
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_twin_matches_reference(dtype):
    """The twin (f64 mean) against cmtci's _match_fused (a mean summed in the
    clouds' dtype) on a ring against a blob, at the agreement rates the
    transport tests hold (XLA may contract an FMA and flip a near-tie)."""
    dt = DTYPES[dtype]
    a, b = (x.astype(np.float32 if dt == torch.float32 else np.float64)
            for x in _ring_and_blob(1, 2500, 2500))
    got = sinkhorn._match_fused(torch.as_tensor(a), torch.as_tensor(b), EPS).numpy()
    want = np.asarray(ref_match_fused(a, b, EPS))
    assert (got == want).mean() >= (0.999 if dt == torch.float32 else 0.9999)


def test_f32_mean_is_the_rounded_mean_of_the_f32_distances():
    """The twin's f32 mean is the f32 rounding of the exact mean of the f32
    distances (math.fsum of them widened to f64), on ragged blocks."""
    a, b = (torch.as_tensor(x, dtype=torch.float32) for x in _ring_and_blob(2, 1500, 1300))
    d = sinkhorn._pairwise_dist(a, b).double().numpy().ravel()
    want = np.float32(math.fsum(d) / d.size)
    total = sinkhorn._blocked_dist_total(a, b, chunk=512)
    assert total.dtype == torch.float64
    assert abs(float(total) - math.fsum(d)) <= 1e-12 * math.fsum(d)
    got = sinkhorn._blocked_mean_dist(a, b, chunk=512)
    assert got.dtype == torch.float32 and got.item() == want


@pytest.mark.parametrize("slabs", [1, 3, 7])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slab_split_and_merge_equal_the_twin(dtype, slabs):
    """The kernel model (slabs of the columns, merged in slab order) is
    bitwise _argmax_kernel_rows on a ragged last tile (1,100 rows) and ragged
    slabs (523 columns), with the twin's mean."""
    a, b = (torch.as_tensor(x, dtype=DTYPES[dtype]) for x in _ring_and_blob(3, 1100, 523))
    mean = sinkhorn._blocked_mean_dist(a, b)
    want = sinkhorn._argmax_kernel_rows(a, b, mean, EPS)
    assert torch.equal(_kernel_model(a, b, mean, EPS, slabs), want)


@pytest.mark.parametrize("slabs", [1, 2, 3])
def test_exact_ties_take_the_first_index(slabs):
    """b holds every point twice (the second copy in a later slab when there
    are two): each row's best k is met twice and the first index wins, in the
    twin and in the kernel model."""
    a, base = (torch.as_tensor(x, dtype=torch.float32) for x in _ring_and_blob(4, 300, 150))
    b = torch.cat([base, base]).contiguous()
    mean = sinkhorn._blocked_mean_dist(a, b)
    want = sinkhorn._argmax_kernel_rows(a, b, mean, EPS)
    assert int(want.max()) < 150
    assert torch.equal(sinkhorn._match_fused(a, b, EPS), want)
    assert torch.equal(_kernel_model(a, b, mean, EPS, slabs), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_nan_coordinates_go_through_nan_to_num(dtype):
    """A NaN in b with a finite mean gives k = 0 for its column; a NaN in a
    makes the mean NaN, every k 0 and every index 0, as cmtci's matcher
    gives; the kernel model agrees with the twin on both."""
    dt = DTYPES[dtype]
    a, b = (torch.as_tensor(x, dtype=dt) for x in _ring_and_blob(5, 700, 600))
    b[3, 1] = math.nan
    mean = torch.tensor(1.25, dtype=dt)
    want = sinkhorn._argmax_kernel_rows(a, b, mean, EPS)
    assert not (want == 3).any()
    assert torch.equal(_kernel_model(a, b, mean, EPS, 2), want)

    a[5, 0] = math.nan
    got = sinkhorn._match_fused(a, b, EPS)
    assert torch.isnan(sinkhorn._blocked_mean_dist(a, b))
    assert not got.any()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_match_fused(a.numpy(), b.numpy(), EPS)))
    assert torch.equal(_kernel_model(a, b, sinkhorn._blocked_mean_dist(a, b), EPS, 3), got)


@pytest.mark.parametrize("n", TRACKER_SIZES)
def test_launch_plan_at_the_tracker_sizes(n):
    """Both passes' grid: tiles of 1,024 rows, slabs of at least MIN_SLAB
    columns that cover [0, m) in order, and at the three largest sizes at
    least 800 CTAs (six per SM of 132)."""
    plan = argmax_match.launch_plan(n, n)
    assert plan.tiles == -(-n // argmax_match.TILE)
    assert plan.ctas == plan.tiles * plan.slabs
    cols = [_slab(s, n, plan.slabs) for s in range(plan.slabs)]
    assert cols[0][0] == 0 and cols[-1][1] == n
    assert all(c1 == c0n for (_, c1), (c0n, _) in zip(cols, cols[1:]))
    assert min(c1 - c0 for c0, c1 in cols) >= argmax_match.MIN_SLAB
    if n >= 14820:
        assert plan.ctas >= 800


def test_launch_plan_small_and_ragged():
    """One slab below 2 * MIN_SLAB columns; the rows' last tile partial."""
    assert argmax_match.launch_plan(1, 1) == argmax_match.Plan(1, 1, 1)
    assert argmax_match.launch_plan(1025, 511) == argmax_match.Plan(2, 1, 2)
    plan = argmax_match.launch_plan(1025, 512)
    assert plan.slabs == 2 and plan.ctas == 4


@pytest.mark.parametrize("eps", [0.8, 0.13])
def test_inverse_eps_is_the_reciprocal_in_the_dtype(eps):
    """f32: 1 / float32(eps) rounded in f32 (at 0.13 not the f64 reciprocal's
    rounding); f64: 1 / eps."""
    inv = argmax_match.inverse_eps(eps, torch.float32)
    assert inv == float(np.float32(1) / np.float32(eps)) and float(np.float32(inv)) == inv
    if eps == 0.13:
        assert inv != float(np.float32(1.0 / eps))
    assert argmax_match.inverse_eps(eps, torch.float64) == 1.0 / eps


@pytest.mark.parametrize("case", ["dtype", "int", "shape", "flat", "strided", "mixed", "empty",
                                  "cpu"])
def test_wrapper_refuses(case):
    """ValueError on what the kernels do not take, and off a card."""
    a = torch.zeros((8, 2), dtype=torch.float32)
    b = torch.zeros((6, 2), dtype=torch.float32)
    bad = {"dtype": (a.half(), b.half()), "int": (a.int(), b.int()),
           "shape": (torch.zeros((8, 3)), torch.zeros((6, 3))),
           "flat": (torch.zeros(8), b), "strided": (torch.zeros((2, 8)).T, b),
           "mixed": (a, b.double()), "empty": (a[:0], b), "cpu": (a, b)}[case]
    with pytest.raises(ValueError):
        argmax_match.argmax_match(*bad, EPS)


def test_tracker_counts_no_card_match_on_the_cpu():
    """tracker.match_card counts matches made on the card: none on the CPU,
    and the matcher launched nothing."""
    before = dict(_launch.launches)
    timer = StageTimer("cpu")
    rows, _ = run_tracker(TrackerConfig(sigma_bins=3.0, t_fixed=2, bins_start=16,
                                        bins_max=16, mandelbrot_grid_start=96,
                                        construct_max_start=60,
                                        mandelbrot_samples_start=400),
                          timer=timer, device="cpu")
    assert len(rows) == 1 and "bins16_match" in timer.times
    assert "tracker.match_card" not in timer.counts
    assert _launch.launches["argmax_mean"] == before["argmax_mean"]
    assert _launch.launches["argmax_rows"] == before["argmax_rows"]


def _c_kinds(entry):
    src = CU.read_text()
    m = re.search(rf'extern "C" int {entry}_launch\(([^)]*)\)', src)
    assert m, entry
    kinds = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        kinds.append(ctypes.c_void_p if "*" in decl else
                     ctypes.c_double if decl.startswith("double") else ctypes.c_int)
    return kinds


@pytest.mark.parametrize("entry", ["argmax_mean", "argmax_rows"])
def test_launch_signature_and_constants_match_the_source(entry):
    """The ctypes argument lists are the .cu's, parameter for parameter, and
    THREADS and ROWS_PER_THREAD are the kernel's."""
    assert _c_kinds(entry) == _launch.ARGTYPES[entry]
    assert _launch.LIBRARY[entry] == "argmax_match"
    src = CU.read_text()
    assert f"kThreads = {argmax_match.THREADS};" in src
    assert f"kRowsPerThread = {argmax_match.ROWS_PER_THREAD};" in src
    assert "w.c0 = (int)((long long)w.slab * m / slabs);" in src  # _slab's cut
