"""cmtci_torch's shell counts (kernels/shellcount.py: csrc/shellcount.cu's
twin, wrapper and launch plan; stats/pointstats._pair_hist) on the CPU.

The kernel runs only on the card, where chip_smoke.py holds its int64 shells
bitwise to the twin's. Here: the thresholds tau[k] that replace the kernel's
square root, against bucketize(sqrt(s)) on every value near each of them; a
numpy model of the kernel's loop (its units, masks, estimate and the bound
pair that settles it) against the twin on ragged sizes and row ranges;
the wrapper's refusals; _pair_hist's dispatch to the twin on a CPU tensor
with today's counts and distances; the counter; the C signature.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cmtci_torch.kernels import _launch, shellcount
from cmtci_torch.parallel.sharded import _share
from cmtci_torch.pipelines import analysis
from cmtci_torch.stats import pointstats as ps

CU = Path(shellcount.__file__).resolve().parents[1] / "csrc" / "shellcount.cu"
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
#: (r_max, dr): the pair cell's shells and chip_smoke's
SHELLS = {"cell": (1.5, 0.05), "smoke": (0.5, 0.02)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers on
    the CPU at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(r_max, dr, tdtype):
    """The edges as _shell_counts makes them."""
    r_vals = np.arange(0, r_max, dr)
    return torch.as_tensor(np.concatenate([r_vals, [r_vals[-1] + dr]]), dtype=tdtype)


@pytest.mark.parametrize("shells", list(SHELLS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_thresholds_equal_bucketize_of_the_root_near_every_edge(dtype, shells):
    """For every value s within 4,096 ulps of each tau[k] (s >= 0), the number
    of tau <= s is bucketize(sqrt(s), edges, right=True); and tau[k] is the
    least such value: one ulp below it the root falls short of edges[k]."""
    ndt, tdt = DTYPES[dtype]
    edges = _edges(*SHELLS[shells], tdt)
    e = edges.numpy()
    tau = shellcount.thresholds(e)
    assert tau.dtype == ndt and len(tau) == len(e)
    ut = np.uint32 if ndt == np.float32 else np.uint64
    near = (tau.view(ut).astype(np.int64)[:, None] + np.arange(-4096, 4097)[None]).ravel()
    s = np.unique(near[near >= 0]).astype(ut).view(ndt)
    want = torch.bucketize(torch.sqrt(torch.as_tensor(s)), edges, right=True).numpy()
    got = np.searchsorted(tau, s, side="right")
    np.testing.assert_array_equal(got, want)
    assert np.all(np.sqrt(tau) >= e)
    below = (tau.view(ut)[1:] - ut(1)).view(ndt)  # tau[0] is 0 for the edge 0
    assert tau[0] == 0 and np.all(np.sqrt(below) < e[1:])


def test_thresholds_of_edges_at_or_below_zero_are_zero_and_of_odd_edges_exact():
    e = np.array([-1.0, 0.0, 1e-300, 0.3, 2.0, 1e300])
    tau = shellcount.thresholds(e)
    assert tau[0] == 0.0 and tau[1] == 0.0
    assert np.all(np.sqrt(tau) >= e)
    prev = np.nextafter(tau[2:], -np.inf)
    assert np.all(np.sqrt(prev) < e[2:])
    with pytest.raises(ValueError, match="finite"):
        shellcount.thresholds(np.array([0.0, np.inf]))
    with pytest.raises(ValueError, match="float32 or float64"):
        shellcount.thresholds(np.array([0, 1], dtype=np.int64))


def _kernel_model(xy, e, nbins, lo, hi, tile, cols, estimate=None):
    """The counts and distances of shellcount.cu's loop, in numpy: the units
    of launch_plan (tile rows against `cols` columns from the tile's first
    row), d^2 in the dtype, the estimate in f32 (`estimate` replaces it), its
    bounds (tau[g - 1], tau[g]) and the walks down and up that settle it,
    slot 0 for the masked pairs of the units that mask, shells 1..nbins."""
    dt = xy.dtype
    tau = shellcount.thresholds(e)
    lower = np.concatenate([[-np.inf], tau]).astype(dt)
    upper = np.concatenate([tau, [np.inf]]).astype(dt)
    n, nedges = len(xy), nbins + 1
    span = float(e[-1]) - float(e[0])
    e0, inv = np.float32(e[0]), np.float32(nbins / span if span > 0 else 0.0)
    counts, distances, units = np.zeros(nbins, np.int64), 0, 0
    for i0 in range(lo, hi, tile):
        row_end = min(i0 + tile, hi)
        rows = np.arange(i0, i0 + tile)
        inside = rows < row_end
        p = np.where(inside[:, None], xy[np.minimum(rows, n - 1)], dt.type(0))
        first = np.where(inside, rows, np.iinfo(np.int64).max)
        for c0 in range(i0, n, cols):
            c1, units = min(c0 + cols, n), units + 1
            distances += (row_end - i0) * (c1 - c0)
            with np.errstate(all="ignore"):
                dx = p[:, 0, None] - xy[None, c0:c1, 0]
                dy = p[:, 1, None] - xy[None, c0:c1, 1]
                s = dx * dx + dy * dy
                if estimate is None:
                    sf = s.astype(np.float32)
                    d = sf * (np.float32(1) / np.sqrt(sf))
                    x = np.fmin(np.fmax(d * inv + (np.float32(0.5) - e0 * inv), 0), nedges)
                    g = np.rint(x).astype(np.int64)
                else:
                    g = estimate(s.shape)
                while np.any(down := (g > 0) & ~(lower[g] <= s)):
                    g -= down
                while np.any(up := (g < nedges) & ~(s < upper[g])):
                    g += up
            if c0 < row_end or row_end - i0 < tile:
                g = np.where(np.arange(c0, c1)[None] > first[:, None], g, 0)
            counts += np.bincount(g.ravel(), minlength=nedges + 1)[1:nedges]
    return counts, distances, units


def _cloud(n, seed=3):
    g = np.random.default_rng(seed)
    return np.column_stack([g.uniform(-0.9, 0.9, n), g.normal(0, 0.5, n)])


def _twin(xy, edges, nbins, rows, chunk=1024):
    got = {}

    def count(name, k):
        got[name] = got.get(name, 0) + k

    counts = shellcount.shell_counts_torch(torch.as_tensor(xy), edges, nbins, chunk, rows, count)
    return counts.numpy(), got["spatial_stats.distances"]


#: (points, rows, tile, cols): below one tile; ragged tiles and units; the
#: row ranges of 2 and 4 ranks (sharded_shell_counts' shares of 64)
RAGGED = {
    "below_one_tile": (37, None, 64, 16),
    "ragged_tiles_and_units": (613, None, 40, 24),
    "cols_below_tile": (300, None, 64, 24),
    "two_ranks_0": (613, (2, 0), 40, 24),
    "two_ranks_1": (613, (2, 1), 40, 24),
    "four_ranks_3": (613, (4, 3), 40, 24),
    "plan_shapes": (2500, None, 1024, 2048),
}


def _rows(n, spec):
    if spec is None:
        return 0, n
    size, rank = spec
    mesh = type("M", (), {"size": size, "rank": rank})()
    lo, hi, _ = _share(n, mesh, 64)
    return lo, hi


@pytest.mark.parametrize("case", list(RAGGED))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_model_equals_the_twin_on_ragged_sizes_and_row_ranges(dtype, case):
    ndt, tdt = DTYPES[dtype]
    n, spec, tile, cols = RAGGED[case]
    xy = _cloud(n).astype(ndt)
    lo, hi = _rows(n, spec)
    edges = _edges(0.5, 0.02, tdt)
    nbins = len(edges) - 1
    got, distances, units = _kernel_model(xy, edges.numpy(), nbins, lo, hi, tile, cols)
    want, _ = _twin(xy, edges, nbins, (lo, hi))
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    plan = shellcount.launch_plan(n, (lo, hi), nbins, cols)
    if tile == plan.tile:
        assert (plan.ctas, plan.distances) == (units, distances)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_model_is_exact_from_any_estimate_and_on_uneven_edges(dtype):
    """The walks down and up from the bound pair make the count exact whatever the
    estimate gives (here a random slot), on uneven edges with a repeated one,
    and on pairs exactly at each edge's distance: (0, 0) and (edges[k], 0)."""
    ndt, tdt = DTYPES[dtype]
    edges = torch.as_tensor([0.0, 0.013, 0.05, 0.05, 0.21, 0.4, 0.9], dtype=tdt)
    nbins = len(edges) - 1
    on = np.column_stack([np.concatenate([[0.0], edges.numpy()]), np.zeros(len(edges) + 1)])
    xy = np.concatenate([on, _cloud(200)]).astype(ndt)
    rng = np.random.default_rng(9)
    got, _, _ = _kernel_model(xy, edges.numpy(), nbins, 0, len(xy), 32, 48,
                              estimate=lambda shape: rng.integers(0, nbins + 2, shape))
    want, _ = _twin(xy, edges, nbins, (0, len(xy)))
    np.testing.assert_array_equal(got, want)
    at_edges, _ = _twin(on.astype(ndt), edges, nbins, (0, len(on)))
    model, _, _ = _kernel_model(on.astype(ndt), edges.numpy(), nbins, 0, len(on), 4, 4)
    np.testing.assert_array_equal(model, at_edges)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_model_counts_nan_inf_and_coincident_points_as_the_twin(dtype):
    """A NaN or infinite coordinate gives a d^2 that counts nowhere (the
    chain's bucketize puts it past the last edge), and coincident points
    (d^2 = 0, whose approximate root is NaN) count in the first shell."""
    ndt, tdt = DTYPES[dtype]
    xy = _cloud(120)
    xy[[5, 60]] = xy[[7, 61]]
    xy[17, 0], xy[33, 1], xy[90, 0] = np.nan, np.inf, -np.inf
    xy = xy.astype(ndt)
    edges = _edges(0.5, 0.02, tdt)
    nbins = len(edges) - 1
    got, _, _ = _kernel_model(xy, edges.numpy(), nbins, 0, len(xy), 16, 24)
    want, _ = _twin(xy, edges, nbins, (0, len(xy)))
    np.testing.assert_array_equal(got, want)
    assert want[0] >= 2


def test_plan_distances_equal_the_twins_at_a_1024_row_tile():
    """At 256 threads (up to 62 shells) a tile is 1,024 rows, the twin's
    block, so the launch computes the distances the twin's blocks do."""
    edges = _edges(1.5, 0.05, torch.float32)
    nbins = len(edges) - 1
    for n, rows in ((3000, None), (2900, (1024, 2900)), (5000, (17, 4100))):
        lo, hi = rows or (0, n)
        plan = shellcount.launch_plan(n, (lo, hi), nbins)
        assert plan.threads == 256 and plan.tile == 1024
        _, want = _twin(_cloud(n).astype(np.float32), edges, nbins, (lo, hi))
        assert plan.distances == want
    assert shellcount.launch_plan(149_877, (0, 149_877), nbins).distances == sum(
        min(1024, 149_877 - i) * (149_877 - i) for i in range(0, 149_877, 1024))


def test_plan_takes_fewer_threads_for_more_shells_and_refuses_what_cannot_fit():
    assert shellcount.launch_plan(100, (0, 100), 62).threads == 256
    assert shellcount.launch_plan(100, (0, 100), 126).threads == 256
    assert shellcount.launch_plan(100, (0, 100), 200).threads == 160
    assert shellcount.launch_plan(100, (0, 100), 1022).threads == 32
    with pytest.raises(ValueError, match="shells"):
        shellcount.launch_plan(100, (0, 100), 1023)
    with pytest.raises(ValueError, match="shells"):
        shellcount.launch_plan(100, (0, 100), 0)
    # a CTA of 1,024 rows x 2**21 columns could count 2**31 pairs
    shellcount.launch_plan(100, (0, 100), 30, cols=2**21 - 1)
    with pytest.raises(ValueError, match="32-bit counters"):
        shellcount.launch_plan(100, (0, 100), 30, cols=2**21)
    empty = shellcount.launch_plan(100, (100, 100), 30)
    assert (empty.ctas, empty.distances) == (0, 0)


def _good():
    return torch.as_tensor(_cloud(50)), _edges(0.5, 0.05, torch.float64)


@pytest.mark.parametrize("fault", ["int_dtype", "half_dtype", "three_columns", "flat",
                                   "non_contiguous", "edges_descending", "edges_nan",
                                   "edges_length", "edges_dtype", "rows_past_n",
                                   "rows_reversed"])
def test_wrapper_refuses(fault):
    xy, edges = _good()
    nbins, rows = len(edges) - 1, None
    if fault == "int_dtype":
        xy = xy.to(torch.int64)
    elif fault == "half_dtype":
        xy, edges = xy.half(), edges.half()
    elif fault == "three_columns":
        xy = torch.cat([xy, xy[:, :1]], 1)
    elif fault == "flat":
        xy = xy.reshape(-1)
    elif fault == "non_contiguous":
        xy = xy.t().contiguous().t()
    elif fault == "edges_descending":
        edges = edges.flip(0)
    elif fault == "edges_nan":
        edges[3] = float("nan")
    elif fault == "edges_length":
        nbins += 1
    elif fault == "edges_dtype":
        edges = edges.float()
    elif fault == "rows_past_n":
        rows = (0, 51)
    else:
        rows = (20, 10)
    with pytest.raises(ValueError):
        shellcount.shell_counts(xy, edges, nbins, rows=rows)


def test_pair_hist_on_a_cpu_tensor_runs_the_twin_with_todays_counts_and_distances():
    """The blocked chain's counts (every pair j > i of an f64 cloud, binned
    by numpy on the same arithmetic) and its distances (rows x remaining
    columns of each 1,024-row block), and no kernel launch."""
    xy = _cloud(2500)
    edges = _edges(1.5, 0.05, torch.float64)
    nbins = len(edges) - 1
    seen = {}
    before = _launch.launches["shellcount"]
    got = ps._pair_hist(torch.as_tensor(xy), edges, nbins,
                        count=lambda name, k: seen.__setitem__(name, seen.get(name, 0) + k))
    i, j = np.triu_indices(len(xy), 1)
    dx, dy = xy[i, 0] - xy[j, 0], xy[i, 1] - xy[j, 1]
    b = np.searchsorted(edges.numpy(), np.sqrt(dx * dx + dy * dy), side="right") - 1
    want = np.bincount(b[(b >= 0) & (b < nbins)], minlength=nbins)
    np.testing.assert_array_equal(got.numpy(), want)
    assert seen == {"spatial_stats.distances": sum(min(1024, 2500 - i) * (2500 - i)
                                                   for i in range(0, 2500, 1024))}
    assert _launch.launches["shellcount"] == before


def test_run_spatial_stats_on_the_cpu_counts_no_card_scans():
    g = np.random.default_rng(8)
    c, m = g.normal(size=(300, 2)), g.normal(size=(250, 2))
    out = analysis.run_spatial_stats(c, m, r_max=0.8, dr=0.1, plots=False, device="cpu")
    assert "spatial_stats.shell_scans_card" not in out["counts"]
    assert out["counts"]["spatial_stats.distances"] == 300 * 300 + 250 * 250  # one block each


def test_launch_signature_and_constants_match_the_source():
    """shellcount's ctypes argument list is shellcount_launch's in the .cu,
    parameter for parameter, and ROWS_PER_THREAD is the kernel's."""
    src = CU.read_text()
    m = re.search(r'extern "C" int shellcount_launch\(([^)]*)\)', src)
    assert m
    kinds = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        kinds.append(ctypes.c_void_p if "*" in decl else
                     ctypes.c_float if decl.startswith("float") else ctypes.c_int)
    assert kinds == _launch.ARGTYPES["shellcount"]
    assert f"kRowsPerThread = {shellcount.ROWS_PER_THREAD};" in src
    assert "__launch_bounds__(256)" in src and shellcount.THREADS == 256
