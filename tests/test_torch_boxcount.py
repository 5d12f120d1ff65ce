"""cmtci_torch's box counts (kernels/boxcount.py: csrc/boxcount.cu's twin and
wrapper; stats/pointstats.fractal_dimension) against cmtci (the JAX
reference) on the CPU, on the same numpy clouds.

The kernel runs only on the card, where chip_smoke.py holds its counts and
bitmaps bitwise to the twin's. Here the twin's slope and log counts are held
bitwise to the reference's on clouds whose keys sit on box edges, the twin's
bitmaps to the reference's keys, the wrapper's refusals, the counter and the
C signature of the launch.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cmtci.stats import pointstats as ref_ps
from cmtci_torch.kernels import _launch, boxcount
from cmtci_torch.kernels import companion
from cmtci_torch.pipelines import analysis
from cmtci_torch.stats import pointstats as ps

CU = Path(boxcount.__file__).resolve().parents[1] / "csrc" / "boxcount.cu"
DEFAULT = np.logspace(-2, 0, 10, base=10.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the suite runs several pytest workers on
    the CPU at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lucas():
    """The Lucas construct at n = 2..60 (1,829 points; LAPACK's roots): its
    89 real roots have y = 0, which is a box edge at the finest scale."""
    z = companion.inverse_cloud(range(2, 61), "lucas_all_ones", backend="lapack", device="cpu")
    return np.column_stack([z.real, z.imag])


def _on_edges():
    """Points exactly on box edges, mins + k * step in f64, at every default
    scale and both axes, between two corners that fix mins and rng."""
    lo, hi = np.array([-0.7, 0.3]), np.array([1.1, 2.9])
    rng = hi - lo
    pts = [lo, hi]
    for s in DEFAULT:
        step = rng * s
        k = np.arange(int(np.floor(1 / s)) + 1)[:, None]
        pts.append(lo + k * step)
        pts.append(np.column_stack([lo[0] + k[:, 0] * step[0], hi[1] - k[:, 0] * step[1]]))
    return np.concatenate([np.atleast_2d(p) for p in pts])


def _random():
    return np.random.default_rng(5).normal(size=(3000, 2))


def _complex():
    g = np.random.default_rng(6)
    return g.uniform(-2, 1, 2500) + 1j * g.standard_cauchy(2500) * 0.1


CASES = {
    "random": (_random, None),
    "lucas_real_axis_on_an_edge": (_lucas, None),
    "points_on_box_edges": (_on_edges, None),
    "complex": (_complex, None),
    "scales_to_1e-3": (_random, np.logspace(-3, 0, 12, base=10.0)),
    "caller_scales": (_lucas, np.array([0.05, 0.1, 0.3, 1.0, 2.5])),
    "zero_extent_host_lines": (lambda: np.column_stack([np.linspace(0, 1, 400),
                                                        np.full(400, 0.25)]), None),
}


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
@pytest.mark.parametrize("case", list(CASES))
def test_fractal_dimension_bitwise_reference(case):
    make, scales = CASES[case]
    pts = make()
    slope, (lx, ly) = ps.fractal_dimension(pts, scales, device="cpu")
    rslope, (rlx, rly) = ref_ps.fractal_dimension(pts, scales)
    assert slope == rslope
    np.testing.assert_array_equal(lx, rlx)
    np.testing.assert_array_equal(ly, rly)


def test_the_lucas_case_sits_on_an_edge():
    """The case above is the one the benchmark fears: real roots whose key
    at the finest scale is a quotient that is exactly an integer > 0."""
    xy = _lucas()
    mins = xy.min(axis=0)
    q = (xy[:, 1] - mins[1]) / ((xy.max(axis=0) - mins)[1] * DEFAULT[0])
    assert np.sum((q == np.floor(q)) & (q > 0)) >= 80


def test_points_on_edges_sit_on_edges():
    """At every scale at least 20 coordinates' quotients are exact integers,
    and over the scales more than 100 round to within 1e-9 below one, where
    floor gives the box before the edge."""
    xy = _on_edges()
    mins = xy.min(axis=0)
    rng = xy.max(axis=0) - mins
    below = 0
    for s in DEFAULT:
        q = (xy - mins) / (rng * s)
        assert np.sum(q == np.floor(q)) >= 20
        below += np.sum((np.round(q) - q > 0) & (np.round(q) - q < 1e-9))
    assert below > 100


def _reference_keys(xy, mins, step):
    return np.unique(np.floor((xy - mins) / step).astype(np.int64), axis=0)


@pytest.mark.parametrize("case", ["random", "lucas_real_axis_on_an_edge", "points_on_box_edges"])
def test_twin_bitmaps_hold_the_reference_keys(case):
    """Each (cloud, scale) bitmap of the twin, in the kernel's layout (bit
    kx * W + ky from the scale's word offset), has a bit set exactly at the
    reference's unique keys, and its popcount is the count."""
    xy = CASES[case][0]()
    mins = xy.min(axis=0)
    rng = xy.max(axis=0) - mins
    widths = boxcount.box_layout(DEFAULT)
    counts, bitmaps = boxcount.box_counts([xy], [mins], [rng * DEFAULT[:, None]], widths,
                                          device="cpu")
    words = bitmaps.numpy().view(np.uint32)
    offsets = boxcount._offsets(widths)
    assert len(words) == offsets[-1]
    for k, (s, w) in enumerate(zip(DEFAULT, widths)):
        bits = np.unpackbits(words[offsets[k]:offsets[k + 1]].view(np.uint8), bitorder="little")
        keys = _reference_keys(xy, mins, rng * s)
        want = np.zeros_like(bits)
        want[keys[:, 0] * w + keys[:, 1]] = 1
        np.testing.assert_array_equal(bits, want)
        assert counts[0, k] == len(keys)


def test_several_clouds_in_one_call_equal_one_at_a_time():
    clouds = [_random(), _lucas(), _on_edges()]
    got = ps.fractal_dimensions(clouds, device="cpu")
    for pts, (slope, (lx, ly)) in zip(clouds, got):
        one, (olx, oly) = ps.fractal_dimension(pts, device="cpu")
        assert slope == one
        np.testing.assert_array_equal(ly, oly)
    widths = boxcount.box_layout(DEFAULT)
    mins = [c.min(axis=0) for c in clouds]
    steps = [(c.max(axis=0) - lo) * DEFAULT[:, None] for c, lo in zip(clouds, mins)]
    counts, bitmaps = boxcount.box_counts(clouds, mins, steps, widths, device="cpu")
    words = int(boxcount._offsets(widths)[-1])
    for i, c in enumerate(clouds):
        one, bits = boxcount.box_counts([c], [mins[i]], [steps[i]], widths, device="cpu")
        assert torch.equal(counts[i], one[0])
        assert torch.equal(bitmaps[i * words:(i + 1) * words], bits)


def test_layout_is_floor_of_inverse_scale_plus_two():
    np.testing.assert_array_equal(boxcount.box_layout([0.01, 0.5, 1.0, 3.0]), [102, 4, 3, 2])
    widths = boxcount.box_layout(DEFAULT)
    assert int(boxcount._offsets(widths)[-1]) == 518  # 2 KB a cloud


@pytest.mark.parametrize("scales", [[0.1, 0.0], [-0.5], [np.inf], [np.nan], []])
def test_layout_refuses_bad_scales(scales):
    with pytest.raises(ValueError, match="finite and positive"):
        boxcount.box_layout(scales)


def _args(xy):
    mins = xy.min(axis=0)
    return [xy], [mins], [(xy.max(axis=0) - mins) * DEFAULT[:, None]], boxcount.box_layout(DEFAULT)


@pytest.mark.parametrize("fault", ["narrow", "mins_above", "zero_step", "nan_point"])
def test_wrapper_refuses_a_key_outside_its_bitmap(fault):
    """A layout a key could overflow is refused, not clamped: bitmaps whose
    side is the largest key (one more just fits), mins above a point (a
    negative key), a zero step, a NaN coordinate."""
    xy = _random()
    xys, mins, steps, widths = _args(xy)
    if fault == "narrow":
        widths = np.floor((xy.max(axis=0) - mins[0]) / steps[0]).max(axis=1).astype(np.int64)
        boxcount.box_counts(xys, mins, steps, widths + 1, device="cpu")  # just fits
    elif fault == "mins_above":
        mins = [mins[0] + 1e-3]
    elif fault == "zero_step":
        steps[0][3, 1] = 0.0
    else:
        xys = [xy.copy()]
        xys[0][17, 0] = np.nan
    with pytest.raises(ValueError):
        boxcount.box_counts(xys, mins, steps, widths, device="cpu")


def test_wrapper_refuses_mismatched_shapes():
    xys, mins, steps, widths = _args(_random())
    with pytest.raises(ValueError, match="do not match"):
        boxcount.box_counts(xys, mins, steps, widths[:-1], device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        boxcount.box_counts([np.zeros((0, 2))], np.zeros((1, 2)), np.ones((1, 10, 2)), widths,
                            device="cpu")


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_counter_reads_the_kernel_counts_on_a_card(monkeypatch):
    """box_scales_card counts what the kernel keyed: nclouds x nscales on a
    card (the card stood in for by the twin), nothing on the CPU, nothing for
    a cloud of zero extent, which takes the host lines."""
    clouds = [_random(), _lucas(), np.column_stack([np.arange(9.0), np.ones(9)])]
    counts = {}

    def count(name, n):
        counts[name] = counts.get(name, 0) + n

    want = ps.fractal_dimensions(clouds, device="cpu", count=count)
    assert counts == {}
    card = torch.device("cuda", 0)
    real = boxcount.box_counts
    monkeypatch.setattr(ps, "resolve_device", lambda device: card)
    monkeypatch.setattr(boxcount, "box_counts", lambda *a, device: real(*a, device="cpu"))
    got = ps.fractal_dimensions(clouds, device="cuda", count=count)
    assert counts == {"spatial_stats.box_scales_card": 2 * len(DEFAULT)}
    assert [g[0] for g in got] == [w[0] for w in want]
    ps.fractal_dimension(clouds[0], device="cuda", count=count)
    assert counts == {"spatial_stats.box_scales_card": 3 * len(DEFAULT)}


def test_run_spatial_stats_on_the_cpu_counts_no_card_boxes():
    g = np.random.default_rng(8)
    c, m = g.normal(size=(200, 2)), g.normal(size=(150, 2))
    out = analysis.run_spatial_stats(c, m, r_max=0.8, dr=0.1, plots=False, device="cpu")
    assert "spatial_stats.box_scales_card" not in out["counts"]
    assert out["fractal_dim_construct"] == ref_ps.fractal_dimension(c)[0]
    assert out["fractal_dim_mandel"] == ref_ps.fractal_dimension(m)[0]


def test_launch_signature_and_constants_match_the_source():
    """boxcount's ctypes argument list is boxcount_launch's in the .cu,
    parameter for parameter, and POINTS_PER_CTA is the kernel's."""
    src = CU.read_text()
    m = re.search(r'extern "C" int boxcount_launch\(([^)]*)\)', src)
    assert m
    kinds = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        kinds.append(ctypes.c_void_p if "*" in decl else
                     ctypes.c_longlong if decl.startswith("long long") else ctypes.c_int)
    assert kinds == _launch.ARGTYPES["boxcount"]
    assert f"kPointsPerCta = {boxcount.POINTS_PER_CTA};" in src
    assert _launch.launches["boxcount"] == 0  # the CPU runs the twin
