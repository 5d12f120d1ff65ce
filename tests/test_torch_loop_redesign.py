"""The two hand kernels redesigned after their first port, on the CPU.

csrc/aberth.cu splits a polynomial with more lanes than a CTA has threads
over a thread block cluster, from a launch plan the wrapper caches;
csrc/orbit.cu's orbit_green runs the f64 equipotential's whole budget in one
launch (green_potential_compacted with one stage). The kernels run only on
the card (chip_smoke.py phase 23). Here:
  (a) the cached plan is the plan built anew, tensor for tensor, and a
      launch's in-place update of its buffers never reaches the cache;
  (b) the cluster's task table covers every lane of every polynomial once,
      within the kernel's 32 lanes a thread, and the shared-memory refusal
      names the largest degree the layout takes;
  (c) the Green potential in one stage is bitwise the staged loop's records
      and within the compacted contract of cmtci's; batch_potential asks for
      one stage only on a card without a mesh.
"""

import numpy as np
import pytest
import torch

from cmtci.kernels import mandelbrot as ref_mb
from cmtci_torch.kernels import _launch, companion
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.pipelines import equipotential as eq

CPU = torch.device("cpu")
#: the tracker's four clouds and the equipotential's and stage1's degrees
PLANS = [("lucas_all_ones", list(range(20, top + 1, 20))) for top in (300, 1220)] + [
    (f, list(range(2, 201))) for f in companion.FAMILIES] + [
    ("lucas_all_ones", list(range(2, 41))), ("sparser_gap_1_0_1_then_ones", list(range(1, 101)))]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


# ---------------------------------------------------------------------------
# (a) the cached plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,ns", PLANS)
@pytest.mark.parametrize("bucketed", [True, False])
def test_cached_plan_is_the_plan_built_anew(family, ns, bucketed):
    companion._CACHE.clear()
    first = companion._one_launch_plan(ns, family, bucketed, CPU)
    again = companion._one_launch_plan(list(ns), family, bucketed, CPU)
    assert all(x is y for x, y in zip(first, again))
    assert _same(first, companion._build_plan(ns, family, bucketed, CPU))


def test_a_launch_never_writes_into_the_cache():
    """_aberth_prepare hands the launch clones of the plan's start roots;
    writing into the launch's buffers, as the kernel does, and into the
    valid mask eigvals_one_launch returns leaves the next plan unchanged."""
    ns, fam = list(range(20, 301, 20)), "lucas_all_ones"
    companion._CACHE.clear()
    fresh = companion._build_plan(ns, fam, True, CPU)
    plan = companion._one_launch_plan(ns, fam, True, CPU)
    zr, zi, steps, go = companion._aberth_prepare(*plan[:6], fam, 200, 1e-13, torch.float32)
    assert go is not None
    zr.fill_(3.0)
    zi.mul_(-1.0)
    steps.fill_(7)
    original = companion._aberth_cuda
    companion._aberth_cuda = lambda a, deg, ns, z, *rest: (z[0].clone(), z[1].clone(),
                                                           torch.zeros(len(ns)))
    try:
        _, _, valid = companion.eigvals_one_launch(ns, fam, device="cpu")
    finally:
        companion._aberth_cuda = original
    valid.fill_(False)
    assert _same(companion._one_launch_plan(ns, fam, True, CPU), fresh)


def test_cache_is_bounded():
    companion._CACHE.clear()
    for n in range(2, 2 + companion._CACHE_SIZE + 10):
        companion._one_launch_plan([n], "lucas_all_ones", False, CPU)
    assert len(companion._CACHE) == companion._CACHE_SIZE
    assert ("plan", (2,), "lucas_all_ones", False, "cpu") not in companion._CACHE


# ---------------------------------------------------------------------------
# (b) the cluster's tasks and shared memory
# ---------------------------------------------------------------------------


def _lanes_of(task, ns, threads):
    """The lanes each CTA of the task table updates, as aberth.cu computes
    them: rank r of a cluster's `parts` CTAs takes [r s, (r + 1) s) with s =
    ceil(n / parts), thread t the lanes lo + t + m threads."""
    out = {}
    for cta, (b, parts) in enumerate(task.tolist()):
        if b < 0:
            continue
        n = ns[b]
        span = -(-n // parts)
        rank = cta % parts if parts > 1 else 0
        lo = min(n, rank * span)
        hi = min(n, lo + span)
        assert -(-(hi - lo) // threads) <= 32
        out.setdefault(b, []).extend(range(lo, hi))
    return out


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("threads", [64, 128, 256])
@pytest.mark.parametrize("ns", [list(range(20, 1221, 20)), list(range(2, 201)), [7],
                                [300, 5, 900, 257, 256]])
def test_tasks_cover_every_lane_once(ns, threads, cluster):
    task = companion.aberth_tasks(ns, threads, cluster)
    assert task.dtype == np.int32 and task.shape[1] == 2 and len(task) % cluster == 0
    for c0 in range(0, len(task), cluster):
        group = task[c0:c0 + cluster]
        parts = set(group[:, 1].tolist())
        assert len(parts) == 1  # a cluster shares one polynomial or none
        if parts == {cluster} and cluster > 1:
            assert len(set(group[:, 0].tolist())) == 1
    lanes = _lanes_of(task, ns, threads)
    assert sorted(lanes) == list(range(len(ns)))
    for b, got in lanes.items():
        assert sorted(got) == list(range(ns[b]))
    split = [b for b in range(len(ns)) if ns[b] > threads and cluster > 1]
    assert sorted({b for b, p in task.tolist() if p > 1}) == split


def test_shared_memory_per_cta_of_the_cluster_layout():
    """A CTA holds two copies of the roots the repulsion reads, 16 B a lane
    it owns, the votes and a Horner row's coefficients."""
    ns = list(range(20, 1221, 20))
    assert companion.aberth_smem_bytes(ns, ns, [True] * len(ns), False) == (
        64 + 2 * 8 * 1220 + 16 * 153)
    assert companion.aberth_smem_bytes([200], [200], [False], True, cluster=8) == (
        64 + 2 * 16 * 200 + 16 * 200 + 8 * 201)
    assert companion.aberth_smem_bytes([1220], [1220], [True], False, cluster=1) == (
        16 + 16 * 1220 + 16 * 1220)
    assert companion.aberth_smem_bytes([1220], [1220], [True], False, cluster=16) == (
        128 + 16 * 1220 + 16 * 77)


@pytest.mark.parametrize("f64_repulsion", [False, True])
@pytest.mark.parametrize("cluster", [1, 8, 16])
def test_largest_degree_fits_and_the_next_is_refused(f64_repulsion, cluster):
    limit = companion.aberth_max_degree(f64_repulsion, cluster=cluster)
    fits = companion.aberth_smem_bytes([limit], [limit], [False], f64_repulsion,
                                       cluster=cluster)
    over = companion.aberth_smem_bytes([limit + 1], [limit + 1], [False], f64_repulsion,
                                       cluster=cluster)
    assert fits <= companion.ABERTH_SMEM_MAX < over


def test_bad_launch_shapes_are_refused():
    """aberth_launch_shape refuses a build the kernel cannot run: a cluster
    outside 1..16, threads outside a warp..1024, more than 32 lanes a
    thread; the committed build's shape fits a warp to 256 threads."""
    for kw in (dict(cluster=0), dict(cluster=17), dict(threads=2048), dict(threads=16)):
        with pytest.raises(ValueError, match="cluster"):
            companion.aberth_launch_shape([40], **kw)
    with pytest.raises(ValueError, match="32 a thread"):
        companion.aberth_launch_shape([1220], threads=32, cluster=1)
    assert companion.aberth_launch_shape([40])[1] == 64
    assert companion.aberth_launch_shape([5])[1] == 32
    task, block = companion.aberth_launch_shape(list(range(20, 1221, 20)))
    assert block == companion.ABERTH_THREADS and len(task) % companion.ABERTH_CLUSTER == 0


# ---------------------------------------------------------------------------
# (c) the one-launch Green potential
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def green_points():
    rng = np.random.default_rng(14)
    return rng.uniform(-2.1, 1.0, 2000) + 1j * rng.uniform(-1.6, 1.6, 2000)


@pytest.fixture(scope="module")
def green_runs(green_points):
    one = mb.green_potential_compacted(green_points, max_iter=2000, stage_iters=2000,
                                       device="cpu")
    staged = mb.green_potential_compacted(green_points, max_iter=2000, stage_iters=64,
                                          device="cpu")
    return one, staged


def test_one_launch_is_the_compacted_loop_bitwise(green_runs):
    (g, k, phi), (gs, ks, phis) = green_runs
    assert g.dtype == gs.dtype and k.dtype == ks.dtype == np.int32 and phi.dtype == phis.dtype
    np.testing.assert_array_equal(g, gs)
    np.testing.assert_array_equal(k, ks)
    np.testing.assert_array_equal(phi, phis)  # NaN equal to NaN
    assert 0 < (k < 2000).sum() < len(k) and (g[k == 2000] == 0).all()
    assert np.isnan(phi[k == 2000]).all()


@pytest.mark.parametrize("run", [0, 1])
def test_one_launch_and_compacted_against_cmtci(green_points, green_runs, run):
    """Both within the compacted contract of tests/test_torch_equipotential.py
    against cmtci's green_potential_compacted: XLA contracts FMAs in the f64
    orbit, so k agrees on >= 99.9% of the points and g within rel 1e-9 on
    >= 98% of those (the rest escape late, where the chaotic orbit
    amplifies the contraction)."""
    g, k, phi = green_runs[run]
    g_ref, k_ref, phi_ref = (np.asarray(v) for v in ref_mb.green_potential_compacted(
        green_points, max_iter=2000, stage_iters=64))
    assert (k == k_ref).mean() >= 0.999
    m = (k == k_ref) & (g_ref > 0)
    assert (np.abs(g[m] - g_ref[m]) <= 1e-9 * g_ref[m]).mean() >= 0.98
    np.testing.assert_array_equal(np.isnan(phi), np.isnan(phi_ref))


def test_one_launch_of_nothing_and_of_no_steps():
    for pts, it in ((np.zeros(0, complex), 50), (np.array([0.3 + 0.1j, 2.5 + 0j]), 0)):
        got = mb.green_potential_compacted(pts, max_iter=it, stage_iters=max(it, 1),
                                           device="cpu")
        want = mb.green_potential_compacted(pts, max_iter=it, device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_one_launch_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mb.green_potential_compacted(np.array([0.3 + 0.1j]), max_iter=5, stage_iters=5,
                                     device="cuda")


@pytest.fixture
def calls(monkeypatch):
    """The stages of the f64 potential batch_potential runs (the budget a
    stage, None for the default), with its device and whether a stage
    executor shards it."""
    seen = []

    def record(cloud, max_iter, escape_r, device="cuda", stage_executor=None, **kw):
        seen.append((kw.get("stage_iters"), str(device), stage_executor is not None))
        n = len(cloud)
        return np.zeros(n), np.full(n, max_iter, np.int32), np.full(n, np.nan + 0j)

    monkeypatch.setattr(mb, "green_potential_compacted", record)
    return seen


def test_batch_potential_takes_one_launch_on_a_card(calls, monkeypatch):
    monkeypatch.setattr(eq, "resolve_device", lambda d: torch.device("cuda", 0))
    eq.batch_potential(np.array([0.3 + 0.1j]), 50, 2.0, device="cuda")
    assert calls == [(50, "cuda", False)]


def test_batch_potential_keeps_the_compacted_loop_on_the_cpu(calls):
    eq.batch_potential(np.array([0.3 + 0.1j]), 50, 2.0, device="cpu")
    assert calls == [(None, "cpu", False)]


def test_batch_potential_keeps_the_staged_executor_on_a_mesh(calls):
    class Mesh:
        device = torch.device("cpu")
        rank = 0

    eq.batch_potential(np.array([0.3 + 0.1j]), 50, 2.0, device="cuda", mesh=Mesh())
    assert calls == [(None, "cpu", True)]


def test_batch_potential_on_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        eq.batch_potential(np.array([0.3 + 0.1j]), 50, 2.0, device="cuda")


def test_sweep_variants_of_the_two_kernels():
    """The constants of orbit_green's and aberth.cu's schedules are in the
    sources, and the package's ABERTH_CLUSTER and ABERTH_THREADS are
    aberth.cu's CLUSTER and MAX_THREADS."""
    import re
    from pathlib import Path

    csrc = Path(companion.__file__).parents[1] / "csrc"
    text = (csrc / "orbit.cu").read_text()
    have = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert have["GREEN_CHUNK"] >= 1 and have["GREEN_EPOCH"] >= 1
    assert "GREEN_REFILL" not in text
    text = (csrc / "aberth.cu").read_text()
    have = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert have["REP_UNROLL"] >= 1
    assert (have["CLUSTER"], have["MAX_THREADS"]) == (companion.ABERTH_CLUSTER,
                                                      companion.ABERTH_THREADS)


def test_cpu_runs_launch_nothing(green_points):
    _launch.reset_launches()
    mb.green_potential_compacted(green_points[:50], max_iter=100, stage_iters=100,
                                 device="cpu")
    companion.inverse_cloud_padded(list(range(2, 30)), device="cpu")
    assert sum(_launch.launches.values()) == 0
