"""cmtci_torch's pair statistics and kNN kernel against cmtci (the JAX
reference) on the CPU, on the same numpy clouds.

Pair counts are integers and must be equal in f64. In f32 a pair whose
distance sits within an f32 rounding of a shell edge may land one shell over,
in the port as in the reference; the clouds here have none (checked), so the
f32 counts are held equal too. The kNN neighbour sets must be identical, and
sigma agrees to rel 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.distance import pdist

from cmtci.stats import embeddings as ref_em
from cmtci.stats import pointstats as ref_ps
from cmtci_torch.stats import embeddings as em
from cmtci_torch.stats import pointstats as ps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    """The bench's noisy circle, small (bench.py:411-415)."""
    rng = np.random.default_rng(1)
    t = rng.uniform(0, 2 * np.pi, 1500)
    r = 1.0 + 0.05 * rng.standard_normal(1500)
    return np.column_stack([r * np.cos(t), r * np.sin(t)])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_shell_counts_vs_reference(cloud, dtype):
    t_dt = torch.float64 if dtype == "float64" else torch.float32
    j_dt = None if dtype == "float64" else jnp.float32
    r, counts, n, rho = ps._shell_counts(cloud, 0.5, 0.02, dtype=t_dt, device="cpu")
    rr, rcounts, rn, rrho = ref_ps._shell_counts(cloud, 0.5, 0.02, dtype=j_dt)
    np.testing.assert_array_equal(r, rr)
    assert (n, rho) == (rn, rrho) and counts.dtype == np.float64
    np.testing.assert_array_equal(counts, rcounts)
    assert counts.sum() > 10000


def test_pair_hist_equals_scipy_histogram_and_blocks_do_not_matter(cloud):
    edges = np.concatenate([np.arange(0, 0.5, 0.02), [0.5]])
    want = np.histogram(pdist(cloud), edges)[0]
    xy = torch.as_tensor(cloud)
    for chunk in (1024, 97, 4000):
        got = ps._pair_hist(xy, torch.as_tensor(edges), len(edges) - 1, chunk=chunk)
        assert got.dtype == torch.int64
        # np.histogram closes the last bin on the right; no pair sits there
        np.testing.assert_array_equal(got.numpy(), want)


def test_pair_hist_complex_input_and_edge_semantics():
    pts = np.array([0.0, 1.0, 2.0 + 0j, 2.0 + 1j])  # distances 1, 2, sqrt5, 1, sqrt2, 1
    r, counts, n, rho = ps._shell_counts(pts, 2.5, 1.0, device="cpu")
    # shells [0,1), [1,2), [2,3): a distance on an edge opens the shell above
    assert r.tolist() == [0.0, 1.0, 2.0] and counts.tolist() == [0.0, 4.0, 2.0]
    assert n == 4 and rho == 4 / 2.0


def test_pair_correlation_and_ripley_k_vs_reference(cloud):
    r, g = ps.pair_correlation(cloud, 0.5, 0.02, device="cpu")
    rr, rg = ref_ps.pair_correlation(cloud, 0.5, 0.02)
    np.testing.assert_array_equal(r, rr)
    np.testing.assert_allclose(g, rg, rtol=1e-14)
    assert g[0] == 0.0 and g[1:].min() > 0
    r, k = ps.ripley_k(cloud, 0.5, 0.02, device="cpu")
    _, rk = ref_ps.ripley_k(cloud, 0.5, 0.02)
    np.testing.assert_allclose(k, rk, rtol=1e-14)
    # one scan shared by both, as the reference's callers do
    shells = ps._shell_counts(cloud, 0.5, 0.02, device="cpu")
    np.testing.assert_array_equal(ps.pair_correlation(cloud, 0.5, 0.02, _shells=shells)[1], g)
    np.testing.assert_array_equal(ps.ripley_k(cloud, 0.5, 0.02, _shells=shells)[1], k)


def test_fractal_dimension_equals_reference(cloud):
    slope, (lx, ly) = ps.fractal_dimension(cloud, device="cpu")
    rslope, (rlx, rly) = ref_ps.fractal_dimension(cloud)
    assert slope == rslope and 0.8 < slope < 2.0
    np.testing.assert_array_equal(lx, rlx)
    np.testing.assert_array_equal(ly, rly)
    z = cloud[:, 0] + 1j * cloud[:, 1]
    assert ps.fractal_dimension(z, np.array([0.1, 0.3, 1.0]), device="cpu")[0] == \
        ref_ps.fractal_dimension(z, np.array([0.1, 0.3, 1.0]))[0]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hausdorff_vs_reference(cloud, dtype):
    rng = np.random.default_rng(2)
    other = cloud[::-1][:1100] + 0.01 * rng.standard_normal((1100, 2))
    t_dt = torch.float64 if dtype == "float64" else torch.float32
    got = ps.hausdorff(cloud, other, dtype=t_dt, device="cpu")
    want = ref_ps.hausdorff(cloud, other, dtype=None if dtype == "float64" else jnp.float32)
    assert got == pytest.approx(want, rel=1e-12 if dtype == "float64" else 1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_build_sparse_kernel_vs_reference(cloud, dtype):
    t_dt = torch.float64 if dtype == "float64" else torch.float32
    kmat, sigma = em.build_sparse_kernel(cloud, k=20, dtype=t_dt, device="cpu")
    rkmat, rsigma = ref_em.build_sparse_kernel(cloud, k=20,
                                               dtype=None if dtype == "float64" else jnp.float32)
    assert kmat.shape == rkmat.shape == (1500, 1500)
    assert sigma == pytest.approx(rsigma, rel=1e-12) and sigma > 0
    # the same sparsity pattern is the same neighbour sets (K is 0.5 (A + A^T))
    a, b = kmat.tocsr(), rkmat.tocsr()
    a.sort_indices()
    b.sort_indices()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=1e-10)
    assert abs(kmat - kmat.T).max() == 0


def test_knn_neighbours_order_ties_and_self(cloud):
    """_knn against the reference's _knn: the same neighbours in the same
    order; on a lattice, equal distances go to the lower index."""
    d, idx = em._knn(torch.as_tensor(cloud), 20, chunk=256)
    rd, ridx = ref_em._knn(jnp.asarray(cloud), 20, chunk=256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-13)
    assert not (idx.numpy() == np.arange(1500)[:, None]).any()
    gx, gy = np.meshgrid(np.arange(6.0), np.arange(5.0))
    lattice = np.column_stack([gx.ravel(), gy.ravel()])
    d, idx = em._knn(torch.as_tensor(lattice), 3, chunk=7)
    rd, ridx = ref_em._knn(jnp.asarray(lattice), 3, chunk=8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=2e-16)  # XLA's sqrt(2)


def test_knn_hilo_resolves_near_duplicates():
    """Points 1e-11 apart collapse in plain f32; the hi/lo search still ranks
    them, and the f32 path then equals the f64 path."""
    rng = np.random.default_rng(4)
    base = rng.uniform(-1, 1, (60, 2))
    pts = np.concatenate([base + i * 1e-11 for i in range(5)])
    hi = pts.astype(np.float32)
    lo = (pts - hi).astype(np.float32)
    cand = em._knn_hilo(torch.as_tensor(hi), torch.as_tensor(lo), 4, chunk=64).numpy()
    rcand = np.asarray(ref_em._knn_hilo(jnp.asarray(hi), jnp.asarray(lo), 4, chunk=64))
    # the four nearest of every point are its own cluster's other members
    assert np.array_equal(np.sort(cand, axis=1) % 60, np.sort(rcand, axis=1) % 60)
    assert (cand % 60 == (np.arange(300) % 60)[:, None]).all()
    k64, s64 = em.build_sparse_kernel(pts, k=6, device="cpu")
    k32, s32 = em.build_sparse_kernel(pts, k=6, dtype=torch.float32, device="cpu")
    assert s32 == pytest.approx(s64, rel=1e-12)
    assert abs(k64 - k32).max() < 1e-12


def test_build_sparse_kernel_small_cloud_and_no_card():
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]])
    # n <= k + 1: the exact scan whatever the dtype
    kmat, sigma = em.build_sparse_kernel(pts, k=2, dtype=torch.float32, device="cpu")
    rk, rs = ref_em.build_sparse_kernel(pts, k=2, dtype=jnp.float32)
    assert sigma == pytest.approx(rs, rel=1e-12)
    np.testing.assert_allclose(kmat.toarray(), rk.toarray(), rtol=1e-12)
    with pytest.raises(RuntimeError, match="cuda"):
        em.build_sparse_kernel(pts, k=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ps._shell_counts(pts, 1.0, 0.5)
