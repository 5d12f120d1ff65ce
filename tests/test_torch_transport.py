"""cmtci_torch.transport against cmtci.transport (the JAX reference), on the
CPU, on the same numpy-seeded inputs."""

import numpy as np
import pytest
import torch

from cmtci.transport import giflow as ref_giflow
from cmtci.transport import histogram as ref_hg
from cmtci.transport import procrustes as ref_procrustes
from cmtci.transport.sinkhorn import _match_fused as ref_match_fused
from cmtci.transport.sinkhorn import entropic_argmax_match as ref_match
from cmtci_torch.transport import giflow, histogram, procrustes, sinkhorn

DOM = (-2.2, 1.2, -1.6, 1.6)


def _clouds(seed, n=3000, m=2500):
    r = np.random.default_rng(seed)
    return r.normal(size=(n, 2)), r.normal(size=(m, 2))


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_matcher_matches_reference_f64(seed):
    # XLA on the CPU may contract dx*dx + dy*dy into an FMA and flip a
    # near-tie, so allow 1 in 10^4 rows to differ
    a, b = _clouds(seed)
    got = sinkhorn._match_fused(torch.as_tensor(a), torch.as_tensor(b), 0.8).numpy()
    want = np.asarray(ref_match_fused(a, b, 0.8))
    assert (got == want).mean() >= 0.9999


def test_torch_matcher_matches_reference_f32():
    # f32 exp(-d/eps) ties more often, and a flipped tie moves the argmax
    a, b = (x.astype(np.float32) for x in _clouds(2))
    got = sinkhorn._match_fused(torch.as_tensor(a), torch.as_tensor(b), 0.8).numpy()
    want = np.asarray(ref_match_fused(a, b, 0.8))
    assert (got == want).mean() >= 0.999


def test_torch_matcher_equals_numpy_backend_without_near_ties():
    # points on a coarse lattice plus distinct offsets: every row's nearest
    # neighbour wins by far more than rounding
    r = np.random.default_rng(3)
    b = np.stack(np.meshgrid(np.arange(40.0), np.arange(40.0)), -1).reshape(-1, 2)
    a = b[r.permutation(len(b))[:1200]] + r.uniform(-0.2, 0.2, size=(1200, 2))
    x = a[:, 0] + 1j * a[:, 1]
    y = b[:1200, 0] + 1j * b[:1200, 1]
    m_np, x_np = sinkhorn.entropic_argmax_match(x, y, rng=np.random.RandomState(5),
                                                backend="numpy")
    m_t, x_t = sinkhorn.entropic_argmax_match(x, y, rng=np.random.RandomState(5),
                                              backend="torch", device="cpu")
    np.testing.assert_array_equal(x_np, x_t)
    np.testing.assert_array_equal(m_np, m_t)


def test_matcher_consumes_the_reference_stream():
    r = np.random.default_rng(4)
    x = r.normal(size=700) + 1j * r.normal(size=700)
    y = r.normal(size=500) + 1j * r.normal(size=500)
    rng_a, rng_b = np.random.RandomState(9), np.random.RandomState(9)
    m1, x1 = sinkhorn.entropic_argmax_match(x, y, rng=rng_a, backend="numpy")
    m2, x2 = ref_match(x, y, rng=rng_b, backend="numpy")
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(m1, m2)
    assert np.array_equal(rng_a.get_state()[1], rng_b.get_state()[1])


@pytest.mark.parametrize("sigma", [0.0, 1.0, 3.0])
def test_mollified_histogram_bitwise(sigma):
    r = np.random.default_rng(5)
    # include points exactly on bin edges and outside the domain
    pts = r.uniform(-2.5, 1.5, 4000) + 1j * r.uniform(-1.8, 1.8, 4000)
    xe, ye = ref_hg.np_edges(64, DOM)
    pts = np.concatenate([pts, xe[:20] + 1j * ye[:20]])
    got = histogram.mollified_histogram(pts, 64, DOM, sigma)
    want = ref_hg.mollified_histogram(pts, 64, DOM, sigma, host_numpy=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_distances_equal_reference():
    r = np.random.default_rng(6)
    p = r.dirichlet(np.ones(256)).reshape(16, 16)
    q = r.dirichlet(np.ones(256)).reshape(16, 16)
    assert histogram.kl(p, q) == ref_hg.kl(p, q)
    assert histogram.tv_distance(p, q) == ref_hg.tv_distance(p, q)
    assert histogram.overlap_mass(p, q) == ref_hg.overlap_mass(p, q)
    assert histogram.pinsker_bound(0.01) == ref_hg.pinsker_bound(0.01)
    c = r.normal(size=100) * 2 + 1j * r.normal(size=100)
    assert (histogram.fraction_outside_domain(c, DOM)
            == ref_hg.fraction_outside_domain(c, DOM))


def _pq(bins=32, seed=7):
    r = np.random.default_rng(seed)
    p = r.dirichlet(np.ones(bins * bins)).reshape(bins, bins)
    q = r.dirichlet(np.ones(bins * bins)).reshape(bins, bins)
    return p, q


@pytest.mark.parametrize("device", [None, "cpu"])
def test_fixed_t_flow_matches_reference(device):
    p, q = _pq()
    x, t, kl0, klt = giflow.gi_flow_fixed_t(p, q, 0.1, 25, device=device)
    rx, rt, rkl0, rklt = ref_giflow.gi_flow_fixed_t(p, q, 0.1, 25)
    assert t == rt == 25
    np.testing.assert_allclose(x, rx, rtol=1e-12)
    assert kl0 == pytest.approx(rkl0, rel=1e-12)
    assert klt == pytest.approx(rklt, rel=1e-12)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_adaptive_flow_matches_reference(device):
    p, q = _pq(seed=8)
    x, t, kl0, klv = giflow.gi_flow_to_threshold(p, q, 0.1, 1e-6, 800, 5, device=device)
    rx, rt, rkl0, rklv = ref_giflow.gi_flow_to_threshold(p, q, 0.1, 1e-6, 800, 5)
    assert t == rt and 5 < t < 800
    np.testing.assert_allclose(x, rx, rtol=1e-12)
    assert kl0 == pytest.approx(rkl0, rel=1e-12)
    assert klv == pytest.approx(rklv, rel=1e-12)


def test_procrustes_is_the_reference_copy():
    r = np.random.default_rng(9)
    x = r.normal(size=50) + 1j * r.normal(size=50)
    y = r.normal(size=50) + 1j * r.normal(size=50)
    for conv in ("reference", "fixed"):
        np.testing.assert_array_equal(
            procrustes.procrustes_align_no_scale(x, y, convention=conv),
            ref_procrustes.procrustes_align_no_scale(x, y, convention=conv))
