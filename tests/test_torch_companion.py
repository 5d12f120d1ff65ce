"""cmtci_torch.kernels.companion against cmtci.kernels.companion (the JAX
reference), on the CPU, on the same inputs."""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from cmtci.kernels import companion as ref
from cmtci_torch.kernels import companion

NS = list(range(20, 301, 20))


def _match_error(a, b):
    """Max |a_i - b_perm(i)| under the optimal one-to-one matching: the
    order-free form of "after sorting" (conjugate pairs share a real part,
    so a lexicographic sort can order them differently in two solvers)."""
    cost = np.abs(a[:, None] - b[None, :])
    r, c = linear_sum_assignment(cost)
    return cost[r, c].max()


@pytest.mark.parametrize("family", companion.FAMILIES)
def test_inverse_cloud_matches_reference(family):
    # both solve to the 1e-13 relative Aberth tolerance with f32 repulsion;
    # the fixed points agree far inside 1e-10
    got = companion.inverse_cloud_split(NS, family, tol=1e-10, device="cpu")
    want = ref.inverse_cloud_split(NS, family, tol=1e-10)
    assert [len(g) for g in got] == [len(w) for w in want]
    for n, g, w in zip(NS, got, want):
        assert _match_error(g, w) <= 1e-10, (family, n)
    assert companion.inverse_cloud(NS, family, device="cpu").shape == (sum(NS),)


@pytest.mark.parametrize("family", ["lucas_all_ones", "sparser_gap_1_0_1_then_ones"])
def test_generic_horner_path_matches_lapack(family):
    # family=None takes the O(n) Horner Newton ratio (the path for
    # top rows without a closed form, e.g. the sparser family at n = 1)
    ns = [1, 2, 7, 33]
    a, deg = companion.poly_coeff_batch(ns, family, device="cpu")
    zr, zi, valid = companion.aberth_roots(a, deg, family=None)
    z = (zr + 1j * zi).numpy()
    for b, n in enumerate(ns):
        lap = np.linalg.eigvals(companion.companion_matrix(companion.family_top_row(family, n)))
        assert _match_error(z[b][valid[b].numpy()], lap) < 1e-8, n
    assert not companion._closed_form_ok(ns, "sparser_gap_1_0_1_then_ones")


def test_lapack_backend_identical():
    for family in companion.FAMILIES:
        got = companion.inverse_cloud(NS[:5], family, backend="lapack", device="cpu")
        want = ref.inverse_cloud(NS[:5], family, backend="lapack")
        np.testing.assert_array_equal(got, want)


def test_bucketed_sweep_matches_reference():
    # spans the curve-init threshold, so both take the bucketed sweep
    ns = [5, 12, 40, 90]
    assert companion._bucketing_pays(ns) and ref._bucketing_pays(ns)
    got = companion.inverse_cloud_split(ns, "lucas_all_ones", device="cpu")
    want = ref.inverse_cloud_split(ns, "lucas_all_ones")
    for g, w in zip(got, want):
        assert _match_error(g, w) <= 1e-10


def test_cloud_leaves_rng_untouched():
    rng = np.random.RandomState(7)
    state0 = rng.get_state()[1].copy()
    companion.inverse_cloud([20, 40, 60], "lucas_all_ones", tol=1e-10, device="cpu")
    assert np.array_equal(rng.get_state()[1], state0)


def test_cuda_request_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        companion.inverse_cloud([20], "lucas_all_ones", device="cuda")
