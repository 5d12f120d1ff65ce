"""cmtci_torch's diffusion-map embeddings and the `embeddings` pipeline
against cmtci (the JAX reference) on the CPU.

The Markov normalization and the eigsh branch are scipy copies. The dense
Lanczos fed the reference's own start vector (jax.random.normal of key(0))
must agree with the reference's within 1e-10; the device eigenpairs against
eigsh within atol 1e-8, eigenvectors |dot| > 1 - 1e-6
(tests/test_stats_more.py:191). The port draws its start vector on the host
(np.random.default_rng(0)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtci.pipelines import analysis as ref_analysis
from cmtci.stats import embeddings as ref
from cmtci_torch.pipelines import analysis
from cmtci_torch.stats import embeddings as emb


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
def markov():
    pts = np.random.default_rng(0).normal(size=(600, 2))
    kmat, _ = ref.build_sparse_kernel(pts, k=12)
    return kmat, ref.markov_from_kernel(kmat)


def test_markov_from_kernel_equal(markov):
    kmat, want = markov
    got = emb.markov_from_kernel(kmat)
    assert (got != want).nnz == 0


def test_dense_from_sparse_equals_toarray(markov):
    s = (0.5 * (markov[1] + markov[1].T)).tocsr()
    got = emb._dense_from_sparse_device(s, torch.float64, "cpu").numpy()
    np.testing.assert_array_equal(got, s.toarray())


@pytest.mark.parametrize("m", [40, 120])
def test_lanczos_with_the_reference_start_vector(markov, m):
    s = (0.5 * (markov[1] + markov[1].T)).toarray()
    n = s.shape[0]
    v0 = np.asarray(jax.random.normal(jax.random.key(0), (n,), dtype=jnp.float64))
    want = [np.asarray(a) for a in ref._lanczos_dense(jnp.asarray(s), m)]
    got = [a.numpy() for a in emb._lanczos_dense(torch.as_tensor(s), m,
                                                 torch.as_tensor(v0.copy()))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


def test_lanczos_start_is_a_host_draw():
    np.testing.assert_array_equal(emb.lanczos_start(17),
                                  np.random.default_rng(0).standard_normal(17))


def test_device_lanczos_matches_eigsh(markov):
    """tests/test_stats_more.py:191: eigenvalues within 1e-8 of eigsh,
    eigenvectors equal up to sign."""
    p = markov[1]
    vals_ref, vecs_ref = emb.spectral_embedding(p, n_eigs=6)
    want_vals, _ = ref.spectral_embedding(p, n_eigs=6)
    np.testing.assert_allclose(vals_ref, want_vals, rtol=0, atol=1e-12)
    vals_dev, vecs_dev = emb.spectral_embedding(p, n_eigs=6, backend="device", device="cpu")
    np.testing.assert_allclose(vals_dev, vals_ref, atol=1e-8)
    for j in range(vecs_ref.shape[1]):
        dot = abs(float(vecs_dev[:, j] @ vecs_ref[:, j]))
        assert dot > 1 - 1e-6, (j, dot)


def test_device_lanczos_f32_close_to_eigsh(markov):
    p = markov[1]
    vals_ref, _ = emb.spectral_embedding(p, n_eigs=6)
    vals32, vecs32 = emb.spectral_embedding(p, n_eigs=6, backend="device",
                                            dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(vals32, vals_ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(vecs32, axis=0), 1.0, rtol=1e-12)


@pytest.mark.parametrize("backend", ["scipy", "device"])
def test_diffusion_map_against_cmtci(backend):
    pts = np.random.default_rng(1).normal(size=(400, 2))
    va, _, sa = emb.diffusion_map(pts, k=10, n_eigs=5, eig_backend=backend, device="cpu")
    vb, _, sb = ref.diffusion_map(pts, k=10, n_eigs=5, eig_backend=backend)
    assert sa == pytest.approx(sb, rel=1e-14)
    np.testing.assert_allclose(va, vb, atol=1e-8)


def test_embedding_spectral_distance_equal():
    a, b = np.array([1.0, 0.9, 0.5]), np.array([1.0, 0.8, 0.45, 0.1])
    assert emb.embedding_spectral_distance(a, b) == ref.embedding_spectral_distance(a, b)


@pytest.mark.parametrize("eig", ["scipy", "device"])
def test_run_embeddings_against_cmtci(tmp_path, eig):
    rng = np.random.default_rng(2)
    c, m = rng.normal(size=(300, 2)), rng.uniform(-1, 1, size=(250, 2))
    port, want = str(tmp_path / "p"), str(tmp_path / "r")
    got = analysis.run_embeddings(c, m, out_prefix=port, eig_backend=eig, plots=False,
                                  device="cpu")
    out = ref_analysis.run_embeddings(c, m, out_prefix=want)
    assert got["spectral_distance"] == pytest.approx(out["spectral_distance"], abs=1e-8)
    for key in ("sigma_construct", "sigma_mandel"):
        assert got[key] == pytest.approx(out[key], rel=1e-14)
    for name in ("construct", "mandel"):
        a = np.loadtxt(f"{port}_eigenvalues_{name}.csv", delimiter=",")
        b = np.loadtxt(f"{want}_eigenvalues_{name}.csv", delimiter=",")
        np.testing.assert_allclose(a, b, atol=1e-8)
        assert (open(f"{port}_eigenvalues_{name}.csv").readline()
                == open(f"{want}_eigenvalues_{name}.csv").readline())
        va, vb = (np.load(f"{p}_eigenvectors_{name}.npy") for p in (port, want))
        assert va.shape == vb.shape
        np.testing.assert_allclose(np.abs(np.sum(va * vb, axis=0)), 1.0, atol=1e-6)
    assert (open(f"{port}_spectral_distance.txt").read().split("=")[0]
            == open(f"{want}_spectral_distance.txt").read().split("=")[0])
    assert open(f"{port}_meta.txt").read().splitlines()[:3] == \
        open(f"{want}_meta.txt").read().splitlines()[:3]


def test_run_embeddings_f32_knn_and_lanczos(tmp_path):
    rng = np.random.default_rng(3)
    c, m = rng.normal(size=(300, 2)), rng.uniform(-1, 1, size=(250, 2))
    f64 = analysis.run_embeddings(c, m, plots=False, device="cpu")
    f32 = analysis.run_embeddings(c, m, eig_backend="device", eig_dtype=torch.float32,
                                  knn_dtype=torch.float32, plots=False, device="cpu")
    for key in ("vals_construct", "vals_mandel"):
        np.testing.assert_allclose(f32[key], f64[key], atol=1e-5)
    assert f32["sigma_construct"] == f64["sigma_construct"]
