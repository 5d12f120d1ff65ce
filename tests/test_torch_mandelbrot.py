"""cmtci_torch's TCI distance-estimator field, K1 twin, band and sampler
against cmtci (the JAX reference), on the CPU.

The K1 kernel itself (csrc/tci_de.cu) runs only on the card, where
chip_smoke.py holds it bitwise to tci_de_field_torch; here the twin is held
to the Pallas kernel in interpret mode, at the sizes
tests/test_pallas_kernel.py uses.
"""

import numpy as np
import pytest
import torch

from cmtci.kernels import mandelbrot as ref_mb
from cmtci.kernels.mandelbrot_pallas import (tci_boundary_selection as ref_selection,
                                             tci_de_field_pallas)
from cmtci_torch.kernels import mandelbrot as mb
from cmtci_torch.kernels import mandelbrot_cuda as mc

DOM = (-2.2, 1.2, -1.6, 1.6)
N, ITERS = 128, 60


def _band(esc, d):
    q = np.quantile(d[esc], 0.25)
    return esc & (d <= q)


def _jaccard(a, b):
    return (a & b).sum() / (a | b).sum()


@pytest.fixture(scope="module")
def twin():
    out = mc.tci_de_field_torch(DOM, N, ITERS, device="cpu").numpy()
    return out >= 0, np.maximum(out, 0.0)


@pytest.fixture(scope="module")
def f64_field():
    cr, ci = ref_mb.complex_grid(DOM, N, N)
    esc, d, _, _ = ref_mb.de_field_tci(np.asarray(cr), np.asarray(ci), max_iter=ITERS)
    return np.asarray(esc), np.asarray(d)


def test_twin_matches_pallas_interpret(twin):
    # XLA on the CPU may contract a*b+c into an FMA inside the interpreted
    # kernel, which flips an ulp-borderline pixel; the twin rounds each op
    esc32, d32 = tci_de_field_pallas(DOM, N, max_iter=ITERS, tile=(8, 128), inner=8)
    esc32, d32 = np.asarray(esc32), np.asarray(d32)
    esc, d = twin
    assert (esc == esc32).mean() >= 0.999
    assert _jaccard(_band(esc, d), _band(esc32, d32)) >= 0.99


def test_twin_matches_f64_field(twin, f64_field):
    # the contract of test_pallas_kernel.py:61-71 (f32 dz overflows earlier)
    esc32, d32 = twin
    esc, d = f64_field
    assert (esc32 == esc).mean() > 0.995
    assert (d32[esc32] == 0).mean() > 0.5
    assert abs((d32[esc32] == 0).mean() - (d[esc] == 0).mean()) < 0.02
    assert _jaccard(_band(esc32, d32), _band(esc, d)) > 0.97


def test_wrapper_on_cpu_is_the_twin(twin):
    esc, d = mc.tci_de_field(DOM, N, ITERS, device="cpu")
    assert esc.dtype == torch.bool and d.dtype == torch.float32
    assert esc.shape == d.shape == (N, N)
    np.testing.assert_array_equal(esc.numpy(), twin[0])
    np.testing.assert_array_equal(d.numpy(), twin[1])


def test_band_selection_matches_reference():
    sel, cnt = mc.tci_boundary_selection(DOM, N, max_iter=ITERS, device="cpu")
    ref_sel, ref_cnt = ref_selection(DOM, N, max_iter=ITERS)
    assert sel.shape == (N, N)
    assert abs(cnt - ref_cnt) <= 0.001 * N * N
    assert _jaccard(sel, ref_sel) >= 0.99


def test_band_selection_interpolates_like_reference():
    # 5 escaped values: pos = 0.25*4 = 1 -> q = sorted[1]
    esc = torch.tensor([True, True, False, True, True, True])
    d = torch.tensor([0.5, 0.1, 9.0, 0.3, 0.2, 0.4])
    sel, cnt, q = mc.band_selection(esc, d)
    assert int(cnt) == 5 and float(q) == pytest.approx(0.2)
    assert sel.tolist() == [False, True, False, False, True, False]


def test_sampler_in_band_without_replacement_deterministic():
    sel, _ = mc.tci_boundary_selection(DOM, N, max_iter=ITERS, device="cpu")
    xs = np.linspace(DOM[0], DOM[1], N)
    ys = np.linspace(DOM[2], DOM[3], N)
    iy, ix = np.nonzero(sel)
    band = set(zip(xs[ix], ys[iy]))

    pts = mc.tci_boundary_sample(DOM, N, 200, seed=3, max_iter=ITERS, device="cpu")
    assert pts.shape == (200,)
    assert len(set(pts)) == 200
    assert all((p.real, p.imag) in band for p in pts)
    np.testing.assert_array_equal(
        pts, mc.tci_boundary_sample(DOM, N, 200, seed=3, max_iter=ITERS, device="cpu"))
    assert not np.array_equal(
        pts, mc.tci_boundary_sample(DOM, N, 200, seed=4, max_iter=ITERS, device="cpu"))
    # band smaller than n_samples -> the whole band (the reference's keep-all)
    pts_all = mc.tci_boundary_sample(DOM, N, len(band) + 500, seed=3, max_iter=ITERS,
                                     device="cpu")
    assert pts_all.shape == (len(band),)
    assert set(zip(pts_all.real, pts_all.imag)) == band


def test_no_escape_raises():
    # a domain inside the main cardioid: every pixel is analytically interior
    with pytest.raises(RuntimeError, match="No escape points"):
        mc.tci_boundary_sample((-0.2, 0.0, -0.1, 0.1), 16, 10, seed=0, max_iter=20,
                               device="cpu")


def test_nan_dz_gives_zero_distance():
    # c = 2 (real axis): z escapes at step 4 (|z| = 1446) and dz overflows
    # to (inf, 0) at step 8. The latched z has im 0, so 2*lzi*dzr = 0*inf
    # is NaN and |2 z dz| is NaN: a max that drops NaN (C's fmaxf,
    # torch.fmax) would give den = 1e-12 and a huge finite d instead of 0
    out = mc.tci_de_field_torch((2.0, 3.0, 0.0, 1.0), 2, 12, device="cpu")
    assert float(out[0, 0]) == 0.0

    f = torch.float32
    lzr, lzi = torch.tensor([1446.0], dtype=f), torch.tensor([0.0], dtype=f)
    dzr, dzi = torch.tensor([float("inf")], dtype=f), torch.tensor([0.0], dtype=f)
    pr = 2.0 * lzr * dzr - 2.0 * lzi * dzi
    pi = 2.0 * lzr * dzi + 2.0 * lzi * dzr
    mag = torch.sqrt(pr * pr + pi * pi)
    floor = mag.new_tensor(1e-12)
    num = torch.log(lzr) * lzr
    assert torch.isnan(torch.maximum(mag, floor)).all()
    assert float(num / torch.fmax(mag, floor)) > 1e12


def test_f64_field_matches_reference(f64_field):
    # same np.linspace grid on both sides; XLA may contract an FMA, so a
    # few d values differ in the last ulps and no escape flips at this size
    cr, ci = mb.complex_grid(DOM, N, N, device="cpu")
    esc, d, _, _ = mb.de_field_tci(cr, ci, max_iter=ITERS)
    ref_esc, ref_d = f64_field
    np.testing.assert_array_equal(esc.numpy(), ref_esc)
    np.testing.assert_allclose(d.numpy(), ref_d, rtol=1e-12, atol=1e-15)


def test_f64_sampler_matches_reference_stream():
    # impl="torch" consumes the host stream like the reference's impl="jax"
    got = mb.sample_boundary_quantile(DOM, N, 300, max_iter=ITERS,
                                      rng=np.random.RandomState(7), device="cpu")
    want = ref_mb.sample_boundary_quantile(DOM, N, 300, max_iter=ITERS,
                                           rng=np.random.RandomState(7))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_numpy_field_is_the_reference_copy():
    xs = np.linspace(DOM[0], DOM[1], 64)
    c = xs[None, :] + 1j * xs[:, None]
    e1, d1 = mb.de_field_tci_numpy(c, max_iter=40)
    e2, d2 = ref_mb.de_field_tci_numpy(c, max_iter=40)
    np.testing.assert_array_equal(e1, e2)
    np.testing.assert_array_equal(d1, d2)


def test_cuda_sampler_guards_eps():
    with pytest.raises(ValueError, match="1e-12"):
        mb.sample_boundary_quantile(DOM, N, 10, eps=1e-10, impl="cuda", device="cpu")
