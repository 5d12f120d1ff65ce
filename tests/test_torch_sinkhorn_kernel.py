"""The stage-1 Sinkhorn loop as csrc/sinkhorn.cu computes it, on the CPU.

The kernel runs only on the card, where chip_smoke.py (phase 23) holds its
plan bitwise to the twin sinkhorn_log_torch. Here:
  * the twin against cmtci's sinkhorn_log (the JAX reference) at stage1's
    eps and iterations and at the tests' earlier (0.05, 300);
  * the twin's fixed-order logsumexp, bitwise, against a numpy emulation of
    the warp's order (32 strided partial sums, then the xor butterfly), and
    the twin's whole loop against a line-by-line model of the kernel;
  * the launch plan on the H100's SMs and shared memory: resident at
    stage1's 819 x 600, streaming at the 6x bus's 5,049 x 1,624 (and at the
    5,049 x 2,000 its 2,000 samples would give), every row and column owned
    by exactly one CTA;
  * a CPU tensor launches nothing, and the card's entry points raise without
    a card.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cmtci.transport import sinkhorn as ref_sinkhorn
from cmtci_torch.kernels import _launch
from cmtci_torch.transport import sinkhorn

CSRC = Path(__file__).resolve().parents[1] / "cmtci_torch" / "csrc"
#: the H100 SXM: SMs, and the shared memory a CTA may opt in to
H100_SMS, H100_SMEM = 132, 232448
#: stage1's cost at the CLI defaults and at the 6x bus (--max-n 100
#: --boundary-samples 2000: the band has 1,624 pixels, every one drawn), and
#: the cost of 2,000 draws
DEFAULT_SHAPE, SIX_X_SHAPE, SIX_X_2000 = (819, 600), (5049, 1624), (5049, 2000)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small tensors: the suite
    runs several pytest workers on the CPU at once, and each worker's
    OpenMP thread pool would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def feature_cost(n: int, m: int, seed: int) -> np.ndarray:
    """A euclidean cost between two clouds of 4-D rows, like stage1's
    [features | coordinates]."""
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=(n, 4)), rng.normal(size=(m, 4))
    return np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))


def np_warp_sum(e: np.ndarray) -> np.ndarray:
    """The warp's order over dim 0, one lane at a time: lane l adds rows l,
    l + 32, ... to +0.0 in increasing order; then lane l < s adds lane
    l + s's sum for s = 16, 8, 4, 2, 1."""
    acc = np.zeros((32, e.shape[1]))
    for lane in range(32):
        for k in range(lane, e.shape[0], 32):
            acc[lane] = acc[lane] + e[k]
    s = 16
    while s:
        acc = np.array([acc[lane] + acc[lane + s] for lane in range(s)])
        s //= 2
    return acc[0]


@pytest.mark.parametrize("shape", [(70, 55), (130, 97)])
@pytest.mark.parametrize("eps,iters", [(0.05, 300), (1e-2, 1000)])
def test_twin_against_cmtci(shape, eps, iters):
    """test_torch_stage1.py's thresholds: 1e-12 of the largest entry, the
    same argmax a row."""
    cost = feature_cost(*shape, seed=shape[0])
    ref = np.asarray(ref_sinkhorn.sinkhorn_log(cost, iters=iters, eps=eps))
    got = sinkhorn.sinkhorn_log_torch(torch.as_tensor(cost), iters=iters, eps=eps).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(ref)
    np.testing.assert_array_equal(got.argmax(axis=1), ref.argmax(axis=1))
    np.testing.assert_allclose(got.sum(axis=0), 1.0 / shape[1], rtol=1e-9)


@pytest.mark.parametrize("length", [1, 31, 32, 33, 600, 819])
def test_warp_sum_is_the_warp_order(length):
    """Bitwise: the sums span 40 binades, so any other order differs."""
    rng = np.random.default_rng(length)
    e = np.exp(rng.uniform(-40.0, 0.0, size=(length, 3)) * np.log(2.0))
    got = sinkhorn.warp_sum(torch.as_tensor(e)).numpy()
    want = np_warp_sum(e)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("length", [1, 31, 32, 33, 600, 819])
def test_logsumexp_fixed_bitwise(length):
    """max (infinite -> 0), exp of the differences, the warp's sum, log plus
    max, bitwise; a column whose terms but the max underflow to 0, one of
    -inf, one holding +inf, and torch.logsumexp within rounding."""
    rng = np.random.default_rng(100 + length)
    x = rng.normal(scale=30.0, size=(length, 5))
    x[:, 1] = -800.0
    x[0, 1] = 0.0
    x[:, 2] = -np.inf
    x[length // 2, 3] = np.inf
    got = sinkhorn.logsumexp_fixed(torch.as_tensor(x))
    mx = np.max(x, axis=0)
    mx[np.abs(mx) == np.inf] = 0.0
    terms = torch.exp(torch.as_tensor(x) - torch.as_tensor(mx)).numpy()
    if length > 1:
        assert terms[1:, 1].max() == 0.0  # the underflowing column
    want = torch.log(torch.as_tensor(np_warp_sum(terms))) + torch.as_tensor(mx)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    lib = torch.logsumexp(torch.as_tensor(x), dim=0)
    assert torch.equal(torch.isinf(got), torch.isinf(lib))
    fin = torch.isfinite(lib)
    torch.testing.assert_close(got[fin], lib[fin], rtol=1e-14, atol=0.0)


def kernel_model(cost: torch.Tensor, iters: int, eps: float, ctas: int) -> torch.Tensor:
    """csrc/sinkhorn.cu line by line: each CTA's rows, then (after the
    barrier) its columns, each line reduced alone from mk's row or column."""
    n, m = cost.shape
    inv = 1.0 / eps
    mk = (-cost) * inv
    f, g = torch.zeros(n, dtype=cost.dtype), torch.zeros(m, dtype=cost.dtype)
    log_mu, log_nu = -math.log(n), -math.log(m)

    def lse(line, add):
        x = (line + add)[:, None]
        return float(sinkhorn.logsumexp_fixed(x)[0])

    for _ in range(iters):
        gs = g * inv
        f_new = torch.empty_like(f)
        for c in range(ctas):
            for i in range(*sinkhorn.block(c, n, ctas)):
                f_new[i] = eps * (log_mu - lse(mk[i], gs))
        f = f_new
        fs = f * inv
        for c in range(ctas):
            for j in range(*sinkhorn.block(c, m, ctas)):
                g[j] = eps * (log_nu - lse(mk[:, j], fs))
    return torch.exp(mk + (f * inv)[:, None] + (g * inv)[None, :])


@pytest.mark.parametrize("ctas", [1, 7])
def test_twin_is_the_line_by_line_kernel(ctas):
    """Bitwise at a ragged 37 x 45 cost over 1 and 7 CTAs: the twin's
    transposed half step is the kernel's row by row."""
    cost = torch.as_tensor(feature_cost(37, 45, seed=3))
    want = kernel_model(cost, 4, 0.1, ctas)
    assert torch.equal(sinkhorn.sinkhorn_log_torch(cost, 4, 0.1), want)


def test_twin_without_steps_is_the_prior():
    cost = torch.as_tensor(feature_cost(9, 5, seed=1))
    assert torch.equal(sinkhorn.sinkhorn_log_torch(cost, 0, 0.5), torch.exp((-cost) * 2.0))


@pytest.mark.parametrize("shape,resident,smem", [(DEFAULT_SHAPE, True, 77712),
                                                 (SIX_X_SHAPE, False, 53384),
                                                 (SIX_X_2000, False, 56392)])
def test_launch_plan_on_the_h100(shape, resident, smem):
    """One CTA an SM; resident holds f, g and 7 rows and 5 columns of mk at
    the defaults (the header's 77,712 B); the 6x bus streams with f and g
    alone in shared memory."""
    plan = sinkhorn.launch_plan(*shape, H100_SMS, H100_SMEM)
    assert plan.ctas == H100_SMS * sinkhorn.SINKHORN_CTAS_PER_SM
    assert (plan.resident, plan.smem) == (resident, smem)
    assert plan.smem <= H100_SMEM


@pytest.mark.parametrize("n,m,ctas", [(819, 600, 132), (819, 600, 97), (819, 600, 66),
                                      (5049, 1624, 132), (5049, 2000, 132), (31, 5, 132),
                                      (1, 1, 4),
                                      (33, 64, 1)])
def test_launch_plan_blocks_cover_every_line_once(n, m, ctas):
    plan = sinkhorn.launch_plan(n, m, H100_SMS, H100_SMEM, ctas=ctas)
    assert plan.ctas == ctas
    for count, most in ((n, plan.row_block), (m, plan.col_block)):
        owned = np.zeros(count, dtype=int)
        for c in range(ctas):
            lo, hi = sinkhorn.block(c, count, ctas)
            assert 0 <= hi - lo <= most
            owned[lo:hi] += 1
        np.testing.assert_array_equal(owned, 1)
    if plan.resident:
        assert plan.smem == 8 * (n + m + plan.row_block * m + plan.col_block * n)
    else:
        assert plan.smem == 8 * (n + m)


def test_launch_plan_streams_when_asked_and_refuses_what_cannot_fit():
    plan = sinkhorn.launch_plan(*DEFAULT_SHAPE, H100_SMS, H100_SMEM, streaming=True)
    assert not plan.resident and plan.smem == 8 * sum(DEFAULT_SHAPE)
    # one CTA cannot hold the whole default cost: it streams
    assert not sinkhorn.launch_plan(*DEFAULT_SHAPE, H100_SMS, H100_SMEM, ctas=1).resident
    with pytest.raises(ValueError, match="past the 232448 B"):
        sinkhorn.launch_plan(20000, 9100, H100_SMS, H100_SMEM)
    with pytest.raises(ValueError, match="0 x 5 cost"):
        sinkhorn.launch_plan(0, 5, H100_SMS, H100_SMEM)


def test_cpu_tensors_launch_nothing():
    _launch.reset_launches()
    cost = torch.as_tensor(feature_cost(40, 33, seed=2))
    assert torch.equal(sinkhorn.sinkhorn_log(cost, 30, 0.05),
                       sinkhorn.sinkhorn_log_torch(cost, 30, 0.05))
    sinkhorn.sinkhorn_match(np.ones((3, 2)), np.zeros((3, 2)), iters=5, device="cpu")
    assert _launch.launches["sinkhorn"] == 0 and sum(_launch.launches.values()) == 0
    with pytest.raises(ValueError, match="expected cuda"):
        sinkhorn.sinkhorn_kernel(cost, 5, 0.1)
    assert _launch.launches["sinkhorn"] == 0


def test_the_card_path_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sinkhorn.sinkhorn_match(np.ones((3, 2)), np.ones((3, 2)), device="cuda")
    meta = torch.empty((4, 4), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sinkhorn.sinkhorn_log(meta, 5, 0.1)
    with pytest.raises(ValueError, match="expected cuda"):
        sinkhorn.sinkhorn_kernel(meta, 5, 0.1)
    assert _launch.launches["sinkhorn"] == 0


def test_signatures_and_constants_match_the_source():
    """Each ctypes argument list has as many types as its extern "C"
    function has parameters, and the Python mirror of CTAS_PER_SM is the
    source's."""
    src = (CSRC / "sinkhorn.cu").read_text()
    for entry in ("sinkhorn", "sinkhorn_barriers"):
        assert _launch.LIBRARY.get(entry, entry) == "sinkhorn"
        m = re.search(rf'extern "C" int {entry}_launch\(([^)]*)\)', src)
        assert m, entry
        assert len(m.group(1).split(",")) == len(_launch.ARGTYPES[entry]), entry
    for query, arity in (("sinkhorn_limits", 2), ("sinkhorn_occupancy", 3)):
        m = re.search(rf'extern "C" int {query}\(([^)]*)\)', src)
        assert m and len(m.group(1).split(",")) == arity, query
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["CTAS_PER_SM"]) == sinkhorn.SINKHORN_CTAS_PER_SM
    assert int(consts["WARP"]) == sinkhorn.WARP
