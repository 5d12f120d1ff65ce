"""The stage-1 Sinkhorn loop as csrc/sinkhorn.cu computes it, on the CPU.

The kernel runs only on the card, where chip_smoke.py (phase 23) holds its
plan bitwise to the twin sinkhorn_log_torch. Here:
  * the twin against cmtci's sinkhorn_log (the JAX reference) at stage1's
    eps and iterations and at the tests' earlier (0.05, 300);
  * the twin's fixed-order logsumexp, bitwise, against a numpy emulation of
    the warp's order (32 strided partial sums, then the xor butterfly), and
    the twin's whole loop against a line-by-line model of the kernel and
    against a model of its schedule (pass_model: resident, a warp a line
    with its lanes' maxima pooled and UNROLL exps added as they come;
    streaming, the passes of a CTA's lines in rounds, the warps' segment
    maxima, the exps laid out as the maxima, the ordered adds of a line's
    warp one round later, the ring and its copies) at ragged shapes, grids,
    passes, ring depths and thread counts;
  * the launch plan on the H100's SMs and shared memory: resident at
    stage1's 819 x 600, streaming at the 6x bus's 5,049 x 1,624 (and at the
    5,049 x 2,000 its 2,000 samples would give), every row and column owned
    by exactly one CTA, the passes, the ring and the bytes it stages;
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


def kernel_constants() -> dict:
    """The `constexpr int` constants of csrc/sinkhorn.cu."""
    src = (CSRC / "sinkhorn.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def fmax(a: float, b: float) -> float:
    """CUDA's fmax, which sinkhorn.cu's maxima take: a NaN operand is passed
    over (the NaN term's exp still makes its line's lse NaN)."""
    return b if a != a else a if b != b else max(a, b)


def butterfly(lanes: list, op) -> float:
    """What lane 0 holds after `v = op(v, __shfl_xor_sync(v, s))` for s =
    16, 8, 4, 2, 1 over the warp's 32 values."""
    for s in (16, 8, 4, 2, 1):
        lanes = [op(lanes[lane], lanes[lane ^ s]) for lane in range(32)]
    return lanes[0]


def model_half_step(block, count, length, ld, pass_, depth, add, eps, log_marg, threads):
    """sinkhorn.cu's streaming half_step for one CTA, round by round in its order:
    `block` holds the CTA's lines (line l at l * ld, a list of floats);
    returns out[l]. In round p (-1 to the last pass + 1): the adds of pass
    p - 1 by a warp a line (at most half the warps; all in the last round);
    the exps of pass p by the other warps, laid out as the maxima (every
    term once); the segment maxima of pass p + 1 into its
    buffer (keys[(p + 1) % 3], whose line maxima the exps and the adds
    take); after the CTA barrier, pass p - 1's slot takes pass p - 1 + depth
    (streaming). Streaming, the ring's
    slots are filled as stage() issues the copies (the first `depth` passes
    before the half step). The schedule is checked: a copy lands only in a
    slot whose pass has been added up, a pass is read from its own slot and
    its maxima from its own buffer, and the parts that run at once touch
    distinct buffers."""
    warps = threads // sinkhorn.WARP
    passes = -(-count // pass_)
    ring = [math.nan] * (depth * pass_ * ld)
    holder = [None] * depth
    added = set()
    out = [None] * count
    if passes == 0:
        return out

    def cnt(p):
        return min(pass_, count - p * pass_)

    def stage(p):
        first = p * pass_
        if first >= count:
            return
        slot = p % depth
        assert holder[slot] is None or holder[slot] in added, (p, holder[slot])
        ring[slot * pass_ * ld: (slot * pass_ + cnt(p)) * ld] = block[first * ld:
                                                                    (first + cnt(p)) * ld]
        holder[slot] = p

    def lines(p):
        assert holder[p % depth] == p, (p, holder)
        return ring, (p % depth) * pass_ * ld

    exps_of = lines

    def partials(p):
        src, s0 = lines(p)
        seg = max(1, warps // cnt(p))
        step, red = 32 * seg, []
        for u in range(cnt(p) * seg):
            x0 = s0 + (u // seg) * ld
            for lane in range(32):
                m = [-math.inf] * 4
                k = (u % seg) * 32 + lane
                while k + 3 * step < length:
                    for i in range(4):
                        m[i] = fmax(m[i], src[x0 + k + i * step] + add[k + i * step])
                    k += 4 * step
                while k < length:
                    m[0] = fmax(m[0], src[x0 + k] + add[k])
                    k += step
                red.append(fmax(fmax(m[0], m[1]), fmax(m[2], m[3])))
        return red

    def line_max(p, red):
        seg, mxs = max(1, warps // cnt(p)), []
        for line in range(cnt(p)):
            lanes = []
            for lane in range(32):
                v = -math.inf
                for s in range(seg):
                    v = fmax(v, red[(line * seg + s) * 32 + lane])
                lanes.append(v)
            v = butterfly(lanes, fmax)
            mxs.append(0.0 if abs(v) == math.inf else v)
        return mxs

    def compute_exps(p, mx, w0):
        (src, s0), (dst, d0) = lines(p), exps_of(p)
        seg = max(1, (warps - w0) // cnt(p))
        step = 32 * seg
        where, terms = [], []
        for u in [u for w in range(w0, warps) for u in range(w - w0, cnt(p) * seg, warps - w0)]:
            line, s = divmod(u, seg)
            for lane in range(32):
                for k in range(s * 32 + lane, length, step):
                    where.append(d0 + line * ld + k)
                    terms.append((src[s0 + line * ld + k] + add[k]) - mx[line])
        assert sorted(where) == [d0 + line * ld + k for line in range(cnt(p))
                                 for k in range(length)]
        for w, v in zip(where, torch.exp(torch.tensor(terms, dtype=torch.float64)).tolist()):
            dst[w] = v

    def add_up(p, mx):
        dst, d0 = exps_of(p)
        accs = []
        for line in range(cnt(p)):
            lanes = []
            for lane in range(32):
                acc = 0.0
                for k in range(lane, length, 32):
                    acc += dst[d0 + line * ld + k]
                lanes.append(acc)
            accs.append(butterfly(lanes, lambda a, b: a + b))
        logs = torch.log(torch.tensor(accs, dtype=torch.float64)).tolist()
        for line in range(cnt(p)):
            out[p * pass_ + line] = eps * (log_marg - (logs[line] + mx[line]))
        added.add(p)

    for p in range(depth):
        stage(p)
    # keys[b]: (the pass whose maxima buffer b holds, its line maxima)
    keys = {}
    p = -1
    while (p - 1) * pass_ < count:
        here, nxt = p >= 0 and p * pass_ < count, (p + 1) * pass_ < count
        # the buffers the parts running at once touch are distinct
        busy = ([exps_of(p)] if here else []) + ([exps_of(p - 1)] if p >= 1 else []) + (
            [lines(p + 1)] if nxt else [])
        assert len({(id(b), o) for b, o in busy}) == len(busy), busy
        assert len({q % 3 for q in (p - 1, p, p + 1)}) == 3
        adders = (min(cnt(p - 1), warps // 2 if here else warps) if p >= 1 else 0)
        if p >= 1:
            assert keys[(p - 1) % 3][0] == p - 1
            add_up(p - 1, keys[(p - 1) % 3][1])
        if here:
            assert keys[p % 3][0] == p
            compute_exps(p, keys[p % 3][1], adders)
        if nxt:
            keys[(p + 1) % 3] = (p + 1, line_max(p + 1, partials(p + 1)))
        if p >= 1:
            stage(p - 1 + depth)
        p += 1
    assert added == set(range(passes))
    return out


def model_line_lse(x: list, add: list, eps: float, log_marg: float, unroll: int) -> float:
    """sinkhorn.cu's line_lse, a resident line by one warp: lane l's
    `unroll` running maxima of its terms l, l + 32, ..., the warp's largest,
    then its exps, `unroll` loaded at a time and added in increasing k, the
    butterfly and the log."""
    length = len(x)
    lanes_max, lanes_sum = [], []
    for lane in range(32):
        part = [-math.inf] * unroll
        k = lane
        while k + (unroll - 1) * 32 < length:
            for u in range(unroll):
                part[u] = fmax(part[u], x[k + u * 32] + add[k + u * 32])
            k += unroll * 32
        while k < length:
            part[0] = fmax(part[0], x[k] + add[k])
            k += 32
        v = part[0]
        for u in range(1, unroll):
            v = fmax(v, part[u])
        lanes_max.append(v)
    mx = max(lanes_max)
    mx = 0.0 if abs(mx) == math.inf else mx
    terms = torch.exp(torch.tensor([(x[k] + add[k]) - mx for k in range(length)],
                                   dtype=torch.float64)).tolist()
    for lane in range(32):
        acc = 0.0
        for k in range(lane, length, 32):
            acc += terms[k]
        lanes_sum.append(acc)
    acc = butterfly(lanes_sum, lambda a, b: a + b)
    return eps * (log_marg - (torch.log(torch.tensor(acc, dtype=torch.float64)).item() + mx))


def pass_model(cost: torch.Tensor, iters: int, eps: float, plan,
               threads: int | None = None) -> torch.Tensor:
    """csrc/sinkhorn.cu's loop on `plan` (launch_plan's), CTA by CTA:
    resident, a warp a line (model_line_lse); streaming, pass by pass
    (model_half_step); the lines of mk and mkT at the kernel's strides
    (streaming: padded to even, as in the scratch), the vectors refilled
    after each barrier, the plan in the epilogue. `threads` defaults to the
    source's THREADS."""
    consts = kernel_constants()
    threads = threads or consts["THREADS"]
    n, m = cost.shape
    inv = 1.0 / eps
    mk = (-cost) * inv
    ldm, ldn = (m, n) if plan.resident else (sinkhorn.padded(m), sinkhorn.padded(n))
    rows = [v for i in range(n) for v in mk[i].tolist() + [math.nan] * (ldm - m)]
    cols = [v for j in range(m) for v in mk[:, j].tolist() + [math.nan] * (ldn - n)]
    f, g = [0.0] * n, [0.0] * m

    def half(block, count, length, ld, pass_, add, log_marg):
        if plan.resident:
            return [model_line_lse(block[i * ld: i * ld + length], add, eps, log_marg,
                                   consts["UNROLL"]) for i in range(count)]
        return model_half_step(block, count, length, ld, pass_, plan.depth, add, eps, log_marg,
                               threads)

    for it in range(iters):
        gs = [(0.0 if it == 0 else v) * inv for v in g]
        f = [None] * n
        for c in range(plan.ctas):
            r0, r1 = sinkhorn.block(c, n, plan.ctas)
            f[r0:r1] = half(rows[r0 * ldm: r1 * ldm], r1 - r0, m, ldm, plan.pass_rows, gs,
                            -math.log(n))
        fs = [v * inv for v in f]
        g = [None] * m
        for c in range(plan.ctas):
            c0, c1 = sinkhorn.block(c, m, plan.ctas)
            g[c0:c1] = half(cols[c0 * ldn: c1 * ldn], c1 - c0, n, ldn, plan.pass_cols, fs,
                            -math.log(m))
    fs = torch.tensor([v * inv for v in f], dtype=torch.float64)
    gs = torch.tensor([v * inv for v in g], dtype=torch.float64)
    return torch.exp((mk + fs[:, None]) + gs[None, :])


#: ragged costs for the schedule model: lines shorter than a warp, shorter
#: and longer than a CTA's 512 threads, more CTAs than lines
RAGGED_SHAPES = ((5, 3), (31, 45), (45, 31), (3, 530), (530, 3))


@pytest.mark.parametrize("iters", [0, 1, 3])
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("ctas", [1, 4, 132])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_pass_model_is_the_twin(shape, ctas, streaming, iters):
    """Bitwise: the redesigned schedule on the H100's plan for the cost
    (resident or forced to stream) gives the twin's plan."""
    cost = torch.as_tensor(feature_cost(*shape, seed=sum(shape)))
    plan = sinkhorn.launch_plan(*shape, H100_SMS, H100_SMEM, ctas=ctas, streaming=streaming)
    assert torch.equal(pass_model(cost, iters, 0.1, plan),
                       sinkhorn.sinkhorn_log_torch(cost, iters, 0.1))


@pytest.mark.parametrize("ctas", [1, 4])
@pytest.mark.parametrize("depth", [3, 4])
@pytest.mark.parametrize("pass_max", [1, 2, 3])
def test_pass_model_ring(pass_max, depth, ctas):
    """Streaming through rings of 3 and 4 passes of 1 to 3 lines, many
    passes a half step: every copy lands in a slot already added up, the
    overlapped parts touch distinct buffers, and the plan stays the twin's."""
    cost = torch.as_tensor(feature_cost(45, 31, seed=7))
    plan = sinkhorn.launch_plan(45, 31, H100_SMS, H100_SMEM, ctas=ctas, streaming=True,
                                depth=depth, pass_max=pass_max)
    assert (plan.pass_rows, plan.pass_cols, plan.depth) == (pass_max, pass_max, depth)
    assert torch.equal(pass_model(cost, 3, 0.1, plan),
                       sinkhorn.sinkhorn_log_torch(cost, 3, 0.1))


def test_a_ring_of_two_passes_is_refused():
    """Pass p + 1's maxima are read while pass p's exps and pass p - 1's
    adds hold two other slots, so a ring of 2 would read pass p + 1 before
    its copy is issued (the model's schedule check fails); launch_plan
    refuses it, as sinkhorn.cu's static_assert does."""
    import dataclasses

    cost = torch.as_tensor(feature_cost(45, 31, seed=7))
    plan = sinkhorn.launch_plan(45, 31, H100_SMS, H100_SMEM, ctas=4, streaming=True,
                                depth=3, pass_max=2)
    with pytest.raises(AssertionError):
        pass_model(cost, 1, 0.1, dataclasses.replace(plan, depth=2))
    with pytest.raises(ValueError, match="ring of 2"):
        sinkhorn.launch_plan(45, 31, H100_SMS, H100_SMEM, depth=2)
    assert "static_assert(RING >= 3" in (CSRC / "sinkhorn.cu").read_text()


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("threads", [256, 1024])
def test_pass_model_threads(threads, streaming):
    """Plans for other THREADS (launch_plan's threads=; up to THREADS / 32
    lines a pass) keep the twin's bits."""
    cost = torch.as_tensor(feature_cost(31, 45, seed=11))
    plan = sinkhorn.launch_plan(31, 45, H100_SMS, H100_SMEM, ctas=2, streaming=streaming,
                                threads=threads)
    assert max(plan.pass_rows, plan.pass_cols) <= threads // 32
    assert torch.equal(pass_model(cost, 2, 0.1, plan, threads=threads),
                       sinkhorn.sinkhorn_log_torch(cost, 2, 0.1))


def test_twin_without_steps_is_the_prior():
    cost = torch.as_tensor(feature_cost(9, 5, seed=1))
    assert torch.equal(sinkhorn.sinkhorn_log_torch(cost, 0, 0.5), torch.exp((-cost) * 2.0))


def work_bytes(n: int, m: int, plan) -> int:
    """Shared memory of a plan past f, g, the resident blocks, the maxima
    and the mbarriers: the ring (streaming; nothing when resident)."""
    if plan.resident:
        return 0
    return 8 * plan.depth * max(plan.pass_rows * sinkhorn.padded(m),
                                plan.pass_cols * sinkhorn.padded(n))


def header_bytes(plan) -> int:
    """Three passes' segment maxima (a key of 8 bytes a warp each) and the
    ring's mbarriers."""
    return 8 * (3 * (sinkhorn.SINKHORN_THREADS // sinkhorn.WARP) + plan.depth)


@pytest.mark.parametrize("shape,resident,smem", [(DEFAULT_SHAPE, True, 77712),
                                                 (SIX_X_SHAPE, False, 53384),
                                                 (SIX_X_2000, False, 56392)])
def test_launch_plan_on_the_h100(shape, resident, smem):
    """One CTA an SM; `smem` is f and g and, resident, the 7 rows and 5
    columns of mk a CTA holds at the defaults (77,712 B); beside them the
    ring (the 6x bus streams), the maxima and the mbarriers."""
    plan = sinkhorn.launch_plan(*shape, H100_SMS, H100_SMEM)
    assert plan.ctas == H100_SMS * sinkhorn.SINKHORN_CTAS_PER_SM
    assert plan.resident == resident
    assert plan.smem == smem + header_bytes(plan) + work_bytes(*shape, plan)
    assert plan.smem <= H100_SMEM


@pytest.mark.parametrize("shape,ctas,streaming,passes,smem,staged",
                         [(DEFAULT_SHAPE, 132, False, (0, 0), 78120, 0),
                          (DEFAULT_SHAPE, 66, False, (0, 0), 139680, 0),
                          (DEFAULT_SHAPE, 132, True, (7, 5), 112560, 7867200),
                          (SIX_X_SHAPE, 132, False, (4, 1), 209696, 131206208)],
                         ids=["defaults", "defaults-66", "defaults-streaming", "6x"])
def test_launch_plan_passes_and_ring(shape, ctas, streaming, passes, smem, staged):
    """The passes, ring and staged bytes on the H100: resident at the
    defaults (a CTA's 7 rows and 5 columns, a warp a line, no passes) and on
    66 CTAs (13 rows and 10 columns); streaming, a ring of 3 passes that
    takes as many lines as fit beside f and g (the defaults: all 7 rows or 5
    columns; the 6x bus: 4 rows of 1,624 or one column of 5,050), and every
    line of mk and mkT copied once a step (8 (n m' + m n') bytes, m' and n'
    padded to even: 131.2 MB at the 6x bus)."""
    plan = sinkhorn.launch_plan(*shape, H100_SMS, H100_SMEM, ctas=ctas, streaming=streaming)
    n, m = shape
    assert plan.depth == sinkhorn.SINKHORN_RING == 3
    assert plan.resident == (staged == 0)
    assert (plan.pass_rows, plan.pass_cols) == passes
    assert (plan.smem, plan.staged) == (smem, staged)
    assert plan.staged == (0 if plan.resident else
                           8 * (n * sinkhorn.padded(m) + m * sinkhorn.padded(n)))
    if not plan.resident:
        # another line a pass would not fit
        ring = H100_SMEM - 8 * (n + m) - header_bytes(plan)
        assert ((plan.pass_rows + 1) * sinkhorn.padded(m) * 8 * plan.depth > ring
                or plan.pass_rows == plan.row_block)
        assert ((plan.pass_cols + 1) * sinkhorn.padded(n) * 8 * plan.depth > ring
                or plan.pass_cols == plan.col_block)


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
    warps = sinkhorn.SINKHORN_THREADS // sinkhorn.WARP
    if plan.resident:
        assert (plan.pass_rows, plan.pass_cols) == (0, 0)
    else:
        assert 1 <= plan.pass_rows <= min(plan.row_block, warps)
        assert 1 <= plan.pass_cols <= min(plan.col_block, warps)
    if plan.resident:
        assert plan.smem == (8 * (n + m + plan.row_block * m + plan.col_block * n)
                             + header_bytes(plan) + work_bytes(n, m, plan))
        assert plan.staged == 0
    else:
        assert plan.smem == 8 * (n + m) + header_bytes(plan) + work_bytes(n, m, plan)
        assert plan.staged == 8 * (n * sinkhorn.padded(m) + m * sinkhorn.padded(n))
    assert plan.smem <= H100_SMEM


def test_launch_plan_streams_when_asked_and_refuses_what_cannot_fit():
    plan = sinkhorn.launch_plan(*DEFAULT_SHAPE, H100_SMS, H100_SMEM, streaming=True)
    assert not plan.resident
    assert plan.smem == 8 * sum(DEFAULT_SHAPE) + header_bytes(plan) + work_bytes(*DEFAULT_SHAPE,
                                                                                plan)
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
    """The ctypes argument list has as many types as the extern "C" launch
    has parameters (test_python_mirror_equals_the_csrc_constant compares the
    mirrors of CTAS_PER_SM, THREADS and RING); the source has one loop, with
    no build-time cut of a half step (STOP) and no clock trace (TRACE)."""
    src = (CSRC / "sinkhorn.cu").read_text()
    assert _launch.LIBRARY.get("sinkhorn", "sinkhorn") == "sinkhorn"
    m = re.search(r'extern "C" int sinkhorn_launch\(([^)]*)\)', src)
    assert m
    assert len(m.group(1).split(",")) == len(_launch.ARGTYPES["sinkhorn"])
    assert re.findall(r'extern "C" int (\w+)\(', src) == [
        "sinkhorn_limits", "sinkhorn_occupancy", "sinkhorn_launch"]
    for query, arity in (("sinkhorn_limits", 2), ("sinkhorn_occupancy", 3)):
        m = re.search(rf'extern "C" int {query}\(([^)]*)\)', src)
        assert m and len(m.group(1).split(",")) == arity, query
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["WARP"]) == sinkhorn.WARP
    assert "STOP" not in consts and "TRACE" not in consts
    assert int(consts["UNROLL"]) >= 1
