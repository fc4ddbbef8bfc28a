"""The slot reductions (``ntpoly_tpu_torch/ops/reduce.py``): the dot and
trace of block-ELL slots, plain and compensated.

On the CPU the wrappers run their plain versions; these are held to a
float64 dense reference over slot patterns with holes, EMPTY slots in
any place, ids that one operand holds alone, an all-EMPTY matrix and a
block row without its diagonal block, at K 1 to 9, bs 8 and 128, in
float32 and float64.  The tests marked ``card`` hold the kernels
(``csrc/reduce.cu``) to their plain versions on an NVIDIA card and skip
without one; they import no JAX, so the card's machine runs them
without the suite's conftest:

    python -m pytest --noconftest -m card -q tests/test_torch_reduce.py
"""
import math

import numpy as np
import pytest
import torch

from _torch_port import card  # noqa: F401  (the tests of the card)
from ntpoly_tpu_torch.ops import _cuda
from ntpoly_tpu_torch.ops import reduce as red
from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.utils import trace

torch.set_num_threads(1)

EMPTY = 2**30
DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}
KS = range(1, 10)


def slots(rng, rows, k, nbc, bs, dtype, *, holes=0.3, keep=None,
          drop=None):
    """Block-ELL (numpy) [rows, k]: each row a random number of
    ascending unique col ids in [0, nbc), holes punched anywhere (slot 0
    included), EMPTY blocks zero.  ``keep[r]``: an id row r must hold;
    ``drop[r]``: an id row r must not hold."""
    cols = np.full((rows, k), EMPTY, np.int64)
    for r in range(rows):
        pool = [c for c in range(nbc) if drop is None or c != drop[r]]
        want = [] if keep is None or keep[r] is None else [keep[r]]
        pool = [c for c in pool if c not in want]
        n = int(rng.integers(0, k + 1 - len(want)))
        ids = sorted(want + list(rng.choice(pool, min(n, len(pool)),
                                            replace=False)))
        cols[r, :len(ids)] = ids
    hit = rng.random((rows, k)) < holes
    if keep is not None:
        hit &= ~(cols == np.asarray([-1 if x is None else x
                                     for x in keep])[:, None])
    cols = np.where(hit, EMPTY, cols)
    blocks = rng.standard_normal((rows, k, bs, bs)).astype(dtype)
    blocks[cols == EMPTY] = 0
    return cols.astype(np.int32), blocks


def dense_dot(a, b):
    """(exactly rounded sum of the rounded products, sum of |products|,
    count of products) of the slots A and B share."""
    (ac, ab), (bc, bb) = a, b
    parts = []
    for r in range(ac.shape[0]):
        for s, cid in enumerate(ac[r]):
            if cid == EMPTY:
                continue
            for t, bid in enumerate(bc[r]):
                if bid == cid:
                    parts.append((ab[r, s] * bb[r, t]).astype(np.float64)
                                 .ravel())
    x = np.concatenate(parts) if parts else np.zeros(0)
    return math.fsum(x), float(np.abs(x).sum()), max(x.size, 1)


def dense_trace(a, row_offset):
    cols, blocks = a
    parts = []
    for r in range(cols.shape[0]):
        for s, cid in enumerate(cols[r]):
            if cid == row_offset + r:
                parts.append(np.diagonal(blocks[r, s]).astype(np.float64))
    x = np.concatenate(parts) if parts else np.zeros(0)
    return math.fsum(x), float(np.abs(x).sum()), max(x.size, 1)


def t(x, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def held(got, want, mag, n, np_dtype, compensated):
    """A reduction's result against the dense reference: a pair's hi + lo
    within the n eps^2 bound, a plain value within the float summation
    bound n eps (both relative to the sum of magnitudes)."""
    eps = float(np.finfo(np_dtype).eps)
    if compensated:
        assert got.shape == (2,)
        value = float(got[0]) + float(got[1])
        assert abs(value - want) <= n * eps**2 * mag + 1e-300, (value, want)
    else:
        assert got.shape == ()
        assert abs(float(got) - want) <= n * eps * mag + 1e-300, \
            (float(got), want)


def dot_operands(rng, k, bs, np_dtype, rows):
    kb = (k * 5) % 9 + 1
    nbc = max(k, kb) + 2
    return (slots(rng, rows, k, nbc, bs, np_dtype),
            slots(rng, rows, kb, nbc, bs, np_dtype))


def trace_operand(rng, k, bs, np_dtype, rows, row_offset):
    """Slots where most rows hold their diagonal block, row 1 does not
    (and with K 1 row 0 keeps it)."""
    keep = [row_offset + r if r != 1 else None for r in range(rows)]
    drop = [None if r != 1 else row_offset + 1 for r in range(rows)]
    return slots(rng, rows, k, rows + row_offset + 2, bs, np_dtype,
                 keep=keep, drop=drop)


# ----------------------------------------------------------------------------
# CPU: the plain versions through the wrappers
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bs", [8, 128])
@pytest.mark.parametrize("k", KS)
def test_slot_dot_plain(k, bs, dt):
    np_dtype, _ = DTYPES[dt]
    rng = np.random.default_rng(100 * k + bs)
    a, b = dot_operands(rng, k, bs, np_dtype, 7 if bs == 8 else 3)
    want, mag, n = dense_dot(a, b)
    before = trace.snapshot()["reductions"]
    for compensated in (False, True):
        got = red.slot_dot(t(a[0]), t(a[1]), t(b[0]), t(b[1]),
                           compensated=compensated)
        held(got, want, mag, n, np_dtype, compensated)
    assert trace.snapshot()["reductions"] == before


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bs", [8, 128])
@pytest.mark.parametrize("k", KS)
def test_slot_trace_plain(k, bs, dt):
    np_dtype, _ = DTYPES[dt]
    rng = np.random.default_rng(200 * k + bs)
    row_offset = 5
    a = trace_operand(rng, k, bs, np_dtype, 7 if bs == 8 else 3, row_offset)
    assert (a[0][1] != row_offset + 1).all()
    want, mag, n = dense_trace(a, row_offset)
    before = trace.snapshot()["reductions"]
    for compensated in (False, True):
        got = red.slot_trace(t(a[0]), t(a[1]), row_offset,
                             compensated=compensated)
        held(got, want, mag, n, np_dtype, compensated)
    assert trace.snapshot()["reductions"] == before


@pytest.mark.parametrize("dt", DTYPES)
def test_all_empty_and_same_operand(dt):
    """An all-EMPTY matrix reduces to zeros; A with itself (one tensor)
    to the sum of squares of its occupied slots."""
    np_dtype, torch_dtype = DTYPES[dt]
    cols = torch.full((1, 4, 3), EMPTY, dtype=torch.int32)
    blocks = torch.zeros((1, 4, 3, 8, 8), dtype=torch_dtype)
    assert float(red.slot_dot(cols, blocks, cols, blocks,
                              compensated=False)) == 0.0
    assert red.slot_dot(cols, blocks, cols, blocks,
                        compensated=True).tolist() == [0.0, 0.0]
    assert red.slot_trace(cols, blocks, 2, compensated=True).tolist() \
        == [0.0, 0.0]
    rng = np.random.default_rng(5)
    a = slots(rng, 6, 4, 8, 8, np_dtype)
    want, mag, n = dense_dot(a, a)
    ac, ab = t(a[0]), t(a[1])
    for compensated in (False, True):
        held(red.slot_dot(ac, ab, ac, ab, compensated=compensated), want,
             mag, n, np_dtype, compensated)


def test_algebra_routes_by_eligibility(monkeypatch):
    """``alg.dot``, ``trace`` and their pairs reduce through the wrappers
    for every dtype and block size, and the route is the wrappers' own:
    on the CPU the plain versions, and with the card's device predicate
    (``_cuda.on_card`` patched, the launches recorded) a launch for the
    dtypes and block sizes the kernels take and the plain versions for
    complex data and other block sizes."""
    calls, launched = [], []
    for name in ("slot_dot", "slot_trace", "slot_dot_plain",
                 "slot_trace_plain"):
        fn = getattr(red, name)
        monkeypatch.setattr(red, name, lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))
    grid = ProcessGrid(device="cpu")
    rng = np.random.default_rng(3)
    plain = ["slot_trace", "slot_trace_plain", "slot_dot", "slot_dot_plain"]
    for dtype, bs, takes in ((torch.float32, 8, True),
                             (torch.float64, 16, True),
                             (torch.complex128, 8, False),
                             (torch.float64, 4, False)):
        d = rng.standard_normal((32, 32))
        if dtype.is_complex:
            d = d + 1j * rng.standard_normal((32, 32))
        m = PM.from_dense(torch.from_numpy(d).to(dtype), bs=bs, grid=grid)
        calls.clear()
        tr, dt_ = alg.trace(m), alg.dot(m, m)
        alg.trace_pair(m), alg.dot_pair(m, m)
        assert calls == plain * 2
        dense = torch.from_numpy(d).to(dtype)
        assert abs(complex(tr) - complex(dense.diagonal().sum())) < 1e-4
        want = (dense.conj() * dense).sum()
        assert abs(complex(dt_) - complex(want)) < 1e-3
        with monkeypatch.context() as card_route:
            card_route.setattr(_cuda, "on_card", lambda x: True)
            card_route.setattr(_cuda, "launch", lambda entry, group, key,
                               *args: launched.append(key))
            card_route.setattr(red, "_max_grid", lambda device: 4)
            calls.clear()
            launched.clear()
            alg.trace(m), alg.dot(m, m)
            alg.trace_pair(m), alg.dot_pair(m, m)
        if takes:
            assert calls == ["slot_trace", "slot_dot"] * 2
            assert launched == ["slot_trace", "slot_dot", "slot_trace_pair",
                                "slot_dot_pair"]
        else:
            assert calls == plain * 2 and launched == []


@pytest.mark.parametrize("dt", DTYPES)
def test_algebra_plain_sums_keep_the_dtype_on_the_cpu(dt):
    """Where the plain versions run, ``alg.dot`` and ``alg.trace`` are
    the reference's sums in the matrices' dtype."""
    _, torch_dtype = DTYPES[dt]
    rng = np.random.default_rng(8)
    d = torch.from_numpy(rng.standard_normal((40, 40))).to(torch_dtype)
    m = PM.from_dense(d, bs=8, grid=ProcessGrid(device="cpu"))
    assert alg.dot(m, m).dtype == torch_dtype
    assert alg.trace(m).dtype == torch_dtype


# ----------------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------------

def _all_tensors(ac, ab, bc, bb, row_offset=0):
    """(dot, dot pair, trace, trace pair) of A (and B)."""
    return (red.slot_dot(ac, ab, bc, bb, compensated=False),
            red.slot_dot(ac, ab, bc, bb, compensated=True),
            red.slot_trace(ac, ab, row_offset, compensated=False),
            red.slot_trace(ac, ab, row_offset, compensated=True))


def _all(a, b, row_offset, device):
    """:func:`_all_tensors` of numpy slots A and B on ``device``."""
    return _all_tensors(*(t(x, device) for x in (*a, *b)), row_offset)


CARD_CASES = [(1, 1, 8), (3, 5, 24), (5, 3, 128), (5, 5, 128), (9, 4, 64),
              (40, 37, 8)]


@pytest.mark.card
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("ka,kb,bs", CARD_CASES)
def test_card_kernel_against_plain(card, ka, kb, bs, dt):
    np_dtype, _ = DTYPES[dt]
    rng = np.random.default_rng(ka * 1000 + kb * 10 + bs)
    rows, row_offset = 37, 3
    nbc = rows + row_offset + 2
    keep = [row_offset + r if r % 7 else None for r in range(rows)]
    a = slots(rng, rows, ka, nbc, bs, np_dtype, keep=keep)
    b = slots(rng, rows, kb, nbc, bs, np_dtype)
    eps = float(np.finfo(np_dtype).eps)
    before = dict(red.reductions)
    got = _all(a, b, row_offset, card)
    assert {k: red.reductions[k] - before[k] for k in before} == dict.fromkeys(
        before, 1)
    plain = _all(a, b, row_offset, "cpu")
    refs = [dense_dot(a, b)] * 2 + [dense_trace(a, row_offset)] * 2
    for i, (g, p, (want, mag, n)) in enumerate(zip(got, plain, refs)):
        g = g.cpu()
        held(g, want, mag, n, np_dtype, i % 2 == 1)
        if i % 2:
            gap = abs(float(g.double().sum()) - float(p.double().sum()))
            assert gap <= 2 * n * eps**2 * mag + 1e-300
            # the kernel's hi is the pair's sum rounded to the dtype
            assert (g[0] + g[1]).item() == g[0].item()
        else:
            assert abs(float(g) - float(p)) <= 2 * n * eps * mag + 1e-300
            # the value of the kernel's pair in float64, within the
            # pairs' bound of the exact sum
            pair = got[i + 1].cpu()
            assert g.dtype == torch.float64
            assert g.item() == pair[0].item() + pair[1].item()
            assert abs(float(g) - want) <= (n * eps**2 * mag
                                            + 2.0**-53 * abs(want) + 1e-300)


@pytest.mark.card
@pytest.mark.parametrize("dt", DTYPES)
def test_card_bits_repeat_and_graph(card, dt):
    """Three runs give the same bits, and so does a CUDA graph's replay;
    the counter counts each replay's launches; A with itself (one
    tensor, its blocks read once) gives the bits of A with a copy."""
    from ntpoly_tpu_torch.solvers import common
    np_dtype, _ = DTYPES[dt]
    rng = np.random.default_rng(11)
    a = slots(rng, 300, 5, 320, 128, np_dtype, holes=0.1,
              keep=list(range(300)))
    b = slots(rng, 300, 3, 320, 128, np_dtype, holes=0.1)
    runs = [torch.cat([x.double().reshape(-1) for x in
                       _all(a, b, 0, card)]) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    ac, ab = t(a[0], card), t(a[1], card)
    same = red.slot_dot(ac, ab, ac, ab, compensated=True)
    copy = red.slot_dot(ac, ab, ac.clone(), ab.clone(), compensated=True)
    assert torch.equal(same, copy)
    # a capacity trim's view (rows strided past unused slots)
    wide = torch.cat([ab, torch.zeros_like(ab)], dim=1)
    wc = torch.cat([ac, torch.full_like(ac, EMPTY)], dim=1)
    assert torch.equal(
        red.slot_dot(wc[:, :5], wide[:, :5], ac, ab, compensated=True),
        same)

    def run(c, k, n):
        return _all_tensors(*c)

    carry = tuple(t(x, card) for x in (*a, *b))
    eager = _all_tensors(*carry)
    before = dict(red.reductions)
    graph = common._Graph(run, carry, (), 1, "reduce")
    assert dict(red.reductions) == {
        k: v + 1 for k, v in before.items()}      # the warm-up step only
    for _ in range(3):
        out = graph(carry)
        assert all(torch.equal(x, y) for x, y in zip(out, eager))
    assert dict(red.reductions) == {k: v + 4 for k, v in before.items()}



@pytest.mark.card
@pytest.mark.parametrize("dt", DTYPES)
def test_card_plain_sums_are_the_pair_value(card, dt):
    """On the card ``alg.dot`` and ``alg.trace`` of real matrices are
    float64: the value hi + lo of ``dot_pair`` and ``trace_pair``."""
    _, torch_dtype = DTYPES[dt]
    rng = np.random.default_rng(9)
    d = torch.from_numpy(rng.standard_normal((64, 64))).to(torch_dtype)
    m = PM.from_dense(d, bs=8, grid=ProcessGrid(device="cuda"))
    for plain, pair in ((alg.dot(m, m), alg.dot_pair(m, m)),
                        (alg.trace(m), alg.trace_pair(m))):
        assert plain.dtype == torch.float64 and pair.dtype == torch_dtype
        hi, lo = pair.tolist()
        assert plain.item() == hi + lo


@pytest.mark.card
def test_card_energy_in_the_matrices_dtype(card):
    """A density solver's plain energy on the card is the float64 dot
    rounded to float32 for float32 matrices (the energy metric's
    quantity), the compensated one the pair's value."""
    from ntpoly_tpu_torch.solvers import density
    rng = np.random.default_rng(10)
    d = torch.from_numpy(rng.standard_normal((64, 64))).to(torch.float32)
    x = PM.from_dense(d, bs=8, grid=ProcessGrid(device="cuda"))
    w = PM.from_dense(d.T.contiguous(), bs=8, grid=ProcessGrid(device="cuda"))
    exact = alg.dot(x, w)
    assert exact.dtype == torch.float64
    assert density._step_energy(x, w, False) == float(exact.float())
    assert density._step_energy(x, w, True) == float(exact)
    (plain,) = density._chunk_energy(x, w, False)
    assert plain.dtype == torch.float32
    assert float(plain) == float(exact.float())


@pytest.mark.card
def test_card_routes_and_refusals(card):
    """A complex CUDA matrix reduces through the plain versions and
    launches nothing; so do the wrappers on a real dtype or block size
    the kernels do not take, with the plain versions' results.  An input
    of a kind the kernels take but at fault raises: int64 col ids, A and
    B of rows that do not match."""
    grid = ProcessGrid(device="cuda")
    rng = np.random.default_rng(2)
    d = rng.standard_normal((32, 32)) + 1j * rng.standard_normal((32, 32))
    m = PM.from_dense(torch.from_numpy(d), bs=8, grid=grid)
    before = dict(red.reductions)
    got = alg.dot(m, m)
    assert abs(complex(got) - float((np.abs(d) ** 2).sum())) < 1e-9
    assert abs(complex(alg.trace(m)) - complex(np.trace(d))) < 1e-9
    alg.dot_pair(m, m), alg.trace_pair(m)
    assert dict(red.reductions) == before
    cols = torch.zeros((1, 4, 1), dtype=torch.int32, device=card)
    for dtype, bs in ((torch.float32, 4), (torch.float16, 8),
                      (torch.complex64, 8)):
        blocks = torch.randn((1, 4, 1, bs, bs), device=card).to(dtype)
        for compensated in (False, True):
            assert torch.equal(
                red.slot_dot(cols, blocks, cols, blocks,
                             compensated=compensated),
                red.slot_dot_plain(cols, blocks, cols, blocks,
                                   compensated=compensated))
            assert torch.equal(
                red.slot_trace(cols, blocks, 0, compensated=compensated),
                red.slot_trace_plain(cols, blocks, 0,
                                     compensated=compensated))
    blocks = torch.ones((1, 4, 1, 8, 8), device=card)
    with pytest.raises(TypeError, match="int32"):
        red.slot_trace(cols.long(), blocks, 0, compensated=True)
    with pytest.raises(ValueError, match="do not match"):
        red.slot_dot(cols, blocks, cols[:, :2], blocks[:, :2],
                     compensated=False)
    assert dict(red.reductions) == before
