"""The k-way merge of block-ELL operands (``ops/merge.py``).

On the CPU the wrapper runs its plain version, ``bell.add_n``; both are
held to a numpy model of the merge's semantics (the candidates every
operand's slots side by side, output slot j the j-th smallest distinct
id, the lowest kept on overflow, each block the sum of the rounded
coefficient times each candidate block of its id in candidate order
from +0, the flush, a slot EMPTY in place where its flushed block has no
L1 norm > 0), which is also the kernel's algorithm: slots and col ids
exactly, blocks bit for bit where a slot has one contribution and within
a few ulp of the float64 sum where it has more (the plain one-hot
product sums in its own order).  The inputs: 2 and 3 operands, W below,
at and above k_out and W > 32, overflow, ids held by every operand and
by one alone, holes, a nonzero block under EMPTY, thresholds 0 and 1e-3
with entries exactly at the float32 threshold, -0.0, float32 and
float64, bs 8, 32 and 128; a zero coefficient, trimmed operand views
and the stats on their own; ``departures``, the check of a kernel's
merge against ``bell.add_n`` on the same tensors, against the model and
planted faults.  The tests marked ``card`` hold the kernel
(``csrc/merge.cu``) to the model bit for bit and to ``bell.add_n``
within the two departures its wrapper states, on the same cases, with
device-scalar coefficients, in a CUDA graph, on inputs of a kind it
does not take (the plain version) and inputs at fault (they raise) and
at the flagship's shape, and skip without a card; they import no JAX,
so the card's machine runs them without the suite's conftest:

    python -m pytest --noconftest -m card -q -s tests/test_torch_merge.py
"""
import numpy as np
import pytest
import torch

from _torch_port import card  # noqa: F401  (the tests of the card)
from ntpoly_tpu_torch.core import bell
from ntpoly_tpu_torch.ops import _cuda
from ntpoly_tpu_torch.ops import merge as mrg
from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid

torch.set_num_threads(1)

EMPTY = 2**30
DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}
# (operand widths, k_out): W below, at and above k_out, overflow, and
# more than a warp's 32 candidates
SHAPES = {"two_below": ((2, 2), 5), "three_at": ((2, 2, 1), 5),
          "three_above": ((5, 5, 1), 5), "two_overflow": ((6, 6), 3),
          "three_wide": ((16, 16, 8), 24)}
# operand 0's coefficient is a power of two, so that its planted entries
# land exactly on the threshold
COEFFS = {2: (0.5, -1.3), 3: (0.5, -2.63, 0.37)}
CASES = [(shape, thr, dt, bs) for shape in SHAPES for thr in (0.0, 1e-3)
         for dt in DTYPES for bs in (8, 32, 128)]
IDS = [f"{s}-thr{t:g}-{d}-bs{b}" for s, t, d, b in CASES]


def planted(shape, threshold, dt, bs, seed=0):
    """Operands (numpy lists of [rows, m_i] col ids and [rows, m_i, bs,
    bs] blocks) with every case of the merge's contract planted: row 0
    one id list for every operand (each slot summed over all), row 1
    disjoint ids (every slot one contribution), row 2 operand 0's first
    two slots under the row's lowest ids (0, 1), which no other operand
    holds, one block wholly at or within the threshold once scaled and
    one entry exactly at it, row 3 -0.0 entries and an all -0.0 block
    under such ids (2, 3), row 4 holes and a nonzero block under EMPTY;
    the other rows random ids from 10 on out of a pool that the operands
    share, with holes."""
    widths, _ = SHAPES[shape]
    npdt = DTYPES[dt][0]
    rng = np.random.default_rng(seed)
    rows = 6 if bs == 128 else 10
    pool = max(sum(widths), 8)
    t32 = float(npdt(threshold))
    cols, blocks = [], []
    for i, m in enumerate(widths):
        c = np.stack([np.sort(rng.choice(pool, m, replace=False)) + 10
                      for _ in range(rows)])
        c[0] = np.arange(m) * 2
        c[1] = 100 * (i + 1) + np.arange(m)
        scale = rng.uniform(0.1, 2.0, (rows, m, 1, 1))
        b = (rng.standard_normal((rows, m, bs, bs)) * scale).astype(npdt)
        holes = rng.random((rows, m)) < 0.2
        holes[:4] = False
        c[holes] = EMPTY
        b[holes] = 0
        cols.append(c)
        blocks.append(b)
    c0, b0 = cols[0], blocks[0]
    c0[2, :2] = [0, 1]
    b0[2, 0] = np.where(rng.random((bs, bs)) < 0.5, 2 * t32, -t32)
    b0[2, 1, 0, 0] = 2 * t32
    b0[2, 1, 0, 1] = -2 * t32
    c0[3, 0] = 2
    b0[3, 0, 0, :3] = -0.0
    cols[1][3, 0] = 3
    blocks[1][3, 0] = -0.0
    c0[4, 0] = EMPTY
    b0[4, 0] = 0
    cols[1][4, 0] = EMPTY
    blocks[1][4, 0] = 1.0
    return ([c.astype(np.int32) for c in cols], blocks)


def model(cols, blocks, coeffs, k_out, threshold):
    """The merge in numpy, slot by slot, in candidate order from +0 ->
    (col ids, blocks [rows, k_out], contributions [rows, k_out], the
    float64 sums, their sums of |product|, fill [rows], used [rows])."""
    npdt = blocks[0].dtype.type
    t = npdt(threshold)
    rows, bs = cols[0].shape[0], blocks[0].shape[-1]
    cands = [(i, s) for i, c in enumerate(cols) for s in range(c.shape[1])]
    oc = np.full((rows, k_out), EMPTY, np.int32)
    ob = np.zeros((rows, k_out, bs, bs), npdt)
    exact = np.zeros((rows, k_out, bs, bs))
    mag = np.zeros((rows, k_out, bs, bs))
    parts = np.zeros((rows, k_out), np.int64)
    fill = np.zeros(rows, np.int32)
    used = np.zeros(rows, np.int32)
    for r in range(rows):
        ids = [int(cols[i][r, s]) for i, s in cands]
        distinct = sorted({x for x in ids if x != EMPTY})
        fill[r] = len(distinct)
        for j, x in enumerate(distinct[:k_out]):
            acc = np.zeros((bs, bs), npdt)
            for (i, s), y in zip(cands, ids):
                if y != x:
                    continue
                p = blocks[i][r, s] * npdt(coeffs[i])
                acc = acc + p
                exact[r, j] += p
                mag[r, j] += np.abs(p)
                parts[r, j] += 1
            with np.errstate(invalid="ignore"):
                acc = np.where((acc <= t) & (acc >= -t), npdt(0), acc)
            ob[r, j] = acc
            if not np.isnan(acc).any() and (acc != 0).any():
                oc[r, j] = x
                used[r] = j + 1
    return oc, ob, parts, exact, mag, fill, used


def bits(x):
    """The raw bits of a float tensor or array, for comparisons that tell
    -0.0 from +0.0 and hold NaN equal to itself."""
    x = torch.as_tensor(x).contiguous()
    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def one_nan(x):
    """``x`` with every NaN the card's canonical NaN (0x7fffffff in
    float32, 0x7fffffffffffffff in float64)."""
    ints = torch.int32 if x.element_size() == 4 else torch.int64
    nan = torch.tensor(torch.iinfo(ints).max, dtype=ints).view(x.dtype)
    return torch.where(torch.isnan(x), nan.to(x.device), x)


def same_bits(a, b) -> bool:
    (ac, ab), (bc, bb) = a, b
    return (torch.equal(torch.as_tensor(ac).cpu(), torch.as_tensor(bc).cpu())
            and torch.equal(bits(ab).cpu(), bits(bb).cpu()))


def _near(want, threshold, ulps):
    """[rows, k_out, bs, bs]: entries summed from two or more
    contributions within ``ulps`` roundings (of their sum of |product|)
    of the threshold."""
    _, ob, parts, exact, mag, _, _ = want
    eps = np.finfo(ob.dtype).eps
    return (np.abs(np.abs(exact) - threshold) <= ulps * eps * mag) \
        & (parts[..., None, None] > 1)


def near_threshold(want, threshold, ulps=4) -> np.ndarray:
    """Block rows with an entry of :func:`_near`: where two orders of
    the sum may flush it otherwise, so the only rows where the kernel's
    slots may differ from the plain version's."""
    near = _near(want, threshold, ulps)
    return np.nonzero(near.reshape(near.shape[0], -1).any(-1))[0]


def held(got, want, threshold, ulps=4) -> list:
    """Block rows where ``got`` (col ids, blocks) departs from the model
    ``want`` beyond the sum order: another slot or col id (but in rows
    :func:`near_threshold`), other bits in a slot of one contribution, or
    an entry of a summed slot more than ``ulps`` roundings (of its sum of
    |product|) from the float64 sum (but entries :func:`_near` the
    threshold)."""
    oc, ob, parts, exact, mag, _, _ = want
    gc = torch.as_tensor(got[0]).cpu().numpy()
    gb = torch.as_tensor(got[1]).cpu().numpy()
    eps = np.finfo(ob.dtype).eps
    one = (parts <= 1)[..., None, None]
    same = bits(gb).numpy() == bits(ob).numpy()
    kept = (oc != EMPTY)[..., None, None]
    with np.errstate(invalid="ignore"):
        close = np.abs(gb.astype(np.float64) - np.where(kept, exact, 0)) \
            <= ulps * eps * mag
    near = _near(want, threshold, ulps)
    ok = np.where(one, same, close | same | near)
    bad = ~ok.reshape(ok.shape[0], -1).all(-1)
    excused = set(near_threshold(want, threshold, ulps).tolist())
    bad |= (gc != oc).any(-1) & ~np.isin(np.arange(len(gc)), list(excused))
    return np.nonzero(bad)[0].tolist()


def operands(shape, threshold, dt, bs, device="cpu", seed=0):
    cols, blocks = planted(shape, threshold, dt, bs, seed)
    return ([torch.from_numpy(c).to(device) for c in cols],
            [torch.from_numpy(b).to(device) for b in blocks], cols, blocks)


def plain_stats(cols, out_cols):
    return torch.stack([bell.union_fill_n(cols).amax(),
                        bell.used_slots(out_cols).amax()])


@pytest.mark.parametrize("shape,threshold,dt,bs", CASES, ids=IDS)
def test_cpu_wrapper_is_plain_and_model(shape, threshold, dt, bs):
    """On CPU tensors the wrapper is ``bell.add_n`` bit for bit with its
    stats, counts no launch, and both are the numpy model's slots, and
    its bits but for the order of summed slots."""
    c, b, cols, blocks = operands(shape, threshold, dt, bs)
    k_out = SHAPES[shape][1]
    coeffs = COEFFS[len(c)]
    before = mrg.merges["slot_add_n"]
    got = mrg.slot_add_n(c, b, coeffs, threshold, k_out)
    assert mrg.merges["slot_add_n"] == before
    plain = bell.add_n(c, b, coeffs, threshold=threshold, k_out=k_out)
    assert got[0].shape == (cols[0].shape[0], k_out)
    assert same_bits(got[:2], plain)
    assert torch.equal(got[2], plain_stats(c, plain[0]))
    want = model(cols, blocks, coeffs, k_out, threshold)
    assert held(plain, want, threshold) == []
    assert got[2].tolist() == [want[5].max(), want[6].max()]


def test_cpu_planted_cases_show():
    """The planted rows do what they are for: at 1e-3 the block at the
    threshold is a hole in place and the entries exactly at it flush; an
    all -0.0 block is a hole and -0.0 entries come out +0.0; every slot
    of row 0 sums all three operands and every slot of row 1 has one."""
    c, b, cols, blocks = operands("three_above", 1e-3, "f32", 8)
    oc, ob = bell.add_n(c, b, COEFFS[3], threshold=1e-3, k_out=5)
    want = model(cols, blocks, COEFFS[3], 5, 1e-3)
    assert oc[2, :2].tolist() == [EMPTY, 1]
    assert ob[2, 1, 0, 0] == 0 and ob[2, 1, 0, 1] == 0
    assert oc[3, :2].tolist() == [2, EMPTY]
    assert torch.equal(ob[3, 0, 0, :3], torch.zeros(3))
    assert not (bits(ob[3]) == bits(torch.tensor(-0.0))).any()
    assert (want[2][0] == 3).sum() == 1 and (want[2][0] >= 2).all()
    assert (want[2][1] == 1).all()


def test_cpu_zero_coefficient_enters_the_union():
    """An operand whose coefficient is 0 still takes its slots: ids it
    alone holds rank, come out EMPTY in place, and count in the fill."""
    c, b, cols, blocks = operands("three_above", 0.0, "f32", 8)
    coeffs = (0.0, 1.0, 0.0)
    got = mrg.slot_add_n(c, b, coeffs, 0.0, 5)
    want = model(cols, blocks, coeffs, 5, 0.0)
    assert held(got[:2], want, 0.0) == []
    assert got[2].tolist() == [want[5].max(), want[6].max()]
    union = bell.union_fill_n(c)
    assert (union > (got[0] != EMPTY).sum(-1)).any()
    assert torch.equal(got[2], plain_stats(c, got[0]))


def trimmed(c, b, extra=3):
    """Each operand as a capacity trim's view of a wider one (``extra``
    more slots, EMPTY with zero blocks): rows that are not dense."""
    out_c, out_b = [], []
    for ci, bi in zip(c, b):
        wc, wb = bell.pad_slots(ci, bi, ci.shape[-1] + extra)
        out_c.append(wc[..., :ci.shape[-1]])
        out_b.append(wb[..., :ci.shape[-1], :, :])
    return out_c, out_b


def test_cpu_trimmed_views():
    """Trimmed (non-contiguous) operand views merge to the same bits as
    the dense operands."""
    c, b, _, _ = operands("three_above", 1e-3, "f64", 8)
    tc, tb = trimmed(c, b)
    assert not tb[0].is_contiguous()
    want = mrg.slot_add_n(c, b, COEFFS[3], 1e-3, 5)
    got = mrg.slot_add_n(tc, tb, COEFFS[3], 1e-3, 5)
    assert same_bits(got[:2], want[:2]) and torch.equal(got[2], want[2])


DEPARTURE_CASES = [(shape, thr, dt) for shape in SHAPES
                   for thr in (0.0, 1e-3) for dt in DTYPES]


@pytest.mark.parametrize("shape,threshold,dt", DEPARTURE_CASES,
                         ids=[f"{s}-thr{t:g}-{d}"
                              for s, t, d in DEPARTURE_CASES])
def test_cpu_departures_holds_a_merge_to_add_n(shape, threshold, dt):
    """``departures`` finds no row where a merge is ``add_n`` itself, and
    names as near the threshold the rows the numpy model names; it
    catches another col id in a row that is not near, other bits in a
    slot of one contribution and a summed entry 16 roundings off."""
    c, b, cols, blocks = operands(shape, threshold, dt, 8)
    k_out = SHAPES[shape][1]
    coeffs = COEFFS[len(c)]
    want = bell.add_n(c, b, coeffs, threshold=threshold, k_out=k_out)
    model_out = model(cols, blocks, coeffs, k_out, threshold)
    bad, near, err = mrg.departures(c, b, coeffs, threshold, k_out, want,
                                    want)
    assert bad.tolist() == [] and err == 0.0
    assert near.tolist() == near_threshold(model_out, threshold).tolist()
    oc, ob, parts = model_out[:3]
    one = [(r, j) for r, j in zip(*np.nonzero((parts == 1) & (oc != EMPTY)))
           if r not in near.tolist()]
    summed = [(r, j) for r, j in zip(*np.nonzero((parts > 1)
                                                  & (oc != EMPTY)))
              if r not in near.tolist()]
    faults = [("col", one[0]), ("one", one[0])]
    if summed:
        faults.append(("summed", summed[0]))
    for what, (r, j) in faults:
        gc, gb = want[0].clone(), want[1].clone()
        if what == "col":
            gc[r, j] += 1
        else:
            at = np.unravel_index(int(gb[r, j].abs().argmax()), (8, 8))
            x = gb[(r, j) + at]
            eps = torch.finfo(gb.dtype).eps
            gb[(r, j) + at] = x + (eps * abs(float(x)) if what == "one"
                                   else 16 * eps * model_out[4][(r, j) + at])
        bad, _, err = mrg.departures(c, b, coeffs, threshold, k_out,
                                     (gc, gb), want)
        assert bad.tolist() == [r], what
        assert (err > 0) == (what != "col"), what


def test_increment_n_calls_the_wrapper(monkeypatch):
    """``increment_n`` merges through ``ops/merge.py`` once a call, at
    its capacity, and reads its stats."""
    calls = []
    real = mrg.slot_add_n

    def spy(cols, blocks, coeffs, threshold=0.0, k_out=None):
        calls.append((len(cols), k_out))
        return real(cols, blocks, coeffs, threshold, k_out)

    monkeypatch.setattr(mrg, "slot_add_n", spy)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((96, 96))
    d = np.where(np.abs(np.subtract.outer(np.arange(96), np.arange(96)))
                 < 12, d, 0.0)
    pm = PM.from_dense(d, bs=8, grid=ProcessGrid(device="cpu"))
    out = alg.increment_n((pm, pm, pm), (1.0, -0.5, 2.0))
    assert calls == [(3, pm.k)]
    np.testing.assert_allclose(PM.to_dense(out).numpy(), 2.5 * d,
                               rtol=1e-14, atol=1e-14)


# ----------------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------------

def launched(fn):
    """fn() -> (its result, the kernel launches it counted)."""
    before = mrg.merges["slot_add_n"]
    out = fn()
    return out, mrg.merges["slot_add_n"] - before


@pytest.mark.card
@pytest.mark.parametrize("shape,threshold,dt,bs", CASES, ids=IDS)
def test_card_kernel_is_model_and_plain(card, shape, threshold, dt, bs):
    """The kernel is the model bit for bit and ``bell.add_n`` on the same
    card tensors but for the order of summed slots; its stats are
    ``union_fill_n`` / ``used_slots``'s."""
    c, b, cols, blocks = operands(shape, threshold, dt, bs, card)
    k_out = SHAPES[shape][1]
    coeffs = COEFFS[len(c)]
    got, n = launched(lambda: mrg.slot_add_n(c, b, coeffs, threshold,
                                             k_out))
    assert n == 1
    want = model(cols, blocks, coeffs, k_out, threshold)
    assert same_bits(got[:2], want[:2])
    assert got[2].tolist() == plain_stats(c, got[0]).tolist()
    plain = bell.add_n(c, b, coeffs, threshold=threshold, k_out=k_out)
    assert held(plain, want, threshold) == []


@pytest.mark.card
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_card_device_scalars_and_zero_coefficient(card, dt):
    """Coefficients as float64 0-d tensors on the card are rounded to the
    result dtype as Python numbers are: the same bits; a zero coefficient
    enters the union as in the model."""
    c, b, cols, blocks = operands("three_above", 1e-3, dt, 32, card)
    coeffs = (0.5, 0.0, -2.63)
    on_card = [torch.tensor(a, dtype=torch.float64, device=card)
               for a in coeffs]
    got, n = launched(lambda: mrg.slot_add_n(c, b, on_card, 1e-3, 5))
    assert n == 1
    want = model(cols, blocks, coeffs, 5, 1e-3)
    assert same_bits(got[:2], want[:2])
    assert same_bits(got[:2], mrg.slot_add_n(c, b, coeffs, 1e-3, 5)[:2])


@pytest.mark.card
def test_card_trimmed_views_and_stats(card):
    """Trimmed operand views are read in place, to the dense operands'
    bits and stats."""
    c, b, _, _ = operands("three_wide", 1e-3, "f32", 128, card)
    tc, tb = trimmed(c, b)
    want = mrg.slot_add_n(c, b, COEFFS[3], 1e-3, 24)
    got = mrg.slot_add_n(tc, tb, COEFFS[3], 1e-3, 24)
    assert same_bits(got[:2], want[:2]) and torch.equal(got[2], want[2])
    assert got[2].tolist() == plain_stats(c, got[0]).tolist()


@pytest.mark.card
def test_card_non_finite_stays_in_its_slot(card):
    """A NaN or inf candidate stays in its own slot (the plain one-hot
    product spreads NaN over its row): the kernel is the model's bits; a
    slot holding NaN is EMPTY in place, as its L1 norm is not > 0."""
    c, b, cols, blocks = operands("three_above", 0.0, "f32", 8, card)
    blocks[0][1, 0, 1, 1] = np.nan
    blocks[1][0, 0, 2, 2] = np.inf
    b = [torch.from_numpy(x).to(card) for x in blocks]
    got = mrg.slot_add_n(c, b, COEFFS[3], 0.0, 5)
    want = model(cols, blocks, COEFFS[3], 5, 0.0)
    # the card's NaN is its canonical one, numpy keeps the input's payload
    assert same_bits(got[:2], (want[0], one_nan(torch.from_numpy(want[1]))))
    assert torch.isnan(got[1][1]).sum() == 1 and got[0][1, 0] == EMPTY
    assert torch.isinf(got[1][0]).sum() == 1 and got[0][0, 0] == 0


def replayed_ms(fn, reps: int) -> float:
    """Device milliseconds per replay of a CUDA graph of ``reps`` calls
    of ``fn`` (captured after a warm-up on a side stream), over three
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 3


def eager_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` on the current stream, CUDA
    events around ``reps`` calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def flushed_ms(fn, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn`` in a CUDA graph with the L2
    flushed before each call (a 256 MiB write): the graph of ``reps`` x
    (flush, fn) less the graph of ``reps`` flushes."""
    scrub = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    both = replayed_ms(lambda: (scrub.fill_(1), fn()), reps)
    return (both - replayed_ms(lambda: scrub.fill_(1), reps)) / reps


@pytest.mark.card
def test_card_graph_and_repeat(card):
    """The same bits on every call and in a CUDA graph's replay, with
    device-scalar coefficients computed inside the graph."""
    c, b, _, _ = operands("three_above", 1e-3, "f32", 128, card, seed=5)
    sigma = torch.tensor(0.37, dtype=torch.float64, device=card)

    def merged():
        return mrg.slot_add_n(c, b, (sigma - 3.0, 4.0 - 2.0 * sigma, sigma),
                              1e-3, 5)

    first = merged()
    again = merged()
    assert same_bits(first[:2], again[:2])
    assert torch.equal(first[2], again[2])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        merged()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = merged()
    graph.replay()
    torch.cuda.synchronize()
    assert same_bits(out[:2], first[:2]) and torch.equal(out[2], first[2])


@pytest.mark.card
@pytest.mark.parametrize("what", ["float16", "bs12", "complex64"])
def test_card_ineligible_takes_plain(card, what):
    """Inputs of a kind the kernel does not take are bell.add_n's, stats
    included, and launch nothing: another dtype, a block size that is not
    a multiple of 8, complex blocks."""
    dtype, bs = torch.float16, 8
    if what == "bs12":
        bs, dtype = 12, torch.float32
    elif what == "complex64":
        dtype = torch.complex64
    cols, blocks = card_operands(card, 2, 6, bs, dtype, torch.int32)
    coeffs = (1.0, 0.75)
    got, launches = launched(lambda: mrg.slot_add_n(cols, blocks, coeffs,
                                                    0.0, 5))
    assert launches == 0
    want = bell.add_n(cols, blocks, coeffs, k_out=5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], plain_stats(cols, want[0]))


def card_operands(card, n, m, bs, dtype, ids):
    """``n`` operands of 4 block rows of ``m`` slots on the card."""
    gen = torch.Generator().manual_seed(2)
    cols = [(torch.arange(m, dtype=ids) + i).repeat(4, 1).to(card)
            for i in range(n)]
    blocks = [torch.randn((4, m, bs, bs), generator=gen).to(dtype).to(card)
              for _ in range(n)]
    return cols, blocks


@pytest.mark.card
@pytest.mark.parametrize("what", ["cols_int64", "five_operands"])
def test_card_input_at_fault_raises(card, what):
    """Real float32 blocks at bs 8 take the kernel's route, so int64 col
    ids and five operands are faults there: they raise and launch
    nothing, rather than run the plain version."""
    n, ids, error = 2, torch.int64, TypeError
    if what == "five_operands":
        n, ids, error = 5, torch.int32, ValueError
    cols, blocks = card_operands(card, n, 6, 8, torch.float32, ids)
    before = mrg.merges["slot_add_n"]
    with pytest.raises(error):
        mrg.slot_add_n(cols, blocks, (1.0,) * n, 0.0, 5)
    assert mrg.merges["slot_add_n"] == before


def flagship_operands(device, seed=11):
    """The flagship's three-term merge: X^2 and X of 8192 block rows of 5
    slots (ids r - 2 .. r + 2, EMPTY off the ends and at a few random
    holes), bs 128, float32, blocks decaying away from the diagonal, and
    the identity (one slot, id r)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows, bs = 8192, 128
    r = torch.arange(rows, device=device)[:, None]
    off = torch.arange(-2, 3, device=device)[None, :]
    decay = 1.0 / (1.0 + off.abs()) ** 2
    cols, blocks = [], []
    for _ in range(2):
        ids = r + off
        hole = torch.rand((rows, 5), generator=gen, device=device) < 0.02
        ids = torch.where((ids < 0) | (ids >= rows) | hole, EMPTY, ids)
        b = torch.randn((rows, 5, bs, bs), generator=gen, device=device)
        b *= (decay * (ids != EMPTY))[..., None, None]
        cols.append(ids.to(torch.int32))
        blocks.append(b)
    eye = torch.eye(bs, device=device).expand(rows, 1, bs, bs).contiguous()
    cols.append(r.to(torch.int32))
    blocks.append(eye)
    return cols, blocks


FLAGSHIP_COEFFS = (0.37 - 3.0, 4.0 - 2.0 * 0.37, 0.37)


@pytest.mark.card
def test_card_flagship_shape(card):
    """8192 rows, 5 + 5 + 1 candidates to 5 slots, bs 128, float32,
    threshold 1e-7: the kernel's slots are bell.add_n's but for rows with
    an entry within rounding of the threshold, its blocks bit for bit
    where a slot has one contribution and within a few ulp of the float64
    sum elsewhere (checked on every 64th row and the differing ones)."""
    c, b = flagship_operands(card)
    got, n = launched(lambda: mrg.slot_add_n(c, b, FLAGSHIP_COEFFS, 1e-7,
                                             5))
    assert n == 1
    want = bell.add_n(c, b, FLAGSHIP_COEFFS, threshold=1e-7, k_out=5)
    differ = (got[0] != want[0]).any(-1).nonzero().flatten().tolist()
    rows = sorted(set(range(0, 8192, 64)) | set(differ))
    sub = ([x[rows].cpu().numpy() for x in c],
           [x[rows].cpu().numpy() for x in b])
    model_out = model(*sub, FLAGSHIP_COEFFS, 5, 1e-7)
    assert held((got[0][rows], got[1][rows]), model_out, 1e-7) == []
    assert held((want[0][rows], want[1][rows]), model_out, 1e-7) == []
    bad, near, _ = mrg.departures(c, b, FLAGSHIP_COEFFS, 1e-7, 5, got[:2],
                                  want)
    assert bad.tolist() == [] and set(differ) <= set(near.tolist())
    print(f"flagship merge: {len(differ)} rows' slots differ from "
          f"bell.add_n, {len(near_threshold(model_out, 1e-7))} near the "
          f"threshold among the {len(rows)} held")
    assert got[2].tolist() == plain_stats(c, got[0]).tolist()


@pytest.mark.card
def test_card_flagship_timing(card):
    """The flagship three-term merge timed in a CUDA graph with the L2
    flushed, beside its byte bound (every candidate block read once,
    every output block written once, at 3.35 TB/s) and bell.add_n."""
    c, b = flagship_operands(card)
    rows = c[0].shape[0]
    blk = 128 * 128 * 4
    nbytes = (sum(int((x != EMPTY).sum()) for x in c) * blk
              + rows * 5 * blk + sum(4 * x.numel() for x in c)
              + rows * 5 * 4)
    full = rows * 16 * blk
    ms = flushed_ms(lambda: mrg.slot_add_n(c, b, FLAGSHIP_COEFFS, 1e-7, 5))
    plain = eager_ms(lambda: bell.add_n(c, b, FLAGSHIP_COEFFS,
                                        threshold=1e-7, k_out=5), 2)
    bound = nbytes / 3.35e12 * 1e3
    print(f"flagship merge 8192 x (5 + 5 + 1) -> 5, bs 128 f32 on "
          f"{torch.cuda.get_device_name(card)}: kernel {ms:.3f} ms (graph, "
          f"L2 flushed), bell.add_n {plain:.3f} ms, bound {bound:.3f} ms "
          f"({nbytes / 1e9:.3f} GB, {100 * bound / ms:.1f}% reached; fully "
          f"occupied {full / 3.35e12 * 1e3:.3f} ms)")
    assert ms < plain
