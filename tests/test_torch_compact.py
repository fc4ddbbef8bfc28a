"""The compact of block-ELL slots to k_out (``ops/compact.py``).

On the CPU the wrapper runs its plain version, ``bell.compact``; both are
held bit for bit to a numpy model of the compact's semantics (the flush,
the occupancy, the ranking by (-norm, slot), the order by (col id, rank),
the occupancy product), which is also the kernels' algorithm, over
inputs with M below, at and above k_out (up to 40 slots in and 33
out), thresholds 0 and 1e-3 (with an entry exactly at the float32
threshold), exact ties, all-zero blocks under valid ids, nonzero blocks
under EMPTY, -0.0 and NaN, float32 and float64, bs 8, 32 and 128.  The
tests marked ``card`` hold the kernels (``csrc/compact.cu``) to
``bell.compact`` on an NVIDIA card, on the same cases, at spans of 17
and 100 slots and at the flagship's shape, and skip without one; they
import no JAX, so the card's machine runs them without the suite's
conftest:

    python -m pytest --noconftest -m card -q tests/test_torch_compact.py
"""
import numpy as np
import pytest
import torch

from _torch_port import card  # noqa: F401  (the tests of the card)
from ntpoly_tpu_torch.core import bell
from ntpoly_tpu_torch.ops import _cuda
from ntpoly_tpu_torch.ops import compact as cmp
from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid

torch.set_num_threads(1)

EMPTY = 2**30
DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}
# (M, k_out): below, at and above the capacity; the full span of two
# matrices of 9 slots (17) to 9, and more than a warp's 32 slots in and
# out
SHAPES = {"m_lt_k": (3, 5), "m_eq_k": (5, 5), "m_gt_k": (9, 5),
          "span17": (17, 9), "wide": (40, 33)}
CASES = [(shape, thr, dt, bs) for shape in SHAPES for thr in (0.0, 1e-3)
         for dt in DTYPES for bs in (8, 32, 128)]
IDS = [f"{s}-thr{t:g}-{d}-bs{b}" for s, t, d, b in CASES]


def planted(shape, threshold, dt, bs, seed=0):
    """Block-ELL (numpy) [rows, M] with every case of the compact's
    contract planted: row 0 an exact tie (slot 1 a copy of slot 0), row 1
    an all-zero block under a valid id, row 2 nonzero blocks under EMPTY
    (negative entries, whose products by 0 are -0.0), row 3 -0.0 and NaN
    entries, row 4 every slot one block (all tied), row 5 a block wholly
    at or below the threshold and an entry exactly at the float32
    threshold; the other rows random, with holes."""
    m, _ = SHAPES[shape]
    npdt = DTYPES[dt][0]
    rng = np.random.default_rng(seed)
    rows = 6 if bs == 128 else 10
    cols = np.full((rows, m), EMPTY, np.int64)
    for r in range(rows):
        cols[r] = np.sort(rng.choice(40, m, replace=False))
    scale = rng.uniform(0.1, 2.0, (rows, m, 1, 1))
    blocks = (rng.standard_normal((rows, m, bs, bs)) * scale).astype(npdt)
    holes = rng.random((rows, m)) < 0.2
    holes[:6] = False
    cols[holes] = EMPTY
    blocks[holes] = 0
    if m >= 2:
        blocks[0, 1] = blocks[0, 0]
    blocks[1, 0] = 0
    cols[2, -1] = EMPTY
    blocks[2, -1] = -np.abs(blocks[2, -1])
    if m >= 3:
        cols[2, 1] = EMPTY
    blocks[3, 0, 0, :3] = [-0.0, np.nan, -0.0]
    blocks[3, -1, 1, 1] = np.nan
    blocks[4] = blocks[4, 0]
    t32 = npdt(threshold)
    blocks[5, 0] = np.where(rng.random((bs, bs)) < 0.5, t32, -t32 / 2)
    blocks[5, -1, 0, 0] = t32
    return cols.astype(np.int32), blocks


def model(cols, blocks, k_out, threshold):
    """The compact's semantics in numpy, slot by slot: -> (col ids,
    blocks) [rows, k_out]."""
    t = blocks.dtype.type(threshold)
    with np.errstate(invalid="ignore"):
        flushed = np.where(np.abs(blocks) > t, blocks, 0).astype(blocks.dtype)
    rows, m = cols.shape
    bs = blocks.shape[-1]
    mp = max(m, k_out)
    oc = np.full((rows, k_out), EMPTY, np.int32)
    ob = np.zeros((rows, k_out, bs, bs), blocks.dtype)
    for r in range(rows):
        c = list(cols[r]) + [EMPTY] * (mp - m)
        b = list(flushed[r]) + [np.zeros((bs, bs), blocks.dtype)] * (mp - m)
        nrm = [float(np.abs(x).astype(np.float64).sum()) for x in b]
        occ = [nrm[s] > 0 and c[s] != EMPTY for s in range(mp)]
        order = sorted(range(mp), key=lambda s: (0, -nrm[s], s) if occ[s]
                       else (1, 0.0, s))[:k_out]
        keyed = sorted(range(k_out), key=lambda p: (
            c[order[p]] if occ[order[p]] else EMPTY, p))
        for o, p in enumerate(keyed):
            s = order[p]
            oc[r, o] = c[s] if occ[s] else EMPTY
            ob[r, o] = b[s] * blocks.dtype.type(1.0 if occ[s] else 0.0)
    return oc, ob


def bits(x):
    """The raw bits of a float tensor or array, for comparisons that tell
    -0.0 from +0.0 and hold NaN equal to itself."""
    x = torch.as_tensor(x).contiguous()
    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def same_bits(a, b) -> bool:
    (ac, ab), (bc, bb) = a, b
    return (torch.equal(torch.as_tensor(ac).cpu(), torch.as_tensor(bc).cpu())
            and torch.equal(bits(ab).cpu(), bits(bb).cpu()))


@pytest.mark.parametrize("shape,threshold,dt,bs", CASES, ids=IDS)
def test_cpu_wrapper_is_plain_and_model(shape, threshold, dt, bs):
    """On CPU tensors the wrapper is ``bell.compact`` bit for bit, counts
    no launch, and both are the numpy model's bits."""
    cols, blocks = planted(shape, threshold, dt, bs)
    k_out = SHAPES[shape][1]
    c, b = torch.from_numpy(cols), torch.from_numpy(blocks)
    before = cmp.compactions["slot_compact"]
    got = cmp.slot_compact(c, b, k_out, threshold)
    assert cmp.compactions["slot_compact"] == before
    plain = bell.compact(c, b, k_out, threshold)
    assert got[0].shape == (cols.shape[0], k_out)
    assert same_bits(got, plain)
    assert same_bits(plain, model(cols, blocks, k_out, threshold))


def test_cpu_planted_cases_show():
    """The planted rows do what they are for: a nonzero block under EMPTY
    comes out as signed zeros, NaN and -0.0 flush to +0.0, and the tie
    keeps the lower slot."""
    cols, blocks = planted("m_lt_k", 0.0, "f32", 8)
    oc, ob = bell.compact(torch.from_numpy(cols), torch.from_numpy(blocks), 5)
    assert (bits(ob[2]) == bits(torch.tensor(-0.0))).any()
    assert not torch.isnan(ob).any()
    assert not (bits(ob[3]) == bits(torch.tensor(-0.0))).any()
    cols, blocks = planted("m_gt_k", 0.0, "f32", 8)
    kept = set(bell.compact(torch.from_numpy(cols), torch.from_numpy(blocks),
                            1)[0][4].tolist())
    assert kept == {int(cols[4, 0])}


def test_cpu_route_and_helpers(monkeypatch):
    """CPU tensors never take the kernels (``_cuda.takes``, whose device
    predicate alone turns them away) and run ``bell.compact``;
    ``rows_differ`` tells -0.0 from +0.0 and sees a changed col id;
    ``near_ties`` finds the row of one block in every slot."""
    cols, blocks = planted("m_gt_k", 0.0, "f32", 8)
    c, b = torch.from_numpy(cols), torch.from_numpy(blocks)
    assert not _cuda.takes(b.dtype, b)
    with monkeypatch.context() as card_route:
        card_route.setattr(_cuda, "on_card", lambda x: True)
        assert _cuda.takes(b.dtype, b)
    assert cmp.compact is bell.compact
    want = bell.compact(c, b, 5)
    got = (want[0].clone(), want[1].clone())
    got[1][2, 0, 0, 0] = -got[1][2, 0, 0, 0] if got[1][2, 0, 0, 0] \
        else -0.0
    got[0][7, 0] += 1
    assert cmp.rows_differ(got, want).tolist() == [2, 7]
    assert cmp.rows_differ(want, bell.compact(c, b, 5)).numel() == 0
    ties = cmp.near_ties(c, b, 5).tolist()
    assert 4 in ties and len(ties) < cols.shape[0]
    assert cmp.near_ties(c, b, 9).numel() == 0


def test_summa_full_span_branch_calls_the_wrapper(monkeypatch):
    """'pallas_band' below the product span compacts through
    ``ops/compact.py`` once a multiply, at k_out."""
    calls = []
    real = cmp.slot_compact

    def spy(cols, blocks, k_out, threshold=0.0):
        calls.append((tuple(cols.shape), k_out))
        return real(cols, blocks, k_out, threshold)

    monkeypatch.setattr(cmp, "slot_compact", spy)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((96, 96))
    d = np.where(np.abs(np.subtract.outer(np.arange(96), np.arange(96)))
                 < 12, d, 0.0)
    pm = PM.from_dense(d, bs=8, grid=ProcessGrid(device="cpu"))
    out = alg.matmul(pm, pm, k_out=3, method="pallas_band",
                     on_overflow="truncate")
    assert len(calls) == 1 and calls[0][1] == 3
    assert out.k == 3


# ----------------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------------

def launched(fn):
    """fn() -> (its result, the kernel launches it counted)."""
    before = cmp.compactions["slot_compact"]
    out = fn()
    return out, cmp.compactions["slot_compact"] - before


@pytest.mark.card
@pytest.mark.parametrize("shape,threshold,dt,bs", CASES, ids=IDS)
def test_card_kernel_is_plain(card, shape, threshold, dt, bs):
    cols, blocks = planted(shape, threshold, dt, bs)
    k_out = SHAPES[shape][1]
    c = torch.from_numpy(cols).to(card)
    b = torch.from_numpy(blocks).to(card)
    got, n = launched(lambda: cmp.slot_compact(c, b, k_out, threshold))
    assert n == 1
    assert same_bits(got, bell.compact(c, b, k_out, threshold))
    assert same_bits(got, model(cols, blocks, k_out, threshold))


def flagship_candidates(device, seed=11):
    """A full-span band product's shape: 8192 block rows of 9 candidate
    slots (ids r - 4 .. r + 4, EMPTY off the ends), bs 128, float32,
    blocks decaying away from the diagonal slot with a random scale a
    row and a few EMPTY holes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows, m, bs = 8192, 9, 128
    r = torch.arange(rows, device=device)[:, None]
    ids = r + torch.arange(-4, 5, device=device)[None, :]
    off = torch.rand((rows, m), generator=gen, device=device) < 0.02
    cols = torch.where((ids < 0) | (ids >= rows) | off, EMPTY, ids)
    decay = 1.0 / (1.0 + torch.arange(-4, 5, device=device).abs()) ** 2
    scale = decay * torch.rand((rows, m), generator=gen, device=device)
    blocks = torch.randn((rows, m, bs, bs), generator=gen, device=device)
    blocks *= scale[..., None, None]
    blocks *= (cols != EMPTY)[..., None, None]
    return cols.to(torch.int32), blocks


@pytest.mark.card
def test_card_flagship_shape(card):
    """8192 x 9 slots, bs 128, float32, k_out 5: the kernel's output is
    bell.compact's, bit for bit, but for rows whose competing norms lie
    within float32 rounding (counted and shown)."""
    c, b = flagship_candidates(card)
    got, n = launched(lambda: cmp.slot_compact(c, b, 5))
    want = bell.compact(c, b, 5)
    assert n == 1
    bad = cmp.rows_differ(got, want)
    ties = cmp.near_ties(c, b, 5)
    print(f"flagship shape: {bad.numel()} rows differ, {ties.numel()} "
          f"near-tie rows")
    assert set(bad.tolist()) <= set(ties.tolist())


@pytest.mark.card
def test_card_graph_and_repeat(card):
    """The same bits on every call and in a CUDA graph's replay."""
    cols, blocks = planted("m_gt_k", 0.0, "f32", 128, seed=5)
    c = torch.from_numpy(cols).to(card)
    b = torch.from_numpy(blocks).to(card)
    first = cmp.slot_compact(c, b, 5)
    assert same_bits(first, cmp.slot_compact(c, b, 5))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cmp.slot_compact(c, b, 5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cmp.slot_compact(c, b, 5)
    graph.replay()
    torch.cuda.synchronize()
    assert same_bits(out, first)


@pytest.mark.card
@pytest.mark.parametrize("what", ["float16", "bs12", "complex64",
                                  "cols_int64"])
def test_card_ineligible_takes_plain(card, what):
    """Inputs the kernels do not take are bell.compact's, and launch
    nothing: another dtype, a block size that is not a multiple of 8,
    complex blocks, int64 col ids."""
    m, bs, dtype, ids = 6, 8, torch.float16, torch.int32
    if what == "bs12":
        bs, dtype = 12, torch.float32
    elif what == "complex64":
        dtype = torch.complex64
    elif what == "cols_int64":
        dtype, ids = torch.float32, torch.int64
    gen = torch.Generator().manual_seed(2)
    cols = torch.arange(m, dtype=ids).repeat(4, 1)
    blocks = torch.randn((4, m, bs, bs), generator=gen).to(dtype)
    c, b = cols.to(card), blocks.to(card)
    # int64 col ids pass the route's data kind; the compact's own check
    # turns them away
    assert _cuda.takes(b.dtype, b) == (what == "cols_int64")
    got, n = launched(lambda: cmp.slot_compact(c, b, 5))
    assert n == 0
    want = bell.compact(c, b, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.card
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("m,k_out", [(17, 5), (17, 9), (100, 40)])
def test_card_full_span_widths(card, m, k_out, dt):
    """bs 128 at the spans a band product of wider operands gives (ka =
    kb = 9: 17 slots; a grown K: 100), to k_out 5, 9 and 40: the kernels
    launch and keep bell.compact's bits, but for near-tie rows."""
    gen = torch.Generator().manual_seed(m + k_out)
    rows, bs = 64, 128
    ids = torch.stack([torch.randperm(4 * m, generator=gen)[:m]
                       for _ in range(rows)]).to(torch.int32)
    ids[torch.rand((rows, m), generator=gen) < 0.1] = EMPTY
    scale = torch.rand((rows, m, 1, 1), generator=gen, dtype=torch.float64)
    blocks = torch.randn((rows, m, bs, bs), generator=gen,
                         dtype=torch.float64) * scale
    c = ids.to(card)
    b = blocks.to(DTYPES[dt][1]).to(card)
    assert _cuda.takes(b.dtype, b)
    got, n = launched(lambda: cmp.slot_compact(c, b, k_out))
    assert n == 1
    bad = cmp.rows_differ(got, bell.compact(c, b, k_out))
    assert set(bad.tolist()) <= set(cmp.near_ties(c, b, k_out).tolist())
