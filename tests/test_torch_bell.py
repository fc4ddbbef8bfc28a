"""Port parity: ntpoly_tpu_torch.core.bell against ntpoly_tpu.core.bell
on the same numpy inputs (f64).  Col ids and holes must match exactly,
blocks to 1e-12 (sums may be taken in another order)."""
import numpy as np
import pytest

from ntpoly_tpu.core import bell as R
from ntpoly_tpu_torch.core import bell as P

from _torch_port import EMPTY, j, n, rand_ell, t

TOL = 1e-12


def close(a, b, tol=TOL):
    a, b = n(a), n(b)
    scale = max(np.abs(b).max(initial=0.0), 1.0)
    return np.abs(a - b).max(initial=0.0) <= tol * scale


def ell(seed, rows=6, k=5, nbc=9, bs=4, **kw):
    rng = np.random.default_rng(seed)
    return rand_ell(rng, rows, k, nbc, bs, **kw)


@pytest.mark.parametrize("k_out", [2, 5, 8])
@pytest.mark.parametrize("threshold", [0.0, 0.8])
def test_compact(k_out, threshold):
    cols, blocks = ell(1, holes=0.2, empty_row=2)
    rc, rb = R.compact(j(cols), j(blocks), k_out, threshold)
    pc, pb = P.compact(t(cols), t(blocks), k_out, threshold)
    assert np.array_equal(n(rc), n(pc))
    assert close(pb, rb)


def test_compact_ties_keep_lower_slot():
    """Equal block norms: the stable sort keeps the lower slot, as the
    reference's."""
    rng = np.random.default_rng(2)
    cols = np.tile(np.arange(6, dtype=np.int32), (3, 1))
    base = rng.standard_normal((4, 4))
    blocks = np.stack([np.stack([base * s for s in
                                 (1, -1, 1, 2, -1, 1)])] * 3)
    rc, rb = R.compact(j(cols), j(blocks), 3)
    pc, pb = P.compact(t(cols), t(blocks), 3)
    assert np.array_equal(n(rc), n(pc))
    assert np.array_equal(n(rb), n(pb))


@pytest.mark.parametrize("k_out", [3, 7, 12])
@pytest.mark.parametrize("threshold", [0.0, 1.0])
def test_merge_duplicates_and_holes(k_out, threshold):
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 7, (5, 10)).astype(np.int32)
    cols[rng.random((5, 10)) < 0.25] = EMPTY
    blocks = rng.standard_normal((5, 10, 4, 4))
    blocks[cols == EMPTY] = 0
    rc, rb = R.merge(j(cols), j(blocks), k_out, threshold)
    pc, pb = P.merge(t(cols), t(blocks), k_out, threshold)
    assert np.array_equal(n(rc), n(pc))
    assert close(pb, rb)


def test_add_n_and_union_fill():
    a = ell(4, k=3)
    b = ell(5, k=4)
    c = ell(6, k=2, holes=0.3)
    coeffs = (0.5, -1.25, 3.0)
    rc, rb = R.add_n([j(x[0]) for x in (a, b, c)],
                     [j(x[1]) for x in (a, b, c)], coeffs,
                     threshold=0.1, k_out=6)
    pc, pb = P.add_n([t(x[0]) for x in (a, b, c)],
                     [t(x[1]) for x in (a, b, c)], coeffs,
                     threshold=0.1, k_out=6)
    assert np.array_equal(n(rc), n(pc))
    assert close(pb, rb)
    ru = R.union_fill_n([j(x[0]) for x in (a, b, c)])
    pu = P.union_fill_n([t(x[0]) for x in (a, b, c)])
    assert np.array_equal(n(ru), n(pu))


def test_used_slots_pad_and_norms():
    cols, blocks = ell(7, holes=0.4, empty_row=1)
    assert np.array_equal(n(R.used_slots(j(cols))),
                          n(P.used_slots(t(cols))))
    rc, rb = R.pad_slots(j(cols), j(blocks), 8)
    pc, pb = P.pad_slots(t(cols), t(blocks), 8)
    assert np.array_equal(n(rc), n(pc)) and np.array_equal(n(rb), n(pb))
    assert close(P.block_norms(t(blocks)), R.block_norms(j(blocks)))


def test_trace_align_dot():
    a = ell(8, rows=6, nbc=6, holes=0.2)
    b = ell(9, rows=6, nbc=6, holes=0.2)
    assert close(P.trace_blocks(t(a[0]), t(a[1]), 0),
                 R.trace_blocks(j(a[0]), j(a[1]), 0))
    assert close(P.trace(t(a[0]), t(a[1])), R.trace(j(a[0]), j(a[1])))
    assert close(P.align(t(a[0]), t(b[0]), t(b[1])),
                 R.align(j(a[0]), j(b[0]), j(b[1])))
    assert close(P.align_mul(t(a[0]), t(a[1]), t(b[0]), t(b[1])),
                 R.align_mul(j(a[0]), j(a[1]), j(b[0]), j(b[1])))
    assert close(P.dot(t(a[0]), t(a[1]), t(b[0]), t(b[1])),
                 R.dot(j(a[0]), j(a[1]), j(b[0]), j(b[1])))


@pytest.mark.parametrize("size", [1, 7, 1000, 4097])
def test_comp_sum_pair(size):
    """The same two-sum tree: the pair resolves the float64 sum of f32
    data to ~n*eps^2, in both packages."""
    rng = np.random.default_rng(size)
    x = (rng.standard_normal(size) * 1e3).astype(np.float32)
    rp = n(R.comp_sum(j(x)))
    pp = n(P.comp_sum(t(x)))
    exact = float(np.sum(x.astype(np.float64)))
    bound = size * np.finfo(np.float32).eps ** 2 * np.abs(x).sum() + 1e-30
    assert abs(float(pp[0]) + float(pp[1]) - exact) <= bound
    assert abs((float(pp[0]) + float(pp[1]))
               - (float(rp[0]) + float(rp[1]))) <= 2 * bound


def test_dense_round_trip_and_col_sums():
    cols, blocks = ell(10, rows=5, k=4, nbc=5)
    rd = R.to_dense(j(cols), j(blocks), nbc=5)
    pd = P.to_dense(t(cols), t(blocks), nbc=5)
    assert close(pd, rd)
    rc, rb = R.from_dense(rd, bs=4, k=5, threshold=0.5)
    pc, pb = P.from_dense(pd, bs=4, k=5, threshold=0.5)
    assert np.array_equal(n(rc), n(pc))
    assert close(pb, rb)
    assert close(P.col_abs_sums(t(cols), t(blocks), 5),
                 R.col_abs_sums(j(cols), j(blocks), 5))
