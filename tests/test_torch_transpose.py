"""Port parity of the non-orthogonal path's algebra: block-COO, filter
and transpose in ntpoly_tpu_torch.core.bell, and ``transpose``,
``filter_small``, ``norm``, ``similarity_transform`` and
``load_balance`` in ntpoly_tpu_torch.parallel.algebra, and the
permutations of ntpoly_tpu_torch.utils.permutation, against
ntpoly_tpu on the same numpy inputs, slot for slot.  Products run the
reference's Pallas kernels in interpret mode (method 'pallas'), so
slots and capacities compare exactly.  Tolerances: exact where no sum
is taken (COO, transpose, filter, permutation matrices), 1e-12 of the
largest value in f64 (products, norms), and 1e-6 in f32."""
import numpy as np
import pytest
import torch

from ntpoly_tpu.core import bell as RB
from ntpoly_tpu.parallel import algebra as RA
from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.utils import permutation as RPerm
from ntpoly_tpu_torch.core import bell as PB
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.utils import permutation as PPerm

from _torch_port import j, n, rand_ell, t

BS = 8
TOL = {np.float64: 1e-12, np.float32: 1e-6}


def same(rm, pm, tol=0.0):
    """Capacity and col ids equal, blocks within tol of the largest."""
    assert (rm.k, rm.dim, rm.bs) == (pm.k, pm.dim, pm.bs)
    assert np.array_equal(n(rm.col_ids), n(pm.col_ids))
    ref = n(rm.blocks)
    scale = max(np.abs(ref).max(initial=0.0), 1.0)
    assert np.abs(ref - n(pm.blocks)).max(initial=0.0) <= tol * scale


def both(dense, k=None, dtype=np.float64):
    rm = RPM.from_dense(dense.astype(dtype), bs=BS, grid=RGrid(1, 1, 1),
                        k=k)
    pm = PPM.from_dense(dense.astype(dtype), bs=BS,
                        grid=ProcessGrid(device="cpu"), k=k)
    return rm, pm


def scattered(dim, seed, density=0.06):
    """A sparse unsymmetric matrix, one all-zero block row."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim)) * (rng.random((dim, dim)) < density)
    a[2 * BS:3 * BS] = 0.0
    return a


def arrow(dim):
    """Each block row holds its diagonal block and block column 0, so
    every row has two slots and row 0 of the transpose has them all."""
    a = np.diag(np.arange(1.0, dim + 1))
    a[:, :BS] += 0.5
    return a


# ----------------------------------------------------------------------------
# core/bell.py
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("row_offset", [0, 5])
def test_to_block_coo(row_offset):
    cols, blocks = rand_ell(np.random.default_rng(1), 7, 4, 9, 4, holes=0.2,
                            empty_row=2)
    ref = RB.to_block_coo(j(cols), j(blocks), row_offset)
    got = PB.to_block_coo(t(cols), t(blocks), row_offset)
    for r, p in zip(ref, got):
        assert np.array_equal(n(r), n(p))


@pytest.mark.parametrize("panels", [1, 3])
@pytest.mark.parametrize("k", [2, 4, 7])
def test_from_block_coo(k, panels):
    """Shuffled COO with invalid entries: ascending cols from slot 0,
    overflow keeps the lowest col ids, invalid entries dropped."""
    rng = np.random.default_rng(2)
    nbr, nbc = 6, 9
    cols, blocks = rand_ell(rng, nbr, 5, nbc, 4, holes=0.25, empty_row=4)
    rows = np.repeat(np.arange(nbr, dtype=np.int32), 5)
    cols, blocks = cols.reshape(-1), blocks.reshape(-1, 4, 4)
    perm = rng.permutation(rows.size)
    rows, cols, blocks = rows[perm], cols[perm], blocks[perm]
    valid = cols != 2**30
    kw = dict(nbr=nbr, k=k, panels=panels,
              panel_nbc=3 if panels > 1 else None)
    rc, rb = RB.from_block_coo(j(rows), j(cols), j(blocks), j(valid), **kw)
    pc, pb = PB.from_block_coo(t(rows), t(cols), t(blocks), t(valid), **kw)
    assert np.array_equal(n(rc), n(pc))
    assert np.array_equal(n(rb), n(pb))


def test_transpose_blocks_filter_and_grand_sum():
    cols, blocks = rand_ell(np.random.default_rng(3), 6, 5, 9, 4, holes=0.2)
    assert np.array_equal(n(RB.transpose_blocks(j(blocks))),
                          n(PB.transpose_blocks(t(blocks))))
    for thr, k_out in ((0.0, None), (1.2, None), (0.5, 3), (0.5, 7)):
        rc, rb = RB.filter_small(j(cols), j(blocks), thr, k_out)
        pc, pb = PB.filter_small(t(cols), t(blocks), thr, k_out)
        assert np.array_equal(n(rc), n(pc))
        assert np.array_equal(n(rb), n(pb))
    assert abs(float(RB.grand_sum(j(blocks)))
               - float(PB.grand_sum(t(blocks)))) <= 1e-12 * blocks.size


# ----------------------------------------------------------------------------
# parallel/algebra.py
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["scattered", "holes", "arrow_grow",
                                  "arrow_truncate", "pinned"])
def test_transpose(case, dtype):
    """Slot for slot, with holes, an empty row, growth (a row of A^T
    needs more slots than A has) and a pinned capacity."""
    dim = 64
    if case.startswith("arrow"):
        rm, pm = both(arrow(dim), dtype=dtype)
        assert rm.k == 2
    else:
        rm, pm = both(scattered(dim, 4), dtype=dtype)
    if case == "holes":
        # EMPTY holes in the middle of rows, as the kernels leave them
        with RA.capacity_policy(method="pallas"):
            rm = RA.matmul(rm, rm, threshold=0.6)
        pm = PPM.from_reference_arrays(n(rm.col_ids), n(rm.blocks), dim,
                                       BS, pm.grid)
        assert (n(rm.col_ids)[..., :-1] == 2**30).any()
    kw = dict(on_overflow="truncate") if case == "arrow_truncate" else {}
    if case == "pinned":
        kw = dict(k_out=3)
    ref, got = RA.transpose(rm, **kw), PA.transpose(pm, **kw)
    same(ref, got)
    if case == "arrow_grow":
        assert got.k == 8 > pm.k
    if case == "arrow_truncate":
        assert got.k == pm.k
    dense = n(PPM.to_dense(pm))
    if case not in ("arrow_truncate", "pinned"):
        assert np.array_equal(n(PPM.to_dense(got)), dense.T)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_norm_and_filter_small(dtype):
    rm, pm = both(scattered(72, 5, density=0.2), dtype=dtype)
    rv, pv = float(RA.norm(rm)), float(PA.norm(pm))
    assert abs(rv - pv) <= TOL[dtype] * rv
    dense = n(PPM.to_dense(pm)).astype(np.float64)
    assert abs(pv - np.abs(dense).sum(axis=0).max()) <= TOL[dtype] * pv
    for thr in (0.0, 0.7, 1.5):
        same(RA.filter_small(rm, thr), PA.filter_small(pm, thr))


def spd(dim, seed):
    """A banded symmetric matrix with a dominant diagonal."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim)) * (np.abs(np.subtract.outer(
        np.arange(dim), np.arange(dim))) <= 10)
    return 0.1 * (a + a.T) + 4.0 * np.eye(dim)


@pytest.mark.parametrize("threshold", [0.0, 1e-3])
def test_similarity_transform_identity(threshold):
    """Identity P and Pinv: A itself, or A filtered when threshold > 0,
    with no multiply."""
    rm, pm = both(scattered(64, 6, density=0.3) * 1e-2)
    ri = RPM.identity(64, bs=BS, grid=rm.grid, dtype=np.float64)
    pi = PPM.identity(64, bs=BS, grid=pm.grid, dtype=torch.float64)
    ref = RA.similarity_transform(rm, ri, ri, threshold=threshold)
    got = PA.similarity_transform(pm, pi, pi, threshold=threshold)
    same(ref, got)
    assert (got is pm) == (threshold == 0.0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_similarity_transform(dtype):
    rm, pm = both(spd(64, 7), dtype=dtype)
    rp, pp = both(spd(64, 8) * 0.25, dtype=dtype)
    rq, pq = RA.transpose(rp), PA.transpose(pp)
    with RA.capacity_policy(method="pallas", precision="highest"):
        ref = RA.similarity_transform(rm, rp, rq, threshold=1e-6)
    with PA.capacity_policy(precision="highest"):
        got = PA.similarity_transform(pm, pp, pq, threshold=1e-6)
    same(ref, got, 10 * TOL[dtype])
    # against the dense product: each multiply flushes entries <= 1e-6,
    # the first one's flush carried through P
    a, p = n(PPM.to_dense(pm)), n(PPM.to_dense(pp))
    want = p @ a @ p.T
    err = np.abs(n(PPM.to_dense(got)) - want).max()
    p_norm = np.abs(p).sum(axis=0).max()
    assert err <= 1e-6 * (1 + p_norm) + 100 * TOL[dtype] * np.abs(
        want).max()


# ----------------------------------------------------------------------------
# utils/permutation.py and load balancing
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["default", "reverse", "random",
                                  "limited"])
@pytest.mark.parametrize("seed", [None, 0, 11])
def test_permutation_lookups(kind, seed):
    ref, got = RPerm.Permutation(), PPerm.Permutation()
    for p in (ref, got):
        if kind == "default":
            p.set_default_permutation(40)
        elif kind == "reverse":
            p.set_reverse_permutation(40)
        elif kind == "random":
            p.set_random_permutation(40, seed=seed if seed is not None
                                     else 5)
        else:
            p.set_limited_random_permutation(30, 40, seed=seed)
    if kind == "limited" and seed is None:
        # unseeded: the same structure, not the same draw
        assert np.array_equal(got.index_lookup[30:], np.arange(30, 40))
        assert np.array_equal(np.sort(got.index_lookup[:30]),
                              np.arange(30))
    else:
        assert np.array_equal(ref.index_lookup, got.index_lookup)
    assert np.array_equal(got.index_lookup[got.reverse_lookup],
                          np.arange(40))
    assert np.array_equal(PPerm.Permutation(12).index_lookup, np.arange(12))


def seeded(dim, seed):
    ref, got = RPerm.Permutation(), PPerm.Permutation()
    ref.set_random_permutation(dim, seed=seed)
    got.set_random_permutation(dim, seed=seed)
    return ref, got


@pytest.mark.parametrize("dim", [16, 61])
def test_permutation_matrices(dim):
    rm, pm = both(spd(dim, 9))
    rperm, pperm = seeded(dim, 3)
    for r, p in zip(RPerm.permutation_matrices(rperm, rm),
                    PPerm.permutation_matrices(pperm, pm)):
        same(r, p)


@pytest.mark.parametrize("dim", [16, 40])
def test_permute_round_trip_and_load_balance(dim):
    """permute_matrix against the reference slot for slot, its undo
    back to the input exactly, and load_balance as the same product."""
    rm, pm = both(spd(dim, 10))
    rperm, pperm = seeded(dim, 4)
    with RA.capacity_policy(method="pallas"):
        ref = RPerm.permute_matrix(rm, rperm, threshold=1e-9)
        ref_back = RPerm.undo_permute_matrix(ref, rperm, threshold=1e-9)
        rp, rq = RPerm.permutation_matrices(rperm, rm)
        ref_lb = RA.load_balance(rm, rp, rq, threshold=1e-9)
    got = PPerm.permute_matrix(pm, pperm, threshold=1e-9)
    back = PPerm.undo_permute_matrix(got, pperm, threshold=1e-9)
    pp, pq = PPerm.permutation_matrices(pperm, pm)
    got_lb = PA.load_balance(pm, pp, pq, threshold=1e-9)
    same(ref, got)
    same(ref_back, back)
    same(ref_lb, got_lb)
    a = n(PPM.to_dense(pm))
    lookup = pperm.index_lookup
    assert np.array_equal(n(PPM.to_dense(got)), a[lookup][:, lookup])
    assert np.array_equal(n(PPM.to_dense(back)), a)
