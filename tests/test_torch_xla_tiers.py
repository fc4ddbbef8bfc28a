"""Port parity: the reference's XLA SpGEMM tiers ('acc' = bell.spgemm,
'cand' = bell.spgemm_candidates, 'dense' = bell.spgemm_dense) and the
slot helpers beside them, plain torch in ntpoly_tpu_torch/core/bell.py,
against ntpoly_tpu/core/bell.py on the same numpy inputs (f64, CPU);
then the multiply's automatic choice of tier and ``matmul`` at the
reference solver suite's DIM = 23 (bs 4), where the kernels do not
run.  Col ids compare exactly; blocks within 1e-12 of max |C|."""
import numpy as np
import pytest
import torch

from ntpoly_tpu.core import bell as RB
from ntpoly_tpu.parallel import algebra as RA
from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu_torch.core import bell as PB
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid

from _torch_port import EMPTY, j, n, rand_ell, t

TOL = 1e-12


def same(ref, got, tol=TOL):
    (rc, rb), (pc, pb) = ref, got
    assert np.array_equal(n(rc), n(pc))
    rb, pb = n(rb), n(pb)
    scale = max(np.abs(rb).max(initial=0.0), 1e-300)
    assert np.abs(rb - pb).max(initial=0.0) <= tol * scale


def operands(seed, bs, rows=7, nbk=9, ka=4, kb=3, holes=0.2):
    rng = np.random.default_rng(seed)
    ac, ab = rand_ell(rng, rows, ka, nbk, bs, holes=holes, empty_row=2,
                      ragged_row=4)
    bc, bb = rand_ell(rng, nbk, kb, nbk, bs, holes=holes, empty_row=5)
    return ac, ab, bc, bb


# (threshold, alpha, k_out): none, filtered, overflowing
CASES = [(0.0, 1.0, 9), (0.5, -1.5, 9), (0.0, 0.75, 2)]


@pytest.mark.parametrize("bs", [4, 5, 8])
@pytest.mark.parametrize("threshold,alpha,k_out", CASES,
                         ids=["plain", "filtered", "overflow"])
def test_spgemm_acc(bs, threshold, alpha, k_out):
    ac, ab, bc, bb = operands(bs, bs)
    ref = RB.spgemm(j(ac), j(ab), j(bc), j(bb), col_offset=0, nbc_out=9,
                    k_out=k_out, threshold=threshold, alpha=alpha,
                    row_chunk=3)
    got = PB.spgemm(t(ac), t(ab), t(bc), t(bb), col_offset=0, nbc_out=9,
                    k_out=k_out, threshold=threshold, alpha=alpha)
    same(ref, got)


@pytest.mark.parametrize("bs", [4, 5, 8])
@pytest.mark.parametrize("threshold,alpha,k_out", CASES,
                         ids=["plain", "filtered", "overflow"])
def test_spgemm_candidates(bs, threshold, alpha, k_out):
    ac, ab, bc, bb = operands(10 + bs, bs)
    ref = RB.spgemm_candidates(j(ac), j(ab), j(bc), j(bb), col_offset=0,
                               k_out=k_out, threshold=threshold,
                               alpha=alpha, row_chunk=4)
    got = PB.spgemm_candidates(t(ac), t(ab), t(bc), t(bb), k_out=k_out,
                               threshold=threshold, alpha=alpha)
    same(ref, got)


@pytest.mark.parametrize("bs", [4, 5, 8])
@pytest.mark.parametrize("threshold,alpha,k_out", CASES,
                         ids=["plain", "filtered", "overflow"])
def test_spgemm_dense(bs, threshold, alpha, k_out):
    ac, ab, bc, bb = operands(20 + bs, bs)
    kw = dict(col_offset=0, nbc_out=9, k_out=k_out, nbk=9,
              threshold=threshold, alpha=alpha)
    same(RB.spgemm_dense(j(ac), j(ab), j(bc), j(bb), **kw),
         PB.spgemm_dense(t(ac), t(ab), t(bc), t(bb), **kw))


def test_spgemm_acc_row_passes(monkeypatch):
    """The accumulator's row passes change no slot or value."""
    ac, ab, bc, bb = operands(3, 4, rows=11)
    whole = PB.spgemm(t(ac), t(ab), t(bc), t(bb), col_offset=0, nbc_out=9,
                      k_out=5, threshold=0.1)
    monkeypatch.setattr(PB, "_ROW_BYTES", 9 * 16 * 8 * 3)    # 3 rows
    parts = PB.spgemm(t(ac), t(ab), t(bc), t(bb), col_offset=0, nbc_out=9,
                      k_out=5, threshold=0.1)
    assert torch.equal(whole[0], parts[0])
    assert torch.equal(whole[1], parts[1])


def test_slot_helpers():
    rng = np.random.default_rng(4)
    ac, ab = rand_ell(rng, 6, 4, 9, 5, holes=0.3)
    bc, bb = rand_ell(rng, 6, 3, 9, 5, holes=0.3)
    assert np.array_equal(n(RB.union_fill(j(ac), j(bc))),
                          n(PB.union_fill(t(ac), t(bc))))
    assert np.array_equal(n(RB.occupancy(j(ac))), n(PB.occupancy(t(ac))))
    same(RB.add(j(ac), j(ab), j(bc), j(bb), 0.5, -2.0, 0.3, k_out=5),
         PB.add(t(ac), t(ab), t(bc), t(bb), 0.5, -2.0, 0.3, k_out=5))
    dr, dc = rng.standard_normal((6, 5)), rng.standard_normal((9, 5))
    for kw_r, kw_p in (({"dvec_rows": j(dr)}, {"dvec_rows": t(dr)}),
                       ({"dvec_cols": j(dc)}, {"dvec_cols": t(dc)})):
        assert np.abs(n(RB.diagonal_scale(j(ac), j(ab), **kw_r))
                      - n(PB.diagonal_scale(t(ac), t(ab), **kw_p))
                      ).max() <= TOL
    assert np.array_equal(ac[0] != EMPTY, n(t(ac)[0] != EMPTY))


# ----------------------------------------------------------------------------
# the multiply's tier choice and matmul at DIM = 23, bs 4
# ----------------------------------------------------------------------------

DIM = 23


def pair(d, bs=4, k=None):
    rm = RPM.from_dense(d, bs=bs, grid=RGrid(1, 1, 1), k=k)
    pm = PPM.from_dense(d, bs=bs, grid=ProcessGrid(device="cpu"), k=k,
                        dtype=torch.float64)
    return rm, pm


def same_mat(rm, pm, tol=TOL):
    assert rm.k == pm.k and rm.dim == pm.dim
    same((rm.col_ids, rm.blocks), (pm.col_ids, pm.blocks), tol)


def matrices(rng):
    dense = rng.random((DIM, DIM))
    sparse = dense * (rng.random((DIM, DIM)) < 0.15)
    band = np.triu(np.tril(dense, 5), -5)
    return {"dense": dense, "sparse": sparse, "band": band}


@pytest.mark.parametrize("kind", ["dense", "sparse", "band"])
def test_pick_method_matches_reference(kind):
    rng = np.random.default_rng(11)
    d = matrices(rng)[kind]
    rm, pm = pair(d)
    for k_out in (1, 2, pm.panel_nb):
        assert PA._pick_method(pm, pm, k_out) == \
            RA._pick_method(rm, rm, k_out=k_out)
    rm8, pm8 = pair(d, bs=8)
    assert PA._pick_method(pm8, pm8, pm8.k) == "pallas"


@pytest.mark.parametrize("kind", ["dense", "sparse", "band"])
@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_matmul_dim23_matches_reference(kind, threshold):
    """At bs 4 both packages take the same XLA tier (the reference's CPU
    grid never runs its kernels), so C is the same slot for slot,
    capacity growth and trim included."""
    rng = np.random.default_rng(5)
    d = matrices(rng)[kind]
    rm, pm = pair(d, k=1 if kind == "band" else None)
    same_mat(RA.matmul(rm, rm, threshold=threshold),
             PA.matmul(pm, pm, threshold=threshold))
    same_mat(RA.matmul(rm, rm, alpha=0.5, beta=-1.0, c=rm,
                       threshold=threshold),
             PA.matmul(pm, pm, alpha=0.5, beta=-1.0, c=pm,
                       threshold=threshold))


@pytest.mark.parametrize("method", ["acc", "cand", "dense"])
def test_matmul_forced_tier(method):
    rng = np.random.default_rng(6)
    d = matrices(rng)["sparse"]
    rm, pm = pair(d)
    same_mat(RA.matmul(rm, rm, method=method, k_out=2,
                       on_overflow="truncate"),
             PA.matmul(pm, pm, method=method, k_out=2,
                       on_overflow="truncate"))


def test_every_real_dtype_and_bs_has_a_tier():
    rng = np.random.default_rng(7)
    d = rng.random((DIM, DIM))
    for dtype in (torch.float32, torch.float64):
        for bs in (1, 3, 4, 6, 8, 12, 16):
            m = PPM.from_dense(d, bs=bs, grid=ProcessGrid(device="cpu"),
                               dtype=dtype)
            c = PA.matmul(m, m)
            err = np.abs(n(PPM.to_dense(c)) - d @ d).max()
            assert err <= (1e-3 if dtype == torch.float32 else 1e-12)
