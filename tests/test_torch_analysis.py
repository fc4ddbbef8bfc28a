"""Port parity: the analysis slice of ntpoly_tpu_torch against ntpoly_tpu
on the same numpy inputs, on the CPU.

Covered: ``matmul`` with ``beta`` and ``c``; ``from_tall_dense``,
``to_triplets``, ``resize`` and ``get_slice`` (aligned and unaligned
offsets, non-square extents); ``core/cplx.py`` and complex storage;
the blocked Cholesky (``solvers/linear.py``), the pivoted Cholesky and
``reduce_dimension`` (``solvers/analysis.py``), and the purification
and Lowdin extrapolations (``solvers/geometry.py``).

Where slots are compared (``matmul`` and the data movement), the
reference multiplies with method='pallas' (its kernels in interpret
mode), so slots and capacities compare exactly; values are exact where
no sum is taken, within 1e-12 of the largest value in float64 and 1e-6
in float32 (the port at 'highest').  The solvers run the reference at
its CPU default and compare values (relative Frobenius or largest
entry, as each test states)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ntpoly_tpu.core import cplx as RC
from ntpoly_tpu.parallel import algebra as RA
from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.solvers import analysis as RAn
from ntpoly_tpu.solvers import geometry as RGe
from ntpoly_tpu.solvers import linear as RL
from ntpoly_tpu.solvers import parameters as RP
from ntpoly_tpu.utils import logging as RLog
from ntpoly_tpu_torch.core import cplx as PC
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import analysis as PAn
from ntpoly_tpu_torch.solvers import geometry as PGe
from ntpoly_tpu_torch.solvers import linear as PL
from ntpoly_tpu_torch.solvers import parameters as PP
from ntpoly_tpu_torch.utils import logging as PLog
from ntpoly_tpu_torch.utils.errors import ComplexSupportError, NTPolyError

from _torch_port import n, overlap_triplets, solve_logged

TOL = {np.float64: 1e-12, np.float32: 1e-6}
RG = RGrid(1, 1, 1)
PG = ProcessGrid(device="cpu")


def same(rm, pm, tol=0.0):
    """Capacity and col ids equal, blocks within tol of the largest."""
    assert (rm.k, rm.dim, rm.bs) == (pm.k, pm.dim, pm.bs)
    assert np.array_equal(n(rm.col_ids), n(pm.col_ids))
    ref = n(rm.blocks)
    scale = max(np.abs(ref).max(initial=0.0), 1.0)
    assert np.abs(ref - n(pm.blocks)).max(initial=0.0) <= tol * scale


def both(dense, bs, k=None):
    return (RPM.from_dense(dense, bs=bs, grid=RG, k=k),
            PPM.from_dense(dense, bs=bs, grid=PG, k=k))


def scattered(dim, seed, density=0.08, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim)) * (rng.random((dim, dim)) < density)
    return a.astype(dtype)


def banded(dim, halfwidth, diag):
    """Symmetric banded matrix: ``diag`` on the diagonal, 0.5 / (1 +
    |i - j|) within the half-width."""
    i = np.arange(dim)
    off = np.abs(i[:, None] - i[None, :])
    return np.where(off == 0, diag, 0.5 / (1.0 + off)) * (off <= halfwidth)


def dense_of(m):
    """The port's matrix as a dense numpy array from its triplets."""
    rows, cols, vals = PPM.to_triplets(m)
    out = np.zeros((m.dim, m.dim), vals.dtype)
    out[rows, cols] = vals
    return out


# ----------------------------------------------------------------------------
# matmul with beta and c
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("beta", [1.0, -0.5])
def test_matmul_beta_c(dtype, beta):
    a, b, c = (scattered(72, seed, dtype=dtype) for seed in (1, 2, 3))
    (ra, pa), (rb, pb), (rc, pc) = (both(x, 8) for x in (a, b, c))
    kw = dict(threshold=1e-3, precision="highest")
    r = RA.matmul(ra, rb, -1.0, beta, rc, method="pallas", **kw)
    p = PA.matmul(pa, pb, -1.0, beta=beta, c=pc, method="pallas", **kw)
    same(r, p, TOL[dtype])
    want = beta * c.astype(np.float64) - a.astype(np.float64) @ b
    got = n(PPM.to_dense(p)).astype(np.float64)
    assert np.abs(got - want).max() <= 1e-3 + 1e-5 * np.abs(want).max()


def test_matmul_without_c_ignores_beta():
    a = scattered(40, 4)
    ra, pa = both(a, 8)
    same(RA.matmul(ra, ra, method="pallas"),
         PA.matmul(pa, pa, beta=3.0, method="pallas"), TOL[np.float64])


# ----------------------------------------------------------------------------
# from_tall_dense, to_triplets, resize, get_slice
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dim,jb0,wb", [(64, 0, 2), (64, 3, 4), (61, 5, 3),
                                        (64, 6, 4)])
def test_from_tall_dense(dim, jb0, wb):
    """Zero blocks (a zero band of rows) are dropped; a block column past
    the matrix (jb0 + wb > nb) is dropped."""
    bs = 8
    nb = -(-dim // bs)
    x = np.random.default_rng(jb0).standard_normal((nb * bs, wb * bs))
    x[2 * bs:4 * bs] = 0.0
    x[:, bs:2 * bs] *= np.random.default_rng(9).random((nb * bs, 1)) < 0.3
    r = RPM.from_tall_dense(jnp.asarray(x), dim, jb0, bs=bs, grid=RG)
    p = PPM.from_tall_dense(torch.from_numpy(x), dim, jb0, bs=bs, grid=PG)
    same(r, p)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
def test_to_triplets(dtype):
    a = scattered(45, 5).astype(dtype)
    if np.iscomplexobj(a):
        a = a + 1j * scattered(45, 6)
    rm = RPM.from_dense(a, bs=8, grid=RG)
    pm = PPM.from_dense(a, bs=8, grid=PG)
    for ref, got in zip(RPM.to_triplets(rm), PPM.to_triplets(pm)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("new_dim", [90, 45, 41, 40, 17],
                         ids=["grow", "crop_in_block", "crop_across",
                              "crop_aligned", "crop_small"])
def test_resize(new_dim):
    rm, pm = both(scattered(45, 7, density=0.2), 8)
    r, p = RPM.resize(rm, new_dim), PPM.resize(pm, new_dim)
    same(r, p)
    assert np.array_equal(n(PPM.to_dense(p)),
                          np.asarray(RPM.to_dense(r)))


SLICES = {
    "aligned": (8, 40, 16, 48),
    "rows": (5, 37, 16, 48),
    "cols": (8, 40, 3, 35),
    "both": (5, 37, 11, 43),
    "tall": (3, 50, 13, 29),
    "wide": (16, 25, 2, 61),
    "whole": (0, 64, 0, 64),
}


@pytest.mark.parametrize("name", list(SLICES))
def test_get_slice(name):
    a = scattered(64, 8, density=0.2)
    rm, pm = both(a, 8)
    r0, r1, c0, c1 = SLICES[name]
    r = RPM.get_slice(rm, r0, r1, c0, c1)
    p = PPM.get_slice(pm, r0, r1, c0, c1)
    same(r, p)
    want = np.zeros((p.dim, p.dim))
    want[:r1 - r0, :c1 - c0] = a[r0:r1, c0:c1]
    assert np.array_equal(n(PPM.to_dense(p)), want)


# ----------------------------------------------------------------------------
# complex storage and the embedding
# ----------------------------------------------------------------------------

def hermitian(seed, dim=24):
    rng = np.random.default_rng(seed)
    h = rng.random((dim, dim)) + 1j * rng.random((dim, dim))
    h = 0.5 * (h + h.conj().T)
    return h * (rng.random((dim, dim)) < 0.5) * (rng.random((dim, dim))
                                                  < 0.5).T


def test_embed_and_extract_triplets():
    h = hermitian(1)
    rows, cols = np.nonzero(h)
    ref = RC.embed_triplets(rows, cols, h[rows, cols], 24)
    got = PC.embed_triplets(rows, cols, h[rows, cols], 24)
    for r, g in zip(ref[:3], got[:3]):
        assert np.array_equal(r, g)
    assert ref[3] == got[3] == 48
    ref_x = RC.extract_triplets(*ref)
    got_x = PC.extract_triplets(*got)
    for r, g in zip(ref_x[:3], got_x[:3]):
        assert g.dtype == r.dtype and np.array_equal(r, g)
    assert np.array_equal(got_x[2], h[got_x[0], got_x[1]])


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_embed_and_extract(dtype):
    h = hermitian(2).astype(dtype)
    rm = RPM.from_dense(h, bs=4, grid=RG)
    pm = PPM.from_dense(h, bs=4, grid=PG)
    same(rm, pm)
    re, pe = RC.embed(rm), PC.embed(pm)
    same(re, pe)
    assert pe.dtype == torch.from_numpy(h.real).dtype
    rx, px = RC.extract(re), PC.extract(pe)
    same(rx, px)
    assert px.dtype == torch.complex128
    assert np.array_equal(n(PPM.to_dense(px)), h.astype(np.complex128))


def test_complex_storage_round_trip():
    h = hermitian(3, dim=30)
    rows, cols = np.nonzero(h)
    for dtype in (torch.complex64, torch.complex128):
        m = PPM.fill_from_triplets(PPM.empty(30, bs=8, grid=PG, dtype=dtype),
                                   rows, cols, h[rows, cols])
        assert m.dtype == dtype
        want = h.astype(m.blocks.numpy().dtype)
        assert np.array_equal(n(PPM.to_dense(m)), want)
        ref = RPM.fill_from_triplets(
            RPM.empty(30, bs=8, grid=RG, dtype=want.dtype), rows, cols,
            h[rows, cols])
        same(ref, m)


def test_complex_matmul_names_the_embedding():
    pm = PPM.from_dense(hermitian(4), bs=8, grid=PG)
    with pytest.raises(ComplexSupportError, match="embedding"):
        PA.matmul(pm, pm)
    real = PPM.from_dense(hermitian(4).real, bs=8, grid=PG)
    with pytest.raises(ComplexSupportError, match="cplx.embed"):
        PA.matmul(real, pm, method="pallas")
    pe = PC.embed(pm)
    prod = PC.extract(PA.matmul(pe, pe))
    h = hermitian(4)
    assert np.abs(n(PPM.to_dense(prod)) - h @ h).max() <= 1e-12


# ----------------------------------------------------------------------------
# the blocked Cholesky
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [1024, 1020], ids=["1024", "1020"])
def test_cholesky(dim, monkeypatch):
    """Two panels at bs 16; 1020 is not a multiple of the block size.
    The port never densifies (``to_dense`` raises while it runs)."""
    a = banded(dim, 12, 4.0 + 0.01 * np.arange(dim))
    rm, pm = both(a, 16)
    ref = np.asarray(RPM.to_dense(RL.cholesky_decomposition(
        rm, RP.SolverParameters(threshold=1e-14))))
    with monkeypatch.context() as mp:
        mp.setattr(PPM, "to_dense", _forbidden)
        ell = PL.cholesky_decomposition(
            pm, PP.SolverParameters(threshold=1e-14))
        resid = PA.matmul(ell, PA.transpose(ell).conjugate(), alpha=-1.0,
                          beta=1.0, c=pm)
    got = dense_of(ell)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    want = np.linalg.cholesky(a)
    assert np.abs(got @ got.T - want @ want.T).max() <= 1e-10
    assert np.count_nonzero(np.triu(got, 1)) == 0
    assert float(PA.norm(resid)) <= 1e-10 * float(PA.norm(pm))


def _forbidden(*args, **kw):
    raise AssertionError("to_dense called: a dim^2 materialization")


def test_cholesky_last_panel_past_the_matrix():
    """dim 1000 at bs 16 pads to 1008 rows, so the second 512-column
    panel passes the logical dimension.  The reference's
    ``jax.lax.dynamic_slice`` clamps that panel's diagonal block to rows
    496..1007 and reports it not positive definite; the port reads rows
    512..1023 (zero past 1008) and factorizes."""
    a = banded(1000, 12, 4.0)
    rm, pm = both(a, 16)
    with pytest.raises(Exception, match="not positive definite"):
        RL.cholesky_decomposition(rm, RP.SolverParameters(threshold=1e-14))
    got = dense_of(PL.cholesky_decomposition(
        pm, PP.SolverParameters(threshold=1e-14)))
    assert np.abs(got - np.linalg.cholesky(a)).max() <= 1e-12


def test_cholesky_not_positive_definite():
    a = banded(64, 4, 4.0)
    a[40, 40] = -1.0
    _, pm = both(a, 8)
    with pytest.raises(NTPolyError, match="not positive definite"):
        PL.cholesky_decomposition(pm)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_cholesky_of_the_overlap(dtype):
    """The path's S at a small size: L L^T - S formed sparsely, held to
    the reference's factor (two panels)."""
    dim = 1024
    rows, cols, vals = overlap_triplets(dim)
    s = np.zeros((dim, dim))
    s[rows, cols] = vals
    rm, pm = both(s.astype(dtype), 32)
    par = dict(threshold=1e-7)
    r = RL.cholesky_decomposition(rm, RP.SolverParameters(**par))
    p = PL.cholesky_decomposition(pm, PP.SolverParameters(
        precision="highest", **par))
    ref = np.asarray(RPM.to_dense(r), np.float64)
    got = n(PPM.to_dense(p)).astype(np.float64)
    assert np.linalg.norm(got - ref) <= 10 * TOL[dtype] * np.linalg.norm(ref)
    with PA.capacity_policy(precision="highest"):
        resid = PA.matmul(p, PA.transpose(p), alpha=-1.0, beta=1.0, c=pm)
    assert (np.sqrt(float(PA.dot(resid, resid)) / float(PA.dot(pm, pm)))
            <= 1e-4)


# ----------------------------------------------------------------------------
# the pivoted Cholesky and reduce_dimension
# ----------------------------------------------------------------------------

def test_pivoted_cholesky_distinct_diagonal():
    """A random PSD matrix of rank DIM - 5 whose diagonal entries are
    distinct: the same pivots, so the same L, slot for slot."""
    dim, rank = 96, 48
    rng = np.random.default_rng(5)
    b = rng.standard_normal((dim, dim - 5))
    a = b @ b.T / dim
    assert len(np.unique(np.diag(a))) == dim
    rm, pm = both(a, 8)
    par = dict(threshold=1e-14)
    r = RAn.pivoted_cholesky_decomposition(rm, rank, RP.SolverParameters(
        **par))
    p = PAn.pivoted_cholesky_decomposition(pm, rank, PP.SolverParameters(
        **par))
    same(r, p, 1e-12)
    # a full-rank run stops at the numerical rank
    full = PAn.pivoted_cholesky_decomposition(pm, dim, PP.SolverParameters(
        **par))
    ell = dense_of(full)
    assert np.abs(ell @ ell.T - a).max() <= 1e-10


def test_pivoted_cholesky_trace_bounds():
    """The tie-heavy banded S (every diagonal 1): the JAX package's
    bounds, which hold whatever order the ties break in."""
    dim, rank = 1024, 64
    rows, cols, vals = overlap_triplets(dim)
    s = np.zeros((dim, dim))
    s[rows, cols] = vals
    _, pm = both(s, 16)
    ell = PAn.pivoted_cholesky_decomposition(
        pm, rank, PP.SolverParameters(threshold=1e-14))
    resid = PA.matmul(ell, PA.transpose(ell).conjugate(), alpha=-1.0,
                      beta=1.0, c=pm)
    t_s, t_r = float(PA.trace(pm)), float(PA.trace(resid))
    assert -1e-8 <= t_r <= t_s * (1.0 - rank / dim) + 1e-8
    assert PPM.to_triplets(ell)[1].max() < rank


def gapped(dim, seed):
    """The JAX package test's gapped matrix (``create_matrix`` with
    ``add_gap``)."""
    m = np.random.default_rng(seed).random((dim, dim))
    m = m + m.T
    w, v = np.linalg.eigh(m)
    w[dim // 2:] += (w[-1] - w[0]) / 2.0
    return v @ np.diag(w) @ v.T


def test_reduce_dimension():
    dim = 64
    a = gapped(dim, 6)
    rm, pm = both(a, 8)
    r = RAn.reduce_dimension(rm, dim // 2, RP.SolverParameters())
    p = PAn.reduce_dimension(pm, dim // 2, PP.SolverParameters())
    assert p.dim == r.dim == dim // 2
    wr = np.linalg.eigvalsh(np.asarray(RPM.to_dense(r)))
    wp = np.linalg.eigvalsh(n(PPM.to_dense(p)))
    assert np.abs(wp - wr).max() <= 1e-10 * np.abs(wr).max()
    want = np.linalg.eigvalsh(a)[:dim // 2]
    assert np.linalg.norm(wp - want) / np.linalg.norm(want) <= 1e-2


# ----------------------------------------------------------------------------
# geometry extrapolation
# ----------------------------------------------------------------------------

def molecule(dim=48, seed=7):
    """A density matrix of a random gapped Hamiltonian in the basis of a
    random SPD overlap S, and the overlap one step later, S + 0.02 X
    for a sparse symmetric X."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((dim, dim)) * (rng.random((dim, dim)) < 0.1)
    s = np.eye(dim) + 0.05 * (x + x.T)
    h = rng.standard_normal((dim, dim))
    h = h + h.T
    w, v = np.linalg.eigh(s)
    isq = (v / np.sqrt(w)) @ v.T
    e, u = np.linalg.eigh(isq @ h @ isq)
    occ = u[:, :dim // 2]
    d = isq @ occ @ occ.T @ isq
    y = rng.standard_normal((dim, dim)) * (rng.random((dim, dim)) < 0.1)
    return d, s, s + 0.02 * (y + y.T)


def test_purification_extrapolate(tmp_path):
    d, s, s2 = molecule()
    (rd, pd), (rs2, ps2) = both(d, 8), both(s2, 8)
    nel = d.shape[0] // 2
    par = dict(threshold=1e-12, converge_diff=1e-10)
    r, rlog = solve_logged(tmp_path / "r.yaml", RLog,
                           RGe.purification_extrapolate, rd, rs2, nel,
                           RP.SolverParameters(be_verbose=True, **par))
    p, plog = solve_logged(tmp_path / "p.yaml", PLog,
                           PGe.purification_extrapolate, pd, ps2, nel,
                           PP.SolverParameters(be_verbose=True, **par))
    assert plog["Total Iterations"] == rlog["Total Iterations"]
    ref = np.asarray(RPM.to_dense(r))
    got = n(PPM.to_dense(p))
    assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)
    assert np.linalg.norm(got @ s2 @ got - got) <= 1e-8 * np.linalg.norm(got)
    assert abs(np.trace(got @ s2) - nel) <= 1e-8


def test_extrapolations_refuse_the_chunked_driver():
    """With iters_per_sync 4 the purification extrapolation runs eagerly
    and the Lowdin one takes its square roots chunked, as in the
    reference: both equal the reference's at the same setting."""
    d, s, s2 = molecule(seed=9)
    (rd, pd), (rs, ps), (rs2, ps2) = both(d, 8), both(s, 8), both(s2, 8)
    kw = dict(threshold=1e-12, converge_diff=1e-10, iters_per_sync=4)
    rp, pp = RP.SolverParameters(**kw), PP.SolverParameters(**kw)
    for ref, got in ((RGe.purification_extrapolate(rd, rs2, 24, rp),
                      PGe.purification_extrapolate(pd, ps2, 24, pp)),
                     (RGe.lowdin_extrapolate(rd, rs, rs2, rp),
                      PGe.lowdin_extrapolate(pd, ps, ps2, pp))):
        ref = np.asarray(RPM.to_dense(ref))
        got = n(PPM.to_dense(got))
        assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)


def test_lowdin_extrapolate():
    d, s, s2 = molecule(seed=8)
    (rd, pd), (rs, ps), (rs2, ps2) = both(d, 8), both(s, 8), both(s2, 8)
    par = dict(threshold=1e-12)
    r = RGe.lowdin_extrapolate(rd, rs, rs2, RP.SolverParameters(**par))
    p = PGe.lowdin_extrapolate(pd, ps, ps2, PP.SolverParameters(**par))
    ref = np.asarray(RPM.to_dense(r))
    got = n(PPM.to_dense(p))
    assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)
    # the idempotency in the new overlap's metric carries over
    assert np.linalg.norm(got @ s2 @ got - got) <= 1e-6 * np.linalg.norm(got)
