"""Port parity: the dense eigen path and what sits on it, against
ntpoly_tpu on the same numpy inputs, on the CPU at bs 8.

Covered: ``algebra.spmv``/``spmm``/``matrix_sigma`` (holes, a ragged
and an empty row), ``eigenbounds`` (Gershgorin and the power iteration
with its Aitken rule, including the start vector a ring Laplacian
annihilates), ``eigen``'s dense path (the decomposition with and
without ``nvals``, the eigenvalues, ``estimate_gap`` and the SVD),
every ``dense_*`` solver on ``dense_matrix_function``, and ``fermi``
(``compute_dense_foe`` with the step function and Fermi-Dirac
smearing, ``dense_density``, ``wom_gc`` and ``wom_c``).

Tolerances (relative Frobenius, port against reference): float64
1e-10; float32 at 'highest' 1e-5 (both exact float32 products, summed
in different orders).  Against a numpy/scipy oracle: 1e-4, the
reference suite's bar (``tests/conftest.py``).  Eigenvectors are not
unique, so the decomposition is compared through V diag(w) V^T."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from ntpoly_tpu.parallel import algebra as RA
from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.solvers import density as RD
from ntpoly_tpu.solvers import eigen as RE
from ntpoly_tpu.solvers import eigenbounds as RB
from ntpoly_tpu.solvers import exponential as RX
from ntpoly_tpu.solvers import fermi as RF
from ntpoly_tpu.solvers import inverse as RI
from ntpoly_tpu.solvers import parameters as RP
from ntpoly_tpu.solvers import sign as RS
from ntpoly_tpu.solvers import squareroot as RSQ
from ntpoly_tpu.solvers import trigonometry as RT
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import density as PD
from ntpoly_tpu_torch.solvers import eigen as PE
from ntpoly_tpu_torch.solvers import eigenbounds as PB
from ntpoly_tpu_torch.solvers import exponential as PX
from ntpoly_tpu_torch.solvers import fermi as PF
from ntpoly_tpu_torch.solvers import inverse as PI
from ntpoly_tpu_torch.solvers import parameters as PP
from ntpoly_tpu_torch.solvers import sign as PS
from ntpoly_tpu_torch.solvers import squareroot as PSQ
from ntpoly_tpu_torch.solvers import trigonometry as PT

from _torch_port import n, rand_ell

BS = 8
TOL = {np.float64: 1e-10, np.float32: 1e-5}
ORACLE = 1e-4
DTYPES = [np.float64, np.float32]
IDS = ["f64", "f32"]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def pair(d, dtype=np.float64):
    """The same dense numpy matrix in both packages."""
    d = np.asarray(d, dtype)
    return (RPM.from_dense(d, bs=BS, grid=RGrid(1, 1, 1)),
            PPM.from_dense(d, bs=BS, grid=ProcessGrid(device="cpu")))


def dense(rm, pm):
    """Both results as float64 numpy arrays."""
    return (np.asarray(RPM.to_dense(rm), np.float64),
            n(PPM.to_dense(pm)).astype(np.float64))


def params(dtype=np.float64, **kw):
    """Both packages' parameters; the port at 'highest' (its f32 'high'
    is bf16x3, the reference's CPU 'high' exact)."""
    return (RP.SolverParameters(**kw),
            PP.SolverParameters(precision="highest", **kw))


def symmetric(rng, dim=64, spd=False, shift=0.0):
    m = rng.random((dim, dim))
    m = m + m.T
    if spd:
        m = m.T @ m / dim + dim * np.eye(dim) / 8
    return m / dim + shift * np.eye(dim)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# ----------------------------------------------------------------------------
# algebra
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_spmv_spmm_matrix_sigma(rng, dtype):
    nb, k = 12, 5
    cols, blocks = rand_ell(rng, nb, k, nb, BS, holes=0.2, dtype=dtype,
                            empty_row=3, ragged_row=7)
    dim = nb * BS - 5                       # padded last block row
    blocks[-1, :, -5:, :] = 0
    blocks[:, :, :, -5:] *= (cols != nb - 1)[..., None, None]
    rm = RPM.empty(dim, bs=BS, k=k, grid=RGrid(1, 1, 1),
                   dtype=dtype).with_data(jnp.asarray(cols[None]),
                                          jnp.asarray(blocks[None]))
    pm = PPM.from_reference_arrays(cols[None], blocks[None], dim, BS,
                                   ProcessGrid(device="cpu"))
    x = rng.standard_normal(nb * BS).astype(dtype)
    xs = rng.standard_normal((nb * BS, 3)).astype(dtype)
    full = n(PPM.to_dense(pm)).astype(np.float64)
    tol = TOL[dtype]
    for fn, arg in ((RA.spmv, x), (RA.spmm, xs)):
        want = np.asarray(fn(rm, jnp.asarray(arg)))
        got = n(getattr(PA, fn.__name__)(pm, torch.from_numpy(arg)))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert rel(got, want) <= tol
        assert rel(got[:dim], full @ arg[:dim].astype(np.float64)) <= tol
    assert abs(float(PA.matrix_sigma(pm)) / float(RA.matrix_sigma(rm))
               - 1) <= tol
    assert abs(float(PA.matrix_sigma(pm))
               * np.abs(full).sum(axis=0).max() ** 2 - 1) <= tol


@pytest.mark.parametrize("k", [None, 9], ids=["k_fill", "k9"])
@pytest.mark.parametrize("kind", ["array", "tensor"])
def test_from_dense_slots(rng, kind, k):
    """A dense array or tensor is blocked on the grid's device with the
    reference's slots: the entries above the threshold, nonzero blocks
    packed in ascending col order, capacity the larger of k and the
    fullest row (dim 93: a padded last block row)."""
    d = rng.standard_normal((93, 93)) * (rng.random((93, 93)) < 0.05)
    d[:, 40:48] *= 1e-9                      # blocks the threshold empties
    want = RPM.from_dense(d, bs=BS, grid=RGrid(1, 1, 1), k=k,
                          threshold=1e-8)
    got = PPM.from_dense(d if kind == "array" else torch.from_numpy(d),
                         bs=BS, grid=ProcessGrid(device="cpu"), k=k,
                         threshold=1e-8)
    assert got.k == want.k and got.dim == 93
    assert np.array_equal(n(got.col_ids), np.asarray(want.col_ids))
    assert np.array_equal(n(got.blocks), np.asarray(want.blocks))


# ----------------------------------------------------------------------------
# eigenbounds
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_gershgorin_and_power_bounds(rng, dtype):
    m = symmetric(rng)
    rm, pm = pair(m, dtype)
    rlo, rhi = RB.gershgorin_bounds(rm)
    plo, phi = PB.gershgorin_bounds(pm)
    assert np.allclose([plo, phi], [rlo, rhi], rtol=TOL[dtype], atol=0)
    radius = np.abs(m).sum(axis=0) - np.abs(np.diag(m))
    assert np.allclose([plo, phi], [(np.diag(m) - radius).min(),
                                    (np.diag(m) + radius).max()],
                       rtol=TOL[dtype])
    rp, pp = params(dtype, max_iterations=10)
    ref, got = RB.power_bounds(rm, rp), PB.power_bounds(pm, pp)
    assert abs(got - ref) <= TOL[dtype] * abs(ref)
    w = np.linalg.eigvalsh(m)
    assert abs(got - np.abs(w).max()) <= ORACLE * np.abs(w).max()


def test_power_bounds_start_vector_in_the_kernel():
    """The uniform start vector of both packages lies in the kernel of a
    ring Laplacian: A x = 0, so the first Ritz value is 0, the monitor
    fires at once and both return 0 (which leaves the exponential
    unscaled, see test_torch_functions)."""
    dim = 64
    lap = (np.diag(np.full(dim, -0.5)) + 0.25 * np.roll(np.eye(dim), 1, 0)
           + 0.25 * np.roll(np.eye(dim), -1, 0))
    rm, pm = pair(lap)
    rp, pp = params(max_iterations=10)
    assert RB.power_bounds(rm, rp) == 0.0
    assert PB.power_bounds(pm, pp) == 0.0


# ----------------------------------------------------------------------------
# the dense eigen path
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("nvals", [None, 5], ids=["all", "lowest5"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_eigen_decomposition(rng, dtype, nvals):
    m = symmetric(rng)
    rm, pm = pair(m, dtype)
    rp, pp = params(dtype, threshold=1e-12)
    rvals, rvecs = RE.eigen_decomposition(rm, nvals, rp)
    pvals, pvecs = PE.eigen_decomposition(pm, nvals, pp)
    rw, pw = dense(rvals, pvals)
    assert rel(pw, rw) <= TOL[dtype]
    w = np.linalg.eigvalsh(m)
    keep = len(w) if nvals is None else nvals
    want = np.diag(np.where(np.arange(len(w)) < keep, w, 0.0))
    assert rel(pw, want) <= ORACLE
    rv, pv = dense(rvecs, pvecs)
    # vectors are unique only up to sign: compare V diag(w) V^T
    rec = (pv * np.diag(pw)) @ pv.T
    assert rel(rec, (rv * np.diag(rw)) @ rv.T) <= TOL[dtype]
    if nvals is None:
        assert rel(rec, m) <= 10 * TOL[dtype]
        assert pvecs.k == rvecs.k and pvals.k == rvals.k
    ev = PE.eigen_values(pm, nvals, pp)
    assert rel(n(PPM.to_dense(ev)), pw) == 0.0


def _oracle(fn, m):
    w, v = np.linalg.eigh(m)
    return (v * fn(w)) @ v.T


# name, (reference module, port module), matrix kind, numpy function
DENSE = [
    ("dense_square_root", RSQ, PSQ, "spd", np.sqrt),
    ("dense_inverse_square_root", RSQ, PSQ, "spd", lambda w: w ** -0.5),
    ("dense_invert", RI, PI, "spd", lambda w: 1.0 / w),
    ("dense_sign_function", RS, PS, "sym", lambda w: np.where(w >= 0, 1.0,
                                                              -1.0)),
    ("compute_dense_exponential", RX, PX, "sym", np.exp),
    ("compute_dense_logarithm", RX, PX, "spd", np.log),
    ("dense_sine", RT, PT, "sym", np.sin),
    ("dense_cosine", RT, PT, "sym", np.cos),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("name,rmod,pmod,kind,fn", DENSE,
                         ids=[d[0] for d in DENSE])
def test_dense_matrix_functions(rng, name, rmod, pmod, kind, fn, dtype):
    """Each dense_* solver on dense_matrix_function: the reference's to
    its tolerance (float32: eigh's rounding, as both packages run
    LAPACK in float32) and the numpy oracle to 1e-4; threshold 1e-8
    drops the same entries in both."""
    m = symmetric(rng, spd=kind == "spd",
                  shift=0.0 if kind == "spd" else -0.05)
    rm, pm = pair(m, dtype)
    rp, pp = params(dtype, threshold=1e-8)
    ref, got = dense(getattr(rmod, name)(rm, rp), getattr(pmod, name)(pm, pp))
    tol = TOL[dtype] if dtype == np.float64 else 1e-4
    assert rel(got, ref) <= tol
    assert rel(got, _oracle(fn, m)) <= ORACLE


# ----------------------------------------------------------------------------
# gap estimate and SVD
# ----------------------------------------------------------------------------

def test_estimate_gap(rng):
    """K and mu from a dense solve, carried across as numpy; then both
    packages' power bounds of K H and K (H - e_min I)."""
    dim, nel = 64, 32
    m = symmetric(rng)
    w, v = np.linalg.eigh(m)
    w[nel:] += 0.5                           # open a gap of 0.5
    m = (v * w) @ v.T
    occ = v[:, :nel]
    k = occ @ occ.T
    mu = 0.5 * (w[nel - 1] + w[nel])
    (rh, ph), (rk, pk) = pair(m), pair(k)
    rp, pp = params(threshold=1e-12)
    ref = RE.estimate_gap(rh, rk, mu, rp)
    got = PE.estimate_gap(ph, pk, mu, pp)
    assert abs(got - ref) <= 1e-10 * abs(ref)
    assert got > 0


def test_singular_value_decomposition(rng):
    m = rng.random((64, 64)) / 64 + 0.5 * np.eye(64)
    rm, pm = pair(m)
    rp, pp = params(threshold=1e-12, converge_diff=1e-10)
    rl, rr, rv = RE.singular_value_decomposition(rm, rp)
    pl, pr, pv = PE.singular_value_decomposition(pm, pp)
    (rld, ld), (rrd, rd), (rvd, vd) = dense(rl, pl), dense(rr, pr), \
        dense(rv, pv)
    assert rel(vd, rvd) <= TOL[np.float64]
    assert rel(np.diag(vd), np.sort(np.linalg.svd(m, compute_uv=False))
               ) <= ORACLE
    # the factors reconstruct A (vectors are unique only up to sign)
    rec = ld @ vd @ rd.T
    assert rel(rec, rld @ rvd @ rrd.T) <= 1e-9
    assert rel(rec, m) <= ORACLE


# ----------------------------------------------------------------------------
# fermi
# ----------------------------------------------------------------------------

DIM, NEL = 64, 20.0


@pytest.fixture(scope="module")
def molecule():
    """A fake molecule (the reference's ``test_chemistry.System``, with
    H scaled by 1/8 so that its spectrum spans ~18 and WOM's steps stay
    few): a gapped H, an SPD overlap S, and S^-1/2 from scipy, carried
    into both packages; and the generalized eigenpairs of the
    oracle."""
    rng = np.random.default_rng(7)
    h = rng.random((DIM, DIM))
    h = 0.0625 * (h + h.T)
    w, v = np.linalg.eigh(h)
    w[int(NEL):] += w[-1] - w[0]
    h = (v * w) @ v.T
    s = rng.random((DIM, DIM))
    s = 0.1 * (s @ s.T) / DIM + np.eye(DIM)
    isq = np.real(sla.fractional_matrix_power(s, -0.5))
    ww, vv = np.linalg.eigh(isq @ h @ isq)
    return pair(h), pair(isq), isq, ww, vv


def _fermi_dirac(ww, mu, beta):
    return 1.0 / (1.0 + np.exp(beta * (ww - mu)))


@pytest.mark.parametrize("smeared", [False, True], ids=["step", "smeared"])
def test_compute_dense_foe(molecule, smeared):
    (rh, ph), (risq, pisq), isq, ww, vv = molecule
    beta = 50.0 if smeared else None
    rp, pp = params(threshold=1e-12)
    rk, re_, rmu = RF.compute_dense_foe(rh, risq, NEL, beta, rp)
    pk, pe, pmu = PF.compute_dense_foe(ph, pisq, NEL, beta, pp)
    rd, pd = dense(rk, pk)
    assert rel(pd, rd) <= TOL[np.float64]
    assert abs(pe - re_) <= 1e-10 * abs(re_) and abs(pmu - rmu) <= 1e-10
    if smeared:
        occ = _fermi_dirac(ww, pmu, beta)
        assert abs(occ.sum() - NEL) <= 1e-6
    else:
        occ = (np.arange(DIM) < NEL).astype(float)
        assert ww[int(NEL) - 1] <= pmu <= ww[int(NEL)]
    assert rel(pd, isq @ ((vv * occ) @ vv.T) @ isq) <= ORACLE
    assert abs(pe - (occ * ww).sum()) <= ORACLE * abs(pe)


def test_dense_density(molecule):
    (rh, ph), (risq, pisq), isq, ww, vv = molecule
    rk, re_, rmu = RD.dense_density(rh, risq, NEL)
    pk, pe, pmu = PD.dense_density(ph, pisq, NEL)
    rd, pd = dense(rk, pk)
    assert rel(pd, rd) <= TOL[np.float64]
    assert abs(pe - re_) <= 1e-10 * abs(re_) and abs(pmu - rmu) <= 1e-10
    occ = vv[:, :int(NEL)]
    assert rel(pd, isq @ occ @ occ.T @ isq) <= ORACLE


@pytest.mark.parametrize("mode", ["gc", "c"])
def test_wom(molecule, mode):
    """WOM_GC at the gap's midpoint and WOM_C at the electron count: at
    the library's step threshold the reference's K and energy to 1e-10;
    at step threshold 1e-4 (the reference suite's) the dense
    Fermi-Dirac density to 1e-4."""
    (rh, ph), (risq, pisq), isq, ww, vv = molecule
    beta = 50.0
    mu = 0.5 * (ww[int(NEL) - 1] + ww[int(NEL)])
    rp, pp = params(threshold=1e-12)
    if mode == "gc":
        ref = RF.wom_gc(rh, risq, mu, beta, rp)
        got = PF.wom_gc(ph, pisq, mu, beta, pp)
    else:
        ref = RF.wom_c(rh, risq, NEL, beta, rp)
        got = PF.wom_c(ph, pisq, NEL, beta, pp)
    rd, pd = dense(ref[0], got[0])
    assert rel(pd, rd) <= TOL[np.float64]
    assert abs(got[1] - ref[1]) <= 1e-10 * abs(ref[1])
    pp.step_thresh = 1e-4
    if mode == "gc":
        k, energy = PF.wom_gc(ph, pisq, mu, beta, pp)
    else:
        from scipy.optimize import brentq
        mu = brentq(lambda x: _fermi_dirac(ww, x, beta).sum() - NEL,
                    ww[0] - 5, ww[-1] + 5)
        k, energy = PF.wom_c(ph, pisq, NEL, beta, pp)
    occ = _fermi_dirac(ww, mu, beta)
    assert rel(n(PPM.to_dense(k)), isq @ ((vv * occ) @ vv.T) @ isq) <= ORACLE
    assert abs(energy - (occ * ww).sum()) <= ORACLE * abs(energy)


def test_wom_refuses_the_chunked_driver(molecule):
    """wom_c runs eagerly whatever iters_per_sync says, as in the
    reference: with 2, the reference's K and energy at the same
    setting."""
    (rh, ph), (risq, pisq), _, _, _ = molecule
    rp, pp = params(threshold=1e-12, iters_per_sync=2)
    ref = RF.wom_c(rh, risq, NEL, 50.0, rp)
    got = PF.wom_c(ph, pisq, NEL, 50.0, pp)
    rd, pd = dense(ref[0], got[0])
    assert rel(pd, rd) <= TOL[np.float64]
    assert abs(got[1] - ref[1]) <= 1e-10 * abs(ref[1])
