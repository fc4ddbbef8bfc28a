"""Port parity: the matrix-function solvers of ntpoly_tpu_torch against
ntpoly_tpu on the same numpy inputs, on the CPU at dim 64 (32 for the
pseudo-inverse), bs 8: inverse and pseudo-inverse (Hotelling), sign and
polar decomposition, roots 1-8 and inverse roots 1-6, Horner and
Paterson-Stockmeyer, Chebyshev (recurrence and recursive split),
Hermite, CG, the exponential (Chebyshev, Taylor, Pade), the logarithm
(Chebyshev, Taylor), the exp/log round trip and sine/cosine (Chebyshev
and Taylor); the matrices are the reference suite's
(``tests/test_solvers.py``'s ``create_matrix``).

Tolerances (relative Frobenius): port against reference 1e-10 in
float64 and 1e-5 in float32, the port at 'highest' (its f32 'high' is
bf16x3, the reference's CPU 'high' exact); against the numpy/scipy
oracle 1e-4, the reference suite's bar.  The iterative solvers also
log the same iteration counts.

The Taylor exponential departs from the reference on purpose: the
reference sums plain powers, without the 1/k!, so it misses the oracle
wherever its power bound leaves the matrix unscaled (a ring Laplacian,
whose bound is 0); the port's series keeps the factorials and is held
to the reference's Chebyshev exponential and to the oracle instead."""
import numpy as np
import pytest
import scipy.linalg as sla

from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.solvers import chebyshev as RC
from ntpoly_tpu.solvers import exponential as RX
from ntpoly_tpu.solvers import hermite as RH
from ntpoly_tpu.solvers import inverse as RI
from ntpoly_tpu.solvers import linear as RL
from ntpoly_tpu.solvers import parameters as RP
from ntpoly_tpu.solvers import polynomial as RPoly
from ntpoly_tpu.solvers import roots as RR
from ntpoly_tpu.solvers import sign as RS
from ntpoly_tpu.solvers import trigonometry as RT
from ntpoly_tpu.utils import logging as RLog
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import chebyshev as PC
from ntpoly_tpu_torch.solvers import exponential as PX
from ntpoly_tpu_torch.solvers import hermite as PH
from ntpoly_tpu_torch.solvers import inverse as PI
from ntpoly_tpu_torch.solvers import linear as PL
from ntpoly_tpu_torch.solvers import parameters as PP
from ntpoly_tpu_torch.solvers import polynomial as PPoly
from ntpoly_tpu_torch.solvers import roots as PR
from ntpoly_tpu_torch.solvers import sign as PS
from ntpoly_tpu_torch.solvers import trigonometry as PT
from ntpoly_tpu_torch.utils import logging as PLog

from _torch_port import n, solve_logged

DIM, BS = 64, 8
TOL = {np.float64: 1e-10, np.float32: 1e-5}
ORACLE = 1e-4
DTYPES = [np.float64, np.float32]
IDS = ["f64", "f32"]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def create_matrix(rng, spd=False, scaled=False, diag_dom=False, dim=DIM):
    """The reference suite's test matrices."""
    m = rng.random((dim, dim))
    m = m + m.T
    if spd:
        m = m.T @ m
    if diag_dom:
        m = m + dim * np.eye(dim)
    if scaled:
        m = m / dim
    return m


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pair(d, dtype=np.float64):
    d = np.asarray(d, dtype)
    return (RPM.from_dense(d, bs=BS, grid=RGrid(1, 1, 1)),
            PPM.from_dense(d, bs=BS, grid=ProcessGrid(device="cpu")))


def params(dtype=np.float64, **kw):
    """The reference suite's solver settings (converge_diff 1e-8, the
    tight criterion only; 1e-4 in float32, whose rounding floor lies
    above 1e-8), the port at 'highest'."""
    kw = dict(converge_diff=1e-8 if dtype == np.float64 else 1e-4,
              monitor_convergence=False, **kw)
    return (RP.SolverParameters(**kw),
            PP.SolverParameters(precision="highest", **kw))


def both(fn_ref, fn_port, m, *args, dtype=np.float64, **kw):
    """Each package's solver on the same matrix -> (reference, port) as
    float64 numpy arrays."""
    rm, pm = pair(m, dtype)
    rp, pp = params(dtype, **kw)
    return (np.asarray(RPM.to_dense(fn_ref(rm, *args, rp)), np.float64),
            n(PPM.to_dense(fn_port(pm, *args, pp))).astype(np.float64))


def assert_both(ref, got, oracle, dtype=np.float64):
    assert rel(got, ref) <= TOL[dtype]
    assert rel(got, oracle) <= ORACLE


def logged_iterations(tmp_path, fn_ref, fn_port, m, *args):
    """The 'Total Iterations' each package logs for the same solve."""
    out = []
    for tag, fn, log, mat, par in zip(("ref", "port"), (fn_ref, fn_port),
                                      (RLog, PLog), pair(m),
                                      params(be_verbose=True)):
        _, blk = solve_logged(tmp_path / f"{tag}.yaml", log, fn, mat,
                              *args, par)
        out.append(blk["Total Iterations"])
    return out


# ----------------------------------------------------------------------------
# inverse, sign, polar
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_invert(rng, dtype):
    m = create_matrix(rng, spd=True, diag_dom=True)
    ref, got = both(RI.invert, PI.invert, m, dtype=dtype)
    assert_both(ref, got, np.linalg.inv(m), dtype)


def test_invert_iterations(tmp_path, rng):
    m = create_matrix(rng, spd=True, diag_dom=True)
    r, p = logged_iterations(tmp_path, RI.invert, PI.invert, m)
    assert r == p


def test_pseudo_inverse(rng):
    m = create_matrix(rng)
    m = m[DIM // 2:] @ m[DIM // 2:].T
    ref, got = both(RI.pseudo_inverse, PI.pseudo_inverse, m)
    assert_both(ref, got, np.linalg.pinv(m))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_sign_function(rng, dtype):
    m = create_matrix(rng)
    ref, got = both(RS.sign_function, PS.sign_function, m, dtype=dtype)
    assert_both(ref, got, np.real(sla.signm(m)), dtype)


def test_sign_iterations(tmp_path, rng):
    m = create_matrix(rng)
    r, p = logged_iterations(tmp_path, RS.sign_function, PS.sign_function,
                             m)
    assert r == p


def test_polar_decomposition(rng):
    """A = U H for a non-symmetric A: the transpose arm every
    iteration."""
    m = rng.random((DIM, DIM)) + DIM * np.eye(DIM) / 4
    rm, pm = pair(m)
    rp, pp = params()
    ru, rh = RS.polar_decomposition(rm, rp)
    pu, ph = PS.polar_decomposition(pm, pp)
    u_want, h_want = sla.polar(m)
    for r, p, want in ((ru, pu, u_want), (rh, ph, h_want)):
        assert_both(np.asarray(RPM.to_dense(r)), n(PPM.to_dense(p)), want)
    assert rel(n(PPM.to_dense(pu)) @ n(PPM.to_dense(ph)), m) <= ORACLE


# ----------------------------------------------------------------------------
# roots
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("root", [1, 2, 3, 4, 5, 6, 7, 8])
def test_compute_root(rng, root):
    m = create_matrix(rng, diag_dom=True)
    ref, got = both(RR.compute_root, PR.compute_root, m, root)
    assert_both(ref, got, sla.fractional_matrix_power(m, 1.0 / root).real)


@pytest.mark.parametrize("root", [1, 2, 3, 4, 5, 6])
def test_compute_inverse_root(rng, root):
    m = create_matrix(rng, diag_dom=True)
    ref, got = both(RR.compute_inverse_root, PR.compute_inverse_root, m,
                    root)
    assert_both(ref, got,
                sla.fractional_matrix_power(m, -1.0 / root).real)


# ----------------------------------------------------------------------------
# polynomials
# ----------------------------------------------------------------------------

def _by_eigen(m, fn):
    w, v = np.linalg.eigh(m)
    return (v * fn(w)) @ v.T


def _poly(cls, coef):
    poly = cls(len(coef))
    for i, c in enumerate(coef):
        poly.set_coefficient(i, c)
    return poly


POLYNOMIALS = [
    ("horner", [1.0, -0.5, 0.25, -0.125, 0.0625]),
    ("paterson_stockmeyer", [0.5, 0.25, 0.125, -0.06, 0.03, -0.015,
                             0.0075, 0.003, 0.001]),
]


@pytest.mark.parametrize("name,coef", POLYNOMIALS,
                         ids=[p[0] for p in POLYNOMIALS])
def test_polynomial(rng, name, coef):
    from numpy.polynomial.polynomial import polyval
    m = create_matrix(rng, scaled=True)
    fn = f"{name}_compute"
    ref, got = both(
        lambda a, p: getattr(RPoly, fn)(a, _poly(RPoly.Polynomial, coef), p),
        lambda a, p: getattr(PPoly, fn)(a, _poly(PPoly.Polynomial, coef), p),
        m)
    assert_both(ref, got, _by_eigen(m, lambda w: polyval(w, coef)))


@pytest.mark.parametrize("form", ["compute", "factorized_compute"])
def test_chebyshev(rng, form):
    from numpy.polynomial.chebyshev import chebval
    m = create_matrix(rng, scaled=True)
    m = m / np.abs(np.linalg.eigvalsh(m)).max() * 0.9
    coef = [1.0, 0.5, 0.25, 0.125, 0.0625, 0.03, 0.015, 0.0075]
    ref, got = both(
        lambda a, p: getattr(RC, form)(
            a, _poly(RC.ChebyshevPolynomial, coef), p),
        lambda a, p: getattr(PC, form)(
            a, _poly(PC.ChebyshevPolynomial, coef), p), m)
    assert_both(ref, got, _by_eigen(m, lambda w: chebval(w, coef)))


def test_hermite(rng):
    from numpy.polynomial.hermite import hermval
    m = create_matrix(rng, scaled=True)
    coef = [1.0, 0.5, 0.25, 0.125]
    ref, got = both(
        lambda a, p: RH.compute(a, _poly(RH.HermitePolynomial, coef), p),
        lambda a, p: PH.compute(a, _poly(PH.HermitePolynomial, coef), p),
        m)
    assert_both(ref, got, _by_eigen(m, lambda w: hermval(w, coef)))


# ----------------------------------------------------------------------------
# CG
# ----------------------------------------------------------------------------

def test_cg_solver(tmp_path, rng):
    amat = create_matrix(rng, spd=True, diag_dom=True)
    bmat = create_matrix(rng)
    (ra, pa), (rb, pb) = pair(amat), pair(bmat)
    rp, pp = params()
    ref = np.asarray(RPM.to_dense(RL.cg_solver(ra, rb, rp)))
    got = n(PPM.to_dense(PL.cg_solver(pa, pb, pp)))
    assert_both(ref, got, np.linalg.solve(amat, bmat))


# ----------------------------------------------------------------------------
# exponential and logarithm
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("name", ["compute_exponential",
                                  "compute_exponential_pade"])
def test_exponential(rng, name, dtype):
    m = create_matrix(rng, scaled=True)
    ref, got = both(getattr(RX, name), getattr(PX, name), m, dtype=dtype)
    assert_both(ref, got, sla.expm(m), dtype)


def _ring(dim=DIM):
    return (np.diag(np.full(dim, -0.5)) + 0.25 * np.roll(np.eye(dim), 1, 0)
            + 0.25 * np.roll(np.eye(dim), -1, 0))


@pytest.mark.parametrize("system", ["scaled", "ring"])
def test_exponential_taylor(rng, system):
    """The port's Taylor exponential against the reference's Chebyshev
    one and the oracle, on a matrix its power bound scales (scaled),
    where it also agrees with the reference's Taylor series, and one it
    leaves unscaled (the ring, bound 0), where the reference's series,
    without the 1/k!, misses the oracle."""
    m = create_matrix(rng, scaled=True) if system == "scaled" else _ring()
    ref, got = both(RX.compute_exponential, PX.compute_exponential_taylor, m)
    assert rel(got, ref) <= 1e-7
    assert rel(got, sla.expm(m)) <= ORACLE
    jax_taylor, _ = both(RX.compute_exponential_taylor,
                         PX.compute_exponential_taylor, m)
    if system == "ring":
        assert rel(jax_taylor, sla.expm(m)) > 1e-2
    else:
        # scaled below 3e-8, the x^2/2 the reference's series leaves
        # out moves a factor by ~r^2/(2 sigma^2); the sigma squarings
        # add that up to ~r^2/(2 sigma), a few 1e-9 here
        assert rel(got, jax_taylor) <= 1e-7


@pytest.mark.parametrize("name", ["compute_logarithm",
                                  "compute_logarithm_taylor"])
def test_logarithm(rng, name):
    m = create_matrix(rng, spd=True, diag_dom=True, scaled=True)
    m = m + np.eye(DIM)
    ref, got = both(getattr(RX, name), getattr(PX, name), m)
    assert_both(ref, got, np.real(sla.logm(m)))


def test_exponential_round_trip(rng):
    """exp then log recovers the input, in both packages alike."""
    m = 0.25 * create_matrix(rng, scaled=True) + np.eye(DIM)
    rm, pm = pair(m)
    rp, pp = params()
    ref = RX.compute_logarithm(RX.compute_exponential(rm, rp), rp)
    got = PX.compute_logarithm(PX.compute_exponential(pm, pp), pp)
    assert_both(np.asarray(RPM.to_dense(ref)), n(PPM.to_dense(got)), m)


# ----------------------------------------------------------------------------
# trigonometry
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name,oracle", [
    ("sine", sla.sinm), ("cosine", sla.cosm),
    ("scale_square_trigonometry_taylor", sla.cosm)],
    ids=["sine", "cosine", "cosine_taylor"])
def test_trigonometry(rng, name, oracle):
    """The Taylor cosine scales the radius below 3e-3 and doubles the
    angle back, each step doubling the relative rounding: on the
    unscaled matrix (15 steps) the two packages' last bits part to
    6e-8, each as far from the oracle; on the scaled one (9 steps) to
    3e-11."""
    m = create_matrix(rng, scaled="taylor" in name)
    ref, got = both(getattr(RT, name), getattr(PT, name), m)
    assert_both(ref, got, np.real(oracle(m)))


# ----------------------------------------------------------------------------
# iters_per_sync > 1: the chunked driver
# ----------------------------------------------------------------------------

def _spd(rng):
    return create_matrix(rng, spd=True, diag_dom=True)


def _log_input(rng):
    return create_matrix(rng, spd=True, diag_dom=True, scaled=True) \
        + np.eye(DIM)


# CG's right-hand side ("b"), and (port solver, reference solver, its
# matrix, the extra arguments, oracle)
B_CG = create_matrix(np.random.default_rng(3))
CHUNKED = [
    (PI.invert, RI.invert, _spd, (), np.linalg.inv),
    (PI.pseudo_inverse, RI.pseudo_inverse, _spd, (), np.linalg.pinv),
    (PS.sign_function, RS.sign_function, create_matrix, (),
     lambda m: np.real(sla.signm(m))),
    (PS.polar_decomposition, RS.polar_decomposition,
     lambda rng: rng.random((DIM, DIM)) + DIM * np.eye(DIM) / 4, (),
     lambda m: sla.polar(m)[0]),
    (PR.compute_root, RR.compute_root,
     lambda rng: create_matrix(rng, diag_dom=True), (3,),
     lambda m: sla.fractional_matrix_power(m, 1.0 / 3).real),
    (PR.compute_inverse_root, RR.compute_inverse_root,
     lambda rng: create_matrix(rng, diag_dom=True), (3,),
     lambda m: sla.fractional_matrix_power(m, -1.0 / 3).real),
    (PL.cg_solver, RL.cg_solver, _spd, ("b",),
     lambda m: np.linalg.solve(m, B_CG)),
    (PX.compute_exponential, RX.compute_exponential,
     lambda rng: create_matrix(rng, scaled=True), (), sla.expm),
    (PX.compute_logarithm, RX.compute_logarithm, _log_input, (),
     lambda m: np.real(sla.logm(m))),
    (PT.sine, RT.sine, create_matrix, (), sla.sinm),
    (PT.cosine, RT.cosine, create_matrix, (), sla.cosm),
]


@pytest.mark.parametrize("fn,fn_ref,make,args,oracle", CHUNKED,
                         ids=[c[0].__name__ for c in CHUNKED])
def test_chunked_driver_refused(rng, fn, fn_ref, make, args, oracle):
    """With iters_per_sync 4 the loops that the reference chunks run
    chunked (Hotelling, sign, CG, and the square roots under the roots
    and the logarithm) and the others eagerly (the polar factor, the
    exponential, sine and cosine), each as the reference's solve at the
    same setting, to 1e-10, and within the oracle bar (the polar
    factor's U)."""
    m = make(rng)
    (rm, pm), (rb, pb) = pair(m), pair(B_CG)
    rp, pp = params(iters_per_sync=4)
    ref = fn_ref(rm, *(rb if a == "b" else a for a in args), rp)
    got = fn(pm, *(pb if a == "b" else a for a in args), pp)
    if isinstance(ref, tuple):
        ref, got = ref[0], got[0]
    assert_both(np.asarray(RPM.to_dense(ref)), n(PPM.to_dense(got)),
                oracle(m))
