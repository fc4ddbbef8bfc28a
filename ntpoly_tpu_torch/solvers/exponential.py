"""Matrix exponential and logarithm.

Counterpart of ``ntpoly_tpu/solvers/exponential.py``.  The exponential
power-bounds the spectrum, scales it by 2^-k into [-1, 1], evaluates a
16-term Chebyshev expansion (c_0 = I_0(1), c_k = 2 I_k(1)) and squares
k times; or a Taylor series to A^10 / 10! after a much deeper scaling
(with the factorials the JAX package leaves out), or a Pade
approximant whose denominator is solved by CG.  The logarithm
takes the 2^k-th root that lands the spectrum in [1/sqrt(2), sqrt(2)]
(as the JAX package, and unlike the reference, rooting on until the
Gershgorin lower edge fits too), evaluates a 32-term Chebyshev fit of
log(1 + x) there and scales by 2^k; or square roots and a Taylor
series.  The dense versions diagonalize.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel import algebra as alg
from . import chebyshev
from .common import (resolve, solver_log, maybe_permute, maybe_unpermute,
                     identity_like)
from .eigenbounds import power_bounds
from .parameters import SolverParameters


def _exp_cheby_coefficients(n: int = 16) -> list[float]:
    from scipy.special import iv
    coeffs = [float(iv(0, 1.0))]
    coeffs += [2.0 * float(iv(k, 1.0)) for k in range(1, n)]
    return coeffs


def _log1p_cheby_coefficients(n: int = 32) -> list[float]:
    """Least-squares fit of log(1 + x) over the rooted spectrum's window
    [1/sqrt(2) - 1, sqrt(2) - 1] in the Chebyshev basis of [-1, 1]."""
    lo, hi = 1.0 / math.sqrt(2.0) - 1.0, math.sqrt(2.0) - 1.0
    x = np.linspace(lo, hi, 2048)
    basis = np.polynomial.chebyshev.chebvander(x, n - 1)
    coeffs, *_ = np.linalg.lstsq(basis, np.log1p(x), rcond=None)
    return [float(c) for c in coeffs]


def _scale_squaring_count(spectral_radius: float, limit: float = 1.0):
    """(sigma = 2^(counter - 1), counter) with radius / sigma <= limit."""
    sigma = 1.0
    counter = 1
    while spectral_radius / sigma > limit:
        sigma *= 2
        counter += 1
    return sigma, counter


def _chebyshev_polynomial(coeffs):
    poly = chebyshev.ChebyshevPolynomial(len(coeffs))
    for i, cv in enumerate(coeffs):
        poly.set_coefficient(i, cv)
    return poly


def _square(out, counter, params):
    for _ in range(counter - 1):
        out = alg.matmul(out, out, threshold=params.threshold)
    return out


def compute_exponential(mat, params: SolverParameters | None = None):
    """exp(A) by Chebyshev and scale-and-square."""
    params, _ = resolve(params)
    with solver_log(params, "Exponential Solver", "Chebyshev"):
        psub = params.copy()
        psub.max_iterations = 10
        sigma, counter = _scale_squaring_count(power_bounds(mat, psub))
        scaled = alg.scale(mat, 1.0 / sigma)
        sub = params.copy()
        sub.threshold = sub.threshold / sigma
        out = chebyshev.compute(
            scaled, _chebyshev_polynomial(_exp_cheby_coefficients(16)), sub)
        del scaled
        out, = maybe_permute(params, out)
        return maybe_unpermute(params, _square(out, counter, params))


def compute_exponential_pade(mat, params: SolverParameters | None = None):
    """exp(A) by scaling, a Pade approximant (P1 - P2)^-1 (P1 + P2)
    solved by CG, and squaring."""
    from .linear import cg_solver
    params, _ = resolve(params)
    with solver_log(params, "Exponential Solver", "Pade"):
        imat = identity_like(mat)
        sigma, counter = _scale_squaring_count(float(alg.norm(mat)))
        scaled = alg.scale(mat, 1.0 / sigma)
        sub = params.copy()
        sub.threshold = sub.threshold / sigma
        b1 = alg.matmul(scaled, scaled, threshold=sub.threshold)
        b2 = alg.matmul(b1, b1, threshold=sub.threshold)
        b3 = alg.matmul(b2, b2, threshold=sub.threshold)
        p1 = alg.increment(
            alg.increment(alg.increment(alg.scale(imat, 17297280.0),
                                        b1, 1.0, 1995840.0),
                          b2, 1.0, 25200.0),
            b3, 1.0, 56.0)
        tmp = alg.increment(
            alg.increment(alg.increment(alg.scale(imat, 8648640.0),
                                        b1, 1.0, 277200.0),
                          b2, 1.0, 1512.0),
            b3, 1.0, 1.0)
        del b1, b2, b3
        p2 = alg.matmul(scaled, tmp, threshold=sub.threshold)
        left = alg.increment(p1, p2, 1.0, -1.0)
        right = alg.increment(p1, p2, 1.0, 1.0)
        del p1, p2, tmp
        return _square(cg_solver(left, right, sub), counter, params)


def compute_exponential_taylor(mat, params: SolverParameters | None = None):
    """exp(A) by the Taylor series to A^10 / 10! after scaling the
    radius below 3e-8, then squaring.  The JAX package's series leaves
    out the 1/k! (its terms are plain powers), which costs nothing once
    the scaling leaves A^2 below rounding, but where no scaling happens
    (a power bound of 0, as on a graph Laplacian, which annihilates the
    uniform start vector) it sums a geometric series instead: the port
    keeps the factorials (ROADMAP Queue C).  In float32 the scaled
    radius 3e-8 lies below the unit roundoff, so I + A / sigma keeps
    little of A there."""
    params, _ = resolve(params)
    with solver_log(params, "Exponential Solver", "Taylor"):
        psub = params.copy()
        psub.max_iterations = 10
        sigma, counter = _scale_squaring_count(power_bounds(mat, psub),
                                               3.0e-8)
        scaled = alg.scale(mat, 1.0 / sigma)
        out = identity_like(mat)
        scaled, out = maybe_permute(params, scaled, out)
        ak = out
        for ii in range(1, 11):
            ak = alg.matmul(ak, scaled, alpha=1.0 / ii,
                            threshold=params.threshold)
            out = alg.increment(out, ak)
        del ak, scaled
        return maybe_unpermute(params, _square(out, counter, params))


def compute_logarithm(mat, params: SolverParameters | None = None):
    """log(A) by a 2^k-th root, Chebyshev of log(1 + x) and rescaling.
    The root is deepened until the radius is at most sqrt(2) and, for a
    positive Gershgorin lower edge, that edge is at least 1/sqrt(2)."""
    from .roots import compute_root
    params, _ = resolve(params)
    with solver_log(params, "Logarithm Solver", "Chebyshev"):
        imat = identity_like(mat)
        psub = params.copy()
        psub.max_iterations = 16
        spectral_radius = power_bounds(mat, psub)
        lo_bound = float(alg.gershgorin_bounds(mat)[0])
        sigma = 1
        counter = 1
        while (spectral_radius > math.sqrt(2.0)
               or (0.0 < lo_bound < 1.0 / math.sqrt(2.0))):
            spectral_radius = math.sqrt(spectral_radius)
            if lo_bound > 0.0:
                lo_bound = math.sqrt(lo_bound)
            sigma *= 2
            counter += 1
        fsub = params.copy()
        fsub.threshold = fsub.threshold / (2.0 ** (counter - 1))
        scaled = alg.increment(compute_root(mat, sigma, params), imat,
                               1.0, -1.0)
        out = chebyshev.factorized_compute(
            scaled, _chebyshev_polynomial(_log1p_cheby_coefficients(32)),
            fsub)
        return alg.scale(out, float(sigma))


def compute_logarithm_taylor(mat, params: SolverParameters | None = None):
    """log(A) by square roots until the radius is at most 1.1, a
    10-term Taylor series of log(1 + x) and rescaling."""
    from .squareroot import square_root
    params, _ = resolve(params)
    with solver_log(params, "Logarithm Solver", "Taylor"):
        imat = identity_like(mat)
        psub = params.copy()
        psub.max_iterations = 10
        spectral_radius = power_bounds(mat, psub)
        sigma = 1
        counter = 1
        while spectral_radius > 1.1:
            spectral_radius = math.sqrt(spectral_radius)
            sigma *= 2
            counter += 1
        scaled = mat
        for _ in range(counter - 1):
            scaled = square_root(scaled, params)
        scaled = alg.increment(scaled, imat, 1.0, -1.0)
        ak = scaled
        out = alg.scale(scaled, 1.0)
        sign = 1.0
        for ii in range(2, 11):
            sign = -sign
            ak = alg.matmul(ak, scaled, threshold=params.threshold)
            out = alg.increment(out, ak, 1.0, sign / ii)
        return alg.scale(out, float(sigma))


def compute_dense_exponential(mat, params: SolverParameters | None = None):
    """exp(A) by eigendecomposition."""
    from .eigen import dense_matrix_function
    params, _ = resolve(params)
    with solver_log(params, "Exponential Solver"):
        return dense_matrix_function(mat, torch.exp, params)


def compute_dense_logarithm(mat, params: SolverParameters | None = None):
    """log(A) by eigendecomposition."""
    from .eigen import dense_matrix_function
    params, _ = resolve(params)
    with solver_log(params, "Logarithm Solver"):
        return dense_matrix_function(mat, torch.log, params)
