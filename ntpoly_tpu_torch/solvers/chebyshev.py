"""Chebyshev polynomial evaluation.

Counterpart of ``ntpoly_tpu/solvers/chebyshev.py``: ``compute`` runs
the three-term recurrence T_k = 2 X T_(k-1) - T_(k-2);
``factorized_compute`` splits the coefficients recursively over the
powers T_(2^i) (liang2003improved), about half the multiplies for a
long expansion.
"""
from __future__ import annotations

from ..parallel import algebra as alg
from .common import (resolve, solver_log, maybe_permute, maybe_unpermute,
                     identity_like)
from .parameters import SolverParameters


class ChebyshevPolynomial:
    """Coefficients c_k of sum_k c_k T_k(x)."""

    def __init__(self, degree: int):
        self.coefficients = [0.0] * degree

    def set_coefficient(self, index: int, value: float):
        self.coefficients[index] = value


def compute(mat, poly: ChebyshevPolynomial,
            params: SolverParameters | None = None):
    """sum_k c_k T_k(A) by the three-term recurrence."""
    params, _ = resolve(params)
    thr = params.threshold
    c = poly.coefficients
    degree = len(c)
    with solver_log(params, "Chebyshev Solver", "Standard",
                    extra={"Degree": degree - 1}):
        imat = identity_like(mat)
        x, imat = maybe_permute(params, mat, imat)
        tkm2 = imat
        if degree == 1:
            out = alg.scale(tkm2, c[0])
        else:
            tkm1 = x
            out = alg.increment(alg.scale(tkm2, c[0]), tkm1, 1.0, c[1])
            for ii in range(2, degree):
                tk = alg.increment(
                    alg.matmul(x, tkm1, alpha=2.0, threshold=thr),
                    tkm2, 1.0, -1.0)
                out = alg.increment(out, tk, 1.0, c[ii])
                tkm2, tkm1 = tkm1, tk
        return maybe_unpermute(params, out)


def factorized_compute(mat, poly: ChebyshevPolynomial,
                       params: SolverParameters | None = None):
    """sum_k c_k T_k(A) by the recursive split over T_(2^i)."""
    params, _ = resolve(params)
    c = list(poly.coefficients)
    degree = len(c)
    with solver_log(params, "Chebyshev Solver", "Recursive",
                    extra={"Degree": degree - 1}):
        imat = identity_like(mat)
        x, imat = maybe_permute(params, mat, imat)
        log2degree = 1
        while 2 ** log2degree <= degree:
            log2degree += 1
        t_powers = [imat]
        if degree == 1:
            out = t_powers[0]
        else:
            t_powers.append(x)
            for _ in range(2, log2degree):
                prev = t_powers[-1]
                t_powers.append(alg.increment(
                    alg.matmul(prev, prev, alpha=2.0,
                               threshold=params.threshold),
                    imat, 1.0, -1.0))
            out = _compute_recursive(t_powers, c, 1, params)
        return maybe_unpermute(params, out)


def _compute_recursive(t_powers, c, depth, params):
    """Split the coefficients at the midpoint m, fold the tail into the
    left half (T_(m+k) + T_(m-k) = 2 T_m T_k), recurse."""
    if len(c) == 1:
        return alg.scale(t_powers[0], c[0])
    if len(c) == 2:
        return alg.increment(alg.scale(t_powers[0], c[0]),
                             t_powers[1], 1.0, c[1])
    mid = len(c) // 2
    left = list(c[:mid])
    right = list(c[mid:])
    for ii in range(1, len(left)):
        left[ii] -= c[len(c) - ii]
    left_mat = _compute_recursive(t_powers, left, depth + 1, params)
    full_mid = len(t_powers) - depth
    right_mat = _compute_recursive(t_powers, right, depth + 1, params)
    out = alg.matmul(t_powers[full_mid], right_mat, alpha=2.0,
                     threshold=params.threshold)
    out = alg.increment(out, left_mat)
    return alg.increment(out, t_powers[full_mid], 1.0, -right[0])
