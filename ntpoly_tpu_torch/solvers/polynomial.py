"""Standard polynomial evaluation.

Counterpart of ``ntpoly_tpu/solvers/polynomial.py``: Horner's method,
and Paterson-Stockmeyer's factorization (paterson1973number), which
needs about 2 sqrt(degree) multiplies.  Coefficient k multiplies x^k.
"""
from __future__ import annotations

import math

from ..parallel import algebra as alg
from .common import (resolve, solver_log, maybe_permute, maybe_unpermute,
                     identity_like)
from .parameters import SolverParameters


class Polynomial:
    def __init__(self, degree: int):
        self.coefficients = [0.0] * degree

    def set_coefficient(self, index: int, value: float):
        self.coefficients[index] = value


def horner_compute(mat, poly: Polynomial,
                   params: SolverParameters | None = None):
    """sum_k c_k A^k by Horner's rule."""
    params, _ = resolve(params)
    c = poly.coefficients
    degree = len(c)
    with solver_log(params, "Polynomial Solver", "Horner",
                    extra={"Degree": degree - 1}):
        imat = identity_like(mat)
        x, imat = maybe_permute(params, mat, imat)
        if degree == 1:
            out = alg.scale(imat, c[0])
        else:
            out = alg.increment(alg.scale(imat, c[degree - 2]),
                                x, 1.0, c[degree - 1])
            for ii in range(degree - 3, -1, -1):
                out = alg.increment(
                    alg.matmul(x, out, threshold=params.threshold),
                    imat, 1.0, c[ii])
        return maybe_unpermute(params, out)


def paterson_stockmeyer_compute(mat, poly: Polynomial,
                                params: SolverParameters | None = None):
    """sum_k c_k A^k by Paterson-Stockmeyer: A^0 .. A^s with
    s = isqrt(degree), then Horner in A^s over blocks of s
    coefficients.  As in the reference, no load-balance permutation."""
    params, _ = resolve(params)
    thr = params.threshold
    c = poly.coefficients
    degree = len(c)
    with solver_log(params, "Polynomial Solver", "Paterson Stockmeyer",
                    citations=("paterson1973number",),
                    extra={"Degree": degree - 1}):
        m_value = degree - 1
        s = max(int(math.isqrt(m_value)), 1)
        r = m_value // s

        imat = identity_like(mat)
        x_powers = [imat]                        # X^0 .. X^s
        for ii in range(s):
            x_powers.append(alg.matmul(mat, x_powers[ii], threshold=thr))
        xs = x_powers[s]

        def block(k, top):
            bk = alg.scale(imat, c[s * k])
            for ii in range(1, top):
                bk = alg.increment(bk, x_powers[ii], 1.0, c[s * k + ii])
            return bk

        # top block: coefficients s*r .. m
        out = alg.matmul(block(r, m_value - s * r + 1), xs, threshold=thr)
        out = alg.increment(out, block(r - 1, s))
        for k in range(r - 2, -1, -1):
            bk = block(k, s)
            out = alg.matmul(xs, out, threshold=thr)
            out = alg.increment(out, bk)
        return out
