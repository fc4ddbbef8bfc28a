"""Hermite polynomial evaluation.

Counterpart of ``ntpoly_tpu/solvers/hermite.py``: the physicists'
recurrence H_(k+1) = 2 X H_k - 2k H_(k-1).
"""
from __future__ import annotations

from ..parallel import algebra as alg
from .common import (resolve, solver_log, maybe_permute, maybe_unpermute,
                     identity_like)
from .parameters import SolverParameters


class HermitePolynomial:
    def __init__(self, degree: int):
        self.coefficients = [0.0] * degree

    def set_coefficient(self, index: int, value: float):
        self.coefficients[index] = value


def compute(mat, poly: HermitePolynomial,
            params: SolverParameters | None = None):
    """sum_k c_k H_k(A)."""
    params, _ = resolve(params)
    c = poly.coefficients
    degree = len(c)
    with solver_log(params, "Hermite Solver", "Standard",
                    extra={"Degree": degree - 1}):
        imat = identity_like(mat)
        x, imat = maybe_permute(params, mat, imat)
        hkm1 = imat                               # H_0
        out = alg.scale(hkm1, c[0])
        if degree > 1:
            hk = alg.scale(x, 2.0)                # H_1 = 2X
            out = alg.increment(out, hk, 1.0, c[1])
            hprime = alg.scale(hkm1, 2.0)         # 2k H_(k-1)
            for ii in range(2, degree):
                hkp1 = alg.increment(
                    alg.matmul(x, hk, alpha=2.0,
                               threshold=params.threshold),
                    hprime, 1.0, -1.0)
                hprime = alg.scale(hk, 2.0 * ii)
                hkm1, hk = hk, hkp1
                out = alg.increment(out, hk, 1.0, c[ii])
        return maybe_unpermute(params, out)
