"""Matrix inverse.

Counterpart of ``ntpoly_tpu/solvers/inverse.py``, eager path: the
Hotelling (Newton) iteration X <- 2X - X A X from Ozaki's start
X = sigma A (ozaki2001efficient, ``alg.matrix_sigma``), converged on
the norm of I - X A; and the inverse by eigendecomposition.
"""
from __future__ import annotations

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, identity_like,
                     real_scalar, eager_only)
from .parameters import SolverParameters


def _hotelling(mat, params, monitor):
    eager_only(params)
    thr = params.threshold
    imat = identity_like(mat)
    balanced, imat = maybe_permute(params, mat, imat)
    x = alg.scale(balanced, real_scalar(alg.matrix_sigma(balanced)))
    total = 0
    with iteration_log(params):
        for ii in range(params.max_iterations):
            t1 = alg.matmul(x, balanced, threshold=thr)
            norm_value = real_scalar(
                alg.norm(alg.increment(imat, t1, 1.0, -1.0)))
            x = alg.increment(alg.scale(x, 2.0),
                              alg.matmul(t1, x, threshold=thr),
                              1.0, -1.0, threshold=thr)
            del t1
            total = ii
            monitor.append(norm_value)
            if monitor.check_converged(params.be_verbose):
                break
    finish_iterations(params, total, x, monitor=monitor,
                      solver="Inverse Solver")
    return maybe_unpermute(params, x)


def invert(mat, params: SolverParameters | None = None):
    """A^-1 by the Hotelling iteration."""
    params, monitor = resolve(params)
    with solver_log(params, "Inverse Solver",
                    citations=("palser1998canonical",
                               "ozaki2001efficient")):
        return _hotelling(mat, params, monitor)


def pseudo_inverse(mat, params: SolverParameters | None = None):
    """The Moore-Penrose pseudo-inverse by the same iteration, which
    converges on the row and column space."""
    params, monitor = resolve(params)
    with solver_log(params, "Inverse Solver",
                    citations=("palser1998canonical",)):
        return _hotelling(mat, params, monitor)


def dense_invert(mat, params: SolverParameters | None = None):
    """A^-1 by eigendecomposition."""
    from .eigen import dense_matrix_function
    params, _ = resolve(params)
    with solver_log(params, "Inverse Solver"):
        return dense_matrix_function(mat, lambda w: 1.0 / w, params)
