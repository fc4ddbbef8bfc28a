"""Linear solvers.

Counterpart of ``ntpoly_tpu/solvers/linear.py``: the matrix conjugate
gradient with trace-ratio step sizes, eager path.  The blocked
Cholesky factorization is ROADMAP Queue A item 6.8 and raises.
"""
from __future__ import annotations

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, identity_like,
                     real_scalar, eager_only)
from .parameters import SolverParameters


def cg_solver(amat, bmat, params: SolverParameters | None = None):
    """X with A X = B for a symmetric positive definite A, from X = I;
    converged on |step| ||P||."""
    params, monitor = resolve(params)
    eager_only(params)
    thr = params.threshold
    with solver_log(params, "Linear Solver", "CG"):
        imat = identity_like(amat)
        ab, bb, imat = maybe_permute(params, amat, bmat, imat)
        x = imat
        r = alg.increment(bb, alg.matmul(ab, x, threshold=thr), 1.0, -1.0)
        p = r
        total = 0
        with iteration_log(params):
            for ii in range(params.max_iterations):
                q = alg.matmul(ab, p, threshold=thr)
                top, bottom = (real_scalar(v) for v in (alg.dot(r, r),
                                                        alg.dot(p, q)))
                step = top / bottom
                x = alg.increment(x, p, 1.0, step)
                norm_value = abs(step * real_scalar(alg.norm(p)))
                r = alg.increment(r, q, 1.0, -step)
                del q
                new_top = real_scalar(alg.dot(r, r))
                p = alg.increment(r, p, 1.0, new_top / top)
                total = ii
                monitor.append(norm_value)
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Linear Solver")
        return maybe_unpermute(params, x)


def cholesky_decomposition(amat, params: SolverParameters | None = None):
    """The blocked right-looking Cholesky factorization: not ported
    yet."""
    raise ValueError("cholesky_decomposition is not ported yet (ROADMAP "
                     "Queue A item 6.8, with analysis.py)")
