"""Matrix inverse.

Counterpart of ``ntpoly_tpu/solvers/inverse.py``: the Hotelling
(Newton) iteration X <- 2X - X A X from Ozaki's start X = sigma A
(ozaki2001efficient, ``alg.matrix_sigma``), converged on the norm of
I - X A, chunked with ``iters_per_sync > 1`` (``common.run_chunked``);
and the inverse by eigendecomposition.
"""
from __future__ import annotations

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, identity_like,
                     real_scalar, pin_capacity, run_chunked)
from .parameters import SolverParameters


def _hotelling(mat, params, monitor):
    thr = params.threshold
    imat = identity_like(mat)
    balanced, imat = maybe_permute(params, mat, imat)
    x = alg.scale(balanced, real_scalar(alg.matrix_sigma(balanced)))
    if params.iters_per_sync > 1:
        x, total = _hotelling_chunked(x, balanced, imat, params, monitor)
        finish_iterations(params, total, x, monitor=monitor,
                          solver="Inverse Solver")
        return maybe_unpermute(params, x)
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


def _hotelling_chunked(x, balanced, imat, params, monitor):
    """The Hotelling step chunked (reference ``_hotelling_chunked``)."""
    thr = params.threshold
    k_pin, (x, balp, imatp) = pin_capacity(params, x, balanced, imat)

    def step(xc, balc, imatc):
        t1 = alg.matmul(xc, balc, threshold=thr)
        norm_value = alg.norm(alg.increment(imatc, t1, 1.0, -1.0))
        x_new = alg.increment(alg.scale(xc, 2.0),
                              alg.matmul(t1, xc, threshold=thr),
                              1.0, -1.0, threshold=thr)
        return x_new, (norm_value,)

    with iteration_log(params) as ilog:
        x, _, total = run_chunked(
            step, x, (balp, imatp), params, monitor, ilog, k_pin=k_pin,
            aux_names=("Convergence",), conv_mode="value",
            cache_key=("hotelling", thr))
    return x, total


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
