"""Density-matrix extrapolation between geometry steps.

Counterpart of ``ntpoly_tpu/solvers/geometry.py``, run eagerly
whatever ``iters_per_sync`` says, as in the reference (the square roots
of ``lowdin_extrapolate`` run chunked with it):
``purification_extrapolate`` (niklasson2010trace) re-purifies the
previous density against the new overlap, X <- 2X - XSX or XSX by
the trace; ``lowdin_extrapolate`` (exner2002comparison) maps it
through the square roots, D_new = ISQR(S_new) SR(S_old) D SR(S_old)
ISQR(S_new).
"""
from __future__ import annotations

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, real_scalar)
from .parameters import SolverParameters


def purification_extrapolate(previous_density, overlap, trace,
                             params: SolverParameters | None = None):
    params, monitor = resolve(params)
    thr = params.threshold
    with solver_log(params, "Density Matrix Extrapolator", "Purification",
                    citations=("niklasson2010trace",)):
        d, s = maybe_permute(params, previous_density, overlap)
        total = 0
        with iteration_log(params):
            for ii in range(params.max_iterations):
                dsd = alg.matmul(alg.matmul(d, s, threshold=thr), d,
                                 threshold=thr)
                trace_value = real_scalar(alg.dot(d, s))
                if trace > trace_value:
                    new = alg.increment(d, dsd, 2.0, -1.0)   # 2D - DSD
                else:
                    new = dsd
                norm_value = real_scalar(
                    alg.norm(alg.increment(d, new, 1.0, -1.0)))
                d = new
                total = ii
                monitor.append(norm_value)
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, d, monitor=monitor,
                          solver="Geometry Optimization")
        return maybe_unpermute(params, d)


def lowdin_extrapolate(previous_density, old_overlap, new_overlap,
                       params: SolverParameters | None = None):
    from .squareroot import square_root, inverse_square_root
    params, _ = resolve(params)
    with solver_log(params, "Density Matrix Extrapolator", "Lowdin",
                    citations=("exner2002comparison",)):
        sqr = square_root(old_overlap, params)
        isq = inverse_square_root(new_overlap, params)
        tmp = alg.similarity_transform(previous_density, sqr, sqr,
                                       threshold=params.threshold)
        return alg.similarity_transform(tmp, isq, isq,
                                        threshold=params.threshold)
