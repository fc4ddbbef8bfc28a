"""Matrix sign function and polar decomposition.

Counterpart of ``ntpoly_tpu/solvers/sign.py``: the scaled Newton-Schulz
iteration X <- (alpha_k / 2) X (3I - alpha_k^2 X^2) with alpha_k =
min(sqrt(3 / (1 + x + x^2)), 1.6977...) and x tracked on the host
(nicholas2008functions), or, with ``iters_per_sync > 1``, chunked
(``common.run_chunked``) with x in the carry on the device; the polar
factor takes X^H X in place of X^2, transposing the iterate every
iteration, and runs eagerly whatever ``iters_per_sync`` says, as in the
reference.  And the sign by eigendecomposition.
"""
from __future__ import annotations

import math

import torch

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, identity_like,
                     real_scalar, pin_capacity, run_chunked)
from .parameters import SolverParameters

ALPHA_MAX = 1.69770248526


def _core(mat, params, monitor, needs_transpose: bool):
    thr = params.threshold
    imat = identity_like(mat)
    out, imat = maybe_permute(params, mat, imat)
    e_min, e_max = torch.stack(alg.gershgorin_bounds(mat)).tolist()
    xk = abs(e_min / e_max)
    out = alg.scale(out, 1.0 / abs(e_max))
    if params.iters_per_sync > 1 and not needs_transpose:
        out, total = _core_chunked(out, imat, xk, params, monitor)
        finish_iterations(params, total + 1, out, monitor=monitor,
                          solver="Sign Solver")
        return maybe_unpermute(params, out)
    total = 0
    with iteration_log(params):
        for ii in range(params.max_iterations):
            alpha_k = min(math.sqrt(3.0 / (1.0 + xk + xk ** 2)), ALPHA_MAX)
            xk = 0.5 * alpha_k * xk * (3.0 - alpha_k ** 2 * xk ** 2)
            left = alg.transpose(out).conjugate() if needs_transpose \
                else out
            t1 = alg.matmul(left, out, alpha=-alpha_k ** 2, threshold=thr)
            del left
            t1 = alg.increment(t1, imat, 1.0, 3.0)
            t2 = alg.matmul(out, t1, alpha=0.5 * alpha_k, threshold=thr)
            del t1
            norm_value = real_scalar(
                alg.norm(alg.increment(out, t2, 1.0, -1.0)))
            out = t2
            total = ii
            monitor.append(norm_value)
            if monitor.check_converged(params.be_verbose):
                break
    finish_iterations(params, total + 1, out, monitor=monitor,
                      solver="Sign Solver")
    return maybe_unpermute(params, out)


def _core_chunked(out, imat, xk0, params, monitor):
    """The scaled Newton-Schulz step chunked (reference
    ``_core_chunked``): x rides in the carry as a float64 device scalar,
    as the eager loop's on the host, and alpha_k reaches the multiplies
    as a device scalar (``sp.spgemm``) -> (X, iterations)."""
    thr = params.threshold
    k_pin, (out, imatp) = pin_capacity(params, out, imat)

    def step(carry, imatc):
        xc, xk = carry
        alpha_k = torch.clamp(torch.sqrt(3.0 / (1.0 + xk + xk ** 2)),
                              max=ALPHA_MAX)
        xk_new = 0.5 * alpha_k * xk * (3.0 - alpha_k ** 2 * xk ** 2)
        t1 = alg.matmul(xc, xc, alpha=-alpha_k ** 2, threshold=thr)
        t1 = alg.increment(t1, imatc, 1.0, 3.0)
        t2 = alg.matmul(xc, t1, alpha=0.5 * alpha_k, threshold=thr)
        del t1
        norm_value = alg.norm(alg.increment(xc, t2, 1.0, -1.0))
        return (t2, xk_new), (norm_value,)

    carry0 = (out, torch.full((), xk0, dtype=torch.float64,
                              device=out.device))
    with iteration_log(params) as ilog:
        (out, _), _, total = run_chunked(
            step, carry0, (imatp,), params, monitor, ilog, k_pin=k_pin,
            aux_names=("Convergence",), conv_mode="value",
            cache_key=("sign_core", thr))
    return out, total


def sign_function(mat, params: SolverParameters | None = None):
    """sign(A) for a Hermitian A."""
    params, monitor = resolve(params)
    with solver_log(params, "Sign Function Solver",
                    citations=("nicholas2008functions",)):
        return _core(mat, params, monitor, needs_transpose=False)


def polar_decomposition(mat, params: SolverParameters | None = None):
    """A = U H -> (U, H)."""
    params, monitor = resolve(params)
    with solver_log(params, "Polar Decomposition Solver",
                    citations=("nicholas2008functions",)):
        u = _core(mat, params, monitor, needs_transpose=True)
        ut = alg.transpose(u).conjugate()
        h = alg.matmul(ut, mat, threshold=params.threshold)
        return u, h


def dense_sign_function(mat, params: SolverParameters | None = None):
    """sign(A) by eigendecomposition (sign(0) = 1)."""
    from .eigen import dense_matrix_function
    params, _ = resolve(params)
    with solver_log(params, "Sign Function Solver"):
        return dense_matrix_function(
            mat, lambda w: (w >= 0) * 2.0 - 1.0, params)
