"""Matrix square root and inverse square root.

Counterpart of ``ntpoly_tpu/solvers/squareroot.py``, eager path only:
the coupled Newton-Schulz iterations (jansik2007linear), order 2 with
a Gershgorin rescale every iteration, and the Taylor variants of order
3 and 5 (5 is the default).  ``iters_per_sync > 1`` (the chunked
driver) is ROADMAP Queue A item 7; the dense square roots wait for
``eigen.py``'s dense path (Queue A item 5).

The inverse square root of the overlap S is what a purification solver
takes to work in the orthogonal basis (``density.trs4(H, ISQ, nel)``).
"""
from __future__ import annotations

import math

import torch

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, identity_like,
                     real_scalar, eager_only)
from .parameters import SolverParameters


def square_root(mat, params: SolverParameters | None = None, order: int = 5):
    return _selector(mat, params, compute_inverse=False, order=order)


def inverse_square_root(mat, params: SolverParameters | None = None,
                        order: int = 5):
    return _selector(mat, params, compute_inverse=True, order=order)


def _selector(mat, params, compute_inverse: bool, order: int):
    if order == 2:
        return _ns_order2(mat, params, compute_inverse)
    if order not in (3, 5):
        raise ValueError(f"unsupported Taylor order {order}")
    return _ns_taylor(mat, params, order, compute_inverse)


def _scale_of(m) -> float:
    """1 / max(|e_min|, |e_max|) of the Gershgorin bounds (one
    readback)."""
    lo, hi = torch.stack(alg.gershgorin_bounds(m)).tolist()
    return 1.0 / max(abs(lo), abs(hi))


def _ns_order2(mat, params, compute_inverse):
    """Order 2: X = lam Y Z, T = (3I - X) / 2, Z <- sqrt(lam) Z T,
    Y <- sqrt(lam) T Y."""
    params, monitor = resolve(params)
    eager_only(params)
    thr = params.threshold
    with solver_log(params, "Newton Schultz Inverse Square Root",
                    citations=("jansik2007linear",)):
        imat = identity_like(mat)
        y = mat                                   # square root iterate
        z = identity_like(mat)                    # inverse square root
        y, imat, z = maybe_permute(params, y, imat, z)
        total = 0
        with iteration_log(params):
            for ii in range(params.max_iterations):
                x = alg.matmul(y, z, threshold=thr)
                lam = _scale_of(x)
                x = alg.scale(x, lam)
                norm_value = real_scalar(
                    alg.norm(alg.increment(imat, x, 1.0, -1.0)))
                tk = alg.scale(alg.increment(imat, x, 3.0, -1.0), 0.5)
                del x
                sq = math.sqrt(lam)
                z = alg.scale(alg.matmul(z, tk, threshold=thr), sq)
                y = alg.scale(alg.matmul(tk, y, threshold=thr), sq)
                del tk
                total = ii
                monitor.append(norm_value)
                if monitor.check_converged(params.be_verbose):
                    break
        out = z if compute_inverse else y
        finish_iterations(params, total + 1, out, monitor=monitor,
                          solver="Square Root Solver")
        return maybe_unpermute(params, out)


def _ns_taylor(mat, params, order, compute_inverse):
    """Taylor orders 3 and 5 on Y = lam S: X = Z Y - I, the correction
    T(X) of :func:`_taylor_update`, Z <- T Z, Y <- Y T; the result is
    scaled back by sqrt(lam)."""
    params, monitor = resolve(params)
    eager_only(params)
    thr = params.threshold
    with solver_log(params, "Newton Schultz Inverse Square Root",
                    citations=("jansik2007linear",),
                    extra={"Order": order}):
        imat = identity_like(mat)
        lam = _scale_of(mat)
        y = alg.scale(mat, lam)
        z = identity_like(mat)
        y, imat, z = maybe_permute(params, y, imat, z)
        total = 0
        with iteration_log(params):
            for ii in range(params.max_iterations):
                x = alg.increment(alg.matmul(z, y, threshold=thr),
                                  imat, 1.0, -1.0)
                norm_value = real_scalar(alg.norm(x))
                x = _taylor_update(x, imat, order, thr)
                z = alg.matmul(x, z, threshold=thr)
                y = alg.matmul(y, x, threshold=thr)
                del x
                total = ii
                monitor.append(norm_value)
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, z if compute_inverse else y,
                          monitor=monitor, solver="Square Root Solver")
        sq = math.sqrt(lam)
        out = alg.scale(z, sq) if compute_inverse else alg.scale(y, 1.0 / sq)
        return maybe_unpermute(params, out)


def _taylor_update(x, imat, order, thr):
    """The order-3/5 Taylor polynomial of the Newton-Schulz
    correction."""
    if order == 3:
        x2 = alg.matmul(x, x, threshold=thr)
        return alg.increment(
            alg.increment(imat, x, 1.0, -0.5), x2, 1.0, 0.375)
    aa, bb = -40.0 / 35.0, 48.0 / 35.0
    cc, dd = -64.0 / 35.0, 128.0 / 35.0
    a = (aa - 1.0) / 2.0
    b = bb * (a + 1.0) - cc - a * (a + 1.0) ** 2
    c = bb - b - a * (a + 1.0)
    d = dd - b * c
    x2 = alg.matmul(x, x, threshold=thr)
    t = alg.increment(x2, x, 1.0, a)
    del x2
    t2 = alg.increment(alg.increment(alg.scale(imat, b), x), t, 1.0, 1.0)
    t = alg.increment(t, imat, 1.0, c)
    x = alg.increment(alg.matmul(t2, t, threshold=thr), imat, 1.0, d)
    return alg.scale(x, 35.0 / 128.0)


def dense_square_root(mat, params: SolverParameters | None = None):
    """The square root by eigendecomposition: needs ``eigen.py``."""
    raise ValueError(
        "dense_square_root needs eigen.dense_matrix_function, which is "
        "not ported yet (ROADMAP Queue A item 5)")


def dense_inverse_square_root(mat, params: SolverParameters | None = None):
    """The inverse square root by eigendecomposition: needs
    ``eigen.py``."""
    raise ValueError(
        "dense_inverse_square_root needs eigen.dense_matrix_function, "
        "which is not ported yet (ROADMAP Queue A item 5)")
