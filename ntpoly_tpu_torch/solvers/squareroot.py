"""Matrix square root and inverse square root.

Counterpart of ``ntpoly_tpu/solvers/squareroot.py``: the coupled
Newton-Schulz iterations (jansik2007linear), order 2 with a Gershgorin
rescale every iteration, and the Taylor variants of order 3 and 5 (5
is the default), each chunked with ``iters_per_sync > 1``
(``common.run_chunked``; the rescale stays on the device); and the
dense square roots by eigendecomposition
(``eigen.dense_matrix_function``).

The inverse square root of the overlap S is what a purification solver
takes to work in the orthogonal basis (``density.trs4(H, ISQ, nel)``).
"""
from __future__ import annotations

import math

import torch

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, identity_like,
                     real_scalar, pin_capacity, run_chunked)
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
    thr = params.threshold
    with solver_log(params, "Newton Schultz Inverse Square Root",
                    citations=("jansik2007linear",)):
        imat = identity_like(mat)
        y = mat                                   # square root iterate
        z = identity_like(mat)                    # inverse square root
        y, imat, z = maybe_permute(params, y, imat, z)
        if params.iters_per_sync > 1:
            y, z, total = _ns_order2_chunked(y, z, imat, params, monitor)
            out = z if compute_inverse else y
            finish_iterations(params, total + 1, out, monitor=monitor,
                              solver="Square Root Solver")
            return maybe_unpermute(params, out)
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
    thr = params.threshold
    with solver_log(params, "Newton Schultz Inverse Square Root",
                    citations=("jansik2007linear",),
                    extra={"Order": order}):
        imat = identity_like(mat)
        lam = _scale_of(mat)
        y = alg.scale(mat, lam)
        z = identity_like(mat)
        y, imat, z = maybe_permute(params, y, imat, z)
        sq = math.sqrt(lam)
        if params.iters_per_sync > 1:
            y, z, total = _ns_taylor_chunked(y, z, imat, order, params,
                                             monitor)
            # as the reference: the monitor is not passed here
            finish_iterations(params, total + 1,
                              z if compute_inverse else y)
            out = alg.scale(z, sq) if compute_inverse \
                else alg.scale(y, 1.0 / sq)
            return maybe_unpermute(params, out)
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


def _ns_order2_chunked(y, z, imat, params, monitor):
    """Order 2 chunked (reference ``_ns_order2_chunked``): the Gershgorin
    rescale as device scalars (float64, as the eager loop's on the
    host) -> (Y, Z, iterations)."""
    thr = params.threshold
    k_pin, (y, z, imatp) = pin_capacity(params, y, z, imat, n_carry=2)

    def step(carry, imatc):
        yc, zc = carry
        x = alg.matmul(yc, zc, threshold=thr)
        lo, hi = alg.gershgorin_bounds(x)
        lam = 1.0 / torch.maximum(lo.double().abs(), hi.double().abs())
        x = alg.scale(x, lam)
        norm_value = alg.norm(alg.increment(imatc, x, 1.0, -1.0))
        tk = alg.scale(alg.increment(imatc, x, 3.0, -1.0), 0.5)
        del x
        sq = lam.sqrt()
        z_new = alg.scale(alg.matmul(zc, tk, threshold=thr), sq)
        y_new = alg.scale(alg.matmul(tk, yc, threshold=thr), sq)
        return (y_new, z_new), (norm_value,)

    with iteration_log(params) as ilog:
        (y, z), _, total = run_chunked(
            step, (y, z), (imatp,), params, monitor, ilog, k_pin=k_pin,
            aux_names=("Convergence",), conv_mode="value",
            cache_key=("ns_order2", thr))
    return y, z, total


def _ns_taylor_chunked(y, z, imat, order, params, monitor):
    """Taylor orders 3 and 5 chunked (reference ``_ns_taylor_chunked``)
    -> (Y, Z, iterations)."""
    thr = params.threshold
    k_pin, (y, z, imatp) = pin_capacity(params, y, z, imat, n_carry=2)

    def step(carry, imatc):
        yc, zc = carry
        x = alg.increment(alg.matmul(zc, yc, threshold=thr), imatc,
                          1.0, -1.0)
        norm_value = alg.norm(x)
        x = _taylor_update(x, imatc, order, thr)
        z_new = alg.matmul(x, zc, threshold=thr)
        y_new = alg.matmul(yc, x, threshold=thr)
        return (y_new, z_new), (norm_value,)

    with iteration_log(params) as ilog:
        (y, z), _, total = run_chunked(
            step, (y, z), (imatp,), params, monitor, ilog, k_pin=k_pin,
            aux_names=("Convergence",), conv_mode="value",
            cache_key=("ns_taylor", order, thr))
    return y, z, total


def dense_square_root(mat, params: SolverParameters | None = None):
    """The square root by eigendecomposition."""
    from .eigen import dense_matrix_function
    params, _ = resolve(params)
    with solver_log(params, "Square Root Solver"):
        return dense_matrix_function(mat, lambda w: w ** 0.5, params)


def dense_inverse_square_root(mat, params: SolverParameters | None = None):
    """The inverse square root by eigendecomposition."""
    from .eigen import dense_matrix_function
    params, _ = resolve(params)
    with solver_log(params, "Square Root Solver"):
        return dense_matrix_function(mat, lambda w: w ** -0.5, params)
