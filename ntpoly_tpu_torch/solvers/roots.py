"""Matrix p-th roots and inverse p-th roots.

Counterpart of ``ntpoly_tpu/solvers/roots.py``: roots 1-4 and the
powers of two by square roots (repeated square roots are far better
conditioned than the general path, which matters for the logarithm's
2^k-th roots); the other roots as A^(1/p) = A (A^p)^(1/p - 1), the
power by Paterson-Stockmeyer and the inverse root by a coupled Newton
iteration on the fourth root of A, with a target root chosen by p mod
4.
"""
from __future__ import annotations

import math

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, identity_like,
                     real_scalar)
from .parameters import SolverParameters


def compute_root(mat, root: int, params: SolverParameters | None = None):
    """A^(1/root)."""
    from .squareroot import square_root
    params, _ = resolve(params)
    with solver_log(params, "Root Solver", extra={"Root": root}):
        if root == 1:
            return mat
        if root == 2:
            return square_root(mat, params)
        if root == 3:
            squared = alg.matmul(mat, mat, threshold=params.threshold)
            return _root_implementation(squared, 6, params)
        if root == 4:
            return square_root(square_root(mat, params), params)
        if root & (root - 1) == 0:
            out = mat
            while root > 1:
                out = square_root(out, params)
                root //= 2
            return out
        return _root_implementation(mat, root, params)


def _root_implementation(mat, root: int, params):
    """A^(1/root) = A (A^(root-1))^(-1/root)."""
    from .polynomial import Polynomial, paterson_stockmeyer_compute
    poly = Polynomial(root)
    poly.set_coefficient(root - 1, 1.0)
    raised = paterson_stockmeyer_compute(mat, poly, params)  # A^(root-1)
    inv = compute_inverse_root(raised, root, params)
    return alg.matmul(mat, inv, threshold=params.threshold)


def compute_inverse_root(mat, root: int,
                         params: SolverParameters | None = None):
    """A^(-1/root)."""
    from .inverse import invert
    from .squareroot import square_root, inverse_square_root
    params, _ = resolve(params)
    with solver_log(params, "Inverse Root Solver", extra={"Root": root}):
        if root == 1:
            return invert(mat, params)
        if root == 2:
            return inverse_square_root(mat, params)
        if root == 3:
            return invert(compute_root(mat, 3, params), params)
        if root == 4:
            return inverse_square_root(square_root(mat, params), params)
        if root & (root - 1) == 0:
            out = mat
            while root > 2:
                out = square_root(out, params)
                root //= 2
            return inverse_square_root(out, params)
        return _inverse_root_implementation(mat, root, params)


def _inverse_root_implementation(mat, root: int, params):
    """The coupled Newton iteration X <- X T, M <- T^t M with
    T = ((t + 1) I - M) / t, from X = I / s and M = A^(1/4) / s^t for
    the target root t; X is then raised to the power that p mod 4
    asks for."""
    params, monitor = resolve(params)
    from .squareroot import square_root
    thr = params.threshold

    e_max = float(alg.gershgorin_bounds(mat)[1])
    scaling_factor = e_max / math.sqrt(2.0) ** (1.0 / root)
    if root % 4 == 0:
        target_root = root // 4
    elif root % 4 in (1, 3):
        target_root = root
    else:
        target_root = (root - 2) // 2 + 1

    fthrt_mat = square_root(square_root(mat, params), params)
    imat = identity_like(mat)
    fthrt_mat, imat = maybe_permute(params, fthrt_mat, imat)
    out = alg.scale(imat, 1.0 / scaling_factor)
    mk = alg.scale(fthrt_mat, 1.0 / scaling_factor ** target_root)
    del fthrt_mat

    total = 0
    with iteration_log(params):
        for ii in range(params.max_iterations):
            inter = alg.increment(alg.scale(imat, float(target_root + 1)),
                                  mk, 1.0 / target_root, -1.0 / target_root)
            out = alg.matmul(out, inter, threshold=thr)
            inter_p = inter
            for _ in range(target_root - 1):
                inter_p = alg.matmul(inter, inter_p, threshold=thr)
            mk = alg.matmul(inter_p, mk, threshold=thr)
            del inter, inter_p
            norm_value = real_scalar(
                alg.norm(alg.increment(mk, imat, 1.0, -1.0)))
            total = ii
            monitor.append(norm_value)
            if monitor.check_converged(params.be_verbose):
                break
    finish_iterations(params, total + 1, out, monitor=monitor,
                      solver="Root Solver")

    if root % 4 in (1, 3):
        tmp = alg.matmul(out, out, threshold=thr)
        out = alg.matmul(tmp, tmp, threshold=thr)
    elif root % 4 == 2:
        out = alg.matmul(out, out, threshold=thr)
    return maybe_unpermute(params, out)
