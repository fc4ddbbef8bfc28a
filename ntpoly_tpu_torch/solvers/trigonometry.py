"""Matrix sine and cosine.

Counterpart of ``ntpoly_tpu/solvers/trigonometry.py``: scale and square
with a 17-term even Chebyshev expansion of cos on [-1, 1]
(serbin1980algorithm, higham2003computing, yau1993reducing; c_0 =
J_0(1), c_2k = 2 (-1)^k J_2k(1)), squared back by cos(2x) =
2 cos^2 x - 1, and sin(x) = cos(x - pi/2); a Taylor variant after a
deeper scaling; and the dense versions by eigendecomposition.
"""
from __future__ import annotations

import math

import torch

from ..parallel import algebra as alg
from .common import (resolve, solver_log, maybe_permute, maybe_unpermute,
                     identity_like)
from .parameters import SolverParameters


def _cos_cheby_coefficients(n: int = 17) -> list[float]:
    from scipy.special import jv
    coeffs = [0.0] * n
    coeffs[0] = float(jv(0, 1.0))
    for k in range(1, (n + 1) // 2):
        if 2 * k < n:
            coeffs[2 * k] = 2.0 * (-1.0) ** k * float(jv(2 * k, 1.0))
    return coeffs


def sine(mat, params: SolverParameters | None = None):
    """sin(A) = cos(A - pi/2 I)."""
    params, _ = resolve(params)
    with solver_log(params, "Trigonometry Solver", "Sine"):
        shifted = alg.increment(mat, identity_like(mat), 1.0,
                                -0.5 * math.pi)
        return _scale_square_trig(shifted, params)


def cosine(mat, params: SolverParameters | None = None):
    """cos(A)."""
    params, _ = resolve(params)
    with solver_log(params, "Trigonometry Solver", "Cosine"):
        return _scale_square_trig(mat, params)


def _scaling(mat, limit: float):
    """(sigma = 2^(counter - 1), counter) with the Gershgorin radius
    over sigma at most ``limit``."""
    e_min, e_max = torch.stack(alg.gershgorin_bounds(mat)).tolist()
    spectral_radius = max(abs(e_min), abs(e_max))
    sigma = 1.0
    counter = 1
    while spectral_radius / sigma > limit:
        sigma *= 2
        counter += 1
    return sigma, counter


def _double_angle(out, imat, counter, thr):
    """cos(2x) = 2 cos^2 x - 1, counter - 1 times."""
    for _ in range(counter - 1):
        out = alg.increment(alg.matmul(out, out, alpha=2.0, threshold=thr),
                            imat, 1.0, -1.0)
    return out


def _scale_square_trig(mat, params):
    """cos(A) by scaling, the even Chebyshev expansion over T2, T4, T6
    and T8 in two halves (T10..T16 as T8 times the low powers), and
    the double angle."""
    thr = params.threshold
    sigma, counter = _scaling(mat, 1.0)
    scaled = alg.scale(mat, 1.0 / sigma)
    imat = identity_like(mat)
    scaled, imat = maybe_permute(params, scaled, imat)
    c = _cos_cheby_coefficients(17)

    t2 = alg.increment(alg.matmul(scaled, scaled, alpha=2.0, threshold=thr),
                       imat, 1.0, -1.0)
    del scaled
    t4 = alg.increment(alg.matmul(t2, t2, alpha=2.0, threshold=thr),
                       imat, 1.0, -1.0)
    t6 = alg.increment(alg.matmul(t4, t2, alpha=2.0, threshold=thr),
                       t2, 1.0, -1.0)
    t8 = alg.increment(alg.matmul(t6, t2, alpha=2.0, threshold=thr),
                       t4, 1.0, -1.0)

    hi = alg.scale(t8, 0.5 * c[16])
    hi = alg.increment(hi, t6, 1.0, 0.5 * c[14])
    hi = alg.increment(hi, t4, 1.0, 0.5 * c[12])
    hi = alg.increment(hi, t2, 1.0, 0.5 * c[10])
    hi = alg.matmul(t8, hi, threshold=thr)

    out = alg.scale(t8, c[8])
    out = alg.increment(out, t6, 1.0, c[6] + 0.5 * c[10])
    out = alg.increment(out, t4, 1.0, c[4] + 0.5 * c[12])
    out = alg.increment(out, t2, 1.0, c[2] + 0.5 * c[14])
    out = alg.increment(out, imat, 1.0, c[0] + 0.5 * c[16])
    out = alg.increment(out, hi)
    del t2, t4, t6, t8, hi
    return maybe_unpermute(params, _double_angle(out, imat, counter, thr))


def scale_square_trigonometry_taylor(mat,
                                     params: SolverParameters | None = None):
    """cos(A) by scaling the radius below 3e-3, the even Taylor series
    sum_k (-1)^k (A / sigma)^2k / (2k)! to k = 20, and the double
    angle (higham2003computing)."""
    params, _ = resolve(params)
    thr = params.threshold
    with solver_log(params, "Trigonometry Solver", "Taylor"):
        sigma, counter = _scaling(mat, 3.0e-3)
        scaled = alg.scale(mat, 1.0 / sigma)
        imat = identity_like(mat)
        out = identity_like(mat)
        scaled, imat, out = maybe_permute(params, scaled, imat, out)
        a2 = alg.matmul(scaled, scaled, threshold=thr)
        del scaled
        ak = out
        taylor_denom = -2.0
        for ii in range(2, 41, 2):
            ak = alg.matmul(ak, a2, threshold=thr)
            out = alg.increment(out, ak, 1.0, 1.0 / taylor_denom)
            taylor_denom *= (ii + 1)
            taylor_denom *= -(ii + 2)
        del ak, a2
        return maybe_unpermute(params, _double_angle(out, imat, counter,
                                                     thr))


def dense_sine(mat, params: SolverParameters | None = None):
    """sin(A) by eigendecomposition."""
    from .eigen import dense_matrix_function
    params, _ = resolve(params)
    with solver_log(params, "Trigonometry Solver"):
        return dense_matrix_function(mat, torch.sin, params)


def dense_cosine(mat, params: SolverParameters | None = None):
    """cos(A) by eigendecomposition."""
    from .eigen import dense_matrix_function
    params, _ = resolve(params)
    with solver_log(params, "Trigonometry Solver"):
        return dense_matrix_function(mat, torch.cos, params)
