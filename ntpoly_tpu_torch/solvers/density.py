"""Density matrix solvers: TRS4 purification.

Counterpart of ``ntpoly_tpu/solvers/density.py``, eager path only: the
4th-order trace-resetting purification (niklasson2002expansion) with
the chemical potential recovered by bisection over the replayed sigma
history.  The other purification solvers are ROADMAP Queue A item 5;
``iters_per_sync > 1`` (the chunked driver) is Queue A item 7.

Returns (K, energy, chemical potential).
"""
from __future__ import annotations

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     orthogonalize, deorthogonalize, identity_like,
                     real_scalar, prologue_scalars)
from .parameters import SolverParameters


def _trs4_scalars(a, b):
    """[dot(A, B), dot(A, A), trace(A), trace(B)] in ONE readback."""
    import torch
    return torch.stack([alg.dot(a, b), alg.dot(a, a), alg.trace(a),
                        alg.trace(b)]).tolist()


def _metric(params) -> str:
    """Resolve convergence_metric ('auto': energy at 'highest',
    idempotency otherwise)."""
    if params.convergence_metric == "auto":
        return "idempotency" if params.precision != "highest" else "energy"
    return params.convergence_metric


def _step_energy(x_new, whc, compensated) -> float:
    """Energy of a purification step as a float64: the compensated
    (hi, lo) pair when asked for, else the plain dot."""
    if compensated:
        return alg.host_pair(alg.dot_pair(x_new, whc))
    return real_scalar(alg.dot(x_new, whc))


def _bisect_chemical_potential(replay, total_iterations, params):
    """Bisection of the accumulated scalar polynomial recursion on
    [0, 1]."""
    a, b = 0.0, 1.0
    midpoint = 0.0
    for _ in range(params.max_iterations):
        midpoint = (b - a) / 2.0 + a
        zero_value = midpoint
        for jj in range(total_iterations):
            zero_value = replay(jj, zero_value)
        if zero_value < 0.5:
            a = midpoint
        else:
            b = midpoint
        if abs(zero_value - 0.5) < params.converge_diff:
            break
    return midpoint


def trs4(h, isq, trace, params: SolverParameters | None = None):
    """4th-order trace-resetting purification (niklasson2002expansion)."""
    params, monitor = resolve(params)
    if params.iters_per_sync > 1:
        raise ValueError(
            "iters_per_sync > 1 needs the chunked driver, which is not "
            "ported yet (ROADMAP Queue A item 7)")
    if params.do_load_balancing and params.balance_permutation is not None:
        raise ValueError("load-balancing permutations are not ported yet "
                         "(ROADMAP Queue A item 3)")
    monitor.plateau = _metric(params) == "idempotency"
    sigma_min, sigma_max = 0.0, 6.0
    sigmas = []
    with solver_log(params, "Density Matrix Solver", "TRS4",
                    ("niklasson2002expansion",)):
        imat = identity_like(h)
        wh, isqt = orthogonalize(h, isq, params)
        e_min, e_max, _ = prologue_scalars(wh)

        x = alg.increment(wh, imat, alpha=-1.0 / (e_max - e_min),
                          beta=e_max / (e_max - e_min))
        energy = 0.0
        total = 0
        metric = _metric(params)
        with iteration_log(params) as ilog:
            for ii in range(params.max_iterations):
                # fx = 4X - 3X^2 and gx = I - 2X + X^2 are never
                # materialized: their traces reduce to dot(X^2, X),
                # dot(X^2, X^2) and trace(X^2)
                x2 = alg.matmul(x, x, threshold=params.threshold)
                d1, d2, t2, tx = _trs4_scalars(x2, x)
                trace_fx = 4.0 * d1 - 3.0 * d2
                trace_gx = t2 - 2.0 * d1 + d2
                if abs(trace_gx) < 1e-14:
                    sigma = 0.5 * (sigma_max - sigma_min)
                else:
                    sigma = (trace - trace_fx) / trace_gx
                sigmas.append(sigma)
                if sigma > sigma_max:
                    x = alg.increment(x, x2, 2.0, -1.0,
                                      threshold=params.threshold)
                elif sigma < sigma_min:
                    x = x2
                else:
                    # poly = fx + sigma gx in ONE three-term merge; X is
                    # released before the multiply
                    poly = alg.increment_n(
                        (x2, x, imat),
                        (sigma - 3.0, 4.0 - 2.0 * sigma, sigma),
                        threshold=params.threshold)
                    del x
                    x = alg.matmul(x2, poly, threshold=params.threshold)
                    del poly
                del x2
                energy_old = energy
                energy = _step_energy(x, wh, params.compensated_scalars)
                total = ii
                if metric == "idempotency":
                    monitor.append(abs(tx - t2) / trace)
                else:
                    monitor.append(energy - energy_old)
                ilog.step(**{"Energy Value": energy})
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Density Matrix Solver")

        k = deorthogonalize(x, isq, isqt, params)

        def replay(jj, zv):
            s = sigmas[jj]
            if s > sigma_max:
                return 2.0 * zv - zv * zv
            if s < sigma_min:
                return zv * zv
            tempfx = zv * zv * (4.0 * zv - 3.0 * zv * zv)
            tempgx = zv * zv * (1.0 - zv) ** 2
            return tempfx + s * tempgx

        midpoint = _bisect_chemical_potential(replay, total, params)
        mu = e_max + (e_min - e_max) * midpoint
    return k, energy, mu
