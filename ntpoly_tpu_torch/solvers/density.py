"""Density matrix solvers: purification.

Counterpart of ``ntpoly_tpu/solvers/density.py``, eager path only: PM
(palser1998canonical), TRS2 and TRS4 (niklasson2002expansion), HPCP
(truflandier2016communication) and scale-and-fold
(rubensson2011nonmonotonic), each in the orthogonal basis of the given
inverse square root of the overlap and optionally load-balanced by a
permutation; and ``energy_density_matrix`` and ``mcweeny_step``.  The
chemical potential is recovered by bisection over the replayed sigma
history, as the reference does.  ``iters_per_sync > 1`` (the chunked
driver) is ROADMAP Queue A item 7; ``dense_density`` waits for
``fermi.py`` and ``eigen.py`` (Queue A items 5 and 6).

The purification solvers take the Hamiltonian H, the inverse square
root ISQ of the overlap and the target trace (electron count), and
return (K, energy, chemical potential); scale-and-fold returns
(K, energy).

``compensated_scalars`` goes further than in the reference, whose
eager loops compensate only TRS4's energy: every solver here reports
the compensated energy, and PM and HPCP also read the traces that their
sigma divides compensated -- PM from tr X, tr X^2 and tr X^3 of the
matrices it combines, where the reference takes tr(X - X^2) and
dot(X - X^2, X), equal in exact arithmetic.  These two solvers keep
the electron count only as far as sigma agrees with the matrices; in
float32 the plain sums moved it by up to 1.7e-6 per electron on the
gapped chain at 16,384 rows, and by 4e-8 with the compensated traces.
Without ``compensated_scalars`` each solver takes the reference's
scalars exactly.
"""
from __future__ import annotations

import torch

from ..parallel import algebra as alg
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     orthogonalize, deorthogonalize, maybe_permute,
                     maybe_unpermute, identity_like, real_scalar,
                     prologue_scalars, eager_only)
from .parameters import SolverParameters


def _scalars(*xs):
    """Device scalars as floats in ONE readback."""
    return torch.stack([torch.as_tensor(x) for x in xs]).tolist()


def _traces(params, *mats):
    """Traces as floats in ONE readback, compensated with
    ``compensated_scalars`` (see the module's docstring)."""
    if params.compensated_scalars:
        pairs = torch.stack([alg.trace_pair(m).double() for m in mats])
        return pairs.sum(dim=1).tolist()
    return _scalars(*(alg.trace(m) for m in mats))


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


def _prologue(h, isq, params):
    """(identity, WH, ISQ^H, e_min, e_max, trace(WH)): the working
    Hamiltonian in the orthogonal basis, permuted when asked."""
    imat = identity_like(h)
    wh, isqt = orthogonalize(h, isq, params)
    wh, imat = maybe_permute(params, wh, imat)
    e_min, e_max, tr_wh = prologue_scalars(wh)
    return imat, wh, isqt, e_min, e_max, tr_wh


def _epilogue(x, isq, isqt, params):
    """Undo the permutation, then back to the overlap's basis."""
    return deorthogonalize(maybe_unpermute(params, x), isq, isqt, params)


def pm(h, isq, trace, params: SolverParameters | None = None):
    """Palser-Manolopoulos canonical purification
    (palser1998canonical)."""
    params, monitor = resolve(params)
    eager_only(params)
    metric = _metric(params)
    monitor.plateau = metric == "idempotency"
    thr = params.threshold
    sigmas = []
    with solver_log(params, "Density Matrix Solver", "PM",
                    ("palser1998canonical",)):
        n = h.dim
        imat, wh, isqt, e_min, e_max, tr_wh = _prologue(h, isq, params)
        lam = tr_wh / n
        alpha = min(trace / (e_max - lam), (n - trace) / (lam - e_min))
        x = alg.increment(wh, imat, alpha=-alpha / n,
                          beta=(alpha * lam + trace) / n)
        energy = 0.0
        total = 0
        with iteration_log(params) as ilog:
            for ii in range(params.max_iterations):
                x2 = alg.matmul(x, x, threshold=thr)
                x3 = alg.matmul(x, x2, threshold=thr)
                if params.compensated_scalars:
                    t1, t2, t3 = _traces(params, x, x2, x3)
                    tv, tv2 = t1 - t2, t2 - t3
                else:
                    tmp = alg.increment(x, x2, 1.0, -1.0,
                                        threshold=thr)    # X - X^2
                    tv, tv2 = _scalars(alg.trace(tmp), alg.dot(tmp, x))
                    del tmp
                sigma = 1.0 if tv <= 1e-300 else tv2 / tv
                sigmas.append(sigma)
                if sigma > 0.5:
                    a1, a2, a3 = 0.0, 1.0 + 1.0 / sigma, -1.0 / sigma
                else:
                    a1 = (1.0 - 2.0 * sigma) / (1.0 - sigma)
                    a2 = (1.0 + sigma) / (1.0 - sigma)
                    a3 = -1.0 / (1.0 - sigma)
                x = alg.increment_n((x, x2, x3), (a1, a2, a3),
                                    threshold=thr)
                del x2, x3
                energy_old = energy
                energy = _step_energy(x, wh, params.compensated_scalars)
                total = ii
                if metric == "idempotency":
                    monitor.append(abs(tv) / trace)
                else:
                    monitor.append(energy - energy_old)
                ilog.step(**{"Energy Value": energy})
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Density Matrix Solver")
        k = _epilogue(x, isq, isqt, params)

        def replay(jj, zv):
            s = sigmas[jj]
            if s > 0.5:
                return ((1.0 + s) * zv ** 2 - zv ** 3) / s
            return ((1.0 - 2.0 * s) * zv + (1.0 + s) * zv ** 2 - zv ** 3) \
                / (1.0 - s)

        midpoint = _bisect_chemical_potential(replay, total, params)
        mu = lam - (n * midpoint - trace) / alpha
    return k, energy, mu


def trs2(h, isq, trace, params: SolverParameters | None = None):
    """2nd-order trace-resetting purification (niklasson2002expansion)."""
    params, monitor = resolve(params)
    eager_only(params)
    metric = _metric(params)
    monitor.plateau = metric == "idempotency"
    thr = params.threshold
    sigmas = []
    with solver_log(params, "Density Matrix Solver", "TRS2",
                    ("niklasson2002expansion",)):
        imat, wh, isqt, e_min, e_max, _ = _prologue(h, isq, params)
        # X0 = (e_max I - WH) / (e_max - e_min)
        x = alg.increment(wh, imat, alpha=-1.0 / (e_max - e_min),
                          beta=e_max / (e_max - e_min))
        energy = 0.0
        total = 0
        with iteration_log(params) as ilog:
            for ii in range(params.max_iterations):
                tv = real_scalar(alg.trace(x))
                sigma = -1.0 if trace - tv < 0.0 else 1.0
                sigmas.append(sigma)
                x2 = alg.matmul(x, x, threshold=thr)
                idem = None
                if metric == "idempotency":
                    idem = (tv - real_scalar(alg.trace(x2))) / trace
                if sigma > 0.0:
                    x = alg.increment(x, x2, 2.0, -1.0, threshold=thr)
                else:
                    x = x2
                del x2
                energy_old = energy
                energy = _step_energy(x, wh, params.compensated_scalars)
                total = ii
                monitor.append(abs(idem) if idem is not None
                               else energy - energy_old)
                ilog.step(**{"Energy Value": energy})
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Density Matrix Solver")
        k = _epilogue(x, isq, isqt, params)

        def replay(jj, zv):
            return zv * zv if sigmas[jj] < 0.0 else 2.0 * zv - zv * zv

        midpoint = _bisect_chemical_potential(replay, total, params)
        mu = e_max + (e_min - e_max) * midpoint
    return k, energy, mu


def trs4(h, isq, trace, params: SolverParameters | None = None):
    """4th-order trace-resetting purification (niklasson2002expansion)."""
    params, monitor = resolve(params)
    eager_only(params)
    metric = _metric(params)
    monitor.plateau = metric == "idempotency"
    thr = params.threshold
    sigma_min, sigma_max = 0.0, 6.0
    sigmas = []
    with solver_log(params, "Density Matrix Solver", "TRS4",
                    ("niklasson2002expansion",)):
        imat, wh, isqt, e_min, e_max, _ = _prologue(h, isq, params)
        x = alg.increment(wh, imat, alpha=-1.0 / (e_max - e_min),
                          beta=e_max / (e_max - e_min))
        energy = 0.0
        total = 0
        with iteration_log(params) as ilog:
            for ii in range(params.max_iterations):
                # fx = 4X - 3X^2 and gx = I - 2X + X^2 are never
                # materialized: their traces reduce to dot(X^2, X),
                # dot(X^2, X^2) and trace(X^2)
                x2 = alg.matmul(x, x, threshold=thr)
                d1, d2, t2, tx = _scalars(alg.dot(x2, x), alg.dot(x2, x2),
                                          alg.trace(x2), alg.trace(x))
                trace_fx = 4.0 * d1 - 3.0 * d2
                trace_gx = t2 - 2.0 * d1 + d2
                if abs(trace_gx) < 1e-14:
                    sigma = 0.5 * (sigma_max - sigma_min)
                else:
                    sigma = (trace - trace_fx) / trace_gx
                sigmas.append(sigma)
                if sigma > sigma_max:
                    x = alg.increment(x, x2, 2.0, -1.0, threshold=thr)
                elif sigma < sigma_min:
                    x = x2
                else:
                    # poly = fx + sigma gx in ONE three-term merge; X is
                    # released before the multiply
                    poly = alg.increment_n(
                        (x2, x, imat),
                        (sigma - 3.0, 4.0 - 2.0 * sigma, sigma),
                        threshold=thr)
                    del x
                    x = alg.matmul(x2, poly, threshold=thr)
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
        k = _epilogue(x, isq, isqt, params)

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


def hpcp(h, isq, trace, params: SolverParameters | None = None):
    """Hole-particle canonical purification
    (truflandier2016communication)."""
    params, monitor = resolve(params)
    eager_only(params)
    metric = _metric(params)
    monitor.plateau = metric == "idempotency"
    thr = params.threshold
    sigmas = []
    with solver_log(params, "Density Matrix Solver", "HPCP",
                    ("truflandier2016communication",)):
        n = h.dim
        imat, wh, isqt, e_min, e_max, tr_wh = _prologue(h, isq, params)
        mu_bar = tr_wh / n
        sigma_bar = (n - trace) / n
        sigma = 1.0 - sigma_bar
        beta = sigma / (e_max - mu_bar)
        beta_bar = sigma_bar / (mu_bar - e_min)
        beta_1 = sigma
        beta_2 = min(beta, beta_bar)
        # D1 = beta_1 I + beta_2 (mu I - WH)
        d1 = alg.increment(imat, alg.increment(imat, wh, mu_bar, -1.0),
                           beta_1, beta_2)
        energy = 0.0
        total = 0
        with iteration_log(params) as ilog:
            for ii in range(params.max_iterations):
                dh = alg.increment(imat, d1, 1.0, -1.0, threshold=thr)
                ddh = alg.matmul(d1, dh, threshold=thr)
                del dh
                d2dh = alg.matmul(d1, ddh, threshold=thr)
                tv, tv2 = _traces(params, ddh, d2dh)
                s = tv2 / tv if tv != 0 else 0.0
                sigmas.append(s)
                d1 = alg.increment_n((d1, d2dh, ddh), (1.0, 2.0, -2.0 * s),
                                     threshold=thr)
                del ddh, d2dh
                energy_old = energy
                energy = _step_energy(d1, wh, params.compensated_scalars)
                total = ii
                if metric == "idempotency":
                    monitor.append(abs(tv) / trace)
                else:
                    monitor.append(energy - energy_old)
                ilog.step(**{"Energy Value": energy})
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, d1, monitor=monitor,
                          solver="Density Matrix Solver")
        k = _epilogue(d1, isq, isqt, params)

        def replay(jj, zv):
            s = sigmas[jj]
            return zv + 2.0 * (zv ** 2 * (1.0 - zv)
                               - s * zv * (1.0 - zv))

        midpoint = _bisect_chemical_potential(replay, total, params)
        mu = mu_bar + (beta_1 - midpoint) / beta_2
    return k, energy, mu


def scale_and_fold(h, isq, trace, homo, lumo,
                   params: SolverParameters | None = None):
    """Accelerated scale-and-fold purification
    (rubensson2011nonmonotonic), from (conservative) homo/lumo
    estimates -> (K, energy)."""
    params, monitor = resolve(params)
    eager_only(params)
    thr = params.threshold
    with solver_log(params, "Density Matrix Solver", "Scale and Fold",
                    ("rubensson2011nonmonotonic",)):
        imat, wh, isqt, e_min, e_max, _ = _prologue(h, isq, params)
        x = alg.increment(wh, imat, alpha=-1.0 / (e_max - e_min),
                          beta=e_max / (e_max - e_min))
        beta = (e_max - lumo) / (e_max - e_min)
        beta_bar = (e_max - homo) / (e_max - e_min)
        energy = 0.0
        total = 0
        with iteration_log(params) as ilog:
            for ii in range(params.max_iterations):
                tv = real_scalar(alg.trace(x))
                if tv > trace:
                    a = 2.0 / (2.0 - beta)
                    x = alg.increment(x, imat, a, 1.0 - a)
                    x = alg.matmul(x, x, threshold=thr)
                    beta = (a * beta + 1 - a) ** 2
                    beta_bar = (a * beta_bar + 1 - a) ** 2
                else:
                    a = 2.0 / (1.0 + beta_bar)
                    x2 = alg.matmul(x, x, threshold=thr)
                    x = alg.increment(x, x2, 2 * a, -a * a, threshold=thr)
                    del x2
                    beta = 2.0 * a * beta - a * a * beta * beta
                    beta_bar = 2.0 * a * beta_bar - a * a * beta_bar ** 2
                energy_old = energy
                energy = _step_energy(x, wh, params.compensated_scalars)
                total = ii
                monitor.append(energy - energy_old)
                ilog.step(**{"Energy Value": energy})
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Density Matrix Solver")
        k = _epilogue(x, isq, isqt, params)
    return k, energy


def dense_density(h, isq, trace, params: SolverParameters | None = None):
    """The dense (eigendecomposition) density solver: needs
    ``fermi.compute_dense_foe`` and ``eigen.eigh``."""
    raise ValueError(
        "dense_density needs fermi.compute_dense_foe and eigen.eigh, "
        "which are not ported yet (ROADMAP Queue A items 5 and 6)")


def energy_density_matrix(h, d, threshold=0.0):
    """EDM = D H D."""
    return alg.matmul(d, alg.matmul(h, d, threshold=threshold),
                      threshold=threshold)


def mcweeny_step(d, s=None, threshold=0.0):
    """D' = 3 DSD - 2 DSDSD; S defaults to the identity (no multiply)."""
    ds = alg.matmul(d, s, threshold=threshold) if s is not None else d
    dsd = alg.matmul(ds, d, threshold=threshold)
    dsdsd = alg.matmul(ds, dsd, threshold=threshold)
    return alg.increment(dsd, dsdsd, 3.0, -2.0, threshold=threshold)
