"""Density matrix solvers: purification.

Counterpart of ``ntpoly_tpu/solvers/density.py``, after reference
Source/Fortran/DensityMatrixSolversModule.F90: PM
(palser1998canonical), TRS2 and TRS4 (niklasson2002expansion), HPCP
(truflandier2016communication) and scale-and-fold
(rubensson2011nonmonotonic), each in the orthogonal basis of the given
inverse square root of the overlap and optionally load-balanced by a
permutation; and ``energy_density_matrix`` and ``mcweeny_step``.  The
chemical potential is recovered by bisection over the replayed sigma
history, as the reference does; ``dense_density`` diagonalizes
(``fermi.compute_dense_foe``).  With ``iters_per_sync > 1``, PM, TRS2,
TRS4 and HPCP run chunked (``common.run_chunked``: the step as device
code, its branches as coefficients picked on the device, a host read
per chunk), as in the reference; scale-and-fold runs eagerly whatever
``iters_per_sync`` says, as there.

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
scalars.  On the card those plain traces and dots are already the
float64 values of the compensated pairs (``parallel/algebra.py``), and
the solvers' sigma and idempotency read them so; the energy, whose
successive differences the energy metric holds to converge_diff, is
the plain dot rounded to the matrices' dtype, as the reference reports
it: the float32 energies of converged float32 iterates settle to equal
values, where their float64 values keep moving with the iterates' own
rounding (at 'highest' on an NVIDIA H100, TRS4 at 102,400 rows then
took 20 iterations where it took 11, and TRS2 never settled).  So on
the card the option changes the energy's precision and which
quantities PM and HPCP sum; everywhere else the plain versions run (the
CPU, complex data, block sizes the kernels refuse).  The chunked steps
follow the same rule, and do their scalar arithmetic in float64 on the
device, as the eager loops do on the host (the reference's chunks keep
the matrices' dtype there; in float64 the two are the same).

TRS4 runs the multiply that makes the iterate it returns at 'highest',
departing from the reference.  At the tensor-core tiers ('high', 'bf16',
'default') a float32 product drops the lo x lo terms of the bfloat16
split, a bias that adds up over an iterate's diagonal: the 2^20-row
gapped chain at 'high' ended 0.9 to 1.4 electrons off its 524,288 on an
NVIDIA H100 (1.7e-6 to 2.7e-6 per electron), against 0.05 at 'highest'.
Each step sets sigma so that the trace of X^2 (fx + sigma gx) is the
electron count, from traces of the computed X^2 and X, so only the
multiply X^2 poly of the last step carries its error into the result;
that one multiply runs exact (a step whose sigma is clamped makes its
iterate from X and X^2 and has none).  An eager solve knows its last
step before that multiply when the idempotency metric decides (from the
incoming iterate, ``Monitor.would_converge``) or at ``max_iterations``;
a chunked solve returns the iterate at a chunk's end, so each chunk's
last step runs exact.  With the energy metric an eager solve cannot
know its last step beforehand and keeps the tier throughout.

TRS4's sigma, (nel - tr fx) / tr gx, is undetermined once tr gx =
tr X^2 - 2 dot(X^2, X) + dot(X^2, X^2) falls below the rounding of its
three terms held in the matrices' dtype (half an ulp each, about 2 eps
tr X^2 near convergence; floored at the reference's 1e-14): the step
then takes the mid sigma, as the reference's does when its float32
sums of a converged float32 iterate cancel to zero.  The float64 sums
of the card resolve tr gx below that, and a converged float32 iterate
would go on resetting its trace by its own rounding, its float32 energy
never settling: at 'highest' the energy metric took 20 iterations at
102,400 rows on an NVIDIA H100 where it took 11 (10 with the guard); at
'high' tr gx stayed above 14 eps tr X^2 to the last step at 102,400
and 2^20 rows, where the guard does not reach.
"""
from __future__ import annotations

import functools

import torch

from ..parallel import algebra as alg
from ..utils import trace
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     orthogonalize, deorthogonalize, maybe_permute,
                     maybe_unpermute, identity_like, real_scalar,
                     prologue_scalars, pin_capacity, run_chunked)
from .parameters import SolverParameters


def _scalars(*xs):
    """Device scalars as floats in ONE readback."""
    return trace.read(torch.stack([torch.as_tensor(x) for x in xs]))


def _traces(params, *mats):
    """Traces as floats in ONE readback, compensated with
    ``compensated_scalars`` (see the module's docstring)."""
    if params.compensated_scalars:
        pairs = torch.stack([alg.trace_pair(m).double() for m in mats])
        return trace.read(pairs.sum(dim=1))
    return _scalars(*(alg.trace(m) for m in mats))


def _metric(params) -> str:
    """Resolve convergence_metric ('auto': energy at 'highest',
    idempotency otherwise)."""
    if params.convergence_metric == "auto":
        return "idempotency" if params.precision != "highest" else "energy"
    return params.convergence_metric


def _step_energy(x_new, whc, compensated) -> float:
    """Energy of a purification step as a float64: the compensated
    (hi, lo) pair when asked for, else the plain dot in the matrices'
    dtype (see the module's docstring)."""
    if compensated:
        return alg.host_pair(alg.dot_pair(x_new, whc))
    return real_scalar(alg.dot(x_new, whc).to(x_new.dtype))


@trace.spanned("ntp.mu")
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


@trace.spanned("ntp.prologue")
def _prologue(h, isq, params):
    """(identity, WH, ISQ^H, e_min, e_max, trace(WH)): the working
    Hamiltonian in the orthogonal basis, permuted when asked."""
    imat = identity_like(h)
    wh, isqt = orthogonalize(h, isq, params)
    wh, imat = maybe_permute(params, wh, imat)
    e_min, e_max, tr_wh = prologue_scalars(wh)
    return imat, wh, isqt, e_min, e_max, tr_wh


@trace.spanned("ntp.epilogue")
def _epilogue(x, isq, isqt, params):
    """Undo the permutation, then back to the overlap's basis."""
    return deorthogonalize(maybe_unpermute(params, x), isq, isqt, params)


# ----------------------------------------------------------------------------
# the chunked steps (reference density.py:31-82,249-430)
# ----------------------------------------------------------------------------

def _gx_floor(d1, d2, t2, dtype):
    """The trace of gx, t2 - 2 d1 + d2, below which TRS4's sigma is
    undetermined and takes the mid value: the rounding of its three
    terms held in the matrices' dtype (half an ulp each), at least the
    reference's 1e-14 (see the module's docstring)."""
    res = 0.5 * torch.finfo(dtype).eps * (abs(t2) + 2.0 * abs(d1)
                                          + abs(d2))
    if isinstance(res, torch.Tensor):
        return res.clamp(min=1e-14)
    return max(1e-14, res)


def _trs4_scalars(a, b):
    """[dot(A, B), dot(A, A), trace(A), trace(B)] as one float64 device
    tensor: TRS4's sigma terms and the idempotency residual of the
    iterate B, with no host read."""
    return torch.stack([alg.dot(a, b), alg.dot(a, a), alg.trace(a),
                        alg.trace(b)]).double()


def _chunk_conv(params):
    """(conv_index, conv_mode, row_transform) of a chunked purification
    whose raw step rows are (energy, sigma, idem) or, compensated,
    (e_hi, e_lo, sigma, idem); transformed rows are always (energy,
    sigma, idem)."""
    if params.compensated_scalars:
        def row_transform(row):
            return (row[0] + row[1],) + tuple(row[2:])
    else:
        row_transform = None
    if _metric(params) == "idempotency":
        return 2, "value", row_transform
    return 0, "diff", row_transform


def _chunk_energy(x_new, whc, compensated):
    """The energy of a chunked step as device scalars: (hi, lo) of the
    compensated dot when asked for (combined in float64 after the
    chunk's read), else (dot,) in the matrices' dtype."""
    if compensated:
        pair = alg.dot_pair(x_new, whc)
        return (pair[0], pair[1])
    return (alg.dot(x_new, whc).to(x_new.dtype),)


def _chunk_traces(compensated, *mats):
    """Traces as one float64 device tensor, compensated (hi + lo) with
    ``compensated_scalars`` (see the module's docstring)."""
    if compensated:
        return torch.stack([alg.trace_pair(m).double().sum()
                            for m in mats])
    return torch.stack([alg.trace(m) for m in mats]).double()


def _chunked(name, step, x, wh, imat, trace, params, monitor, ilog,
             *key, last_step=None):
    """Run a purification step chunked from X (``run_chunked``), with
    WH and the identity as constants; ``last_step`` in place of
    ``step`` as a chunk's last."""
    k_pin, (x, whp, imatp) = pin_capacity(params, x, wh, imat)
    conv_index, conv_mode, row_transform = _chunk_conv(params)
    return run_chunked(step, x, (whp, imatp), params, monitor, ilog,
                       k_pin=k_pin, aux_names=("Energy Value",),
                       conv_index=conv_index, conv_mode=conv_mode,
                       row_transform=row_transform, last_step=last_step,
                       cache_key=(name, params.threshold, float(trace),
                                  params.compensated_scalars) + key)


def _pm_chunked(x, wh, imat, trace, params, monitor, ilog):
    """PM (reference ``_pm_chunked``): the sigma branch as coefficients
    picked on the device."""
    thr = params.threshold
    comp = params.compensated_scalars

    def step(xc, whc, imatc):
        x2 = alg.matmul(xc, xc, threshold=thr)
        x3 = alg.matmul(xc, x2, threshold=thr)
        if comp:
            t = _chunk_traces(True, xc, x2, x3)
            tv, tv2 = t[0] - t[1], t[1] - t[2]
        else:
            tmp = alg.increment(xc, x2, 1.0, -1.0, threshold=thr)
            tv = alg.trace(tmp).double()
            tv2 = alg.dot(tmp, xc).double()
            del tmp
        small = tv <= 1e-300
        sigma = torch.where(small, 1.0, tv2 / torch.where(small, 1.0, tv))
        hi = sigma > 0.5
        a1 = torch.where(hi, 0.0, (1.0 - 2.0 * sigma) / (1.0 - sigma))
        a2 = torch.where(hi, 1.0 + 1.0 / sigma,
                         (1.0 + sigma) / (1.0 - sigma))
        a3 = torch.where(hi, -1.0 / sigma, -1.0 / (1.0 - sigma))
        x_new = alg.increment_n((xc, x2, x3), (a1, a2, a3), threshold=thr)
        del x2, x3
        # tv is tr(X - X^2): the incoming iterate's idempotency residual
        idem = tv.abs() / trace
        return x_new, _chunk_energy(x_new, whc, comp) + (sigma, idem)

    return _chunked("pm", step, x, wh, imat, trace, params, monitor, ilog)


def _hpcp_chunked(d1, wh, imat, trace, params, monitor, ilog):
    """HPCP (reference ``_hpcp_chunked``)."""
    thr = params.threshold
    comp = params.compensated_scalars

    def step(dc, whc, imatc):
        dh = alg.increment(imatc, dc, 1.0, -1.0, threshold=thr)
        ddh = alg.matmul(dc, dh, threshold=thr)
        del dh
        d2dh = alg.matmul(dc, ddh, threshold=thr)
        tv, tv2 = _chunk_traces(comp, ddh, d2dh)
        zero = tv == 0
        s = torch.where(zero, 0.0, tv2 / torch.where(zero, 1.0, tv))
        d_new = alg.increment_n((dc, d2dh, ddh), (1.0, 2.0, -2.0 * s),
                                threshold=thr)
        del ddh, d2dh
        # tv is tr(D (I - D)): the incoming iterate's idempotency residual
        idem = tv.abs() / trace
        return d_new, _chunk_energy(d_new, whc, comp) + (s, idem)

    return _chunked("hpcp", step, d1, wh, imat, trace, params, monitor,
                    ilog)


def _trs2_chunked(x, wh, imat, trace, params, monitor, ilog):
    """TRS2 (reference ``_trs2_chunked``): the sigma branch as the
    coefficients of one merge."""
    thr = params.threshold
    comp = params.compensated_scalars

    def step(xc, whc, imatc):
        tv = alg.trace(xc).double()
        sigma = torch.where(trace - tv < 0.0, -1.0, 1.0).double()
        x2 = alg.matmul(xc, xc, threshold=thr)
        t2 = alg.trace(x2).double()
        up = sigma > 0.0
        x_new = alg.increment_n((xc, x2), (torch.where(up, 2.0, 0.0),
                                           torch.where(up, -1.0, 1.0)),
                                threshold=thr)
        del x2
        idem = (tv - t2).abs() / trace
        return x_new, _chunk_energy(x_new, whc, comp) + (sigma, idem)

    return _chunked("trs2", step, x, wh, imat, trace, params, monitor,
                    ilog)


def _trs4_chunked(x, wh, imat, trace, params, monitor, ilog,
                  sigma_min, sigma_max):
    """TRS4 (reference ``_trs4_chunked``): fx = 4X - 3X^2 and gx = I - 2X
    + X^2 are never formed (their traces reduce to dot(X^2, X),
    dot(X^2, X^2) and trace(X^2)); poly = fx + sigma gx is one merge,
    X^2 poly one multiply, and the sigma clamps are the coefficients
    of the merge that makes the new iterate: (2, -1, 0) on X, X^2 and
    X^2 poly above sigma_max, (0, 1, 0) below sigma_min, (0, 0, 1)
    between.  A chunk's last step (``last``) takes X^2 poly at
    'highest' (see the module's docstring)."""
    thr = params.threshold
    comp = params.compensated_scalars

    def step(xc, whc, imatc, last=False):
        x2 = alg.matmul(xc, xc, threshold=thr)
        d1, d2, t2, tx = _trs4_scalars(x2, xc)
        trace_fx = 4.0 * d1 - 3.0 * d2
        trace_gx = t2 - 2.0 * d1 + d2
        sigma = torch.where(trace_gx.abs() < _gx_floor(d1, d2, t2,
                                                       xc.dtype),
                            0.5 * (sigma_max - sigma_min),
                            (trace - trace_fx) / trace_gx)
        poly = alg.increment_n((x2, xc, imatc),
                               (sigma - 3.0, 4.0 - 2.0 * sigma, sigma),
                               threshold=thr)
        x_mid = alg.matmul(x2, poly, threshold=thr,
                           precision="highest" if last else None)
        del poly
        hi = sigma > sigma_max
        lo = sigma < sigma_min
        ca = torch.where(hi, 2.0, 0.0)
        cb = torch.where(hi, -1.0, torch.where(lo, 1.0, 0.0))
        cc = torch.where(hi | lo, 0.0, 1.0)
        x_new = alg.increment_n((x2, xc, x_mid), (cb, ca, cc),
                                threshold=thr)
        del x2, x_mid
        # the incoming iterate's idempotency residual per electron
        idem = (tx - t2).abs() / trace
        return x_new, _chunk_energy(x_new, whc, comp) + (sigma, idem)

    return _chunked("trs4", step, x, wh, imat, trace, params, monitor,
                    ilog, sigma_min, sigma_max,
                    last_step=functools.partial(step, last=True))


def pm(h, isq, trace, params: SolverParameters | None = None):
    """Palser-Manolopoulos canonical purification
    (palser1998canonical)."""
    params, monitor = resolve(params)
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
        if params.iters_per_sync > 1:
            with iteration_log(params) as ilog:
                x, history, total_1b = _pm_chunked(
                    x, wh, imat, trace, params, monitor, ilog)
            energy = history[-1][0]
            sigmas = [row[1] for row in history]
            total = total_1b - 1
        else:
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
        if params.iters_per_sync > 1:
            with iteration_log(params) as ilog:
                x, history, total_1b = _trs2_chunked(
                    x, wh, imat, trace, params, monitor, ilog)
            energy = history[-1][0]
            sigmas = [row[1] for row in history]
            total = total_1b - 1
        else:
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
        if params.iters_per_sync > 1:
            with iteration_log(params) as ilog:
                x, history, total_1b = _trs4_chunked(
                    x, wh, imat, trace, params, monitor, ilog,
                    sigma_min, sigma_max)
            energy = history[-1][0]
            sigmas = [row[1] for row in history]
            total = total_1b - 1
        else:
            energy = 0.0
            total = 0
            with iteration_log(params) as ilog:
                for ii in range(params.max_iterations):
                    # fx = 4X - 3X^2 and gx = I - 2X + X^2 are never
                    # materialized: their traces reduce to dot(X^2, X),
                    # dot(X^2, X^2) and trace(X^2)
                    x2 = alg.matmul(x, x, threshold=thr)
                    d1, d2, t2, tx = _scalars(*_trs4_scalars(x2, x))
                    trace_fx = 4.0 * d1 - 3.0 * d2
                    trace_gx = t2 - 2.0 * d1 + d2
                    idem = abs(tx - t2) / trace
                    if abs(trace_gx) < _gx_floor(d1, d2, t2, x.dtype):
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
                        # the step that makes the returned iterate
                        # multiplies exact (see the module's docstring)
                        last = (ii == params.max_iterations - 1
                                or (metric == "idempotency"
                                    and monitor.would_converge(idem)))
                        x = alg.matmul(x2, poly, threshold=thr,
                                       precision="highest" if last
                                       else None)
                        del poly
                    del x2
                    energy_old = energy
                    energy = _step_energy(x, wh, params.compensated_scalars)
                    total = ii
                    if metric == "idempotency":
                        monitor.append(idem)
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
        if params.iters_per_sync > 1:
            with iteration_log(params) as ilog:
                d1, history, total_1b = _hpcp_chunked(
                    d1, wh, imat, trace, params, monitor, ilog)
            energy = history[-1][0]
            sigmas = [row[1] for row in history]
            total = total_1b - 1
        else:
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
    """The dense (eigendecomposition) density solver: the step-function
    occupations of ``fermi.compute_dense_foe`` -> (K, energy, mu)."""
    from .fermi import compute_dense_foe
    return compute_dense_foe(h, isq, trace, params=params)


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
