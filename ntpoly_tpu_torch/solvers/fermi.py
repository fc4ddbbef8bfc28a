"""Fermi operator expansion.

Counterpart of ``ntpoly_tpu/solvers/fermi.py``.  ``compute_dense_foe``
diagonalizes the working Hamiltonian ISQ H ISQ^H on its device, fills
the occupations on the host in float64 (the step function, or
Fermi-Dirac at a finite inverse temperature with mu bisected onto the
target trace) and forms K = ISQ^H V diag(occ) V^H ISQ back on the
device.  ``wom_gc`` and ``wom_c`` minimize the wave operator in the
grand-canonical and canonical ensembles: RK2 in the inverse
temperature with the step adapted to ``params.step_thresh``, and
K = W^2.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..utils.logging import logger
from .common import (resolve, solver_log, iteration_log, identity_like,
                     orthogonalize, deorthogonalize, maybe_permute,
                     maybe_unpermute, real_scalar, print_matrix_information)
from .parameters import SolverParameters


def compute_dense_foe(h, isq, trace, inv_temp: float | None = None,
                      params: SolverParameters | None = None):
    """-> (K, energy, chemical potential)."""
    from .eigen import eigh
    params, _ = resolve(params)
    do_smearing = inv_temp is not None
    with solver_log(params, "Density Matrix Solver",
                    "Dense FOE" if do_smearing else "Dense Step Function"):
        isqt = alg.transpose(isq).conjugate()
        wh = alg.matmul(alg.matmul(isq, h, threshold=params.threshold),
                        isqt, threshold=params.threshold)
        w, v = eigh(wh)
        eigs = w.double().cpu().numpy()
        n = h.dim

        if do_smearing:
            left, right = float(eigs.min()), float(eigs.max())
            mu = 0.5 * (left + right)
            for _ in range(10 * params.max_iterations):
                mu = left + (right - left) / 2
                sval = inv_temp * (eigs - mu)
                occ = np.where(sval > 30,
                               0.5 * (1.0 - _erf_vec(sval)),
                               1.0 / (1.0 + np.exp(np.minimum(sval, 700))))
                sv = float(occ.sum())
                if abs(trace - sv) < 1e-8:
                    break
                if sv > trace:
                    right = mu
                else:
                    left = mu
            energy = float((occ * eigs).sum())
            sqrt_occ = np.sqrt(np.where(occ < 0, 0.0, occ))
        else:
            nocc = int(math.floor(trace))
            homo = eigs[nocc - 1]
            lumo = eigs[nocc] if nocc < n else eigs[-1]
            mu = homo + (nocc + 1 - trace) * 0.5 * (lumo - homo)
            occ = np.zeros(n)
            occ[:nocc] = 1.0
            energy = float(eigs[:nocc].sum())
            if math.ceil(trace) > nocc:          # fractional occupation
                frac = trace - nocc
                occ[nocc] = frac
                energy += frac * eigs[nocc]
            sqrt_occ = np.sqrt(occ)

        if params.be_verbose:
            logger.write_header("Chemical Potential Search")
            logger.enter_sub_log()
            logger.write_element("Potential", float(mu))
            logger.exit_sub_log()

        vs = v * torch.from_numpy(sqrt_occ).to(v)[None, :]
        wd = vs @ vs.conj().T
        del vs
        wd_ps = PM.from_dense(wd, bs=h.bs, k=h.k, grid=h.grid, dtype=h.dtype,
                              threshold=params.threshold)
        del wd
        k = alg.matmul(alg.matmul(isqt, wd_ps, threshold=params.threshold),
                       isq, threshold=params.threshold)
    return k, energy, float(mu)


def _erf_vec(x):
    from scipy.special import erf
    return erf(x)


def wom_gc(h, isq, chemical_potential, inv_temp,
           params: SolverParameters | None = None):
    """Grand-canonical WOM at the given chemical potential ->
    (K, energy)."""
    params, _ = resolve(params)
    with solver_log(params, "Density Matrix Solver", "WOM_GC",
                    extra={"Inverse Temperature": inv_temp,
                           "Chemical Potential": chemical_potential}):
        return _wom(h, isq, inv_temp, params, mu=chemical_potential)


def wom_c(h, isq, trace, inv_temp, params: SolverParameters | None = None):
    """Canonical WOM at the given trace -> (K, energy)."""
    params, _ = resolve(params)
    with solver_log(params, "Density Matrix Solver", "WOM_C",
                    extra={"Inverse Temperature": inv_temp,
                           "Target Trace": trace}):
        return _wom(h, isq, inv_temp, params, trace=trace)


def _compute_x(w, imat, threshold):
    """X = W (I - W^2) -> (X, W^2)."""
    w2 = alg.matmul(w, w, threshold=threshold)
    tmp = alg.increment(imat, w2, 1.0, -1.0)
    return alg.matmul(w, tmp, threshold=threshold), w2


def _gc_step(x, a, threshold):
    """K0 = -X A / 2."""
    return alg.matmul(x, a, alpha=-0.5, threshold=threshold)


def _c_step(x, a, w, threshold):
    """K0 = -(XA - (<W, XA> / <X, W>) X) / 2."""
    xa = alg.matmul(x, a, threshold=threshold)
    denom = real_scalar(alg.dot(x, w))
    num = real_scalar(alg.dot(w, xa))
    out = alg.increment(xa, x, 1.0, -num / denom)
    return alg.scale(out, -0.5)


def _wom(h, isq, inv_temp, params, mu=None, trace=None):
    """RK2 from W = I / sqrt(2) (grand canonical, A = H - mu I) or
    W = sqrt(trace / dim) I (canonical, A = H) up to beta = inv_temp;
    a stage is redone at a smaller step while its error exceeds 1.1
    step_thresh, and the solve exits early once W stops changing."""
    gc = mu is not None
    imat = identity_like(h)
    wh, isqt = orthogonalize(h, isq, params)
    wh, imat = maybe_permute(params, wh, imat)
    thr = params.threshold

    a = alg.increment(wh, imat, 1.0, -mu) if gc else wh
    w = alg.scale(imat, 1.0 / math.sqrt(2.0) if gc
                  else math.sqrt(trace / h.dim))

    def step_of(x, rk):
        return _gc_step(x, a, thr) if gc else _c_step(x, a, rk, thr)

    def rk_stage(k0, step_val):
        rk1 = alg.increment(w, k0, 1.0, step_val, threshold=thr)
        x1, _ = _compute_x(rk1, imat, thr)
        k1 = step_of(x1, rk1)
        rk2 = alg.increment(
            alg.increment(w, k0, 1.0, step_val * 0.5, threshold=thr),
            k1, 1.0, step_val * 0.5, threshold=thr)
        err_val = real_scalar(alg.norm(alg.increment(rk1, rk2, 1.0, -1.0)))
        return rk2, err_val

    ii = 0
    b_i = 0.0
    step = 1.0
    with iteration_log(params) as ilog:
        while b_i < inv_temp:
            step = min(step, inv_temp - b_i)
            x, korth = _compute_x(w, imat, thr)
            energy = real_scalar(alg.dot(wh, korth))
            k0 = step_of(x, w)
            del x, korth
            ii += 1
            rk2, err = rk_stage(k0, step)
            ii += 1
            while err > 1.1 * params.step_thresh:
                step = step * (params.step_thresh / err) ** 0.5
                rk2, err = rk_stage(k0, step)
                ii += 1
            err2 = real_scalar(alg.norm(alg.increment(rk2, w, 1.0, -1.0)))
            if err2 < params.converge_diff:
                logger.write_comment("Early Exit Triggered")
                break
            w = rk2
            b_i_old = b_i
            b_i = b_i + step
            step = step * (params.step_thresh / err) ** 0.5
            ilog.step(**{"Beta": b_i_old, "Energy": energy,
                         "Norm of Change": err2})

    korth = alg.matmul(w, w, threshold=thr)
    energy = real_scalar(alg.dot(wh, korth))
    if params.be_verbose:
        logger.write_element("Total_Iterations", ii)
        print_matrix_information(w)
    korth = maybe_unpermute(params, korth)
    return deorthogonalize(korth, isq, isqt, params), energy
