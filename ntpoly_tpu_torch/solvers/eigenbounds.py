"""Spectral bounds.

Counterpart of ``ntpoly_tpu/solvers/eigenbounds.py``: the Gershgorin
bounds (a reduction in ``parallel/algebra.py``) and the power-iteration
estimate of the largest eigenvalue with Aitken's delta-squared
extrapolation, run on a dense vector through ``alg.spmv``.
"""
from __future__ import annotations

import torch

from ..parallel import algebra as alg
from .common import resolve, solver_log, iteration_log
from .parameters import SolverParameters


def gershgorin_bounds(mat):
    """(lo, hi) as floats (one readback)."""
    lo, hi = torch.stack(alg.gershgorin_bounds(mat)).tolist()
    return float(lo), float(hi)


def power_bounds(mat, params: SolverParameters | None = None) -> float:
    """The largest eigenvalue by power iteration: the start vector is
    1/dim on every logical column (padding included, which a load
    balance may have filled), and the loop stops when the monitor fires
    and the Aitken estimate lies within its loose cutoff of the Ritz
    value."""
    if params is None:
        params = SolverParameters(max_iterations=10)
    params, monitor = resolve(params)

    with solver_log(params, "Power Bounds Solver"):
        x = torch.full((mat.logical_dim,), 1.0 / mat.dim, dtype=mat.dtype,
                       device=mat.device)
        ritz = [0.0, 0.0, 0.0]
        aitken = [0.0, 0.0, 0.0]
        with iteration_log(params) as ilog:
            for ii in range(1, params.max_iterations + 1):
                y = alg.spmv(mat, x)
                num, den = torch.stack([torch.dot(x, y),
                                        torch.dot(x, x)]).tolist()
                max_value = num / den
                x = y / y.abs().amax()
                ritz = ritz[1:] + [max_value]
                aitken = aitken[1:] + [0.0]
                if ii >= 3:
                    num_a = ritz[2] * ritz[0] - ritz[1] ** 2
                    den_a = ritz[2] - 2 * ritz[1] + ritz[0]
                    aitken[2] = num_a / den_a if abs(den_a) > 1e-14 \
                        else ritz[2]
                else:
                    aitken[2] = ritz[2]
                monitor.append(-(aitken[2] - aitken[1]))
                if monitor.check_converged(params.be_verbose):
                    if abs(aitken[2] - ritz[2]) < monitor.loose_cutoff:
                        break
                ilog.step(**{"Estimate": ritz[2],
                             "Aitken Estimate": aitken[2]})
    return float(aitken[2])
