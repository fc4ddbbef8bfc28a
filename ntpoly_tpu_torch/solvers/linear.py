"""Linear solvers.

Counterpart of ``ntpoly_tpu/solvers/linear.py``: the matrix conjugate
gradient with trace-ratio step sizes (chunked with ``iters_per_sync >
1``, ``common.run_chunked``), and the blocked
right-looking Cholesky factorization.  Each panel of a few block
columns is extracted with one tall ``alg.spmm``, its diagonal block
factorized densely (``torch.linalg.cholesky_ex``), the rows below
solved triangularly, and the trailing matrix updated with one
threshold-filtered SpGEMM: O(dim x panel) dense scratch, never dim^2.
"""
from __future__ import annotations

import torch

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..utils.errors import NTPolyError
from .common import (resolve, solver_log, iteration_log, finish_iterations,
                     maybe_permute, maybe_unpermute, identity_like,
                     real_scalar, pin_capacity, run_chunked)
from .parameters import SolverParameters


def cg_solver(amat, bmat, params: SolverParameters | None = None):
    """X with A X = B for a symmetric positive definite A, from X = I;
    converged on |step| ||P||."""
    params, monitor = resolve(params)
    thr = params.threshold
    with solver_log(params, "Linear Solver", "CG"):
        imat = identity_like(amat)
        ab, bb, imat = maybe_permute(params, amat, bmat, imat)
        x = imat
        r = alg.increment(bb, alg.matmul(ab, x, threshold=thr), 1.0, -1.0)
        p = r
        if params.iters_per_sync > 1:
            x, total = _cg_chunked(x, r, p, ab, params, monitor)
            finish_iterations(params, total + 1, x, monitor=monitor,
                              solver="Linear Solver")
            return maybe_unpermute(params, x)
        total = 0
        with iteration_log(params):
            for ii in range(params.max_iterations):
                q = alg.matmul(ab, p, threshold=thr)
                top, bottom = (real_scalar(v) for v in (alg.dot(r, r),
                                                        alg.dot(p, q)))
                step = top / bottom
                x = alg.increment(x, p, 1.0, step)
                norm_value = abs(step * real_scalar(alg.norm(p)))
                r = alg.increment(r, q, 1.0, -step)
                del q
                new_top = real_scalar(alg.dot(r, r))
                p = alg.increment(r, p, 1.0, new_top / top)
                total = ii
                monitor.append(norm_value)
                if monitor.check_converged(params.be_verbose):
                    break
        finish_iterations(params, total + 1, x, monitor=monitor,
                          solver="Linear Solver")
        return maybe_unpermute(params, x)


def _cg_chunked(x, r, p, ab, params, monitor):
    """The CG step chunked (reference ``_cg_chunked``): X, R and P ride
    in the carry.  CG starts with P = R, one matrix twice; the chunk
    is functional and a captured chunk copies each into its own
    input."""
    thr = params.threshold
    k_pin, (x, r, p, abp) = pin_capacity(params, x, r, p, ab, n_carry=3)

    def step(carry, abc):
        xc, rc, pc = carry
        # the scalars in float64 on the device, as the eager loop's on
        # the host
        q = alg.matmul(abc, pc, threshold=thr)
        top = alg.dot(rc, rc).double()
        step_sz = top / alg.dot(pc, q).double()
        x_new = alg.increment(xc, pc, 1.0, step_sz)
        norm_value = (step_sz * alg.norm(pc).double()).abs()
        r_new = alg.increment(rc, q, 1.0, -step_sz)
        del q
        new_top = alg.dot(r_new, r_new).double()
        p_new = alg.increment(r_new, pc, 1.0, new_top / top)
        return (x_new, r_new, p_new), (norm_value,)

    with iteration_log(params) as ilog:
        (x, _, _), _, total = run_chunked(
            step, (x, r, p), (abp,), params, monitor, ilog, k_pin=k_pin,
            aux_names=("Convergence",), conv_mode="value",
            cache_key=("cg", thr))
    return x, total


def _chol_panel(a_rem, j0: int, dim_limit: int):
    """One panel of the blocked right-looking Cholesky: the solved
    columns [j0, j0 + W) of L as a dense [N, W] tensor (rows above the
    panel masked, columns at or beyond ``dim_limit`` zeroed), and a
    device flag that the diagonal block was not positive definite.

    The diagonal block is read at rows [j0, j0 + W) even where the last
    panel passes the logical dimension (zero rows there; their columns
    are dead and carry a unit diagonal)."""
    n = a_rem.logical_dim
    w = _chol_panel_width(a_rem)
    dev = a_rem.device
    rows = torch.arange(n, device=dev)
    cols = j0 + torch.arange(w, device=dev)
    live = cols < dim_limit
    sel = (rows[:, None] == cols[None, :]) & live[None, :]
    p = alg.spmm(a_rem, sel.to(a_rem.dtype))          # [N, W] = A[:, J]
    # rows above the panel are eliminated (zero up to threshold noise)
    p = p * (rows[:, None] >= j0)
    d = torch.nn.functional.pad(p[j0:j0 + w], (0, 0, 0, max(0, j0 + w - n)))
    eye = torch.eye(w, dtype=d.dtype, device=dev)
    d = torch.where(live[None, :] & live[:, None], d, eye)
    ld, info = torch.linalg.cholesky_ex(d)
    bad = (info != 0) | ld.isnan().any()
    # L[:, J] = P ld^-H, a triangular solve from the right
    lcols = torch.linalg.solve_triangular(ld, p.conj().T, upper=False).T
    return lcols.conj() * live[None, :], bad


def _chol_panel_width(a) -> int:
    """Panel width in elements: 512 // bs block columns, at most the
    matrix's."""
    return min(a.nb, max(1, 512 // a.bs)) * a.bs


def cholesky_decomposition(amat, params: SolverParameters | None = None):
    """A = L L^H with L lower triangular, threshold-sparsified; a panel
    whose diagonal block is not positive definite raises NTPolyError."""
    params, _ = resolve(params)
    with solver_log(params, "Linear Solver", "Cholesky"):
        n = amat.logical_dim
        w = _chol_panel_width(amat)
        thr = params.threshold
        a_rem = amat
        ell = None
        for j0 in range(0, n, w):
            lcols, bad = _chol_panel(a_rem, j0, amat.dim)
            if bool(bad):
                raise NTPolyError(
                    f"cholesky_decomposition: panel at column {j0} is "
                    "not positive definite (threshold-filtered trailing "
                    "updates can destabilize near-singular inputs; "
                    "lower params.threshold)")
            if thr > 0:
                lcols = torch.where(lcols.abs() > thr, lcols, 0)
            lp = PM.from_tall_dense(lcols, amat.dim, j0 // amat.bs,
                                    bs=amat.bs, grid=amat.grid)
            del lcols
            ell = lp if ell is None else alg.increment(ell, lp)
            if j0 + w < n:
                # trailing update A <- A - Lp Lp^H, threshold-filtered
                a_rem = alg.matmul(lp, alg.transpose(lp).conjugate(),
                                   alpha=-1.0, threshold=thr, beta=1.0,
                                   c=a_rem)
        return ell
