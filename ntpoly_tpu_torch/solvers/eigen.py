"""Eigendecomposition and dense matrix functions.

Counterpart of ``ntpoly_tpu/solvers/eigen.py``, dense path: the matrix
is gathered to a dense tensor on its device, factorized by
``torch.linalg.eigh`` and blocked back with the threshold.
``dense_matrix_function`` (eigendecompose, map the eigenvalues, put
back together) is what every ``dense_*`` solver runs; its ``func`` maps
a torch tensor of eigenvalues (``torch.exp``, ``lambda w: 1.0 / w``).
The matrix-free LOBPCG (``eigen_decomposition_iterative``) and the
complex embedding's pair reconstruction (``dedup_embedded_pairs``) are
ROADMAP Queue A item 6.12 and raise.
"""
from __future__ import annotations

import torch

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from .common import resolve, solver_log, identity_like
from .parameters import SolverParameters


def _to_ps(dense, like, threshold=0.0):
    return PM.from_dense(dense, bs=like.bs, k=like.k, grid=like.grid,
                         dtype=like.dtype, threshold=threshold)


def eigh(mat):
    """Dense Hermitian eigendecomposition of a PSMatrix -> (w, v)
    tensors on its device, eigenvalues ascending."""
    return torch.linalg.eigh(PM.to_dense(mat))


def eigen_decomposition(mat, nvals: int | None = None,
                        params: SolverParameters | None = None,
                        compute_vectors: bool = True):
    """(vals, vecs) as PSMatrices, vals diagonal.  With ``nvals`` only
    the lowest nvals pairs are kept (the other columns zeroed)."""
    params, _ = resolve(params)
    with solver_log(params, "Eigen Solver", "LAPACK"):
        w, v = eigh(mat)
        if nvals is not None and nvals < mat.dim:
            keep = torch.arange(w.shape[0], device=w.device) < nvals
            w = torch.where(keep, w, 0.0)
            v = torch.where(keep[None, :], v, 0.0)
        vals = _to_ps(torch.diag(w), like=mat)
        if not compute_vectors:
            return vals, None
        return vals, _to_ps(v, like=mat, threshold=params.threshold)


def eigen_values(mat, nvals: int | None = None,
                 params: SolverParameters | None = None):
    vals, _ = eigen_decomposition(mat, nvals=nvals, params=params,
                                  compute_vectors=False)
    return vals


def dense_matrix_function(mat, func, params: SolverParameters | None = None):
    """V f(w) V^H, entries with |x| <= threshold dropped.  ``func`` maps
    a torch tensor of eigenvalues elementwise."""
    params, _ = resolve(params)
    w, v = eigh(mat)
    out = (v * func(w)[None, :]) @ v.conj().T
    return _to_ps(out, like=mat, threshold=params.threshold)


def eigen_decomposition_iterative(mat, nvals: int,
                                  params: SolverParameters | None = None,
                                  max_iters: int = 200, tol=None):
    """The matrix-free LOBPCG: not ported yet."""
    raise ValueError("eigen_decomposition_iterative (LOBPCG) is not "
                     "ported yet (ROADMAP Queue A item 6.12)")


def dedup_embedded_pairs(w2, v2, cdim: int, nvals: int):
    """Complex pairs from the real embedding: not ported yet."""
    raise ValueError("dedup_embedded_pairs needs core/cplx.py, which is "
                     "not ported yet (ROADMAP Queue A item 6.12)")


def estimate_gap(h, k, chemical_potential,
                 params: SolverParameters | None = None):
    """HOMO-LUMO gap estimate from the density matrix K and mu: power
    bounds of KH, then of K (H - e_min I)."""
    from .eigenbounds import power_bounds, gershgorin_bounds
    params, _ = resolve(params)
    with solver_log(params, "Gap Estimator"):
        kh = alg.matmul(k, h, threshold=params.threshold)
        e_min = power_bounds(kh, params)
        if e_min > 0:
            e_min, _ = gershgorin_bounds(h)
        shift_h = alg.increment(identity_like(h), h, -e_min, 1.0)
        kh = alg.matmul(k, shift_h, threshold=params.threshold)
        e_max = power_bounds(kh, params) + e_min
        return 2.0 * (chemical_potential - e_max)


def singular_value_decomposition(mat, params: SolverParameters | None = None):
    """SVD by polar decomposition A = U H and the eigendecomposition of
    H -> (left vectors, right vectors, singular values)."""
    from .sign import polar_decomposition
    params, _ = resolve(params)
    with solver_log(params, "SVD Solver", "Polar + Eigen"):
        u, h = polar_decomposition(mat, params)
        singular_values, right = eigen_decomposition(h, params=params)
        left = alg.matmul(u, right, threshold=params.threshold)
        return left, right, singular_values
