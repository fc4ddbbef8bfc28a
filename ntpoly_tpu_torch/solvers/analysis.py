"""Matrix analysis: the pivoted Cholesky factorization and dimension
reduction.

Counterpart of ``ntpoly_tpu/solvers/analysis.py``.  The rank-k pivoted
Cholesky (aquilante2006fast) keeps the matrix sparse: each step reads
one column by a one-hot ``alg.spmv``, updates a dense [dim, rank]
panel and downdates the remaining diagonal.  The loop is a Python loop
of tensor operations with no host read: the pivot is a device tensor
(``argmax``, the first maximal index) and ``index_select`` /
``index_copy_`` read and write at it.  ``reduce_dimension`` runs TRS4
with an identity overlap, the pivoted Cholesky of the density, the
similarity transform into that subspace and ``get_slice``.
"""
from __future__ import annotations

import torch

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from .common import resolve, solver_log, identity_like
from .parameters import SolverParameters


def _pivoted_chol(amat, diag0, threshold: float, rank: int):
    """The dense [logical_dim, rank] panel of the rank-``rank`` pivoted
    Cholesky.  Step jj: pivot p = argmax(diag); col = (A[:, p] -
    L L[p, :]^H) / sqrt(diag[p]), with sqrt(diag[p]) at row p; a pivot
    with diag[p] <= 0 gives a zero column, which freezes the
    factorization."""
    n = amat.logical_dim
    dev = amat.device
    idx = torch.arange(n, device=dev)
    slots = torch.arange(rank, device=dev)
    ell = torch.zeros((n, rank), dtype=amat.dtype, device=dev)
    diag = diag0.clone()
    for jj in range(rank):
        p = torch.argmax(diag).reshape(1)
        val = diag.index_select(0, p)[0]
        ok = val > 0
        at_p = idx == p
        acol = alg.spmv(amat, at_p.to(amat.dtype))        # A[:, p]
        ellp = ell.index_select(0, p)[0]
        proj = ell @ torch.where(slots < jj, ellp.conj(), 0)
        denom = torch.sqrt(torch.where(ok, val, 1.0)).to(ell.dtype)
        col = (acol - proj) / denom
        col = torch.where(at_p, denom, col)
        col = torch.where((col.abs() > threshold) & ok, col, 0)
        ell[:, jj] = col
        diag = diag - col.abs().to(diag.dtype) ** 2
        diag.index_copy_(0, p, torch.where(ok, 0.0, val).reshape(1))
    return ell


def pivoted_cholesky_decomposition(amat, rank: int,
                                   params: SolverParameters | None = None):
    """Rank-``rank`` L with A ~= L L^H, as a PSMatrix whose first
    ``rank`` columns are the pivoted Cholesky vectors."""
    params, _ = resolve(params)
    with solver_log(params, "Cholesky Solver", "Pivoted",
                    citations=("aquilante2006fast",),
                    extra={"Target_Rank": rank}):
        n = amat.logical_dim
        diag0 = alg.diagonal_values(amat).real
        # padded rows carry a zero diagonal and are never picked while a
        # positive pivot remains
        diag0 = torch.where(torch.arange(n, device=amat.device) < amat.dim,
                            diag0, 0.0)
        ell = _pivoted_chol(amat, diag0, params.threshold, rank)
        # whole blocks for from_tall_dense
        ell = torch.nn.functional.pad(ell, (0, -rank % amat.bs))
        return PM.from_tall_dense(ell, amat.dim, 0, bs=amat.bs,
                                  grid=amat.grid)


def reduce_dimension(mat, dim: int, params: SolverParameters | None = None):
    """The matrix in the subspace of its ``dim`` lowest states: TRS4
    at ``dim`` electrons, the rank-``dim`` pivoted Cholesky of that
    density, L^H A L, and its leading dim x dim block."""
    from .density import trs4
    params, _ = resolve(params)
    with solver_log(params, "Dimension Reduction"):
        pmat, _, _ = trs4(mat, identity_like(mat), float(dim), params)
        pvec = pivoted_cholesky_decomposition(pmat, dim, params)
        del pmat
        pvec_t = alg.transpose(pvec).conjugate()
        vav = alg.similarity_transform(mat, pvec_t, pvec,
                                       threshold=params.threshold)
        return PM.get_slice(vav, 0, dim, 0, dim)
