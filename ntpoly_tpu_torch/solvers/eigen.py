"""Eigendecomposition and dense matrix functions.

Counterpart of ``ntpoly_tpu/solvers/eigen.py``, dense path: the matrix
is gathered to a dense tensor on its device, factorized by
``torch.linalg.eigh`` and blocked back with the threshold.
``dense_matrix_function`` (eigendecompose, map the eigenvalues, put
back together) is what every ``dense_*`` solver runs; its ``func`` maps
a torch tensor of eigenvalues (``torch.exp``, ``lambda w: 1.0 / w``).
``eigen_decomposition_iterative`` finds the lowest eigenpairs without
densifying: LOBPCG (``solvers/lobpcg.py``) on the block-sparse
operator, complex matrices through their real embedding and
``dedup_embedded_pairs``.
"""
from __future__ import annotations

import numpy as np
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
    """The lowest ``nvals`` eigenpairs without densifying: LOBPCG on
    b I - A, with b the Gershgorin upper bound + 1 (LOBPCG finds the
    largest), one ``alg.spmm`` per operator application, the padded
    rows masked inside the operator (a load-balanced matrix, permuted
    into the padding, is not supported) -> (w [nvals] ascending,
    v [dim, nvals]) as tensors on the matrix's device.  ``tol=None`` is
    the dtype's epsilon rule of :func:`lobpcg.lobpcg_standard`.

    The start block is standard normal from a ``torch.Generator``
    seeded 7 on the CPU, moved to the matrix's device, so a card run
    and a CPU run start alike; it is not the reference's
    ``jax.random.normal(PRNGKey(7))`` draw.  A complex matrix runs as
    its real embedding at 2 * nvals and returns numpy arrays from
    :func:`dedup_embedded_pairs`."""
    from .lobpcg import lobpcg_standard
    if mat.dtype.is_complex:
        from ..core import cplx
        w2, v2 = eigen_decomposition_iterative(
            cplx.embed(mat), 2 * nvals, params=params, max_iters=max_iters,
            tol=tol)
        return dedup_embedded_pairs(w2.cpu().numpy(), v2.cpu().numpy(),
                                    mat.dim, nvals)
    params, _ = resolve(params)
    with solver_log(params, "Eigen Solver", "LOBPCG (matrix-free)",
                    extra={"Requested Values": nvals}):
        b = alg.gershgorin_bounds(mat)[1] + 1.0
        n = mat.logical_dim
        mask = (torch.arange(n, device=mat.device) < mat.dim)[:, None]
        mask = mask.to(mat.dtype)

        def op(x):
            return (b * x - alg.spmm(mat, x)) * mask

        gen = torch.Generator().manual_seed(7)
        x0 = torch.randn((n, nvals), generator=gen, dtype=mat.dtype)
        theta, v, iters = lobpcg_standard(op, x0.to(mat.device) * mask,
                                          m=max_iters, tol=tol)
        w = b - theta
        order = torch.argsort(w)
        v = v[:, order] * mask
        if params.be_verbose:
            from ..utils.logging import logger
            logger.write_element("Iterations", iters)
        return w[order], v[:mat.dim, :]


def dedup_embedded_pairs(w2: np.ndarray, v2: np.ndarray, cdim: int,
                         nvals: int):
    """Complex eigenpairs from the real embedding's: each complex pair
    arrives twice, and any unit vector [x; y] of its real eigenspace
    gives a unit complex eigenvector x + iy up to phase.  Candidates
    from every embedded vector are kept when complex-linearly new
    (modified Gram-Schmidt, norm above 0.3).

    w2 [2 * nvals] ascending, v2 [2 * cdim, 2 * nvals] -> (w [nvals],
    v [cdim, nvals] complex128), numpy."""
    cands = v2[:cdim, :] + 1j * v2[cdim:, :]
    sel_w: list = []
    sel_v: list = []
    for k in range(cands.shape[1]):
        u = cands[:, k].astype(np.complex128)
        for uu in sel_v:
            u = u - uu * (np.conj(uu) @ u)
        nrm = np.linalg.norm(u)
        if nrm > 0.3:
            sel_v.append(u / nrm)
            sel_w.append(float(w2[k]))
        if len(sel_v) == nvals:
            break
    return (np.asarray(sel_w),
            np.stack(sel_v, axis=1) if sel_v
            else np.zeros((cdim, 0), np.complex128))


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
