"""LOBPCG for the largest eigenpairs of a Hermitian operator.

A transcription into torch of ``lobpcg_standard`` in JAX's
``jax/experimental/sparse/linalg.py`` (JAX 0.9.0): the same algorithm
(an orthonormal X, P, R basis kept by SVQB orthonormalization, the
residuals projected out of X and P twice, a Rayleigh-Ritz step on the
3k columns, P from the QR of Q's off-diagonal quadrant), the same
stopping rule (a pair converges when |A x - theta x| < tol * 10 * n *
(|A x| + theta), with tol the dtype's epsilon when None), and the same
``0 < k * 5 < n`` check on the input.  Where the JAX routine loops on
the device, this one reads the converged count back once an iteration.
Matrix products run in the operands' precision (TF32 is off).
"""
from __future__ import annotations

from typing import Callable

import torch


def lobpcg_standard(A: Callable[[torch.Tensor], torch.Tensor],
                    X: torch.Tensor, m: int = 100, tol: float | None = None):
    """The top k eigenpairs of the operator ``A`` from the start block
    ``X`` [n, k] (orthonormalized here), in at most ``m`` iterations ->
    (theta [k], U [n, k], iterations)."""
    n, k = X.shape
    _check_inputs(A, X)
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)
    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    i, converged = 0, 0
    while i < m and converged < k:
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)
        theta, Q = _rayleigh_ritz_orth(A, XPR)
        # eigenvector extraction
        B = Q[:, :k]
        B = B / _norms(B)
        X = XPR @ B
        X = X / _norms(X)
        # search directions: Q[k:, :k] orthogonalized against Q[:, :k]
        # in the standard basis, then mapped by the orthonormal XPR
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        norm_p = _norms(P)
        P = P / torch.where(norm_p == 0, 1.0, norm_p)
        AX = A(X)
        R = AX - theta[None, :k] * X
        resid_norms = _norms(R)[0]
        reltol = (_norms(AX)[0] + theta[:k]) * n * 10
        converged = int((resid_norms < tol * reltol).sum())
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def _check_inputs(A, X):
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got "
                         f"{k * 5}, {n})")
    out = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if out.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were {out.dtype}, "
                         f"{X.dtype})")
    if out.shape != (n, 1):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output "
                         f"{tuple(out.shape)}")


def _norms(x):
    """Column 2-norms [1, k] as sqrt(sum(x^2)): torch's strided
    ``linalg.norm(x, dim=0)`` sums a tall float32 column in order on the
    CPU (2.4e-4 off at 2^20 rows), which costs LOBPCG its
    orthonormality."""
    return torch.sqrt((x * x).sum(dim=0, keepdim=True))


def _eigh_descending(a):
    """Eigenpairs of a symmetric matrix, largest first (JAX's
    ``_eigh_ascending`` returns this order)."""
    w, v = torch.linalg.eigh(a)
    return w.flip(0), v.flip(1)


def _svqb(X):
    """A truncated orthonormal basis of X's columns (SVQB): normalize,
    diagonalize X^T X, scale; directions with eigenvalue at most eps
    times the largest are zeroed."""
    norms = _norms(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)
    ortho = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = _norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _project_out(basis, U):
    """U's component orthogonal to the orthonormal ``basis`` (zero
    columns allowed): subtract and orthonormalize twice, subtract twice
    more, and zero every column whose norm fell below 0.99."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    norm_u = _norms(U)
    return U * (norm_u >= 0.99).to(U.dtype)


def _orthonormalize(basis):
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A, S):
    """Eigenpairs of S^T A S for an orthonormal S (zero columns
    allowed), largest first."""
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X, m: int):
    """m columns that extend the orthonormal X [n, k] to an orthonormal
    basis, from a block Householder reflector."""
    n, k = X.shape
    upper, lower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat((upper + u @ vt, lower), dim=0)
    other = torch.cat((torch.eye(m, dtype=X.dtype, device=X.device),
                       X.new_zeros((n - k - m, m))), dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-0.5))[None, :])
    h = -2 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h
