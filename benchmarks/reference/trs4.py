"""The plain reference of a TRS4 density solve.

TRS4 (Niklasson, "Expansion algorithm for the density matrix", Phys.
Rev. B 66, 155115 (2002)) as NTPoly's DensityMatrixSolversModule.F90
runs it: X_0 = (e_max I - H) / (e_max - e_min) from the Gershgorin
bounds, then each step forms X^2, the trace-resetting coefficient

    sigma = (nel - tr(4 X^3 - 3 X^4)) / tr(X^2 (I - X)^2)

and takes X <- 2X - X^2 above sigma_max = 6, X <- X^2 below
sigma_min = 0, else X <- X^2 ((sigma - 3) X^2 + (4 - 2 sigma) X +
sigma I).  The density is the last X, the energy tr(X H), and the
chemical potential e_max + (e_min - e_max) m, where m is the point of
[0, 1] that the replayed scalar steps send to 1/2, found by bisection.

The reference runs in float64 on block-band matrices (``band.py``) and
keeps going until the idempotency residual |tr X - tr X^2| / nel is
below ``tol`` or stops falling: its density is the projector to
float64 rounding, whatever the program's stopping rule.  With
``dtype=float32`` and ``operands`` that round to a lower precision it
is the control of the check (``entries/trs4.py``).

:func:`gap_edges` bounds the gap that the chemical potential has to
lie in, from a density and its Hamiltonian alone.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import band as B

SIGMA_MIN, SIGMA_MAX = 0.0, 6.0
# Lanczos steps of each gap edge
EDGE_STEPS = 40


@dataclass
class Solution:
    density: torch.Tensor          # band[2w + 1, nb, bs, bs]
    energy: float
    mu: float
    iterations: int
    idempotency: float             # |tr X - tr X^2| / nel of the last X


def _replay(sigma: float, z: float) -> float:
    if sigma > SIGMA_MAX:
        return 2.0 * z - z * z
    if sigma < SIGMA_MIN:
        return z * z
    fx = z * z * (4.0 * z - 3.0 * z * z)
    gx = z * z * (1.0 - z) ** 2
    return fx + sigma * gx


def chemical_potential(sigmas, e_min: float, e_max: float,
                       tol: float = 1e-13, steps: int = 200) -> float:
    """e_max + (e_min - e_max) m, m the bisection point of [0, 1] that
    the scalar steps of ``sigmas`` send to within ``tol`` of 1/2."""
    a, b = 0.0, 1.0
    m = 0.5
    for _ in range(steps):
        m = 0.5 * (a + b)
        z = m
        for s in sigmas:
            z = _replay(s, z)
        if abs(z - 0.5) < tol:
            break
        if z < 0.5:
            a = m
        else:
            b = m
    return e_max + (e_min - e_max) * m


def trs4(h: torch.Tensor, nel: float, *, dtype=torch.float64,
         operands=None, tol: float = 1e-12,
         max_iterations: int = 60) -> Solution:
    """The density of the Hamiltonian band ``h`` at ``nel`` electrons
    (see the module docstring)."""
    h = h.to(dtype)
    w = B.half_width(h)
    nb, bs = h.shape[1], h.shape[2]
    e_min, e_max = B.gershgorin(h)
    span = e_max - e_min
    x = B.identity(nb, bs, w, dtype, h.device).mul_(e_max / span)
    x.sub_(h, alpha=1.0 / span)
    sigmas = []
    last = float("inf")
    idem = last
    n = 0
    for n in range(1, max_iterations + 1):
        x2 = B.matmul(x, x, operands)
        d1, d2 = B.dot(x2, x), B.dot(x2, x2)
        t2, tx = B.trace(x2), B.trace(x)
        trace_fx = 4.0 * d1 - 3.0 * d2
        trace_gx = t2 - 2.0 * d1 + d2
        if abs(trace_gx) < 1e-14:
            sigma = 0.5 * (SIGMA_MAX - SIGMA_MIN)
        else:
            sigma = (nel - trace_fx) / trace_gx
        sigmas.append(sigma)
        if sigma > SIGMA_MAX:
            x = x.mul_(2.0).sub_(x2)
        elif sigma < SIGMA_MIN:
            x = x2
        else:
            poly = x2.mul(sigma - 3.0).add_(x, alpha=4.0 - 2.0 * sigma)
            poly[w].diagonal(dim1=-2, dim2=-1).add_(sigma)
            del x
            x = B.matmul(x2, poly, operands)
            del poly
        del x2
        idem = abs(tx - t2) / nel
        if idem < tol or (idem >= last and last < 1e-6):
            break
        last = idem
    energy = B.dot(x, h)
    mu = chemical_potential(sigmas, e_min, e_max)
    return Solution(x, energy, mu, n, idem)


def _top_ritz(op, v: torch.Tensor, steps: int) -> float:
    """The largest Ritz value of the symmetric operator ``op`` after
    ``steps`` Lanczos steps from ``v``, the basis reorthogonalised in
    full: never above the operator's largest eigenvalue."""
    basis = torch.zeros((steps,) + tuple(v.shape), dtype=v.dtype,
                        device=v.device)
    flat = basis.view(steps, -1)
    alphas, betas = [], []
    q = v / v.norm()
    for j in range(steps):
        basis[j] = q
        z = op(q)
        alphas.append(float((q * z).sum()))
        for _ in range(2):
            z -= (flat[:j + 1].T @ (flat[:j + 1] @ z.reshape(-1))) \
                .view_as(z)
        beta = float(z.norm())
        if j + 1 == steps or beta <= 1e-10 * abs(alphas[-1]):
            break
        betas.append(beta)
        q = z / beta
    t = torch.diag(torch.tensor(alphas, dtype=torch.float64))
    if betas:
        off = torch.tensor(betas, dtype=torch.float64)
        t += torch.diag(off, 1) + torch.diag(off, -1)
    return float(torch.linalg.eigvalsh(t).max())


def gap_edges(h: torch.Tensor, k: torch.Tensor,
              steps: int = EDGE_STEPS, seed: int = 0) -> tuple[float,
                                                               float]:
    """(homo, lumo) of the Hamiltonian band ``h`` with the projector
    ``k`` (a density, in ``h``'s band): the largest eigenvalue of H on
    K's range from below and the smallest on the rest from above, by
    Lanczos on K (H - e_min) K and (I - K) (e_max - H) (I - K).  Ritz
    values never pass the eigenvalues they tend to, so the interval
    returned holds the true gap: a chemical potential outside it lies
    outside the gap."""
    e_min, e_max = B.gershgorin(h)
    gen = torch.Generator(device=h.device)
    gen.manual_seed(seed)
    r = torch.randn(h.shape[1:3], generator=gen, dtype=h.dtype,
                    device=h.device)

    def occupied(v):
        v = B.matvec(k, v)
        return B.matvec(k, B.matvec(h, v) - e_min * v)

    def empty(v):
        v = v - B.matvec(k, v)
        u = e_max * v - B.matvec(h, v)
        return u - B.matvec(k, u)

    homo = e_min + _top_ritz(occupied, B.matvec(k, r), steps)
    lumo = e_max - _top_ritz(empty, r - B.matvec(k, r), steps)
    return homo, lumo
