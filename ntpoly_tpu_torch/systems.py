"""Model Hamiltonians of the benchmarks, as value functions for
``parallel.pmatrix.banded``.

Counterpart of the value functions in the JAX package's ``bench.py``.
"""
from __future__ import annotations

import torch


def gapped_fn(i, j):
    """Value function of the gapped (insulating) tight-binding chain:
    staggered +-0.15 on-site energies, hopping 0.25 / (1 + |i - j|)^2,
    computed in float32 like the reference's benchmark system."""
    off = (i - j).abs().to(torch.float32)
    hop = 0.25 / (1.0 + off) ** 2
    stag = torch.where(i % 2 == 0, 0.15, -0.15)
    return torch.where(off == 0, stag, hop)


def chain_fn(dim: int):
    """Value function of the tight-binding chain of ``dim`` sites
    (hopping 1 / (1 + |i - j|)^2, on-site energies rising linearly from
    -1 to 1), computed in float32 like the reference's ``_chain_fn``."""
    def fn(i, j):
        off = (i - j).abs().to(torch.float32)
        hop = 1.0 / (1.0 + off) ** 2
        diag = -1.0 + 2.0 * i.to(torch.float32) / (dim - 1)
        return torch.where(off == 0, diag, hop)
    return fn


def overlap_fn(i, j):
    """Value function of a banded overlap matrix: ones on the diagonal
    and 0.3 / (1 + |i - j|)^2 off it (used at half-width 16, where it
    is symmetric positive definite with eigenvalues in about
    [0.89, 1.35]), computed in float64."""
    off = (i - j).abs().to(torch.float64)
    return torch.where(off == 0, 1.0, 0.3 / (1.0 + off) ** 2)
