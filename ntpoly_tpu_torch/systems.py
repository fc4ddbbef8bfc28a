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
