"""Seeded Hamiltonians: the inputs every cell's calls are made on.

A traffic mix (``traffic/<mix>.json``) names a ``pool`` of Hamiltonians
that the single caller hands the library in turn, as successive SCF or
MD steps do: one sparsity pattern, values that differ by an on-site
disorder.  The pool is one fixed set, drawn on the device from the
mix's ``set_seed`` in one call, and a run's ``--seed`` draws the order
in which the caller sends them (:func:`order`): the iteration count of
a solve turns on its Hamiltonian's details (a chunked solve of 9
iterations costs two chunks where one of 8 costs one), so a pool drawn
from each run's seed would change the work from run to run.  The
value function below is the benchmark's own, evaluated alike by the
program's constructor and by the reference.
"""
from __future__ import annotations

import random

import torch


def onsite(seed: int, pool: int, rows: int, amplitude: float,
           device) -> torch.Tensor:
    """float32[pool, rows] drawn uniformly from [-amplitude, amplitude)
    by a generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    u = torch.rand((pool, rows), generator=gen, device=device,
                   dtype=torch.float32)
    return (u * 2.0 - 1.0) * amplitude


def gapped_chain(config: dict, disorder: torch.Tensor):
    """Value function of the gapped tight-binding chain with an on-site
    disorder: staggered +-stagger on the diagonal (+ on even rows) plus
    ``disorder[i]``, hopping / (1 + |i - j|)^2 off it, in float32.
    ``i`` and ``j`` are integer index tensors that broadcast."""
    stagger = float(config["onsite_stagger"])
    hopping = float(config["hopping"])
    last = disorder.shape[0] - 1

    def fn(i, j):
        off = (i - j).abs().to(torch.float32)
        hop = hopping / (1.0 + off) ** 2
        ii = i.long().clamp(0, last)
        diag = torch.where(i % 2 == 0, stagger, -stagger) + disorder[ii]
        return torch.where(off == 0, diag, hop)
    return fn


FAMILIES = {"gapped_chain": gapped_chain}


def order(seed: int, pool: int, calls: int) -> list[int]:
    """The pool members of the first ``calls`` calls: each round of
    ``pool`` calls sends every member once, in an order drawn from
    ``seed``."""
    rng = random.Random(seed)
    out: list[int] = []
    while len(out) < calls:
        rnd = list(range(pool))
        rng.shuffle(rnd)
        out += rnd
    return out[:calls]


def value_function(config: dict, disorder: torch.Tensor):
    """The value function of ``config['family']`` with one pool member's
    on-site disorder."""
    return FAMILIES[config["family"]](config, disorder)
