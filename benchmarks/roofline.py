"""The work of a block-sparse product and the least time the card could
take for it.

Operands are block-ELL structures: ``cols[nb, k]`` holds the block
column of each slot of each block row, a slot whose id is not in
[0, nb) being unused.  For C = A @ B:

  flops  2 bs^3 for each pair of stored blocks A(i, m), B(m, j): the
         block products the operands' structure needs, whether or not
         the product is later dropped by the threshold;
  bytes  each input's stored blocks once (one operand when A is B) and
         the output's stored blocks once.

The least time is the larger of bytes over the memory bandwidth and
flops over the tensor-core rate (``peaks.json``).  The same formula
holds at every precision tier, so the work reads alike whatever
computes the product, and no implementation can beat it.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def peaks() -> dict:
    with open(HERE / "peaks.json") as f:
        return json.load(f)


def _used(cols: torch.Tensor, nb: int) -> torch.Tensor:
    return (cols >= 0) & (cols < nb)


def stored_blocks(cols: torch.Tensor, nb: int) -> int:
    return int(_used(cols, nb).sum())


def block_pairs(a_cols: torch.Tensor, b_cols: torch.Tensor, nb: int) -> int:
    """Pairs (A(i, m), B(m, j)) of stored blocks."""
    per_row = _used(b_cols, nb).sum(dim=1)               # B's row m
    used = _used(a_cols, nb)
    return int(per_row[a_cols.long().clamp(0, nb - 1)][used].sum())


def product(a_cols, b_cols, c_cols, nb: int, bs: int, itemsize: int,
            same: bool) -> dict:
    """{'bytes', 'flops'} of C = A @ B (``same``: A is B)."""
    inputs = stored_blocks(a_cols, nb)
    if not same:
        inputs += stored_blocks(b_cols, nb)
    block = bs * bs * itemsize
    return {"bytes": (inputs + stored_blocks(c_cols, nb)) * block,
            "flops": 2 * bs ** 3 * block_pairs(a_cols, b_cols, nb)}


def least_seconds(work: dict, peak: dict | None = None) -> float:
    peak = peak or peaks()
    return max(work["bytes"] / peak["hbm_bytes_per_s"],
               work["flops"] / peak["flops_per_s"])
