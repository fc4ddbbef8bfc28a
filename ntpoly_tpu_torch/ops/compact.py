"""The compact of block-ELL slots to k_out: the full-span band product's
truncation.

``slot_compact(cols, blocks, k_out, threshold)`` returns what
``core/bell.py``'s ``compact`` returns: entries with |v| <= threshold
flushed to +0, the k_out occupied slots of largest block L1 norm kept (a
tie keeps the lower slot), ordered by col id, EMPTY last, padded to
k_out.

On CUDA blocks of a dtype and block size the kernels take
(``_cuda.takes``: real float32/float64, bs a multiple of 8 up to 128)
with int32 col ids, a Python number for the threshold and k_out >= 1
(any number of slots in and out) it launches ``csrc/compact.cu``: the
candidates' norms in one pass, the rows ranked, and the kept blocks
gathered.  Its norms are float64 sums, so where two of a row's norms
lie within the plain float32 sum's rounding the two may keep different
slots; everywhere else the output has the plain version's bits.  Such
an input at fault (on two devices, or blocks that do not match the col
ids) raises.  Every other input, CPU tensors, complex data, other block
sizes and int64 col ids included, takes the plain version,
``bell.compact``, as the reductions route (``ops/reduce.py``).  On the
card every input of the full-span band product
(``parallel/algebra.py``) is one the kernels take, since the band
kernel runs only at eligible dtypes and block sizes.

``compactions`` counts the compacts run on the card (the counter group
'compactions' of ``utils/trace.py``; each is three kernel launches, and
the plain version counts nothing).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import EMPTY
from ..core.bell import compact
from ..utils import trace
from . import _cuda

Tensor = torch.Tensor

compactions = trace.counter_group("compactions", ("slot_compact",))


def slot_compact(cols: Tensor, blocks: Tensor, k_out: int, threshold=0.0
                 ) -> Tuple[Tensor, Tensor]:
    """[..., R, M] slots -> [..., R, k_out] (col ids, blocks): the compact
    kernels (``csrc/compact.cu``) where ``_cuda.takes`` (and the col ids
    are int32, the threshold a Python number, k_out >= 1), else the
    plain version (``compact``)."""
    if not (_cuda.takes(blocks.dtype, blocks) and cols.dtype == torch.int32
            and isinstance(threshold, (int, float)) and k_out >= 1):
        return compact(cols, blocks, k_out, threshold)
    lead = tuple(cols.shape[:-1])
    dt, bs = blocks.dtype, blocks.shape[-1]
    c, b = _cuda.slot_operands(dt, (cols, blocks))
    rows, m = c.shape
    dev = b.device
    out_c = torch.empty((rows, k_out), dtype=torch.int32, device=dev)
    out_b = torch.empty((rows, k_out, bs, bs), dtype=dt, device=dev)
    if rows:
        norms = torch.empty((rows, m), dtype=torch.float64, device=dev)
        place = torch.empty((rows, max(m, k_out)), dtype=torch.int32,
                            device=dev)
        source = torch.empty((rows, k_out), dtype=torch.int32, device=dev)
        _cuda.launch("ntp_slot_compact" + _cuda.SUFFIX[dt], compactions,
                     "slot_compact",
                     (c, b, out_c, out_b, norms, place, source),
                     (c.stride(0), b.stride(0), rows, m, k_out, bs),
                     (threshold,))
    return (out_c.reshape(lead + (k_out,)),
            out_b.reshape(lead + (k_out, bs, bs)))


def rows_differ(got, want) -> Tensor:
    """Block rows where two compacts' (col ids, blocks) differ, the
    blocks bit for bit (-0.0 is not +0.0, NaN equals its own bits)."""
    ints = torch.int32 if got[1].element_size() == 4 else torch.int64
    cols = (got[0] != want[0]).flatten(0, -2).any(dim=-1)
    blocks = (got[1].contiguous().view(ints)
              != want[1].contiguous().view(ints)).flatten(0, -4)
    return (cols | blocks.flatten(1).any(dim=-1)).nonzero().flatten()


def near_ties(cols, blocks, k_out: int, rel: float = 1e-6) -> Tensor:
    """Block rows whose k_out-th and next largest occupied norms (float64
    sums, at threshold 0) lie within ``rel`` of each other: where the
    plain version's float32 norm (torch's sum of bs^2 terms, a few eps
    off; ``rel`` 1e-6 is about 8 eps) and the kernels' float64 one may
    rank the two either way, so the only rows where :func:`slot_compact`
    may keep other slots than ``compact``."""
    nrm = blocks.abs().sum(dim=(-1, -2), dtype=torch.float64)
    nrm = torch.where(cols != EMPTY, nrm, 0.0).flatten(0, -2)
    if nrm.shape[-1] <= k_out:
        return nrm.new_zeros((0,), dtype=torch.long)
    top = torch.sort(nrm, dim=-1, descending=True).values
    a, b = top[:, k_out - 1], top[:, k_out]
    return ((b > 0) & ((a - b) <= rel * a)).nonzero().flatten()
