"""The compact of block-ELL slots to k_out: the full-span band product's
truncation.

``slot_compact(cols, blocks, k_out, threshold)`` returns what
``core/bell.py``'s ``compact`` returns: entries with |v| <= threshold
flushed to +0, the k_out occupied slots of largest block L1 norm kept (a
tie keeps the lower slot), ordered by col id, EMPTY last, padded to
k_out.

On CUDA tensors the kernels take (``kernel_takes``: real float32/float64
at a block size ``spgemm.eligible`` accepts, int32 col ids, a Python
number for the threshold; any number of slots in and out) it launches
``csrc/compact.cu``: the candidates' norms in one pass, the rows ranked,
and the kept blocks gathered.  Its norms are float64 sums, so where two
of a row's norms lie within the plain float32 sum's rounding the two may
keep different slots; everywhere else the output has the plain version's
bits.  Every other input, CPU tensors included, takes the plain version,
``bell.compact``: the route follows the device, dtype and block size,
and the two compute the same function.  On the card every input of the
full-span band product (``parallel/algebra.py``) is one the kernels
take, since the band kernel runs only at eligible dtypes and block
sizes.

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
from .spgemm import eligible, slot_rows

Tensor = torch.Tensor

compactions = trace.counter_group("compactions", ("slot_compact",))

_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


def kernel_takes(cols: Tensor, blocks: Tensor, k_out: int,
                 threshold=0.0) -> bool:
    """Does :func:`slot_compact` launch the kernels for these inputs."""
    if blocks.device.type != "cuda" or blocks.dim() < 3:
        return False
    bs = blocks.shape[-1]
    return (eligible(blocks.dtype, bs) and blocks.shape[-2] == bs
            and cols.dtype == torch.int32 and cols.device == blocks.device
            and tuple(blocks.shape[:-2]) == tuple(cols.shape)
            and isinstance(threshold, (int, float)) and k_out >= 1)


def slot_compact(cols: Tensor, blocks: Tensor, k_out: int, threshold=0.0
                 ) -> Tuple[Tensor, Tensor]:
    """[..., R, M] slots -> [..., R, k_out] (col ids, blocks): the compact
    kernels (``csrc/compact.cu``) where :func:`kernel_takes`, else the
    plain version (``compact``)."""
    if not kernel_takes(cols, blocks, k_out, threshold):
        return compact(cols, blocks, k_out, threshold)
    lead = tuple(cols.shape[:-1])
    dt, bs = blocks.dtype, blocks.shape[-1]
    c, b = slot_rows(cols, blocks, dt)
    if b.data_ptr() % 16 or b.stride(0) * b.element_size() % 16:
        b = b.clone(memory_format=torch.contiguous_format)
    rows, m = c.shape
    dev = b.device
    out_c = torch.empty((rows, k_out), dtype=torch.int32, device=dev)
    out_b = torch.empty((rows, k_out, bs, bs), dtype=dt, device=dev)
    if rows:
        from . import _cuda
        norms = torch.empty((rows, m), dtype=torch.float64, device=dev)
        place = torch.empty((rows, max(m, k_out)), dtype=torch.int32,
                            device=dev)
        source = torch.empty((rows, k_out), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(_cuda.library(), "ntp_slot_compact" + _SUFFIX[dt])(
            c.data_ptr(), b.data_ptr(), out_c.data_ptr(), out_b.data_ptr(),
            norms.data_ptr(), place.data_ptr(), source.data_ptr(),
            c.stride(0), b.stride(0), rows, m, k_out, bs, float(threshold),
            stream)
        _cuda.check(code, "slot_compact")
        compactions["slot_compact"] += 1
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
