"""Slot-aligned reductions of block-ELL operands: the dot and the trace.

``slot_dot`` sums A_ij * B_ij over the blocks that A and B hold at the
same (block row, col id); ``slot_trace`` sums the diagonal of each block
row's diagonal block.  Each returns a 0-d tensor, or with
``compensated`` the [2] (hi, lo) two-float pair whose hi + lo resolves
the sum to ~n*eps^2.

On CUDA blocks of a dtype and block size the kernels take
(``_cuda.takes``: real float32/float64, bs a multiple of 8 up to 128)
each wrapper launches ``csrc/reduce.cu``: one pass that reads only the
matched (or diagonal) blocks, and a deterministic combine of the
per-CTA pairs.  The kernel computes the pair whichever result is asked
for, so its plain result is the pair's value hi + lo as a float64 0-d
tensor, for float32 blocks too; its compensated pair need not have the
bits of ``comp_sum``'s tree.  Such an input at fault (col ids not
int32, A and B on two devices or of rows or block sizes that do not
match) raises.  Every other input, CPU tensors, complex data and other
block sizes, takes the plain version (``*_plain``: ``core/bell.py``'s
``dot`` and ``trace`` in the blocks' dtype, and ``comp_sum`` of
``align_mul`` or of the diagonal), as ``slot_compact`` routes.

``reductions`` counts kernel launches per wrapper (the counter group
'reductions' of ``utils/trace.py``; a plain version counts nothing).
"""
from __future__ import annotations

import functools

import torch

from ..core import bell
from ..utils import trace
from . import _cuda

Tensor = torch.Tensor

reductions = trace.counter_group("reductions", (
    "slot_dot", "slot_dot_pair", "slot_trace", "slot_trace_pair"))

# CTAs of the first pass per SM, at most: four of 256 threads keep 128 KB
# of loads in flight on each SM (the kernel takes fewer where the rows
# are fewer)
CTAS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _max_grid(device: torch.device) -> int:
    """The most CTAs a first pass runs (the rows of its scratch): a few
    an SM."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return CTAS_PER_SM * _sms(index)


def _result(dt, device, compensated: bool) -> Tensor:
    """The output: [2] (hi, lo) of ``dt`` with ``compensated``, else
    the 0-d float64 value."""
    if compensated:
        return torch.empty((2,), dtype=dt, device=device)
    return torch.empty((), dtype=torch.float64, device=device)


def slot_dot(a_cols: Tensor, a_blocks: Tensor, b_cols: Tensor,
             b_blocks: Tensor, *, compensated: bool) -> Tensor:
    """sum_ij A_ij * B_ij over the slots A and B share: the dot kernel
    (``csrc/reduce.cu``) where ``_cuda.takes``, else its plain version.
    A [..., R, KA] and B [..., R, KB] slots of one shape of rows; -> 0-d
    (float64 from the kernel), or [2] (hi, lo) with ``compensated``.
    Where A and B are one tensor each block is read once."""
    dt = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
    if not _cuda.takes(dt, a_blocks):
        return slot_dot_plain(a_cols, a_blocks, b_cols, b_blocks,
                              compensated=compensated)
    ac, ab, bc, bb = _cuda.slot_operands(dt, (a_cols, a_blocks),
                                         (b_cols, b_blocks))
    rows, bs = ac.shape[0], ab.shape[-1]
    dev = ab.device
    if rows == 0:
        return _result(dt, dev, compensated).zero_()
    grid = _max_grid(dev)
    partial = torch.empty((grid, 2), dtype=dt, device=dev)
    out = _result(dt, dev, compensated)
    _cuda.launch("ntp_slot_dot" + _cuda.SUFFIX[dt], reductions,
                 "slot_dot_pair" if compensated else "slot_dot",
                 (ac, ab, bc, bb, partial, out),
                 (ac.stride(0), ab.stride(0), bc.stride(0), bb.stride(0),
                  rows, ac.shape[1], bc.shape[1], bs, grid,
                  int(compensated)))
    return out


def slot_dot_plain(a_cols: Tensor, a_blocks: Tensor, b_cols: Tensor,
                   b_blocks: Tensor, *, compensated: bool) -> Tensor:
    """Plain version of :func:`slot_dot`: ``bell.dot`` (A conjugated
    when complex), or ``bell.comp_sum`` of ``bell.align_mul`` with
    ``compensated``; any dtype and block size."""
    if compensated:
        return bell.comp_sum(bell.align_mul(a_cols, a_blocks, b_cols,
                                            b_blocks))
    return bell.dot(a_cols, a_blocks, b_cols, b_blocks)


def slot_trace(cols: Tensor, blocks: Tensor, row_offset: int = 0, *,
               compensated: bool) -> Tensor:
    """The trace of [..., R, K] slots whose local block row r is global
    block row ``row_offset + r``: the trace kernel (``csrc/reduce.cu``),
    reading only each row's diagonal block's diagonal, where
    ``_cuda.takes``, else its plain version; -> 0-d (float64 from the
    kernel), or [2] (hi, lo) with ``compensated``."""
    dt = blocks.dtype
    if not _cuda.takes(dt, blocks):
        return slot_trace_plain(cols, blocks, row_offset,
                                compensated=compensated)
    period = cols.shape[-2]
    c, b = _cuda.slot_operands(dt, (cols, blocks))
    rows, bs = c.shape[0], b.shape[-1]
    dev = b.device
    if rows == 0:
        return _result(dt, dev, compensated).zero_()
    grid = _max_grid(dev)
    partial = torch.empty((grid, 2), dtype=dt, device=dev)
    out = _result(dt, dev, compensated)
    _cuda.launch("ntp_slot_trace" + _cuda.SUFFIX[dt], reductions,
                 "slot_trace_pair" if compensated else "slot_trace",
                 (c, b, partial, out),
                 (c.stride(0), b.stride(0), rows, period, int(row_offset),
                  c.shape[1], bs, grid, int(compensated)))
    return out


def slot_trace_plain(cols: Tensor, blocks: Tensor, row_offset: int = 0, *,
                     compensated: bool) -> Tensor:
    """Plain version of :func:`slot_trace`: ``bell.trace``, or
    ``bell.comp_sum`` of the diagonal blocks' diagonals with
    ``compensated``; any dtype and block size."""
    if compensated:
        d = bell.trace_blocks(cols, blocks, row_offset)
        return bell.comp_sum(torch.diagonal(d, dim1=-2, dim2=-1))
    return bell.trace(cols, blocks, row_offset)
