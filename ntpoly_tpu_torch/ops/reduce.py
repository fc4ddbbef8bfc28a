"""Slot-aligned reductions of block-ELL operands: the dot and the trace.

``slot_dot`` sums A_ij * B_ij over the blocks that A and B hold at the
same (block row, col id); ``slot_trace`` sums the diagonal of each block
row's diagonal block.  Each returns a 0-d tensor, or with
``compensated`` the [2] (hi, lo) two-float pair whose hi + lo resolves
the sum to ~n*eps^2.

On CUDA tensors of a dtype and block size the kernels take
(``spgemm.eligible``: real float32/float64, bs a multiple of 8 up to
128) each wrapper launches ``csrc/reduce.cu``: one pass that reads only
the matched (or diagonal) blocks, and a deterministic combine of the
per-CTA pairs.  The kernel computes the pair whichever result is asked
for, so its plain result is the pair's value hi + lo as a float64 0-d
tensor, for float32 blocks too; its compensated pair need not have the
bits of ``comp_sum``'s tree.  Any other CUDA tensor raises; callers
route complex data and other block sizes to the plain versions
(``parallel/algebra.py``).  On CPU tensors the plain versions run
(``*_plain``: ``core/bell.py``'s ``dot`` and ``trace`` in the blocks'
dtype, and ``comp_sum`` of ``align_mul`` or of the diagonal).

``reductions`` counts kernel launches per wrapper (the counter group
'reductions' of ``utils/trace.py``; a plain version counts nothing).
"""
from __future__ import annotations

import functools

import torch

from ..core import bell
from ..utils import trace
from .spgemm import eligible, slot_rows

Tensor = torch.Tensor

reductions = trace.counter_group("reductions", (
    "slot_dot", "slot_dot_pair", "slot_trace", "slot_trace_pair"))

# CTAs of the first pass per SM, at most: four of 256 threads keep 128 KB
# of loads in flight on each SM (the kernel takes fewer where the rows
# are fewer)
CTAS_PER_SM = 4

_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _max_grid(device: torch.device) -> int:
    """The most CTAs a first pass runs (the rows of its scratch): a few
    an SM."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return CTAS_PER_SM * _sms(index)


def _checked(what: str, cols: Tensor, blocks: Tensor, dt) -> None:
    if blocks.device.type != "cuda":
        raise ValueError(f"no {what} kernel for {blocks.device}")
    if not eligible(dt, blocks.shape[-1]):
        raise TypeError(f"the {what} kernel takes float32/float64 blocks "
                        f"of a size that is a multiple of 8 up to 128; got "
                        f"{dt}, bs {blocks.shape[-1]}")
    if cols.dtype != torch.int32 or cols.device != blocks.device:
        raise TypeError(f"{what}: col ids must be int32 on the blocks' "
                        f"device")
    if tuple(blocks.shape[:-2]) != tuple(cols.shape) \
            or blocks.shape[-1] != blocks.shape[-2]:
        raise ValueError(f"{what}: blocks {tuple(blocks.shape)} do not "
                         f"match col ids {tuple(cols.shape)}")


def _launch(entry: str, key: str, args, ints) -> None:
    """Launch C entry ``entry`` on the current stream with the pointers
    of ``args`` and then ``ints``; raise on a CUDA error, else count one
    launch of ``key``."""
    from . import _cuda
    fn = getattr(_cuda.library(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(*[x.data_ptr() for x in args], *ints, stream)
    _cuda.check(code, key)
    reductions[key] += 1


def _result(dt, device, compensated: bool) -> Tensor:
    """The output: [2] (hi, lo) of ``dt`` with ``compensated``, else
    the 0-d float64 value."""
    if compensated:
        return torch.empty((2,), dtype=dt, device=device)
    return torch.empty((), dtype=torch.float64, device=device)


def slot_dot(a_cols: Tensor, a_blocks: Tensor, b_cols: Tensor,
             b_blocks: Tensor, *, compensated: bool) -> Tensor:
    """sum_ij A_ij * B_ij over the slots A and B share: the dot kernel
    (``csrc/reduce.cu``) on CUDA tensors, its plain version on CPU
    tensors.  A [..., R, KA] and B [..., R, KB] slots of one shape of
    rows; -> 0-d (float64 from the kernel), or [2] (hi, lo) with
    ``compensated``.  Where A and B are one tensor each block is read
    once."""
    if a_blocks.device.type == "cpu":
        return slot_dot_plain(a_cols, a_blocks, b_cols, b_blocks,
                              compensated=compensated)
    dt = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
    _checked("slot_dot", a_cols, a_blocks, dt)
    _checked("slot_dot", b_cols, b_blocks, dt)
    if (a_cols.shape[:-1] != b_cols.shape[:-1]
            or a_blocks.shape[-1] != b_blocks.shape[-1]
            or a_blocks.device != b_blocks.device):
        raise ValueError(f"slot_dot: A {tuple(a_blocks.shape)} and B "
                         f"{tuple(b_blocks.shape)} differ in rows, block "
                         f"size or device")
    ac, ab = slot_rows(a_cols, a_blocks, dt)
    bc, bb = slot_rows(b_cols, b_blocks, dt)
    rows, bs = ac.shape[0], ab.shape[-1]
    dev = ab.device
    if rows == 0:
        return _result(dt, dev, compensated).zero_()
    if ab.data_ptr() % 16 or bb.data_ptr() % 16:
        raise ValueError("slot_dot: blocks must start on 16 bytes")
    grid = _max_grid(dev)
    partial = torch.empty((grid, 2), dtype=dt, device=dev)
    out = _result(dt, dev, compensated)
    _launch("ntp_slot_dot" + _SUFFIX[dt],
            "slot_dot_pair" if compensated else "slot_dot",
            (ac, ab, bc, bb, partial, out),
            (ac.stride(0), ab.stride(0), bc.stride(0), bb.stride(0), rows,
             ac.shape[1], bc.shape[1], bs, grid, int(compensated)))
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
    block row ``row_offset + r``: the trace kernel (``csrc/reduce.cu``)
    on CUDA tensors, reading only each row's diagonal block's diagonal,
    its plain version on CPU tensors; -> 0-d (float64 from the kernel),
    or [2] (hi, lo) with ``compensated``."""
    if blocks.device.type == "cpu":
        return slot_trace_plain(cols, blocks, row_offset,
                                compensated=compensated)
    dt = blocks.dtype
    _checked("slot_trace", cols, blocks, dt)
    period = cols.shape[-2]
    c, b = slot_rows(cols, blocks, dt)
    rows, bs = c.shape[0], b.shape[-1]
    dev = b.device
    if rows == 0:
        return _result(dt, dev, compensated).zero_()
    grid = _max_grid(dev)
    partial = torch.empty((grid, 2), dtype=dt, device=dev)
    out = _result(dt, dev, compensated)
    _launch("ntp_slot_trace" + _SUFFIX[dt],
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
