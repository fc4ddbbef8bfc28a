"""Element-wise matrix maps and sparsity-pattern conversion
(reference Source/Fortran/MatrixMapsModule.F90:39-438 and
MatrixConversionModule.F90:21-63).

Counterpart of ``ntpoly_tpu/utils/maps.py``, three tiers:

  * ``map_matrix`` -- the callback path: a host loop over the triplets
    calling a ``RealOperation``/``ComplexOperation`` (the reference's
    SWIG directors, Source/CPlusPlus/MatrixMapper.h:13-45), 1-based;
  * ``map_values`` -- the device path: a torch callable applied to the
    stored blocks where they lie, masked to the stored entries;
  * ``map_triplets`` -- a vectorized map over host triplet arrays that
    may also move entries, re-filling the matrix afterwards.

``snap_to_sparsity_pattern`` runs on the device as a pattern-aligned
gather.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EMPTY
from ..core import bell
from ..parallel import pmatrix as PM


class Triplet:
    __slots__ = ("index_row", "index_column", "point_value")

    def __init__(self, row=0, col=0, val=0.0):
        self.index_row = row
        self.index_column = col
        self.point_value = val


class RealOperation:
    """Subclass and override __call__(); ``self.data`` holds the current
    Triplet; return False to drop the element (reference
    MatrixMapper.h)."""

    def __init__(self):
        self.data = Triplet()

    def __call__(self) -> bool:
        return True


ComplexOperation = type("ComplexOperation", (RealOperation,), {})


def _refill(mat: PM.PSMatrix, r, c, v) -> PM.PSMatrix:
    out = PM.empty(mat.dim, bs=mat.bs, k=mat.k, dtype=mat.dtype,
                   grid=mat.grid)
    return PM.fill_from_triplets(out, r, c, v)


def map_matrix(mat: PM.PSMatrix, op) -> PM.PSMatrix:
    """Apply ``op`` to every stored element (reference
    MapMatrix_psr/psc), indices 1-based as the reference's."""
    rows, cols, vals = PM.to_triplets(mat)
    out_r, out_c, out_v = [], [], []
    for r, c, v in zip(rows, cols, vals):
        op.data.index_row = int(r) + 1
        op.data.index_column = int(c) + 1
        op.data.point_value = v
        if op():
            out_r.append(op.data.index_row - 1)
            out_c.append(op.data.index_column - 1)
            out_v.append(op.data.point_value)
    np_dtype = torch.empty(0, dtype=mat.dtype).numpy().dtype
    return _refill(mat, np.asarray(out_r, np.int64),
                   np.asarray(out_c, np.int64), np.asarray(out_v, np_dtype))


def map_values(mat: PM.PSMatrix, fn) -> PM.PSMatrix:
    """Element-wise map over the stored entries, on the device.

    ``fn(rows, cols, vals)`` maps tensors of the blocks' shape (rows and
    cols the global 0-based int32 indices of each entry) to new values,
    or to (values, keep mask).  It runs on the block tensor where it
    lies; entries that are not stored, or that ``keep`` drops, become
    zero, and the slot pattern is unchanged.  The counterpart of the
    reference's jitted ``fn``: here any torch callable."""
    P, NB, K, bs, _ = mat.blocks.shape
    i32 = dict(dtype=torch.int32, device=mat.device)
    rr = (torch.arange(NB, **i32)
          + mat.row_offset)[None, :, None, None, None]
    ii = torch.arange(bs, **i32)[None, None, None, :, None]
    jj = torch.arange(bs, **i32)[None, None, None, None, :]
    bj = mat.col_ids[..., None, None]
    valid = bj != EMPTY
    rows = (rr * bs + ii).expand(mat.blocks.shape)
    cols = torch.where(valid, bj, 0) * bs + jj
    stored = valid & (mat.blocks != 0) & (rows < mat.dim) & (cols < mat.dim)
    result = fn(rows, cols, mat.blocks)
    if isinstance(result, tuple):
        vals, keep = result
        stored = stored & keep
    else:
        vals = result
    new_blocks = torch.where(stored, vals.to(mat.dtype), 0)
    return mat.with_data(mat.col_ids, new_blocks)


def map_triplets(mat: PM.PSMatrix, fn) -> PM.PSMatrix:
    """Vectorized map over the host triplet arrays: fn(rows, cols, vals)
    -> (rows, cols, vals) or (rows, cols, vals, keep_mask), numpy
    arrays.  Use this form when the map moves entries; use
    :func:`map_values` when it only changes values (on the device)."""
    rows, cols, vals = PM.to_triplets(mat)
    result = fn(rows, cols, vals)
    if len(result) == 4:
        r, c, v, keep = result
        r, c, v = r[keep], c[keep], v[keep]
    else:
        r, c, v = result
    return _refill(mat, r, c, v)


def snap_to_sparsity_pattern(mat: PM.PSMatrix,
                             pattern: PM.PSMatrix) -> PM.PSMatrix:
    """``mat`` forced onto ``pattern``'s sparsity (reference
    SnapMatrixToSparsityPattern): mat's blocks gathered onto the
    pattern's slots, kept where the pattern itself has an entry."""
    aligned = bell.align(pattern.col_ids, mat.col_ids, mat.blocks)
    aligned = torch.where(pattern.blocks != 0, aligned, 0)
    return pattern.with_data(pattern.col_ids, aligned).astype(mat.dtype)
