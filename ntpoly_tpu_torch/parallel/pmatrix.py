"""PSMatrix — the block-sparse matrix on one device.

Counterpart of ``ntpoly_tpu/parallel/pmatrix.py``, with the reference's
storage exactly (one column panel on the 1 x 1 x 1 grid):

    col_ids : int32[Pc=1, NB, K]         global block-col ids (EMPTY = unused)
    blocks  : dtype[Pc=1, NB, K, bs, bs]

The logical dimension is padded up to whole blocks; padded rows and
columns are kept identically zero.  Matrices are immutable: every
operation returns a new PSMatrix.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..config import EMPTY, as_torch_dtype, default_real_dtype
from ..core import bell
from .grid import ProcessGrid


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class PSMatrix:
    col_ids: torch.Tensor                 # i32[Pc, NB, K]
    blocks: torch.Tensor                  # dtype[Pc, NB, K, bs, bs]
    dim: int = 0
    bs: int = 0
    grid: ProcessGrid = None

    # -- geometry --------------------------------------------------------
    @property
    def nb(self) -> int:                  # logical block rows (= block cols)
        return self.col_ids.shape[1]

    @property
    def k(self) -> int:
        return self.col_ids.shape[2]

    @property
    def panels(self) -> int:
        return self.col_ids.shape[0]

    @property
    def panel_nb(self) -> int:
        return self.nb // self.panels

    @property
    def logical_dim(self) -> int:
        return self.nb * self.bs

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    # -- convenience -----------------------------------------------------
    def with_data(self, col_ids, blocks) -> "PSMatrix":
        return replace(self, col_ids=col_ids, blocks=blocks)

    def astype(self, dtype) -> "PSMatrix":
        return self.with_data(self.col_ids,
                              self.blocks.to(as_torch_dtype(dtype)))

    def conjugate(self) -> "PSMatrix":
        return self.with_data(self.col_ids,
                              torch.conj_physical(self.blocks))

    @property
    def nnz(self) -> int:
        return int((self.blocks != 0).sum())


# ----------------------------------------------------------------------------
# geometry / construction
# ----------------------------------------------------------------------------

def geometry(dim: int, bs: int, grid: ProcessGrid):
    """Logical block count and panel size for a dim x dim matrix."""
    nb = _round_up(max(1, -(-dim // bs)), grid.rows * grid.cols)
    return nb, nb // grid.cols


def empty(dim: int, *, bs: int, grid: ProcessGrid, k: int | None = None,
          dtype=None) -> PSMatrix:
    """An all-zero matrix at capacity ``k`` (default 1, at most the
    panel's block columns); fills grow it to what the data needs."""
    dtype = as_torch_dtype(dtype or default_real_dtype())
    if dtype.is_complex:
        raise TypeError("complex matrices are not ported yet (ROADMAP "
                        "Queue A item 9)")
    nb, pnb = geometry(dim, bs, grid)
    k = min(k or 1, pnb)
    col_ids = torch.full((grid.cols, nb, k), EMPTY, dtype=torch.int32,
                         device=grid.device)
    blocks = torch.zeros((grid.cols, nb, k, bs, bs), dtype=dtype,
                         device=grid.device)
    return PSMatrix(col_ids, blocks, dim, bs, grid)


def _eye_fn(i, j):
    return torch.where(i == j, 1.0, 0.0)


def identity(dim: int, *, bs: int, grid: ProcessGrid, dtype=None
             ) -> PSMatrix:
    """Ones on the actual (unpadded) diagonal, built as a band of width
    0.  It carries the ``_known_identity`` tag, which the solvers read
    instead of checking the values (any derived matrix is untagged)."""
    out = fill_banded(empty(dim, bs=bs, dtype=dtype, grid=grid), 0,
                      _eye_fn)
    object.__setattr__(out, "_known_identity", True)
    return out


def fill_from_triplets(m: PSMatrix, rows, cols, vals) -> PSMatrix:
    """Build the block-ELL arrays from global (i, j, v) triplets on the
    host (numpy), then move them to the grid's device.  Duplicate
    coordinates are summed; slots are packed in ascending col order."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if ((rows.size and rows.max(initial=0) >= m.logical_dim)
            or (cols.size and cols.max(initial=0) >= m.logical_dim)):
        raise ValueError("triplet coordinates beyond matrix dimension")
    bs, nb, pnb = m.bs, m.nb, m.panel_nb
    np_dtype = torch.empty(0, dtype=m.dtype).numpy().dtype
    bi, bj = rows // bs, cols // bs
    bid = bi * nb + bj
    ub, inv = np.unique(bid, return_inverse=True)
    nub = len(ub)
    blocks = np.zeros((nub, bs, bs), np_dtype)
    np.add.at(blocks, (inv, rows % bs, cols % bs), vals.astype(np_dtype))
    ubi, ubj = ub // nb, ub % nb
    p = ubj // pnb
    order = np.lexsort((ubj, ubi, p))
    sp, sr, sc = p[order], ubi[order], ubj[order]
    sb = blocks[order]
    grp = sp * nb + sr
    first = np.ones(nub, bool)
    first[1:] = grp[1:] != grp[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(nub), 0))
    slot = np.arange(nub) - start
    k_needed = int(slot.max()) + 1 if nub else 1
    k = max(m.k, k_needed)
    col_ids = np.full((m.panels, nb, k), EMPTY, np.int32)
    col_ids[sp, sr, slot] = sc
    out_blocks = np.zeros((m.panels, nb, k, bs, bs), np_dtype)
    out_blocks[sp, sr, slot] = sb
    dev = m.grid.device
    return m.with_data(torch.from_numpy(col_ids).to(dev),
                       torch.from_numpy(out_blocks).to(dev))


def fill_banded(m: PSMatrix, halfwidth: int, fn,
                threshold: float = 0.0) -> PSMatrix:
    """Fill a banded matrix on the device: entry (i, j) = fn(i, j)
    wherever |i - j| <= halfwidth and |fn(i, j)| > threshold, zero
    elsewhere; the band's blocks keep their slots when the threshold
    zeroes them.  ``fn`` is an elementwise function of int32 index
    tensors (broadcast row indices i and column indices j)."""
    bs, nb, pnb = m.bs, m.nb, m.panel_nb
    bband = 0 if halfwidth < 1 else (halfwidth - 1) // bs + 1
    k = min(2 * bband + 1, pnb)
    dev = m.grid.device
    i32 = dict(dtype=torch.int32, device=dev)
    p = torch.arange(m.panels, **i32)[:, None, None]
    r = torch.arange(nb, **i32)[None, :, None]
    s = torch.arange(k, **i32)[None, None, :]
    lo = torch.maximum(r - bband, p * pnb)
    hi = torch.minimum(r + bband, (p + 1) * pnb - 1)
    c = lo + s                                        # [Pc, NB, K]
    valid = c <= hi
    col_ids = torch.where(valid, c, EMPTY).to(torch.int32)
    gi = (r[..., None, None] * bs
          + torch.arange(bs, **i32)[:, None])         # [1, NB, 1, bs, 1]
    gj = (c[..., None, None] * bs
          + torch.arange(bs, **i32)[None, :])         # [Pc, NB, K, 1, bs]
    vals = fn(gi, gj)
    if threshold > 0.0:
        vals = torch.where(vals.abs() > threshold, vals, 0)
    mask = (((gi - gj).abs() <= halfwidth) & (gi < m.dim) & (gj < m.dim)
            & valid[..., None, None])
    blocks = torch.where(mask, vals.to(m.dtype), 0)
    return m.with_data(col_ids, blocks)


def banded(dim: int, halfwidth: int, fn, *, bs: int, grid: ProcessGrid,
           dtype=None, threshold: float = 0.0) -> PSMatrix:
    """Convenience wrapper: empty + :func:`fill_banded`."""
    return fill_banded(empty(dim, bs=bs, dtype=dtype, grid=grid),
                       halfwidth, fn, threshold=threshold)


def from_dense(dense, *, bs: int, grid: ProcessGrid, k: int | None = None,
               dtype=None, threshold: float = 0.0) -> PSMatrix:
    """Dense (numpy array or tensor) -> PSMatrix, blocked on the grid's
    device: the entries with |x| > threshold, nonzero blocks packed in
    ascending col order, at capacity the larger of ``k`` and the
    fullest row."""
    if not isinstance(dense, torch.Tensor):
        dense = torch.from_numpy(np.array(dense))
    m = empty(dense.shape[0], bs=bs, k=k, dtype=dtype or dense.dtype,
              grid=grid)
    n = m.logical_dim
    d = dense.to(grid.device)
    d = torch.where(d.abs() > threshold, d, 0).to(m.dtype)
    d = torch.nn.functional.pad(d, (0, n - d.shape[1], 0, n - d.shape[0]))
    nz = (d != 0).reshape(m.nb, bs, m.nb, bs).any(dim=(1, 3))
    k_out = max(m.k, int(nz.sum(dim=1).amax()))
    cc, cb = bell.from_dense(d, bs, k_out)
    return m.with_data(cc[None], cb[None])


def to_dense(m: PSMatrix) -> torch.Tensor:
    """PSMatrix -> dense [dim, dim] tensor (test/IO utility)."""
    d = bell.to_dense(m.col_ids[0], m.blocks[0], nbc=m.nb)
    return d[:m.dim, :m.dim]


def from_reference_arrays(col_ids, blocks, dim: int, bs: int,
                          grid: ProcessGrid) -> PSMatrix:
    """A PSMatrix from the reference package's arrays as numpy
    (``np.asarray(m.col_ids)``, ``np.asarray(m.blocks)``), on the grid's
    device."""
    col_ids = np.array(col_ids, np.int32)      # copies: jax arrays are
    blocks = np.array(blocks)                  # read-only views
    if col_ids.ndim != 3 or blocks.shape[:3] != col_ids.shape:
        raise ValueError(f"shapes {col_ids.shape}, {blocks.shape} are not "
                         "[Pc, NB, K] and [Pc, NB, K, bs, bs]")
    dev = grid.device
    return PSMatrix(torch.from_numpy(col_ids).to(dev),
                    torch.from_numpy(blocks).to(dev), dim, bs, grid)


def to_numpy(m: PSMatrix):
    """(col_ids, blocks) as numpy arrays, the reference's layout."""
    return m.col_ids.cpu().numpy(), m.blocks.cpu().numpy()
