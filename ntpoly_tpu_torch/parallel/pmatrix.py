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
from .grid import ProcessGrid, global_grid


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


def empty(dim: int, *, bs: int, grid: ProcessGrid | None = None,
          k: int | None = None, dtype=None) -> PSMatrix:
    """An all-zero matrix at capacity ``k`` (default 1, at most the
    panel's block columns) on ``grid`` (the global grid unless given);
    fills grow it to what the data needs.  A complex dtype is storage
    only: the kernels are real, and complex data is multiplied as its
    2 x 2 real embedding (``core/cplx.py``)."""
    grid = grid or global_grid()
    dtype = as_torch_dtype(dtype or default_real_dtype())
    nb, pnb = geometry(dim, bs, grid)
    k = min(k or 1, pnb)
    col_ids = torch.full((grid.cols, nb, k), EMPTY, dtype=torch.int32,
                         device=grid.device)
    blocks = torch.zeros((grid.cols, nb, k, bs, bs), dtype=dtype,
                         device=grid.device)
    return PSMatrix(col_ids, blocks, dim, bs, grid)


def _eye_fn(i, j):
    return torch.where(i == j, 1.0, 0.0)


def identity(dim: int, *, bs: int, grid: ProcessGrid | None = None,
             dtype=None, k: int | None = None) -> PSMatrix:
    """Ones on the actual (unpadded) diagonal, built as a band of width
    0, EMPTY-padded to capacity ``k`` when that is given.  It carries
    the ``_known_identity`` tag, which the solvers read instead of
    checking the values (any derived matrix is untagged)."""
    out = fill_banded(empty(dim, bs=bs, dtype=dtype, grid=grid), 0,
                      _eye_fn)
    if k and k > out.k:
        cc, cb = bell.pad_slots(out.col_ids, out.blocks,
                                min(k, out.panel_nb))
        out = out.with_data(cc, cb)
    object.__setattr__(out, "_known_identity", True)
    return out


def _as_device(x, device, dtype=None) -> torch.Tensor:
    """A numpy array or a tensor on ``device`` (as ``dtype``)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def fill_from_triplets(m: PSMatrix, rows, cols, vals) -> PSMatrix:
    """Build the block-ELL arrays from global (i, j, v) triplets (numpy
    arrays or tensors) on the grid's device.  Each value is rounded to
    the matrix dtype, then duplicate coordinates are summed in the
    order given; slots are packed in ascending col order, at the
    larger of ``m.k`` and the fullest row's need.  Coordinates may
    address the padded region."""
    dev = m.grid.device
    r = _as_device(rows, dev, torch.int64)
    c = _as_device(cols, dev, torch.int64)
    if not isinstance(vals, torch.Tensor):
        vals = np.asarray(vals)
        np_dtype = torch.empty(0, dtype=m.dtype).numpy().dtype
        vals = vals.astype(np_dtype, copy=False)
    v = _as_device(vals, dev, m.dtype)
    if r.numel() and max(int(r.max()), int(c.max())) >= m.logical_dim:
        raise ValueError("triplet coordinates beyond matrix dimension")
    col_ids, blocks = bell.from_triplets(r, c, v, nbr=m.nb, nbc=m.nb,
                                         bs=m.bs, k=m.k, panels=m.panels)
    return m.with_data(col_ids, blocks)


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


def banded(dim: int, halfwidth: int, fn, *, bs: int,
           grid: ProcessGrid | None = None, dtype=None,
           threshold: float = 0.0) -> PSMatrix:
    """Convenience wrapper: empty + :func:`fill_banded`."""
    return fill_banded(empty(dim, bs=bs, dtype=dtype, grid=grid),
                       halfwidth, fn, threshold=threshold)


def from_dense(dense, *, bs: int, grid: ProcessGrid | None = None,
               k: int | None = None, dtype=None,
               threshold: float = 0.0) -> PSMatrix:
    """Dense (numpy array or tensor) -> PSMatrix, blocked on the grid's
    device: the entries with |x| > threshold, nonzero blocks packed in
    ascending col order, at capacity the larger of ``k`` and the
    fullest row."""
    grid = grid or global_grid()
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


def from_tall_dense(x: torch.Tensor, dim: int, jb0: int, *, bs: int,
                    grid: ProcessGrid) -> PSMatrix:
    """A dim x dim PSMatrix whose block columns [jb0, jb0 + wb) hold the
    dense column block ``x`` [logical_dim, wb * bs] and nothing else:
    the panel container of the blocked Cholesky, built on ``x``'s
    device.  Only blocks with a nonzero are kept, in ascending column
    order from slot 0; the other slots are EMPTY."""
    nb, pnb = geometry(dim, bs, grid)
    wb = x.shape[-1] // bs
    if x.shape[-2] != nb * bs or x.shape[-1] % bs:
        raise ValueError(f"tall block {tuple(x.shape)} is not "
                         f"[{nb * bs}, wb * {bs}]")
    blocks = x.reshape(nb, bs, wb, bs).transpose(1, 2)   # [nb, wb, bs, bs]
    cols = jb0 + torch.arange(wb, dtype=torch.int32, device=x.device)
    nz = blocks.abs().sum(dim=(-1, -2)) > 0              # [nb, wb]
    pidx = torch.arange(grid.cols, dtype=torch.int32,
                        device=x.device)[:, None, None]
    keep = ((cols[None, None, :] // pnb) == pidx) & nz[None]
    col_ids = torch.where(keep, cols[None, None, :], EMPTY).to(torch.int32)
    out_blocks = torch.where(keep[..., None, None], blocks[None], 0)
    return PSMatrix(col_ids, out_blocks, dim, bs, grid)


def to_dense(m: PSMatrix) -> torch.Tensor:
    """PSMatrix -> dense [dim, dim] tensor (test/IO utility)."""
    d = bell.to_dense(m.col_ids[0], m.blocks[0], nbc=m.nb)
    return d[:m.dim, :m.dim]


def to_triplets(m: PSMatrix):
    """PSMatrix -> (rows, cols, vals) numpy triplets of the stored
    nonzeros inside ``dim``, in the order of the stored entries (panel,
    block row, slot, row and column inside the block), as the
    reference's.  The entries are found on the matrix's device; only
    the triplets cross to the host."""
    rows, cols, vals = bell.to_triplets(m.col_ids, m.blocks, m.dim, m.dim)
    return rows.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy()


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


# ----------------------------------------------------------------------------
# crop, shift and re-block on the device
# ----------------------------------------------------------------------------

def _flat_block_coo(m: PSMatrix):
    """Every slot as block-COO [Pc * NB * K]: (rows, cols, blocks,
    valid)."""
    pc, nbr, k = m.col_ids.shape
    rows = torch.arange(nbr, dtype=torch.int32, device=m.device)
    rows = rows[None, :, None].expand(pc, nbr, k)
    return (rows.reshape(-1), m.col_ids.reshape(-1),
            m.blocks.reshape(-1, m.bs, m.bs),
            (m.col_ids != EMPTY).reshape(-1))


def _crop(rows, cols, blocks, valid, *, rlim: int, clim: int, bs: int,
          nb2: int, row_off: int, col_off: int):
    """Shift block-COO by whole blocks into nb2 block rows and columns,
    zeroing the elements at or beyond the row and column limits ->
    (rows, cols EMPTY where dropped, blocks, keep)."""
    rows = rows - row_off
    cols = torch.where(valid, cols - col_off, cols)
    keep = valid & (rows >= 0) & (cols >= 0) & (rows < nb2) & (cols < nb2)
    ar = torch.arange(bs, device=rows.device)
    r_el = rows[:, None] * bs + ar[None, :]                 # [N, bs]
    c_el = cols[:, None] * bs + ar[None, :]
    blocks = (blocks * (r_el < rlim)[:, :, None].to(blocks.dtype)
              * (c_el < clim)[:, None, :].to(blocks.dtype))
    return rows, torch.where(keep, cols, EMPTY), blocks, keep


def _shift_coo(rows, cols, blocks, valid, *, ro: int, co: int, bs: int):
    """Block-COO for an element offset (ro, co) inside a block: each
    block gives up to four candidate output blocks, static sub-block
    shifts of it (pads of slices, no per-element scatter).  Candidates
    that land on the same (row, col) are summed by the caller's
    merge."""
    pad = torch.nn.functional.pad
    out_r, out_c, out_b, out_v = [], [], [], []
    for dr in ((0, 1) if ro else (0,)):
        for dc in ((0, 1) if co else (0,)):
            b = blocks
            if ro:
                b = (pad(b[:, ro:, :], (0, 0, 0, ro)) if dr == 0
                     else pad(b[:, :ro, :], (0, 0, bs - ro, 0)))
            if co:
                b = (pad(b[:, :, co:], (0, co)) if dc == 0
                     else pad(b[:, :, :co], (bs - co, 0)))
            out_r.append(rows - dr)
            out_c.append(torch.where(valid, cols - dc, cols))
            out_b.append(b)
            out_v.append(valid)
    return (torch.cat(out_r), torch.cat(out_c), torch.cat(out_b),
            torch.cat(out_v))


def _rebuild_device(m: PSMatrix, new_dim: int, row_off: int = 0,
                    col_off: int = 0, rlim: int | None = None,
                    clim: int | None = None, ro: int = 0,
                    co: int = 0) -> PSMatrix:
    """Crop, shift and re-block on the device, without host triplets:
    ``row_off``/``col_off`` shift by whole blocks, ``ro``/``co`` by
    elements inside a block (the candidates of :func:`_shift_coo`,
    merged after the rebuild)."""
    grid = m.grid
    nb2, pnb2 = geometry(new_dim, m.bs, grid)
    rlim = new_dim if rlim is None else rlim
    clim = new_dim if clim is None else clim
    rows, cols, blocks, valid = _flat_block_coo(m)
    if ro or co:
        rows, cols, blocks, valid = _shift_coo(rows, cols, blocks, valid,
                                               ro=ro, co=co, bs=m.bs)
    rows, cols, blocks, keep = _crop(rows, cols, blocks, valid, rlim=rlim,
                                     clim=clim, bs=m.bs, nb2=nb2,
                                     row_off=row_off, col_off=col_off)
    # the build's capacity is the exact fill of the fullest (panel, row)
    # (from_block_coo drops what overflows).  The unaligned expansion
    # lands up to four candidates per output block, all counted, so its
    # capacity may pass panel_nb; the merge brings it back under
    fill = torch.zeros((grid.cols, nb2), dtype=torch.int32,
                       device=rows.device)
    fill.index_put_((torch.where(keep, cols // pnb2, 0).long(),
                     torch.where(keep, rows, 0).long()),
                    keep.to(torch.int32), accumulate=True)
    k2 = min(max(int(fill.amax()), 1), pnb2 * (4 if (ro or co) else 1))
    oc, ob = bell.from_block_coo(rows, cols, blocks, keep, nbr=nb2, k=k2,
                                 panels=grid.cols, panel_nbc=pnb2)
    if ro or co:
        oc, ob = bell.merge(oc, ob, min(k2, pnb2), 0.0)
    return PSMatrix(oc, ob, new_dim, m.bs, grid)


def resize(m: PSMatrix, new_dim: int) -> PSMatrix:
    """Crop or zero-pad to ``new_dim``, on the device."""
    return _rebuild_device(m, new_dim)


def get_slice(m: PSMatrix, start_row: int, end_row: int, start_col: int,
              end_col: int) -> PSMatrix:
    """Rows [start_row, end_row) and columns [start_col, end_col) as a
    new square PSMatrix of the larger extent, on the device for every
    offset (an unaligned start goes through the shifted candidates of
    :func:`_shift_coo`)."""
    new_dim = max(end_row - start_row, end_col - start_col)
    return _rebuild_device(m, new_dim,
                           row_off=start_row // m.bs,
                           col_off=start_col // m.bs,
                           rlim=end_row - start_row,
                           clim=end_col - start_col,
                           ro=start_row % m.bs, co=start_col % m.bs)
