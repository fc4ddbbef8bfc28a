"""PSMatrix -- the block-sparse matrix, one tile per rank.

Counterpart of ``ntpoly_tpu/parallel/pmatrix.py``, with the reference's
storage exactly.  The reference's global arrays

    col_ids : int32[Pc, NB, K]         global block-col ids (EMPTY = unused)
    blocks  : dtype[Pc, NB, K, bs, bs]

are cut as its ``matrix_sharding`` cuts them: the rank at (r, c, s) of
the grid holds panel c's block rows [r NB/rows, (r + 1) NB/rows), as
``col_ids[1, NB/rows, K]`` and ``blocks[1, NB/rows, K, bs, bs]``, and
the slices hold replicas.  K is the same on every rank.  On the
1 x 1 x 1 grid the tile is the whole matrix.

The logical dimension is padded up to whole blocks and to a multiple of
lcm(rows, cols) blocks; padded rows and columns are kept identically
zero.  Matrices are immutable: every operation returns a new PSMatrix.
Functions that exchange data between ranks (fills, gathers, rebuilds)
are collective: every rank of the grid calls them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..config import EMPTY, as_torch_dtype, default_real_dtype
from ..core import bell
from . import dist
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
        return self.col_ids.shape[1] * self.grid.rows

    @property
    def nbr(self) -> int:                 # block rows of this rank's tile
        return self.col_ids.shape[1]

    @property
    def k(self) -> int:
        return self.col_ids.shape[2]

    @property
    def panels(self) -> int:
        return self.grid.cols

    @property
    def panel_nb(self) -> int:
        return self.nb // self.panels

    @property
    def row_offset(self) -> int:          # the tile's first global block row
        return self.grid.my_row * self.nbr

    @property
    def col_offset(self) -> int:          # the tile's panel's first block col
        return self.grid.my_col * self.panel_nb

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
        """Stored nonzeros over the grid (collective)."""
        n = (self.blocks != 0).sum().reshape(1)
        return int(self.grid.group("plane").sum_ordered(n))


# ----------------------------------------------------------------------------
# geometry / construction
# ----------------------------------------------------------------------------

def geometry(dim: int, bs: int, grid: ProcessGrid):
    """Logical block count and panel size for a dim x dim matrix."""
    nb = _round_up(max(1, -(-dim // bs)), math.lcm(grid.rows, grid.cols))
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
    nbr = nb // grid.rows
    col_ids = torch.full((1, nbr, k), EMPTY, dtype=torch.int32,
                         device=grid.device)
    blocks = torch.zeros((1, nbr, k, bs, bs), dtype=dtype,
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


def _rows_per(m: PSMatrix) -> int:
    return m.nb // m.grid.rows


def _shard_owners(m: PSMatrix) -> np.ndarray:
    """owner[p, rblock, s] -> the world rank holding the slice-s replica
    of the (panel p, row shard) tile (reference ``_shard_owners``; one
    rank per process, so no entry repeats)."""
    g = m.grid
    return np.asarray(g.ranks, np.int64).reshape(
        g.rows, g.cols, g.slices).transpose(1, 0, 2).copy()


def _to_host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def fill_from_triplets(m: PSMatrix, rows, cols, vals,
                       mode: str = "replicated") -> PSMatrix:
    """Build the block-ELL tiles from global (i, j, v) triplets (numpy
    arrays or tensors) on the grid's device.  Each value is rounded to
    the matrix dtype, then duplicate coordinates are summed in the
    order given; slots are packed in ascending col order, at the
    larger of ``m.k`` and the fullest (panel, row)'s need over the
    grid.  Coordinates may address the padded region.

    On a grid of several ranks (collective), ``mode`` says what each
    rank passes: 'replicated', the same full set (each keeps its
    tile's); 'distributed', disjoint subsets (byte-range reads), routed
    to their owners first, every slice replica a copy (reference
    alltoallv fill, FillMatrixFromTripletList.f90:25-46);
    'prepartitioned', exactly its own tile's triplets."""
    grid = m.grid
    dev = grid.device
    if mode == "distributed" and grid.n_devices > 1:
        rows, cols, vals = _to_host(rows), _to_host(cols), _to_host(vals)
        bad = (len(rows) and max(int(rows.max()), int(cols.max()))
               >= m.logical_dim)
        if bad:
            raise ValueError("triplet coordinates beyond matrix dimension")
        owners = _shard_owners(m)
        pi = (cols // m.bs) // m.panel_nb
        ri = (rows // m.bs) // m.nbr
        dest = owners[pi, ri]                             # [n, S]
        n = len(rows)
        rep = np.repeat(np.arange(n), grid.slices)
        rows, cols, vals = dist.exchange_triplets(
            rows[rep], cols[rep], vals[rep], dest.reshape(-1),
            grid.group("all"))
    r = _as_device(rows, dev, torch.int64)
    c = _as_device(cols, dev, torch.int64)
    if not isinstance(vals, torch.Tensor):
        vals = np.asarray(vals)
        np_dtype = torch.empty(0, dtype=m.dtype).numpy().dtype
        vals = vals.astype(np_dtype, copy=False)
    v = _as_device(vals, dev, m.dtype)
    if r.numel() and max(int(r.max()), int(c.max())) >= m.logical_dim:
        raise ValueError("triplet coordinates beyond matrix dimension")
    if grid.n_devices > 1:
        mine = (((r // m.bs) // m.nbr == grid.my_row)
                & ((c // m.bs) // m.panel_nb == grid.my_col))
        r, c, v = r[mine] - m.row_offset * m.bs, c[mine], v[mine]
    col_ids, blocks = bell.from_triplets(r, c, v, nbr=m.nbr, nbc=m.nb,
                                         bs=m.bs, k=m.k, panels=1)
    k = _grid_max(grid, col_ids.shape[-1])
    col_ids, blocks = bell.pad_slots(col_ids, blocks, k)
    return m.with_data(col_ids, blocks)


def _grid_max(grid: ProcessGrid, n: int) -> int:
    """The largest ``n`` over the grid's ranks (a capacity every tile
    must share)."""
    g = grid.group("all")
    if g.size == 1:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=grid.device)
    return int(g.max(t))


def fill_banded(m: PSMatrix, halfwidth: int, fn,
                threshold: float = 0.0) -> PSMatrix:
    """Fill a banded matrix on the device: entry (i, j) = fn(i, j)
    wherever |i - j| <= halfwidth and |fn(i, j)| > threshold, zero
    elsewhere; the band's blocks keep their slots when the threshold
    zeroes them.  ``fn`` is an elementwise function of int32 index
    tensors (broadcast row indices i and column indices j).  Each rank
    fills its own tile."""
    bs, pnb = m.bs, m.panel_nb
    bband = 0 if halfwidth < 1 else (halfwidth - 1) // bs + 1
    k = min(2 * bband + 1, pnb)
    dev = m.grid.device
    i32 = dict(dtype=torch.int32, device=dev)
    p = torch.full((1, 1, 1), m.grid.my_col, **i32)
    r = (torch.arange(m.nbr, **i32) + m.row_offset)[None, :, None]
    s = torch.arange(k, **i32)[None, None, :]
    lo = torch.maximum(r - bband, p * pnb)
    hi = torch.minimum(r + bband, (p + 1) * pnb - 1)
    c = lo + s                                        # [1, NBR, K]
    valid = c <= hi
    col_ids = torch.where(valid, c, EMPTY).to(torch.int32)
    gi = (r[..., None, None] * bs
          + torch.arange(bs, **i32)[:, None])         # [1, NBR, 1, bs, 1]
    gj = (c[..., None, None] * bs
          + torch.arange(bs, **i32)[None, :])         # [1, NBR, K, 1, bs]
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
    """Dense (numpy array or tensor, the whole matrix on every rank) ->
    PSMatrix, each rank blocking its tile on the grid's device: the
    entries with |x| > threshold, nonzero blocks packed in ascending
    col order, at capacity the larger of ``k`` and the fullest (panel,
    row)."""
    grid = grid or global_grid()
    if not isinstance(dense, torch.Tensor):
        dense = torch.from_numpy(np.array(dense))
    m = empty(dense.shape[0], bs=bs, k=k, dtype=dtype or dense.dtype,
              grid=grid)
    n = m.logical_dim
    d = dense.to(grid.device)
    d = torch.where(d.abs() > threshold, d, 0).to(m.dtype)
    d = torch.nn.functional.pad(d, (0, n - d.shape[1], 0, n - d.shape[0]))
    nz = (d != 0).reshape(m.nb, bs, grid.cols, m.panel_nb, bs).any(
        dim=(1, 4))
    k_out = max(m.k, int(nz.sum(dim=-1).amax()))
    r0, c0 = m.row_offset * bs, m.col_offset * bs
    tile = d[r0:r0 + m.nbr * bs, c0:c0 + m.panel_nb * bs]
    cc, cb = bell.from_dense(tile, bs, k_out, col_offset=m.col_offset)
    return m.with_data(cc[None], cb[None])


def from_tall_dense(x: torch.Tensor, dim: int, jb0: int, *, bs: int,
                    grid: ProcessGrid) -> PSMatrix:
    """A dim x dim PSMatrix whose block columns [jb0, jb0 + wb) hold the
    dense column block ``x`` [logical_dim, wb * bs] (the whole block on
    every rank) and nothing else: the panel container of the blocked
    Cholesky, built on ``x``'s device.  Only blocks with a nonzero are
    kept, in ascending column order from slot 0; the other slots are
    EMPTY."""
    nb, pnb = geometry(dim, bs, grid)
    wb = x.shape[-1] // bs
    if x.shape[-2] != nb * bs or x.shape[-1] % bs:
        raise ValueError(f"tall block {tuple(x.shape)} is not "
                         f"[{nb * bs}, wb * {bs}]")
    nbr = nb // grid.rows
    r0 = grid.my_row * nbr
    x = x[r0 * bs:(r0 + nbr) * bs]
    blocks = x.reshape(nbr, bs, wb, bs).transpose(1, 2)  # [nbr, wb, bs, bs]
    cols = jb0 + torch.arange(wb, dtype=torch.int32, device=x.device)
    nz = blocks.abs().sum(dim=(-1, -2)) > 0              # [nbr, wb]
    keep = ((cols[None, None, :] // pnb) == grid.my_col) & nz[None]
    col_ids = torch.where(keep, cols[None, None, :], EMPTY).to(torch.int32)
    out_blocks = torch.where(keep[..., None, None], blocks[None], 0)
    return PSMatrix(col_ids, out_blocks, dim, bs, grid)


def _tiles(m: PSMatrix, x: torch.Tensor) -> list:
    """Every rank's ``x`` over this rank's slice (collective), as a
    [rows][cols] list of lists."""
    parts = m.grid.group("plane").all_gather(x)
    C = m.grid.cols
    return [parts[r * C:(r + 1) * C] for r in range(m.grid.rows)]


def to_dense(m: PSMatrix) -> torch.Tensor:
    """PSMatrix -> dense [dim, dim] tensor, the same on every rank
    (gathered: a test and I/O utility)."""
    d = bell.to_dense(m.col_ids[0], m.blocks[0], nbc=m.panel_nb,
                      col_offset=m.col_offset)
    if m.grid.n_devices > 1:
        d = torch.cat([torch.cat(row, dim=1) for row in _tiles(m, d)])
    return d[:m.dim, :m.dim]


def _tile_triplets(m: PSMatrix):
    """This tile's stored nonzeros inside ``dim`` as tensors (i, j, v),
    global coordinates, in the order of the stored entries."""
    i, j, v = bell.to_triplets(m.col_ids, m.blocks,
                               m.dim - m.row_offset * m.bs, m.dim)
    return i + m.row_offset * m.bs, j, v


def to_triplets(m: PSMatrix, local: bool = False):
    """PSMatrix -> (rows, cols, vals) numpy triplets of the stored
    nonzeros inside ``dim``, in the order of the stored entries (panel,
    block row, slot, row and column inside the block), as the
    reference's.  The entries are found on the matrix's device; only
    the triplets cross to the host.  On several ranks the tiles of
    slice 0 own the entries: ``local=True`` gives this rank's (nothing
    on the other slices), and otherwise every rank gets the union
    (collective)."""
    i, j, v = _tile_triplets(m)
    g = m.grid
    if local and g.my_slice != 0:
        i, j, v = i[:0], j[:0], v[:0]
    if g.n_devices > 1 and not local:
        cplx = v.is_complex()
        vr = torch.view_as_real(v) if cplx else v
        plane = g.group("plane")
        ij = plane.all_gather_v(torch.stack([i, j], dim=-1))
        vs = plane.all_gather_v(vr)
        order = [r * g.cols + c for c in range(g.cols)
                 for r in range(g.rows)]            # panel-major
        ij = torch.cat([ij[p] for p in order])
        v = torch.cat([vs[p] for p in order])
        v = torch.view_as_complex(v.contiguous()) if cplx else v
        i, j = ij[:, 0], ij[:, 1]
    return i.cpu().numpy(), j.cpu().numpy(), v.cpu().numpy()


def from_reference_arrays(col_ids, blocks, dim: int, bs: int,
                          grid: ProcessGrid) -> PSMatrix:
    """A PSMatrix from the reference package's global arrays as numpy
    (``np.asarray(m.col_ids)``, ``np.asarray(m.blocks)``), each rank
    taking its tile, on the grid's device."""
    col_ids = np.asarray(col_ids)
    blocks = np.asarray(blocks)
    if col_ids.ndim != 3 or blocks.shape[:3] != col_ids.shape:
        raise ValueError(f"shapes {col_ids.shape}, {blocks.shape} are not "
                         "[Pc, NB, K] and [Pc, NB, K, bs, bs]")
    nbr = col_ids.shape[1] // grid.rows
    r0, c = grid.my_row * nbr, grid.my_col
    cc = np.array(col_ids[c:c + 1, r0:r0 + nbr], np.int32)   # copies: jax
    cb = np.array(blocks[c:c + 1, r0:r0 + nbr])    # arrays are read-only
    dev = grid.device
    return PSMatrix(torch.from_numpy(cc).to(dev),
                    torch.from_numpy(cb).to(dev), dim, bs, grid)


def to_numpy(m: PSMatrix):
    """(col_ids, blocks) as the reference's global numpy arrays
    [Pc, NB, K] and [Pc, NB, K, bs, bs] (gathered on several ranks)."""
    cc, cb = m.col_ids, m.blocks
    if m.grid.n_devices > 1:
        tc, tb = _tiles(m, cc), _tiles(m, cb)
        cc = torch.cat([torch.cat([tc[r][c] for r in range(m.grid.rows)],
                                  dim=1) for c in range(m.grid.cols)])
        cb = torch.cat([torch.cat([tb[r][c] for r in range(m.grid.rows)],
                                  dim=1) for c in range(m.grid.cols)])
    return cc.cpu().numpy(), cb.cpu().numpy()


def load_balance_stats(m: PSMatrix) -> tuple[int, int]:
    """(min, max) stored nonzeros per (rows, cols) tile (reference
    GetMatrixLoadBalance, PSMatrixModule.F90:1394-1427); collective."""
    n = (m.blocks != 0).sum().reshape(1)
    counts = torch.cat(m.grid.group("plane").all_gather(n))
    return int(counts.min()), int(counts.max())


# ----------------------------------------------------------------------------
# crop, shift and re-block on the device
# ----------------------------------------------------------------------------

def _flat_block_coo(m: PSMatrix):
    """Every slot of the tile as block-COO [NBR * K]: (global rows, cols,
    blocks, valid)."""
    pc, nbr, k = m.col_ids.shape
    rows = torch.arange(nbr, dtype=torch.int32, device=m.device)
    rows = (rows + m.row_offset)[None, :, None].expand(pc, nbr, k)
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


def _route(rows, cols, blocks, keep, src: ProcessGrid, targets,
           nbr2: int, pnb2: int):
    """Send each kept block (global new coordinates) from slice 0 of
    ``src`` to its owner in every slice of every grid of ``targets``
    (grids on ranks of ``src``) -> the blocks this rank receives,
    (rows, cols, blocks), in sender order."""
    if src.n_devices == 1 and targets == (src,):
        return rows[keep], cols[keep], blocks[keep]
    if src.my_slice != 0:
        keep = torch.zeros_like(keep)
    idx = torch.nonzero(keep).reshape(-1)
    rows, cols, blocks = rows[idx], cols[idx], blocks[idx]
    r_sh, p = (rows // nbr2).long(), (cols // pnb2).long()
    dest, items = [], []
    for g in targets:
        at = torch.as_tensor(g.ranks, device=rows.device).reshape(
            g.rows, g.cols, g.slices)
        for s in range(g.slices):
            dest.append(at[r_sh, p, s])
            items.append(torch.arange(rows.numel(), device=rows.device))
    dest, items = torch.cat(dest), torch.cat(items)
    grp = src.group("all")
    pos = torch.full((max(grp.ranks) + 1,), -1, dtype=torch.int64,
                     device=rows.device)
    pos[list(grp.ranks)] = torch.arange(grp.size, device=rows.device)
    pos = pos[dest]
    order = torch.argsort(pos, stable=True)
    items = items[order]
    counts = torch.bincount(pos, minlength=grp.size).tolist()
    ij = grp.all_to_all_v(torch.stack([rows[items], cols[items]], -1).to(
        torch.int64), counts)
    bl = blocks[items]
    cplx = bl.is_complex()
    got = grp.all_to_all_v(torch.view_as_real(bl) if cplx else bl, counts)
    if cplx:
        got = torch.view_as_complex(got.contiguous())
    return ij[:, 0].to(torch.int32), ij[:, 1].to(torch.int32), got


def _rebuild_device(m: PSMatrix, new_dim: int, row_off: int = 0,
                    col_off: int = 0, rlim: int | None = None,
                    clim: int | None = None, ro: int = 0,
                    co: int = 0, targets=None) -> PSMatrix:
    """Crop, shift and re-block on the device, without host triplets:
    ``row_off``/``col_off`` shift by whole blocks, ``ro``/``co`` by
    elements inside a block (the candidates of :func:`_shift_coo`,
    merged after the rebuild).  Each block goes to its owner in the new
    geometry by one all-to-all (reference targeted sends,
    PSMatrixModule.F90:1036-1227), on each grid of ``targets`` (the
    matrix's own by default); this rank's result lies on the target
    grid it is a member of."""
    targets = tuple(targets or (m.grid,))
    grid = next(g for g in targets if g.member)
    nb2, pnb2 = geometry(new_dim, m.bs, grid)
    nbr2 = nb2 // grid.rows
    rlim = new_dim if rlim is None else rlim
    clim = new_dim if clim is None else clim
    rows, cols, blocks, valid = _flat_block_coo(m)
    if ro or co:
        rows, cols, blocks, valid = _shift_coo(rows, cols, blocks, valid,
                                               ro=ro, co=co, bs=m.bs)
    rows, cols, blocks, keep = _crop(rows, cols, blocks, valid, rlim=rlim,
                                     clim=clim, bs=m.bs, nb2=nb2,
                                     row_off=row_off, col_off=col_off)
    rows, cols, blocks = _route(rows, cols, blocks, keep, m.grid, targets,
                                nbr2, pnb2)
    rows = rows - grid.my_row * nbr2
    # the build's capacity is the exact fill of the fullest row over the
    # grid (from_block_coo drops what overflows).  The unaligned
    # expansion lands up to four candidates per output block, all
    # counted, so its capacity may pass panel_nb; the merge brings it
    # back under
    fill = torch.zeros(nbr2 + 1, dtype=torch.int32, device=rows.device)
    fill.index_put_((rows.long(),), torch.ones_like(rows),
                    accumulate=True)
    k2 = min(max(_grid_max(grid, int(fill.amax())), 1),
             pnb2 * (4 if (ro or co) else 1))
    ones = torch.ones_like(rows, dtype=torch.bool)
    oc, ob = bell.from_block_coo(rows, cols, blocks, ones, nbr=nbr2, k=k2)
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


def set_grid(m: PSMatrix, grid: ProcessGrid) -> PSMatrix:
    """Move a matrix onto another grid on the same ranks (reference
    SetMatrixProcessGrid, PSMatrixModule.F90:309-347): each block routed
    to its new owners on the device; collective over the matrix's
    grid."""
    return _rebuild_device(m, m.dim, targets=(grid,))


def comm_split(m: PSMatrix):
    """Split the matrix's grid in half and give each half a copy
    (reference CommSplitMatrix, PSMatrixModule.F90:1489-1545), for
    independent solves on the halves.  -> (the copy on this rank's half,
    color, split_slice): color 0 on the first half, 1 on the second.
    On one rank both halves are the grid itself (color 0)."""
    first, second, split_slice = m.grid.split()
    if first is second:
        return m, 0, split_slice
    out = _rebuild_device(m, m.dim, targets=(first, second))
    return out, (0 if first.member else 1), split_slice
