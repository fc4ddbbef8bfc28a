"""Local (one-device, possibly rectangular) sparse matrix.

Counterpart of ``ntpoly_tpu/core/lmatrix.py``: NTPoly's on-node CSR
layer (reference Source/Fortran/SMatrixModule.F90:15-31 and
SMatrixAlgebraModule.F90) as users see it through Matrix_lsr/Matrix_lsc
(reference Source/CPlusPlus/SMatrix.h).  A local matrix is a one-panel
block-ELL container on an explicit device (the CUDA card unless
named), bs 4 by default, on the slot algebra of ``core/bell.py``; its
products run the dense-accumulator tier (``bell.spgemm``) as the
reference's do.  Triplets and extracted rows and columns are read
from the stored blocks, never from a dense copy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EMPTY, as_torch_dtype, default_real_dtype
from . import bell


def _round_up(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


class LocalMatrix:
    """rows x cols block-ELL matrix on ``device``."""

    def __init__(self, rows: int, cols: int, bs: int = 4, dtype=None,
                 device="cuda"):
        self.rows, self.cols, self.bs = rows, cols, bs
        self.dtype = as_torch_dtype(dtype or default_real_dtype())
        self.device = torch.device(device)
        self.nbr = _round_up(rows, bs) // bs
        self.nbc = _round_up(cols, bs) // bs
        self.col_ids = torch.full((self.nbr, self.nbc), EMPTY,
                                  dtype=torch.int32, device=self.device)
        self.blocks = torch.zeros((self.nbr, self.nbc, bs, bs),
                                  dtype=self.dtype, device=self.device)

    # -- construction ----------------------------------------------------
    @classmethod
    def from_triplets(cls, rows_idx, cols_idx, vals, rows, cols, bs=4,
                      dtype=None, device="cuda"):
        """Triplets -> block-ELL without a dense matrix; duplicates are
        summed (reference ConstructMatrixFromTripletList)."""
        vals = np.asarray(vals)
        out = cls(rows, cols, bs=bs, dtype=dtype or vals.dtype,
                  device=device)
        dev = out.device
        ri = torch.from_numpy(np.asarray(rows_idx, np.int64)).to(dev)
        ci = torch.from_numpy(np.asarray(cols_idx, np.int64)).to(dev)
        np_dtype = torch.empty(0, dtype=out.dtype).numpy().dtype
        v = torch.from_numpy(np.ascontiguousarray(
            vals.astype(np_dtype))).to(dev)
        cc, cb = bell.from_triplets(ri, ci, v, nbr=out.nbr, nbc=out.nbc,
                                    bs=bs)
        out.col_ids, out.blocks = cc[0], cb[0]
        return out

    @classmethod
    def from_dense(cls, dense, bs: int = 4, device="cuda"):
        dense = torch.as_tensor(np.asarray(dense)).to(device)
        out = cls(dense.shape[0], dense.shape[1], bs=bs, dtype=dense.dtype,
                  device=device)
        padded = dense.new_zeros((out.nbr * bs, out.nbc * bs))
        padded[:dense.shape[0], :dense.shape[1]] = dense
        out.col_ids, out.blocks = bell.from_dense(padded, bs=bs, k=out.nbc)
        return out

    def to_dense(self) -> np.ndarray:
        d = bell.to_dense(self.col_ids, self.blocks, nbc=self.nbc)
        return d[:self.rows, :self.cols].cpu().numpy()

    def to_triplets(self):
        """(rows, cols, vals) numpy arrays of the stored nonzeros, in
        row-major order (the order of the reference's dense scan)."""
        r, c, v = bell.to_triplets(self.col_ids, self.blocks, self.rows,
                                   self.cols)
        order = torch.argsort(r * (self.nbc * self.bs) + c)
        return (r[order].cpu().numpy(), c[order].cpu().numpy(),
                v[order].cpu().numpy())

    def _like(self, rows=None, cols=None, dtype=None):
        return LocalMatrix(rows or self.rows, cols or self.cols,
                           bs=self.bs, dtype=dtype or self.dtype,
                           device=self.device)

    # -- algebra ---------------------------------------------------------
    def scale(self, c):
        self.blocks = self.blocks * torch.as_tensor(c, dtype=self.dtype)

    def increment(self, other: "LocalMatrix", alpha=1.0, threshold=0.0):
        self.col_ids, self.blocks = bell.add(
            self.col_ids, self.blocks, other.col_ids, other.blocks,
            alpha=1.0, beta=alpha, threshold=threshold, k_out=self.nbc)
        self.dtype = self.blocks.dtype

    def dot(self, other: "LocalMatrix"):
        """sum(conj(self) * other) (reference DotMatrix_lsc,
        SMatrixAlgebraModule.F90:196-215)."""
        return bell.dot(self.col_ids, self.blocks, other.col_ids,
                        other.blocks)

    def pairwise(self, a: "LocalMatrix", b: "LocalMatrix"):
        prod = bell.align_mul(a.col_ids, a.blocks, b.col_ids, b.blocks)
        self.col_ids, self.blocks = bell.compact(a.col_ids, prod, self.nbc)
        self.dtype = self.blocks.dtype

    def transpose(self, a: "LocalMatrix"):
        r, c, blks, v = bell.to_block_coo(a.col_ids, a.blocks)
        oc, ob = bell.from_block_coo(
            c, r, bell.transpose_blocks(blks), v, nbr=a.nbc, k=a.nbr)
        self.col_ids, self.blocks = oc[0], ob[0]
        self.rows, self.cols = a.cols, a.rows
        self.nbr, self.nbc = a.nbc, a.nbr
        self.dtype = a.dtype

    def conjugate(self):
        self.blocks = torch.conj_physical(self.blocks)

    def gemm(self, a: "LocalMatrix", b: "LocalMatrix", a_transposed=False,
             b_transposed=False, alpha=1.0, beta=0.0, threshold=0.0):
        """this = alpha * op(A) op(B) + beta * this (reference local
        MatrixMultiply, SMatrixAlgebraModule.F90:221-289)."""
        if a_transposed:
            at = a._like(a.cols, a.rows)
            at.transpose(a)
            a = at
        if b_transposed:
            bt = b._like(b.cols, b.rows)
            bt.transpose(b)
            b = bt
        cc, cb = bell.spgemm(
            a.col_ids, a.blocks, b.col_ids, b.blocks, col_offset=0,
            nbc_out=b.nbc, k_out=b.nbc, threshold=threshold, alpha=alpha)
        if beta != 0.0:
            cc, cb = bell.add(cc, cb, self.col_ids, self.blocks,
                              alpha=1.0, beta=beta, threshold=threshold,
                              k_out=b.nbc)
        self.col_ids, self.blocks = cc, cb
        self.rows, self.cols = a.rows, b.cols
        self.nbr, self.nbc = a.nbr, b.nbc
        self.dtype = cb.dtype

    def diagonal_scale(self, dvals):
        d = torch.as_tensor(np.asarray(dvals)).to(self.device)
        d = torch.nn.functional.pad(d, (0, self.nbc * self.bs - d.shape[0]))
        dt = torch.promote_types(self.blocks.dtype, d.dtype)
        self.blocks = bell.diagonal_scale(
            self.col_ids, self.blocks.to(dt),
            dvec_cols=d.to(dt).reshape(self.nbc, self.bs))
        self.dtype = self.blocks.dtype

    def _extract(self, r, c, v, rows, cols):
        return LocalMatrix.from_triplets(r, c, v, rows, cols, bs=self.bs,
                                         dtype=self.dtype,
                                         device=self.device)

    def extract_row(self, row: int) -> "LocalMatrix":
        """Row ``row`` as a 1 x cols matrix, read from its block row."""
        rb, ri = divmod(row, self.bs)
        vals = self.blocks[rb, :, ri, :]                      # [K, bs]
        kk, jj = torch.nonzero(vals != 0, as_tuple=True)
        c = self.col_ids[rb, kk].long() * self.bs + jj
        keep = c < self.cols
        return self._extract(np.zeros(int(keep.sum()), np.int64),
                             c[keep].cpu().numpy(),
                             vals[kk, jj][keep].cpu().numpy(), 1, self.cols)

    def extract_column(self, col: int) -> "LocalMatrix":
        """Column ``col`` as a rows x 1 matrix, read from the slots that
        hold its block column."""
        cb, cj = divmod(col, self.bs)
        hit = self.col_ids == cb                              # [NBR, K]
        vals = (self.blocks[..., cj] * hit[..., None]).sum(dim=1)
        rr, ii = torch.nonzero(vals != 0, as_tuple=True)
        r = rr * self.bs + ii
        keep = r < self.rows
        return self._extract(r[keep].cpu().numpy(),
                             np.zeros(int(keep.sum()), np.int64),
                             vals[rr, ii][keep].cpu().numpy(), self.rows, 1)
