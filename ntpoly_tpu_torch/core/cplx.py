"""Complex matrices on the real-only kernels: the 2x2 real embedding.

Counterpart of ``ntpoly_tpu/core/cplx.py``.  The SpGEMM kernels are
real, so a complex matrix C = A + iB is multiplied as the real matrix
of twice the dimension

    E(C) = [[A, -B],
            [B,  A]]

E is a ring homomorphism (E(C1 C2) = E(C1) E(C2), E(C1 + C2) = E(C1) +
E(C2), E(alpha C) = alpha E(C) for real alpha), so every solver built
from multiplies and real-coefficient additions satisfies f(E(C)) =
E(f(C)).  A Hermitian C maps to a symmetric E(C) whose spectrum is C's
with every multiplicity doubled.  Each bs x bs complex block becomes
four real blocks, so the block structure and the threshold (per
component) carry over.  Complex PSMatrices exist as storage
(``PM.empty``, ``fill_from_triplets``, ``from_dense``, ``to_dense``,
``to_triplets``); :func:`embed` and :func:`extract` cross between the
two forms through host triplets.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel import pmatrix as PM


def embed_triplets(rows, cols, vals, dim: int):
    """(i, j, a + ib) -> the four triplet groups of the embedding ->
    (rows2, cols2, vals2, 2 * dim), exact zeros dropped."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    re = np.ascontiguousarray(vals.real)
    im = np.ascontiguousarray(vals.imag)
    i2 = np.concatenate([rows, rows, rows + dim, rows + dim])
    j2 = np.concatenate([cols, cols + dim, cols, cols + dim])
    v2 = np.concatenate([re, -im, im, re])
    keep = v2 != 0
    return i2[keep], j2[keep], v2[keep], 2 * dim


def extract_triplets(rows2, cols2, vals2, dim2: int):
    """Inverse of :func:`embed_triplets`: A from the upper-left and B
    from the lower-left block, duplicates summed -> (rows, cols, vals
    complex128, dim), in ascending (row, col) order."""
    rows2 = np.asarray(rows2, np.int64)
    cols2 = np.asarray(cols2, np.int64)
    vals2 = np.asarray(vals2)
    dim = dim2 // 2
    ul = (rows2 < dim) & (cols2 < dim)
    ll = (rows2 >= dim) & (cols2 < dim)
    keys = np.concatenate([rows2[ul] * dim + cols2[ul],
                           (rows2[ll] - dim) * dim + cols2[ll]])
    contrib = np.concatenate([vals2[ul].astype(np.complex128),
                              1j * vals2[ll].astype(np.complex128)])
    if not len(keys):
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.complex128), dim)
    uk, inv = np.unique(keys, return_inverse=True)
    v = np.zeros(len(uk), np.complex128)
    np.add.at(v, inv, contrib)
    return uk // dim, uk % dim, v, dim


def embed(m: PM.PSMatrix, real_dtype=None) -> PM.PSMatrix:
    """Complex PSMatrix -> its real embedding (dimension doubled), on
    the same grid."""
    rows, cols, vals = PM.to_triplets(m)
    i2, j2, v2, dim2 = embed_triplets(rows, cols, vals, m.dim)
    real_dtype = real_dtype or m.dtype.to_real()
    out = PM.empty(dim2, bs=m.bs, dtype=real_dtype, grid=m.grid)
    return PM.fill_from_triplets(out, i2, j2, v2)


def extract(me: PM.PSMatrix, complex_dtype=None) -> PM.PSMatrix:
    """Real embedding -> complex PSMatrix (dimension halved; complex128
    unless ``complex_dtype`` is given)."""
    r2, c2, v2 = PM.to_triplets(me)
    i, j, v, dim = extract_triplets(r2, c2, v2, me.dim)
    out = PM.empty(dim, bs=me.bs, dtype=complex_dtype or torch.complex128,
                   grid=me.grid)
    return PM.fill_from_triplets(out, i, j, v)
