"""Block-ELL slot algebra on one shard (PyTorch).

Counterpart of ``ntpoly_tpu/core/bell.py``, with the same format:

    col_ids : int32[..., R, K]        global block-column ids, ascending,
                                      EMPTY (2**30) marks an unused slot
    blocks  : dtype[..., R, K, bs, bs]

Invariants: non-EMPTY col ids of a row are ascending and unique, and an
EMPTY slot's block is all-zero.  EMPTY slots usually pack last, but the
SpGEMM marks below-threshold slots EMPTY *in place* (holes), so no
consumer may assume a dense prefix.  Col ids stay int32 in storage and
are cast to int64 only to index.

Every function gives the reference's slots and col ids exactly; block
values agree up to the order of floating-point sums.  The one-hot
contractions (``merge``, ``align``) run as batched matrix products in
full precision (TF32 is off, see ``config``), so a block that has one
contribution is copied exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import EMPTY

Tensor = torch.Tensor


# ----------------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------------

def _gather_slots(blocks: Tensor, idx: Tensor) -> Tensor:
    """blocks[..., M, bs, bs] gathered along the slot axis by
    idx[..., k] -> [..., k, bs, bs], one block at a time (no full-size
    index tensor)."""
    lead = idx.shape[:-1]
    m, bs = blocks.shape[-3], blocks.shape[-1]
    flat = blocks.reshape(-1, m, bs, bs)
    rows = torch.arange(flat.shape[0], device=blocks.device)[:, None]
    out = flat[rows, idx.reshape(flat.shape[0], -1).long()]
    return out.reshape(lead + (idx.shape[-1], bs, bs))


def _slot_sum(onehot: Tensor, blocks: Tensor) -> Tensor:
    """einsum('...mk,...mij->...kij') as one batched product."""
    lead = onehot.shape[:-2]
    m, k = onehot.shape[-2:]
    bs = blocks.shape[-1]
    oh = onehot.to(blocks.dtype).reshape(-1, m, k).transpose(1, 2)
    out = torch.bmm(oh, blocks.reshape(-1, m, bs * bs))
    return out.reshape(lead + (k, bs, bs))


def block_norms(blocks: Tensor) -> Tensor:
    """L1 norm of each block: [..., M, bs, bs] -> [..., M]."""
    return blocks.abs().sum(dim=(-1, -2))


def pad_slots(cols: Tensor, blocks: Tensor, k: int
              ) -> Tuple[Tensor, Tensor]:
    """Grow the slot axis to capacity ``k`` (no-op if already >= k)."""
    m = cols.shape[-1]
    if m >= k:
        return cols, blocks
    pc = cols.new_full(cols.shape[:-1] + (k - m,), EMPTY)
    pb = blocks.new_zeros(blocks.shape[:-3] + (k - m,)
                          + blocks.shape[-2:])
    return torch.cat([cols, pc], dim=-1), torch.cat([blocks, pb], dim=-3)


# ----------------------------------------------------------------------------
# compaction / merging — the truncation primitive
# ----------------------------------------------------------------------------

def compact(cols: Tensor, blocks: Tensor, k_out: int, threshold=0.0
            ) -> Tuple[Tensor, Tensor]:
    """Threshold + select blocks, restoring the format invariants.

    Entries with |v| <= threshold are flushed to zero, all-zero blocks
    are dropped, and if more than ``k_out`` blocks survive in a row the
    largest (by block L1 norm) are kept; ties keep the lower slot (a
    stable sort, as the reference's).  Output slots are sorted by col id.
    """
    blocks = torch.where(blocks.abs() > threshold, blocks,
                         blocks.new_zeros(()))
    cols, blocks = pad_slots(cols, blocks, k_out)
    norms = block_norms(blocks)
    occupied = (norms > 0) & (cols != EMPTY)
    inf = norms.new_full((), float("inf"))
    rank_key = torch.where(occupied, -norms, inf)
    # both reorders are composed on the [..., K] metadata first, so the
    # block tensor is gathered once
    order = torch.argsort(rank_key, dim=-1, stable=True)[..., :k_out]
    c = torch.gather(cols, -1, order)
    occ = torch.gather(occupied, -1, order)
    c = torch.where(occ, c, c.new_full((), EMPTY))
    c2, order2 = torch.sort(c, dim=-1, stable=True)
    final = torch.gather(order, -1, order2)
    b = _gather_slots(blocks, final)
    occ2 = torch.gather(occ, -1, order2)
    return c2, b * occ2[..., None, None].to(b.dtype)


def _ranks(cols: Tensor) -> Tuple[Tensor, Tensor]:
    """(first, rank): first[m] marks the first occurrence of a valid id;
    rank[m] is the number of distinct valid ids smaller than cols[m]."""
    m = cols.shape[-1]
    valid = cols != EMPTY
    eq = cols[..., :, None] == cols[..., None, :]
    ar = torch.arange(m, device=cols.device)
    earlier = ar[:, None] > ar[None, :]
    first = valid & ~(eq & earlier).any(dim=-1)
    lt = cols[..., None, :] < cols[..., :, None]
    rank = (first[..., None, :] & lt).sum(dim=-1)
    return first, rank


def merge(cols: Tensor, blocks: Tensor, k_out: int, threshold=0.0
          ) -> Tuple[Tensor, Tensor]:
    """Sum blocks sharing a col id into ascending output slots.

    Accepts any slot order and duplicate col ids.  The output slot of
    each candidate is its count of distinct smaller ids, and the
    dedup-sum is one one-hot contraction.  On overflow (more than k_out
    distinct ids) the lowest col ids are kept.  Below-threshold values
    flush to zero; slots whose whole block flushes are EMPTY in place.
    """
    valid = cols != EMPTY
    first, rank = _ranks(cols)
    slot = torch.where(valid, rank, rank.new_full((), k_out))
    ko = torch.arange(k_out, device=cols.device)
    out = _slot_sum(slot[..., None] == ko, blocks)
    hit = (rank[..., None] == ko) & first[..., None]
    oc = torch.where(hit, cols[..., :, None].to(torch.int32),
                     torch.full((), EMPTY, dtype=torch.int32,
                                device=cols.device))
    oc = oc.amin(dim=-2)
    # the flush in place, and the norms as one reduction: no temporary
    # the size of the output (the k-way merges of a chunked solve run
    # at its pinned capacity)
    small = (out.abs() <= threshold) if out.is_complex() \
        else (out <= threshold) & (out >= -threshold)
    out.masked_fill_(small, 0.0)
    nm = torch.linalg.vector_norm(out, 1, dim=(-1, -2))
    oc = torch.where(nm > 0, oc, oc.new_full((), EMPTY))
    return oc, out


def union_fill_n(cols_list) -> Tensor:
    """Exact per-row structural fill of an N-operand sum: distinct
    non-EMPTY col ids in the union of the slot sets."""
    ids = torch.cat(list(cols_list), dim=-1)
    sids, _ = torch.sort(ids, dim=-1)
    prev = torch.cat([sids.new_full(sids.shape[:-1] + (1,), -1),
                      sids[..., :-1]], dim=-1)
    first = (sids != prev) & (sids != EMPTY)
    return first.sum(dim=-1, dtype=torch.int32)


def union_fill(a_cols: Tensor, b_cols: Tensor) -> Tensor:
    """Exact per-row structural fill of A + B."""
    return union_fill_n([a_cols, b_cols])


def occupancy(cols: Tensor) -> Tensor:
    """Per-row count of occupied slots: [..., K] -> [...]."""
    return (cols != EMPTY).sum(dim=-1, dtype=torch.int32)


def used_slots(cols: Tensor) -> Tensor:
    """Highest occupied slot index + 1: [..., K] -> [...].  Correct for
    hole-bearing layouts, so capacity trims use this."""
    k = cols.shape[-1]
    ar = torch.arange(1, k + 1, dtype=torch.int32, device=cols.device)
    idx = torch.where(cols != EMPTY, ar, torch.zeros_like(ar))
    return idx.amax(dim=-1)


def add(a_cols, a_blocks, b_cols, b_blocks, alpha=1.0, beta=1.0,
        threshold=0.0, k_out: int | None = None) -> Tuple[Tensor, Tensor]:
    """alpha*A + beta*B with threshold flush (one :func:`add_n`)."""
    return add_n([a_cols, b_cols], [a_blocks, b_blocks], [alpha, beta],
                 threshold=threshold, k_out=k_out)


def add_n(cols_list, blocks_list, coeffs, threshold=0.0,
          k_out: int | None = None) -> Tuple[Tensor, Tensor]:
    """sum_i coeffs[i] * M_i over N operands in ONE k-way merge.  Each
    coefficient is rounded to the result dtype before it scales.  The
    merge's input, every operand's slots side by side, is built a block
    of rows at a time, so that no temporary exceeds _ROW_BYTES (rows are
    independent: the same bits as one pass)."""
    if k_out is None:
        k_out = max(c.shape[-1] for c in cols_list)
    dt = blocks_list[0].dtype
    for b in blocks_list[1:]:
        dt = torch.promote_types(dt, b.dtype)
    first = blocks_list[0]
    rows, bs = first.shape[-4], first.shape[-1]
    width = sum(c.shape[-1] for c in cols_list)
    step = _row_passes(rows, (width + k_out) * bs * bs
                       * torch.empty((), dtype=dt).element_size())
    if step >= rows:
        return _add_rows(cols_list, blocks_list, coeffs, dt, threshold,
                         k_out)
    lead = first.shape[:-4]
    oc = cols_list[0].new_empty(lead + (rows, k_out))
    ob = first.new_empty(lead + (rows, k_out, bs, bs), dtype=dt)
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        oc[..., r0:r1, :], ob[..., r0:r1, :, :, :] = _add_rows(
            [c[..., r0:r1, :] for c in cols_list],
            [b[..., r0:r1, :, :, :] for b in blocks_list], coeffs, dt,
            threshold, k_out)
    return oc, ob


def _add_rows(cols_list, blocks_list, coeffs, dt, threshold, k_out):
    """:func:`add_n` on whole rows: each operand scaled straight into its
    part of the merge's input."""
    cols = torch.cat(list(cols_list), dim=-1)
    first = blocks_list[0]
    blocks = first.new_empty(first.shape[:-3] + (cols.shape[-1],)
                             + first.shape[-2:], dtype=dt)
    at = 0
    for b, a in zip(blocks_list, coeffs):
        w = b.shape[-3]
        torch.mul(b.to(dt), torch.as_tensor(a, dtype=dt),
                  out=blocks[..., at:at + w, :, :])
        at += w
    return merge(cols, blocks, k_out, threshold)


# ----------------------------------------------------------------------------
# SpGEMM tiers of plain torch (the reference's XLA tiers)
# ----------------------------------------------------------------------------
# The kernels of ``ops/spgemm.py`` take f32/f64 at block sizes that are
# multiples of 8.  Other shapes take these tiers, as the reference's
# XLA tiers serve the shapes its Pallas kernels refuse.  Unlike the
# kernels, they pack their output: 'acc' and 'dense' keep the largest
# blocks of a row that overflows k_out (``compact``), 'cand' its lowest
# col ids with holes where a whole block flushes (``merge``).

# bytes of dense accumulator (or gathered candidates) per pass over rows
_ROW_BYTES = 1 << 30


def _row_passes(rows: int, per_row_bytes: int) -> int:
    """Row chunk that keeps one pass's temporaries under _ROW_BYTES."""
    return max(1, min(rows, _ROW_BYTES // max(per_row_bytes, 1)))


def _result_dtype(a_blocks: Tensor, b_blocks: Tensor) -> torch.dtype:
    return torch.promote_types(a_blocks.dtype, b_blocks.dtype)


def _b_rows(a_cols: Tensor, b_cols: Tensor, b_blocks: Tensor):
    """B's block rows named by A's slots -> (valid [R, KA], cols [R, KA,
    KB], blocks [R, KA, KB, bs, bs]); EMPTY slots of A gather row 0."""
    valid = a_cols != EMPTY
    ks = torch.where(valid, a_cols, 0).long()
    return valid, b_cols[ks], b_blocks[ks]


def spgemm(a_cols: Tensor, a_blocks: Tensor, b_cols: Tensor,
           b_blocks: Tensor, *, col_offset: int, nbc_out: int, k_out: int,
           threshold=0.0, alpha=1.0) -> Tuple[Tensor, Tensor]:
    """C = alpha * A @ B, threshold-filtered: the dense-accumulator
    tier ('acc').

    A: [R, KA] slots whose col ids index block rows of B.  B: [NBK, KB]
    slots whose col ids lie in the output panel [col_offset, col_offset
    + nbc_out).  Each row's products are summed, slot of A by slot of
    A, into a dense row of nbc_out blocks, which is scaled by alpha,
    thresholded and compacted to k_out slots (:func:`compact`).  Rows
    are processed in passes that bound the accumulator."""
    R, KA = a_cols.shape
    bs = a_blocks.shape[-1]
    dt = _result_dtype(a_blocks, b_blocks)
    step = _row_passes(R, nbc_out * bs * bs * 8)
    cols_out, blocks_out = [], []
    for r0 in range(0, R, step):
        ac, ab = a_cols[r0:r0 + step], a_blocks[r0:r0 + step].to(dt)
        valid, bc, bb = _b_rows(ac, b_cols, b_blocks)
        n = ac.shape[0]
        # one spare column takes the products of EMPTY slots
        acc = ab.new_zeros((n, nbc_out + 1, bs, bs))
        rows = torch.arange(n, device=ac.device)[:, None]
        for s in range(KA):
            part = torch.matmul(ab[:, s, None], bb[:, s].to(dt))
            tval = (bc[:, s] != EMPTY) & valid[:, s, None]
            loc = torch.where(tval, bc[:, s].long() - col_offset, nbc_out)
            acc.index_put_((rows.expand_as(loc), loc), part,
                           accumulate=True)
        acc = acc[:, :nbc_out] * torch.as_tensor(alpha, dtype=dt)
        out_cols = (torch.arange(nbc_out, dtype=torch.int32,
                                 device=ac.device) + col_offset
                    ).expand(n, nbc_out)
        cc, cb = compact(out_cols, acc, k_out, threshold)
        cols_out.append(cc)
        blocks_out.append(cb)
    return torch.cat(cols_out), torch.cat(blocks_out)


def spgemm_candidates(a_cols: Tensor, a_blocks: Tensor, b_cols: Tensor,
                      b_blocks: Tensor, *, col_offset: int = 0, k_out: int,
                      threshold=0.0, alpha=1.0) -> Tuple[Tensor, Tensor]:
    """C = alpha * A @ B by explicit partial products and a k-way merge
    ('cand'): each slot of A multiplies the whole B row it names, and
    the KA * KB candidate blocks of a row are summed by :func:`merge`.
    ``col_offset`` is kept for the signature: candidate ids come from
    B directly."""
    R, KA = a_cols.shape
    KB = b_cols.shape[-1]
    bs = a_blocks.shape[-1]
    dt = _result_dtype(a_blocks, b_blocks)
    step = _row_passes(R, KA * KB * bs * bs * 8 * 3)
    cols_out, blocks_out = [], []
    for r0 in range(0, R, step):
        ac, ab = a_cols[r0:r0 + step], a_blocks[r0:r0 + step].to(dt)
        valid, bc, bb = _b_rows(ac, b_cols, b_blocks)
        n = ac.shape[0]
        parts = torch.matmul(ab[:, :, None], bb.to(dt)) \
            * torch.as_tensor(alpha, dtype=dt)
        cand = torch.where(valid[..., None] & (bc != EMPTY), bc,
                           torch.full((), EMPTY, dtype=bc.dtype,
                                      device=bc.device))
        cc, cb = merge(cand.reshape(n, KA * KB),
                       parts.reshape(n, KA * KB, bs, bs), k_out, threshold)
        cols_out.append(cc)
        blocks_out.append(cb)
    return torch.cat(cols_out), torch.cat(blocks_out)


def spgemm_dense(a_cols, a_blocks, b_cols, b_blocks, *, col_offset: int,
                 nbc_out: int, k_out: int, nbk: int, threshold=0.0,
                 alpha=1.0) -> Tuple[Tensor, Tensor]:
    """C = alpha * A @ B by densifying both operands, one dense product
    and re-blocking ('dense'); ``nbk`` is B's block-row count."""
    dt = _result_dtype(a_blocks, b_blocks)
    ad = to_dense(a_cols, a_blocks.to(dt), nbc=nbk)
    bd = to_dense(b_cols, b_blocks.to(dt), nbc=nbc_out,
                  col_offset=col_offset)
    cd = torch.as_tensor(alpha, dtype=dt) * (ad @ bd)
    cd = torch.where(cd.abs() > threshold, cd, cd.new_zeros(()))
    return from_dense(cd, bs=a_blocks.shape[-1], k=k_out,
                      col_offset=col_offset)


# ----------------------------------------------------------------------------
# dense <-> block-ELL
# ----------------------------------------------------------------------------

def to_dense(cols: Tensor, blocks: Tensor, nbc: int, col_offset: int = 0
             ) -> Tensor:
    """[R, K] block-ELL -> dense [R*bs, nbc*bs], cols shifted by
    col_offset (slots outside [0, nbc) are dropped)."""
    R, K = cols.shape
    bs = blocks.shape[-1]
    loc = cols.long() - col_offset
    valid = (cols != EMPTY) & (loc >= 0) & (loc < nbc)
    out = blocks.new_zeros((R, nbc, bs, bs))
    r, k = torch.nonzero(valid, as_tuple=True)
    out.index_put_((r, loc[r, k]), blocks[r, k], accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(R * bs, nbc * bs)


def from_dense(dense: Tensor, bs: int, k: int, col_offset: int = 0,
               threshold=0.0) -> Tuple[Tensor, Tensor]:
    """Dense [M, N] (multiples of bs) -> block-ELL [M/bs, k]."""
    M, N = dense.shape[-2:]
    if M % bs or N % bs:
        raise ValueError(f"dense shape {(M, N)} not a multiple of {bs}")
    R, nbc = M // bs, N // bs
    blocks = dense.reshape(dense.shape[:-2] + (R, bs, nbc, bs))
    blocks = blocks.transpose(-3, -2)
    cols = (torch.arange(nbc, dtype=torch.int32, device=dense.device)
            + col_offset).expand(blocks.shape[:-3] + (nbc,))
    return compact(cols, blocks, k, threshold)


# ----------------------------------------------------------------------------
# slot-wise algebra
# ----------------------------------------------------------------------------

def trace_blocks(cols: Tensor, blocks: Tensor, row_offset: int = 0
                 ) -> Tensor:
    """Diagonal blocks: [..., R, K] -> [..., R, bs, bs] (global block-row
    of local row r is row_offset + r)."""
    R = cols.shape[-2]
    rows = torch.arange(R, device=cols.device) + row_offset
    hit = (cols == rows[:, None]).to(blocks.dtype)
    return (blocks * hit[..., None, None]).sum(dim=-3)


def trace(cols: Tensor, blocks: Tensor, row_offset: int = 0) -> Tensor:
    d = trace_blocks(cols, blocks, row_offset)
    return torch.diagonal(d, dim1=-2, dim2=-1).sum()


def align(a_cols: Tensor, b_cols: Tensor, b_blocks: Tensor) -> Tensor:
    """B's blocks gathered onto A's slot structure: [..., KA, bs, bs],
    slot s holding the B block with A's col id (0 if B has none)."""
    match = ((a_cols[..., :, None] == b_cols[..., None, :])
             & (a_cols != EMPTY)[..., :, None])               # [.., KA, KB]
    return _slot_sum(match.transpose(-1, -2), b_blocks)


def align_mul(a_cols, a_blocks, b_cols, b_blocks) -> Tensor:
    """Hadamard product on the intersection pattern, aligned to A's
    slots: [..., KA, bs, bs]."""
    dt = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
    return a_blocks.to(dt) * align(a_cols, b_cols, b_blocks.to(dt))


def dot(a_cols, a_blocks, b_cols, b_blocks) -> Tensor:
    """sum_ij conj(A_ij) * B_ij on one shard (A conjugated when
    complex)."""
    return align_mul(a_cols, torch.conj(a_blocks), b_cols, b_blocks).sum()


def comp_sum(x: Tensor) -> Tensor:
    """Compensated sum of all elements -> [2] (hi, lo) two-float pair.

    Pairwise reduction where every level's rounding error is captured
    exactly by a two-sum and carried in a parallel lo array, so hi + lo
    carries the sum to ~n*eps^2 instead of n*eps.  The same tree as the
    reference's, so the pair agrees with it to that bound."""
    hi = x.reshape(-1)
    lo = torch.zeros_like(hi)
    n = hi.shape[0]
    while n > 1:
        m = (n + 1) // 2
        if 2 * m != n:
            hi = torch.cat([hi, hi.new_zeros(1)])
            lo = torch.cat([lo, lo.new_zeros(1)])
        a, b = hi[:m], hi[m:]
        s = a + b
        bb = s - a
        err = (a - (s - bb)) + (b - bb)
        hi = s
        lo = lo[:m] + lo[m:] + err
        n = m
    return torch.cat([hi, lo])


def col_abs_sums(cols: Tensor, blocks: Tensor, nbc: int) -> Tensor:
    """Per-column sums of |v| over [R, K] slots -> [nbc, bs].

    Every slot is added in slot order (an EMPTY slot adds zeros to
    column 0, which leaves each sum's bits as they are): no
    data-dependent shape and no host read, so a captured chunk can run
    it.  On a CUDA tensor an accumulating ``index_put_`` sorts the
    indices and sums each column in order, the same bits on every run,
    where ``index_add_`` adds by atomics."""
    persl = blocks.abs().sum(dim=-2)                  # [R, K, bs]
    valid = cols != EMPTY
    bs = persl.shape[-1]
    idx = torch.where(valid, cols, 0).reshape(-1).long()
    vals = (persl * valid[..., None].to(persl.dtype)).reshape(-1, bs)
    out = persl.new_zeros((nbc, bs))
    if out.is_cuda:
        return out.index_put_((idx,), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


def diagonal_scale(cols: Tensor, blocks: Tensor, dvec_rows=None,
                   dvec_cols=None) -> Tensor:
    """Scale rows by dvec_rows[..., R, bs] and/or columns by
    dvec_cols[nbc, bs] (gathered by each slot's col id)."""
    out = blocks
    if dvec_rows is not None:
        out = out * dvec_rows[..., :, None, :, None]
    if dvec_cols is not None:
        valid = cols != EMPTY
        loc = torch.where(valid, cols, 0).long()
        dc = dvec_cols[loc] * valid[..., None].to(dvec_cols.dtype)
        out = out * dc[..., None, :]
    return out


def filter_small(cols: Tensor, blocks: Tensor, threshold,
                 k_out: int | None = None) -> Tuple[Tensor, Tensor]:
    """Drop |v| <= threshold and re-pack (:func:`compact` at the same
    capacity unless ``k_out`` is given)."""
    k_out = cols.shape[-1] if k_out is None else k_out
    return compact(cols, blocks, k_out, threshold)


def grand_sum(blocks: Tensor) -> Tensor:
    """Sum of every stored value."""
    return blocks.sum()


# ----------------------------------------------------------------------------
# triplets <-> block-ELL
# ----------------------------------------------------------------------------

def from_triplets(rows: Tensor, cols: Tensor, vals: Tensor, *, nbr: int,
                  nbc: int, bs: int, k: int = 1, panels: int = 1
                  ) -> Tuple[Tensor, Tensor]:
    """Block-ELL [panels, nbr, K] from (i, j, v) tensors on one device,
    without a dense matrix: duplicate coordinates are summed in the
    order given, and each (panel, block row) packs its blocks from slot
    0 in ascending col order, K the larger of ``k`` and the fullest
    row's need.  Column panel ``p`` holds block columns ``p * nbc //
    panels`` onward."""
    dev = vals.device
    ub, inv = torch.unique(rows // bs * nbc + cols // bs, sorted=True,
                           return_inverse=True)
    nub = ub.numel()
    blocks = torch.zeros((nub, bs, bs), dtype=vals.dtype, device=dev)
    blocks.index_put_((inv, rows % bs, cols % bs), vals, accumulate=True)
    del inv
    ubi, ubj = ub // nbc, ub % nbc
    p = ubj // (nbc // panels)
    if panels > 1:                        # (panel, row, col) order
        order = torch.argsort(p * nbr * nbc + ub, stable=True)
        p, ubi, ubj, blocks = p[order], ubi[order], ubj[order], \
            blocks[order]
    grp = p * nbr + ubi
    idx = torch.arange(nub, device=dev)
    first = torch.ones(nub, dtype=torch.bool, device=dev)
    first[1:] = grp[1:] != grp[:-1]
    slot = idx - torch.cummax(torch.where(first, idx, 0), dim=0).values
    k = max(k, int(slot.max()) + 1 if nub else 1)
    out_cols = torch.full((panels, nbr, k), EMPTY, dtype=torch.int32,
                          device=dev)
    out_cols[p, ubi, slot] = ubj.to(torch.int32)
    out_blocks = torch.zeros((panels, nbr, k, bs, bs), dtype=vals.dtype,
                             device=dev)
    out_blocks[p, ubi, slot] = blocks
    return out_cols, out_blocks


def to_triplets(cols: Tensor, blocks: Tensor, n_rows: int, n_cols: int
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """(i, j, v) tensors of the stored nonzeros of block-ELL ``cols``
    [..., R, K] and ``blocks`` [..., R, K, bs, bs] with i < ``n_rows``
    and j < ``n_cols``, in the order of the stored entries (leading
    index, block row, slot, row and column inside the block)."""
    bs = blocks.shape[-1]
    *lead, rr, kk, ii, jj = torch.nonzero(blocks != 0, as_tuple=True)
    i = rr * bs + ii
    j = cols[(*lead, rr, kk)].long() * bs + jj
    v = blocks[(*lead, rr, kk, ii, jj)]
    keep = (i < n_rows) & (j < n_cols)
    return i[keep], j[keep], v[keep]


# ----------------------------------------------------------------------------
# block-COO <-> block-ELL (transpose machinery)
# ----------------------------------------------------------------------------

def to_block_coo(cols: Tensor, blocks: Tensor, row_offset: int = 0):
    """Flatten [R, K] slots to block-COO (rows, cols, blocks, valid),
    every slot listed, EMPTY ones with valid False."""
    R, K = cols.shape
    bs = blocks.shape[-1]
    rows = (torch.arange(R, dtype=torch.int32, device=cols.device)
            + row_offset)[:, None].expand(R, K)
    return (rows.reshape(-1), cols.reshape(-1),
            blocks.reshape(R * K, bs, bs), (cols != EMPTY).reshape(-1))


def from_block_coo(rows: Tensor, cols: Tensor, blocks: Tensor,
                   valid: Tensor, *, nbr: int, k: int, panels: int = 1,
                   panel_nbc: int | None = None) -> Tuple[Tensor, Tensor]:
    """Build block-ELL [panels, nbr, k] from flat block-COO.

    (row, col) must be unique among the valid entries.  Each row's
    blocks pack from slot 0 in ascending col order; a row with more
    than ``k`` keeps its ``k`` lowest col ids, and invalid entries are
    dropped (their row becomes ``nbr``, outside the matrix).  With
    ``panels > 1`` the output is split by column panel
    ``col // panel_nbc``."""
    bs = blocks.shape[-1]
    dev = rows.device
    rows = torch.where(valid, rows, nbr)
    if panels > 1:
        if panel_nbc is None:
            raise ValueError("panels > 1 needs panel_nbc")
        p = torch.where(valid, cols // panel_nbc, 0)
    else:
        p = torch.zeros_like(rows)
    # lexicographic (panel, row, col) by two stable sorts
    colkey = torch.where(valid, cols, EMPTY)
    order1 = torch.argsort(colkey, stable=True)
    grp = p * (nbr + 1) + rows
    order = order1[torch.argsort(grp[order1], stable=True)]
    sp, sr, sc, sv = p[order], rows[order], cols[order], valid[order]
    grp = grp[order]
    n = grp.shape[0]
    idx = torch.arange(n, device=dev)
    row_first = torch.ones(n, dtype=torch.bool, device=dev)
    row_first[1:] = grp[1:] != grp[:-1]
    start = torch.cummax(torch.where(row_first, idx, 0), dim=0).values
    slot = idx - start
    keep = sv & (slot < k) & (sr < nbr)
    out_cols = torch.full((panels, nbr, k), EMPTY, dtype=torch.int32,
                          device=dev)
    out_blocks = blocks.new_zeros((panels, nbr, k, bs, bs))
    at = (sp[keep].long(), sr[keep].long(), slot[keep])
    out_cols[at] = sc[keep].to(torch.int32)
    out_blocks[at] = blocks[order[keep]]
    return out_cols, out_blocks


def transpose_blocks(blocks: Tensor) -> Tensor:
    """Transpose within each block (no conjugation)."""
    return blocks.transpose(-1, -2)
