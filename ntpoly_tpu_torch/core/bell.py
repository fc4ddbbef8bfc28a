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
                     torch.tensor(EMPTY, dtype=torch.int32,
                                  device=cols.device))
    oc = oc.amin(dim=-2)
    out = torch.where(out.abs() > threshold, out, out.new_zeros(()))
    nm = block_norms(out)
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


def used_slots(cols: Tensor) -> Tensor:
    """Highest occupied slot index + 1: [..., K] -> [...].  Correct for
    hole-bearing layouts, so capacity trims use this."""
    k = cols.shape[-1]
    ar = torch.arange(1, k + 1, dtype=torch.int32, device=cols.device)
    idx = torch.where(cols != EMPTY, ar, torch.zeros_like(ar))
    return idx.amax(dim=-1)


def add_n(cols_list, blocks_list, coeffs, threshold=0.0,
          k_out: int | None = None) -> Tuple[Tensor, Tensor]:
    """sum_i coeffs[i] * M_i over N operands in ONE k-way merge.  Each
    coefficient is rounded to the result dtype before it scales."""
    if k_out is None:
        k_out = max(c.shape[-1] for c in cols_list)
    dt = blocks_list[0].dtype
    for b in blocks_list[1:]:
        dt = torch.promote_types(dt, b.dtype)
    cols = torch.cat(list(cols_list), dim=-1)
    blocks = torch.cat(
        [b.to(dt) * torch.as_tensor(a, dtype=dt)
         for b, a in zip(blocks_list, coeffs)], dim=-3)
    return merge(cols, blocks, k_out, threshold)


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
    """sum_ij A_ij * B_ij on one shard (real matrices)."""
    return align_mul(a_cols, a_blocks, b_cols, b_blocks).sum()


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
    """Per-column sums of |v| over [R, K] slots -> [nbc, bs]."""
    persl = blocks.abs().sum(dim=-2)                  # [R, K, bs]
    valid = cols != EMPTY
    out = persl.new_zeros((nbc, persl.shape[-1]))
    r, k = torch.nonzero(valid, as_tuple=True)
    out.index_add_(0, cols[r, k].long(), persl[r, k])
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
