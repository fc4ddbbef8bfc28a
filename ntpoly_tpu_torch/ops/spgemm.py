"""The local block-sparse SpGEMM: structure pass, kernels, entry point.

Counterpart of ``ntpoly_tpu/ops/spgemm_pallas.py``: C = alpha * A @ B
with threshold truncation, at block granularity, on one shard, split
into an integer *structure pass* (plain torch) and a *numeric pass*
(hand-written CUDA kernels, ``csrc/``).  The entry point ``spgemm``
runs one of two:

  * ``spgemm_general``: every candidate product goes to the output slot
    ``structure_plan`` assigned it (rank form: slot g holds the g-th
    smallest output col id);
  * ``spgemm_band``: for banded operands, offset form (slot t holds col
    ``occ0 + t``), addressed arithmetically from ``band_plan``.

Both run the reference's tiers (``kernel_tier``): float32 at 'high' is
its bfloat16 hi/lo split (``split_bf16x3``) and at 'bf16' and 'default'
(the TPU's one bf16 pass) the hi part alone, on the tensor cores after
the split pass (``split_bf16``) has written the planes; 'highest' and
float64 at every tier are exact.

Two more compute the general kernel's rank form from the panel layout
of B (``b_panel``); as in the reference, only the low-K profile
(``profiling/lowk.py``) calls them:

  * ``spgemm_stream``: one row at a time, the operand stream overlapped
    with the products;
  * ``spgemm_window``: a group of G rows at a time from one window of
    KA + G - 1 panel rows (``_v3_pick``, ``_v3_window``), at the
    reference's tiers -- float32 'high' its bfloat16 hi/lo split on the
    tensor cores after the split pass -- and at 'bf16' on bfloat16
    operands.

One more computes the *uniform-band* product of the JAX package's
round-5 experiments (``profile_lowk_r5.py``: kernels v6, v7, v9, v10);
only the round-5 low-K profile (``profiling/lowk_r5.py``) calls it:

  * ``spgemm_uniform``: static output offsets (A slot s lands at output
    slot s + t for B slot t), B rows addressed by col id or by position
    inside the group's window, per-column norms, and the TPU's three
    tiers -- 'high' as its bfloat16 hi/lo split (``split_bf16x3``) on
    the tensor cores after the split pass.

The tensor-core tiers of the band, general, window and uniform kernels
share one product (``csrc/tc.cuh``).

Each kernel has a plain PyTorch version beside it with the same inputs
and outputs (``*_plain``).  The wrappers take the plain version only
for tensors on the CPU; for a CUDA tensor they launch the kernel
through ``_cuda.launch`` or raise (``ops/_cuda.py`` says why and what
every kernel takes).  ``launches`` counts kernel launches per wrapper.

Format contract: A [R, KA] slots whose col ids index block-rows of B;
B [NBK, KB] slots with global block-col ids; C [R, k_out] with global
col ids, ascending and unique, holes (EMPTY, zero block) where a whole
block fell below the threshold.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from ..config import EMPTY
from ..utils import trace
from . import _cuda

Tensor = torch.Tensor

# kernel launches per wrapper (the counter group 'launches' of
# utils/trace.py, reset with reset_launches); a launch under a device
# predicate (``run``), whose blocks may all return unread, counts under
# the kernel's name with "_pred" appended
launches = trace.counter_group("launches", (
    "spgemm_general", "spgemm_band", "spgemm_stream", "spgemm_window",
    "spgemm_uniform", "split_bf16", "spgemm_band_pred",
    "spgemm_general_pred"))


def reset_launches() -> None:
    trace.reset_counters("launches")


# ----------------------------------------------------------------------------
# structure pass
# ----------------------------------------------------------------------------

def _candidate_ids(a_cols: Tensor, b_cols: Tensor) -> Tensor:
    """[R, KA*KB] output block-col id of every candidate product (EMPTY
    for unused A slots and B slots)."""
    R, KA = a_cols.shape
    valid_a = a_cols != EMPTY
    ks = torch.where(valid_a, a_cols, 0).long()
    ids = torch.where(valid_a[:, :, None], b_cols[ks],
                      b_cols.new_full((), EMPTY))
    return ids.reshape(R, KA * b_cols.shape[-1])


def _sorted_ranks(ids: Tensor):
    """Sort each row of candidate ids: (sorted ids, their order, first-
    occurrence flags, ranks among distinct valid ids) in sorted order."""
    sids, order = torch.sort(ids, dim=-1, stable=True)
    prev = torch.cat([sids.new_full(sids.shape[:-1] + (1,), -1),
                      sids[..., :-1]], dim=-1)
    first = (sids != prev) & (sids != EMPTY)
    rank = torch.cumsum(first.to(torch.int32), dim=-1) - 1
    return sids, order, first, rank


def structural_fill(a_cols: Tensor, b_cols: Tensor) -> Tensor:
    """Exact per-row structural fill of C = A @ B: the number of distinct
    output block-columns of each row before threshold pruning."""
    ids = _candidate_ids(a_cols, b_cols)
    return _sorted_ranks(ids)[2].sum(dim=-1, dtype=torch.int32)


def structure_plan(a_cols: Tensor, b_cols: Tensor, k_out: int
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """The output pattern of C = A @ B from col ids alone.

    Returns
      slot   [R, KA*KB] int32 — output slot of each candidate product
                                (>= k_out means dropped: overflow or
                                EMPTY, whose slot is KA*KB)
      occ    [R, k_out] int32 — ascending unique output col ids
      ucnt   [R]        int32 — exact structural fill-in per row

    The slot of a candidate is its rank among the row's distinct ids, as
    in the reference; here the ranks come from one sort per row.
    """
    ids = _candidate_ids(a_cols, b_cols)
    R, M = ids.shape
    sids, order, first, rank = _sorted_ranks(ids)
    slot = torch.empty_like(rank).scatter_(1, order, rank)
    slot = torch.where(ids != EMPTY, slot, slot.new_full((), M))
    ucnt = first.sum(dim=-1, dtype=torch.int32)
    occ = ids.new_full((R, k_out + 1), EMPTY)
    tgt = torch.where(first & (rank < k_out), rank,
                      rank.new_full((), k_out)).long()
    occ.scatter_(1, tgt, sids)
    return slot.to(torch.int32), occ[:, :k_out], ucnt


def band_plan(a_cols: Tensor, b_cols: Tensor, k_out: int,
              span: int | None = None):
    """Offset-form output plan for the band kernel.

    When every referenced B row is arithmetically contiguous (all its
    valid cols satisfy col(t) = base + t; EMPTY holes anywhere are
    fine), the product of A slot s lands at output offset gg0 = base
    (acol_s) - occ0, its KB column blocks at gg0..gg0+KB-1.  ``span``
    (default k_out) is the width of the computed output; ``ok`` requires
    every row's data extent to fit it.

    Returns (gg0 [R, KA] int32, occ0 [R] int32, ok bool tensor).
    """
    NBK, KB = b_cols.shape
    span = k_out if span is None else span
    width = min(span, k_out)
    big = torch.full((), EMPTY, dtype=torch.int64, device=a_cols.device)
    bc = b_cols.long()
    t_idx = torch.arange(KB, device=bc.device)
    validb = b_cols != EMPTY
    base_all = torch.where(validb, bc - t_idx, big)
    base_min = base_all.amin(dim=1)
    base_max = torch.where(validb, bc - t_idx, -1).amax(dim=1)
    has_b = validb.any(dim=1)
    b_ok = (~has_b | (base_min == base_max)).all()
    base = torch.where(has_b, base_min, 0)
    # actual data extent of each B row (last valid slot + 1), so that
    # capacity-padded rows are not flagged
    ext = torch.where(validb, t_idx + 1, 0).amax(dim=1)
    valida = a_cols != EMPTY
    ks = torch.where(valida, a_cols, 0).long()
    rbase = torch.where(valida, base[ks], big)
    occ0 = rbase.amin(dim=1)
    occ0 = torch.where(occ0 == big, 0, occ0)
    hi = torch.where(valida, rbase + ext[ks], -big).amax(dim=1)
    span_ok = (~valida.any(dim=1) | (hi - occ0 <= width)).all()
    gg0 = torch.clamp(torch.where(valida, rbase - occ0[:, None], 0),
                      0, max(width - 1, 0))
    return (gg0.to(torch.int32), occ0.to(torch.int32), b_ok & span_ok)


def _v4_span(ka: int, kb: int, k_out: int) -> int:
    """Width (blocks) of the band kernel's computed output: a contiguous
    band product spans at most KA + KB - 1 output blocks."""
    return min(k_out, ka + kb - 1)


# Regime gates of the band kernel, kept from the reference so that the
# arm chosen (and so the output form) matches it slot for slot.  The
# TPU-only gates (bs % 128, scalar and vector memory budgets, grid
# steps) have no counterpart here.
V3_MIN_ROWS = 128
V3_MAX_KA = 8


def _v4_pick(ka: int, kb: int, k_out: int, r: int, nbk: int):
    """(g_rows, window) for the band kernel, or (None, None) when the
    shape is outside its regime.  g_rows and window only define the
    group windows of the runtime check (``_v3_window``)."""
    if r < V3_MIN_ROWS or ka > V3_MAX_KA:
        return None, None
    if kb > k_out:
        return None, None
    for g in (16, 8, 4, 2):
        w = ka + g - 1
        if nbk < w or r < g:
            continue
        return g, w
    return None, None


def _v3_pick(ka: int, kb: int, k_out: int, r: int, nbk: int):
    """(g_rows, window) for the window kernel, or (None, None) when the
    shape is outside its regime: the reference's gates and its group
    order (8 first, where the band kernel's ``_v4_pick`` tries 16
    first), so that both pick the same (g, w)."""
    if r < V3_MIN_ROWS or ka > V3_MAX_KA:
        return None, None
    if kb > k_out:
        return None, None
    for g in (8, 16, 4, 2):
        w = ka + g - 1
        if nbk < w or r < g:
            continue
        return g, w
    return None, None


def _v3_window(a_cols: Tensor, g_rows: int):
    """Per-group window starts and the max window width from col ids:
    wlo[g] = min valid col id of group g, width = max over groups of
    (max - min + 1).  Returns (wlo int32 [ng], width 0-d tensor)."""
    R, KA = a_cols.shape
    ng = R // g_rows
    grp = a_cols.reshape(ng, g_rows * KA).long()
    valid = grp != EMPTY
    lo = torch.where(valid, grp, EMPTY).amin(dim=1)
    hi = torch.where(valid, grp, -1).amax(dim=1)
    width = torch.where(valid.any(dim=1), hi - lo + 1, 0).amax()
    return torch.where(lo == EMPTY, 0, lo).to(torch.int32), width


def kernel_tier(dtype, precision: str) -> str:
    """The tier the band, general and window kernels run for blocks of
    ``dtype`` at ``precision``, as the reference's kernels do: float32
    at 'high' runs the bfloat16 split and at 'bf16' its hi part, on the
    tensor cores; float32 at 'default' runs 'bf16', the TPU's one bf16
    pass (``jnp.dot`` at DEFAULT precision, spgemm_pallas.py:181-183);
    'highest', and float64 at every tier, run exact products (the
    reference keeps float64 exact)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if dtype == torch.float32 and precision != "highest":
        return "bf16" if precision == "default" else precision
    return "highest"


def b_panel(b_cols: Tensor, b_blocks: Tensor) -> Tensor:
    """B rows concatenated along columns, [NBK, bs, KB*bs], with EMPTY
    slots zeroed: block t of row k is panel[k, :, t*bs:(t+1)*bs] (the
    reference's ``make_panel``)."""
    NBK, KB, bs, _ = b_blocks.shape
    masked = torch.where((b_cols != EMPTY)[..., None, None], b_blocks,
                         b_blocks.new_zeros(()))
    return masked.transpose(1, 2).reshape(NBK, bs, KB * bs)


# ----------------------------------------------------------------------------
# plain versions of the kernels
# ----------------------------------------------------------------------------

def _masked_b(a_col: Tensor, b_cols: Tensor, b_blocks: Tensor, t: int):
    """B block (row a_col[r], slot t) per row r, zero where A's slot or
    B's slot is EMPTY.  -> ([R, bs, bs], valid [R])."""
    valid = a_col != EMPTY
    ks = torch.where(valid, a_col, 0).long()
    ok = valid & (b_cols[ks, t] != EMPTY)
    blk = b_blocks[ks, t]
    return blk * ok[:, None, None].to(blk.dtype), ok


def _epilogue(acc: Tensor, alpha: float, threshold: float):
    x = acc * torch.as_tensor(alpha, dtype=acc.dtype)
    x = torch.where(x.abs() > threshold, x, x.new_zeros(()))
    return x, x.abs().sum(dim=(-1, -2))


def _panel_b(a_col: Tensor, b_row: Tensor, panel: Tensor, t: int):
    """Panel block (row b_row[r], block t) per row r, zero where A's slot
    is EMPTY.  -> ([R, bs, bs], valid [R])."""
    bs = panel.shape[1]
    valid = a_col != EMPTY
    blk = panel[torch.where(valid, b_row, 0).long(), :, t * bs:(t + 1) * bs]
    return blk * valid[:, None, None].to(blk.dtype), valid


def _plain(a_cols, a_blocks, kb, b_of, slot_of, cut, k_out, alpha,
           threshold, dtype=None, tier="highest"):
    """Output slot slot_of(s, t)[r] of row r receives A[r, s] @ b_of(s,
    t)[0][r] where b_of(s, t)[1][r] holds, unless the slot is >= cut;
    products at ``tier`` (``_tier_bmm``) and sums in ``dtype`` (default
    A's); then the prune epilogue.  -> (blocks [R, k_out, bs, bs], norms
    [R, k_out])."""
    R, KA = a_cols.shape
    bs = a_blocks.shape[-1]
    dtype = dtype or a_blocks.dtype
    acc = a_blocks.new_zeros((R * (k_out + 1), bs, bs), dtype=dtype)
    rows = torch.arange(R, device=a_cols.device) * (k_out + 1)
    for s in range(KA):
        for t in range(kb):
            bblk, ok = b_of(s, t)
            g = slot_of(s, t)
            g = torch.where(ok & (g < cut), g, k_out)
            acc.index_add_(0, rows + g, _tier_bmm(
                a_blocks[:, s].to(dtype), bblk.to(dtype), tier))
    acc = acc.reshape(R, k_out + 1, bs, bs)[:, :k_out]
    return _epilogue(acc, alpha, threshold)


def _chosen(run, out, blocks: Tensor, norms: Tensor):
    """The plain side of a launch under the device predicate ``run``:
    (blocks, norms) where run is nonzero, else ``out`` untouched, as the
    kernel leaves its output buffers when every block returns."""
    if run is None:
        return blocks, norms
    keep = run.reshape(()) != 0
    return (torch.where(keep, blocks, out[0]),
            torch.where(keep, norms, out[1]))


def spgemm_general_plain(a_cols, a_blocks, b_cols, b_blocks, plan, *,
                         k_out: int, alpha: float, threshold: float,
                         precision: str = "highest", run=None, out=None):
    """Plain version of the general kernel: output slot
    plan[r, s*KB + t] receives A[r, s] @ B[acols[r, s], t] (dropped when
    >= k_out) at ``kernel_tier``, then the prune epilogue.  -> (blocks
    [R, k_out, bs, bs], norms [R, k_out]); with the predicate ``run``
    (an int tensor) 0, ``out`` as given (``_chosen``)."""
    KB = b_cols.shape[1]
    return _chosen(run, out, *_plain(
        a_cols, a_blocks, KB,
        lambda s, t: _masked_b(a_cols[:, s], b_cols, b_blocks, t),
        lambda s, t: plan[:, s * KB + t].long(), k_out, k_out,
        alpha, threshold, tier=kernel_tier(a_blocks.dtype, precision)))


def spgemm_band_plain(a_cols, a_blocks, b_cols, b_blocks, gg0, *,
                      k_out: int, span: int, alpha: float,
                      threshold: float, precision: str = "highest",
                      run=None, out=None):
    """Plain version of the band kernel: output slot t < span of row r
    receives A[r, s] @ B[acols[r, s], t - gg0[r, s]] for every valid A
    slot s with 0 <= t - gg0 < KB, at ``kernel_tier``; slots >= span are
    zero.  -> (blocks [R, k_out, bs, bs], norms [R, k_out]); with the
    predicate ``run`` 0, ``out`` as given (``_chosen``)."""
    return _chosen(run, out, *_plain(
        a_cols, a_blocks, b_cols.shape[1],
        lambda s, t: _masked_b(a_cols[:, s], b_cols, b_blocks, t),
        lambda s, t: gg0[:, s].long() + t, span, k_out,
        alpha, threshold, tier=kernel_tier(a_blocks.dtype, precision)))


def spgemm_stream_plain(a_cols, a_blocks, panel, plan, *, kb: int,
                        k_out: int, alpha: float, threshold: float):
    """Plain version of the stream kernel: the general kernel's contract
    with B as a panel ([NBK, bs, KB*bs], ``b_panel``): output slot
    plan[r, s*KB + t] receives A[r, s] @ panel[min(acols[r, s], NBK -
    1)][:, t*bs:(t+1)*bs].  -> (blocks [R, k_out, bs, bs], norms
    [R, k_out])."""
    last = panel.shape[0] - 1
    return _plain(a_cols, a_blocks, kb,
                  lambda s, t: _panel_b(a_cols[:, s],
                                        a_cols[:, s].clamp(max=last),
                                        panel, t),
                  lambda s, t: plan[:, s * kb + t].long(), k_out, k_out,
                  alpha, threshold)


# output dtype of the window kernel per operand dtype
_WINDOW_OUT = {torch.float32: torch.float32, torch.float64: torch.float64,
               torch.bfloat16: torch.float32}


def _window_types(a_cols, a_blocks, panel, wlo, g_rows, w, precision):
    """Check the window kernel's arguments -> its output dtype.  The
    operands are float32 or float64 (output in their dtype) or, for the
    'bf16' tier and only there, bfloat16 (output float32).  Rows come in
    whole groups of g_rows, one window start each, and the window fits
    the panel."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    dt = a_blocks.dtype
    if panel.dtype != dt or dt not in _WINDOW_OUT:
        raise TypeError(f"window kernel operands: {dt}, {panel.dtype}")
    if (precision == "bf16") != (dt == torch.bfloat16):
        raise TypeError("the 'bf16' tier takes bfloat16 operands, and "
                        f"only it does; got {dt} at {precision!r}")
    R = a_cols.shape[0]
    if g_rows < 1 or R % g_rows:
        raise ValueError(f"{R} rows are not whole groups of {g_rows}")
    if tuple(wlo.shape) != (R // g_rows,):
        raise ValueError(f"wlo shape {tuple(wlo.shape)} != {(R // g_rows,)}")
    if not 1 <= w <= panel.shape[0]:
        raise ValueError(f"window {w} outside 1..{panel.shape[0]}")
    return _WINDOW_OUT[dt]


def _window_rows(a_col: Tensor, wlo: Tensor, g_rows: int, w: int,
                 nbk: int) -> Tensor:
    """Panel row of each row's col id inside its group's window: lo +
    clip(acol - lo, 0, w - 1) with lo = min(wlo[group], nbk - w), as
    the reference addresses its window."""
    lo = torch.repeat_interleave(wlo.long().clamp(max=nbk - w), g_rows)
    lo = lo.clamp(min=0)
    return lo + (a_col.long() - lo).clamp(0, w - 1)


def spgemm_window_plain(a_cols, a_blocks, panel, plan, wlo, *, kb: int,
                        k_out: int, g_rows: int, w: int,
                        precision: str = "highest", alpha: float,
                        threshold: float):
    """Plain version of the window kernel: the stream kernel's contract
    for groups of ``g_rows`` rows, each reading its B rows from its
    window (``_window_rows``), sums in the output dtype
    (:func:`_window_types`), products at ``kernel_tier`` (float32 'high'
    the bf16x3 split, float32 'default' its hi part; bfloat16 operands
    exact in float32).  -> (blocks [R, k_out, bs, bs], norms [R,
    k_out])."""
    out_dtype = _window_types(a_cols, a_blocks, panel, wlo, g_rows, w,
                              precision)
    nbk = panel.shape[0]
    return _plain(a_cols, a_blocks, kb,
                  lambda s, t: _panel_b(
                      a_cols[:, s],
                      _window_rows(a_cols[:, s], wlo, g_rows, w, nbk),
                      panel, t),
                  lambda s, t: plan[:, s * kb + t].long(), k_out, k_out,
                  alpha, threshold, dtype=out_dtype,
                  tier=kernel_tier(a_blocks.dtype, precision))


# operand dtype -> output dtype of the uniform kernel, per tier
_UNIFORM_OUT = {
    "highest": {torch.float32: torch.float32, torch.float64: torch.float64},
    "high": {torch.float32: torch.float32},
    "bf16": {torch.bfloat16: torch.float32},
}
ADDRESSINGS = ("col", "position")


def split_bf16x3(x: Tensor) -> Tuple[Tensor, Tensor]:
    """The reference's bfloat16 split of float32 x: hi = bf16(x), lo =
    bf16(x - f32(hi)), both rounded to nearest even.  The 'high' tier
    sums a_hi b_hi + a_lo b_hi + a_hi b_lo."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).to(torch.bfloat16)


def _uniform_types(a_cols, a_blocks, b_blocks, wlo, *, kb, g_rows, w, span,
                   addressing, precision):
    """Check the uniform kernel's arguments -> its output dtype.
    'highest' takes float32 or float64 operands (output in their dtype),
    'high' float32 and 'bf16' bfloat16 (output float32).  B is raw
    blocks [NBK, KB, bs, bs]; rows come in whole groups of g_rows, one
    window start each; the window fits B; and every static offset fits
    the computed width, KA + KB - 1 <= span."""
    if precision not in _UNIFORM_OUT:
        raise ValueError(f"precision {precision!r} not in "
                         f"{tuple(_UNIFORM_OUT)}")
    if addressing not in ADDRESSINGS:
        raise ValueError(f"addressing {addressing!r} not in {ADDRESSINGS}")
    outs = _UNIFORM_OUT[precision]
    dt = a_blocks.dtype
    if b_blocks.dtype != dt or dt not in outs:
        raise TypeError(f"the uniform kernel at {precision!r} takes "
                        f"{'/'.join(str(d)[6:] for d in outs)} operands; "
                        f"got {dt}, {b_blocks.dtype}")
    R, KA = a_cols.shape
    bs = a_blocks.shape[-1]
    if (tuple(a_blocks.shape) != (R, KA, bs, bs) or b_blocks.dim() != 4
            or tuple(b_blocks.shape[1:]) != (kb, bs, bs)):
        raise ValueError(f"A {tuple(a_blocks.shape)} and B "
                         f"{tuple(b_blocks.shape)} do not match [R, KA, bs, "
                         f"bs] and [NBK, KB, bs, bs] at KB={kb}")
    if g_rows < 1 or R % g_rows:
        raise ValueError(f"{R} rows are not whole groups of {g_rows}")
    if tuple(wlo.shape) != (R // g_rows,):
        raise ValueError(f"wlo shape {tuple(wlo.shape)} != {(R // g_rows,)}")
    if not 1 <= w <= b_blocks.shape[0]:
        raise ValueError(f"window {w} outside 1..{b_blocks.shape[0]}")
    if KA + kb - 1 > span:
        raise ValueError(f"static offsets pass the computed width: KA + KB "
                         f"- 1 = {KA + kb - 1} > span {span}")
    return outs[dt]


def _uniform_rows(a_cols: Tensor, wlo: Tensor, g_rows: int, w: int,
                  nbk: int, addressing: str) -> Tensor:
    """[R, KA] raw B row that slot s of row r reads, inside its group's
    window from lo = max(min(wlo[group], nbk - w), 0): 'col' addresses
    by col id, clamped into the window (``_window_rows``,
    profile_lowk_r5.py:219-222); 'position' reads window row i + s for
    row i of the group whatever its col id (:336-341, :514-518)."""
    R, KA = a_cols.shape
    if addressing == "col":
        return torch.stack([_window_rows(a_cols[:, s], wlo, g_rows, w, nbk)
                            for s in range(KA)], dim=1)
    lo = torch.repeat_interleave(wlo.long().clamp(max=nbk - w), g_rows)
    i = torch.arange(R, device=a_cols.device) % g_rows
    return (lo.clamp(min=0) + i)[:, None] + torch.arange(
        KA, device=a_cols.device)


def _tier_bmm(a: Tensor, b: Tensor, precision: str) -> Tensor:
    """Batched block products at one tier: 'highest' in the operands'
    dtype; 'high' as the three bf16 terms and 'bf16' on the operands
    rounded to bfloat16, each product exact in float32, sums in
    float32."""
    f = torch.float32
    if precision == "high":
        (ah, al), (bh, bl) = split_bf16x3(a), split_bf16x3(b)
        return (torch.bmm(ah.to(f), bh.to(f)) + torch.bmm(al.to(f), bh.to(f))
                + torch.bmm(ah.to(f), bl.to(f)))
    if precision == "bf16":
        bf = torch.bfloat16
        return torch.bmm(a.to(bf).to(f), b.to(bf).to(f))
    return torch.bmm(a, b)


def spgemm_uniform_plain(a_cols, a_blocks, b_blocks, wlo, *, kb: int,
                         k_out: int, g_rows: int, w: int, span: int,
                         addressing: str, precision: str, alpha: float,
                         threshold: float):
    """Plain version of the uniform kernel: output slot t < span of row
    r sums A[r, s] @ B[row(r, s), t - s] over the slots s with 0 <= t -
    s < KB (``_uniform_rows``; no slot is skipped for its col id: EMPTY
    slots hold zero blocks), then alpha, the threshold flush and the
    L1 norm of every column; slots t >= span are zero.  -> (blocks
    [R, k_out, bs, bs], col_norms [R, k_out, bs])."""
    out_dtype = _uniform_types(a_cols, a_blocks, b_blocks, wlo, kb=kb,
                               g_rows=g_rows, w=w, span=span,
                               addressing=addressing, precision=precision)
    R, KA = a_cols.shape
    bs = a_blocks.shape[-1]
    rows = _uniform_rows(a_cols, wlo, g_rows, w, b_blocks.shape[0],
                         addressing)
    acc = torch.zeros((R, k_out, bs, bs), dtype=out_dtype,
                      device=a_blocks.device)
    for t in range(min(span, k_out)):
        for s in range(max(0, t - kb + 1), min(KA - 1, t) + 1):
            acc[:, t] += _tier_bmm(a_blocks[:, s], b_blocks[rows[:, s], t - s],
                                   precision)
    x = acc * torch.as_tensor(alpha, dtype=out_dtype)
    x = torch.where(x.abs() > threshold, x, x.new_zeros(()))
    return x, x.abs().sum(dim=-2)


# ----------------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------------

def _check_panel(a_cols, a_blocks, panel, kb, index, dtypes=_cuda.REAL):
    """The operands of a kernel that reads B as a panel, checked
    (``_cuda.operands``, blocks of ``dtypes``; ``index`` names the int32
    tensors besides a_cols, the plan first) -> contiguous a_cols, the
    index tensors, A and the panel."""
    *ids, ab, bp = _cuda.operands({"a_cols": a_cols, **index},
                                  {"A": a_blocks, "panel": panel}, dtypes)
    R, KA = ids[0].shape
    bs = ab.shape[-1]
    if (tuple(ab.shape) != (R, KA, bs, bs) or bp.dim() != 3
            or tuple(bp.shape[1:]) != (bs, kb * bs)):
        raise ValueError(f"A {tuple(ab.shape)} and panel "
                         f"{tuple(bp.shape)} do not match [R, KA, bs, "
                         f"bs] and [NBK, bs, KB*bs] at KB={kb}")
    if tuple(ids[1].shape) != (R, KA * kb):
        raise ValueError(f"plan shape {tuple(ids[1].shape)} != "
                         f"{(R, KA * kb)}")
    return (*ids, ab, bp)


def split_bf16(x: Tensor, *, lo: bool = True):
    """The split pass (``csrc/spgemm_band.cu``) on a CUDA tensor, its
    plain version (``split_bf16x3``) on a CPU tensor: the bfloat16
    planes (hi, lo) of float32 x, lo None unless asked for."""
    if not _cuda.route(x, "split"):
        return split_bf16x3(x) if lo else (x.to(torch.bfloat16), None)
    if x.dtype != torch.float32:
        raise TypeError(f"the split pass takes float32, got {x.dtype}")
    x = x.contiguous()
    if not _cuda.on_vectors(x.data_ptr(), x.numel() * x.element_size()):
        raise ValueError("the split pass takes whole float4 vectors on 16 "
                         "bytes")
    hi = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    low = torch.empty_like(hi) if lo else None
    _cuda.launch("ntp_split_bf16", launches, "split_bf16", (x, hi, low),
                 (x.numel(),))
    return hi, low


def _planes(ab: Tensor, bb: Tensor, tier: str):
    """The bfloat16 planes of contiguous A and B for a tensor-core tier:
    bfloat16 operands are their own hi planes; float32 ones go through
    the split pass, B's planes taken from A's when B is the leading part
    of A's storage (X @ X splits X once, also when A is X padded)."""
    if ab.dtype == torch.bfloat16:
        return (ab, None), (bb, None)
    pa = split_bf16(ab, lo=tier == "high")
    if bb.data_ptr() == ab.data_ptr() and bb.numel() <= ab.numel():
        return pa, tuple(None if x is None else
                         x.view(-1)[:bb.numel()].view(bb.shape) for x in pa)
    return pa, split_bf16(bb, lo=tier == "high")


def _run_kernel(name, a_cols, a_blocks, b_cols, b_blocks, idx, want,
                tail, precision, alpha, threshold, planes=None, *,
                run=None, out=None):
    """Check and launch the band or general kernel ``name`` (``idx``:
    its gg0 or plan, of shape ``want``) at ``kernel_tier``: the exact
    instance of the operands' dtype, or the split pass and the
    tensor-core product (float32 out).  ``tail``: the C entry's ints
    after (R, KA, KB[, NBK]).  ``planes``: the ``split_bf16`` planes of
    A and B, split already (for timing the product alone, and so that
    the two launches of a predicated multiply split once).  ``run``: a
    device predicate (int32, one element) under which the kernel writes
    ``out`` (its (blocks, norms) buffers) only where run is nonzero;
    such a launch counts under ``name + '_pred'``."""
    ac, bc, ix, ab, bb = _cuda.operands(
        {"a_cols": a_cols, "b_cols": b_cols, "index": idx},
        {"A": a_blocks, "B": b_blocks})
    R, KA = ac.shape
    NBK, KB = bc.shape
    bs = ab.shape[-1]
    if bb.shape[-1] != bs:
        raise ValueError("A and B block sizes differ")
    if tuple(ix.shape) != want:
        raise ValueError(f"index shape {tuple(ix.shape)} != {want}")
    tier = kernel_tier(ab.dtype, precision)
    k_out = tail[0]
    key = name
    if run is None:
        out = ab.new_empty((R, k_out, bs, bs))
        nrm = ab.new_empty((R, k_out))
    else:
        out, nrm = out
        if (run.device != ab.device or run.dtype != torch.int32
                or run.numel() != 1):
            raise ValueError("run must be one int32 on A's device")
        if (tuple(out.shape) != (R, k_out, bs, bs)
                or tuple(nrm.shape) != (R, k_out) or out.dtype != ab.dtype
                or nrm.dtype != ab.dtype or not out.is_contiguous()
                or not nrm.is_contiguous() or out.device != ab.device
                or nrm.device != ab.device):
            raise ValueError("out must be contiguous [R, k_out, bs, bs] "
                             "blocks and [R, k_out] norms of A's dtype "
                             "on A's device")
        key = name + "_pred"
    if tier == "highest":
        _cuda.launch(f"ntp_{name}{_cuda.SUFFIX[ab.dtype]}", launches, key,
                     (ac, ab, bc, bb, ix, out, nrm, run),
                     (R, KA, KB, *tail), (alpha, threshold))
    else:
        (ah, al), (bh, bl) = planes or _planes(ab, bb, tier)
        _cuda.launch(f"ntp_{name}_tc", launches, key,
                     (ac, ah, al, bc, bh, bl, ix, out, nrm, run),
                     (R, KA, KB, NBK, *tail), (alpha, threshold))
    return out, nrm


def spgemm_general(a_cols, a_blocks, b_cols, b_blocks, plan, *,
                   k_out: int, alpha: float, threshold: float,
                   precision: str = "highest", run=None, out=None,
                   planes=None):
    """General kernel (``csrc/spgemm_general.cu``) on CUDA tensors at
    ``kernel_tier`` (float32 'high' and 'bf16': the split pass, then the
    tensor cores), its plain version on CPU tensors.  With ``run`` (one
    int32 on the device) and ``out`` ((blocks, norms) buffers), the
    product is written into ``out`` only where run is nonzero
    (``_run_kernel``); ``planes``: A's and B's split planes."""
    if not _cuda.route(a_blocks, "SpGEMM"):
        return spgemm_general_plain(a_cols, a_blocks, b_cols, b_blocks,
                                    plan, k_out=k_out, alpha=alpha,
                                    threshold=threshold, precision=precision,
                                    run=run, out=out)
    R, KA = a_cols.shape
    return _run_kernel("spgemm_general", a_cols, a_blocks, b_cols, b_blocks,
                       plan, (R, KA * b_cols.shape[1]),
                       (k_out, a_blocks.shape[-1]), precision, alpha,
                       threshold, planes, run=run, out=out)


def spgemm_band(a_cols, a_blocks, b_cols, b_blocks, gg0, *, k_out: int,
                span: int, alpha: float, threshold: float,
                precision: str = "highest", run=None, out=None,
                planes=None):
    """Band kernel (``csrc/spgemm_band.cu``) on CUDA tensors at
    ``kernel_tier`` (float32 'high' and 'bf16': the split pass, then the
    tensor cores), its plain version on CPU tensors; ``run``, ``out``
    and ``planes`` as :func:`spgemm_general`'s."""
    if not _cuda.route(a_blocks, "SpGEMM"):
        return spgemm_band_plain(a_cols, a_blocks, b_cols, b_blocks, gg0,
                                 k_out=k_out, span=span, alpha=alpha,
                                 threshold=threshold, precision=precision,
                                 run=run, out=out)
    return _run_kernel("spgemm_band", a_cols, a_blocks, b_cols, b_blocks,
                       gg0, tuple(a_cols.shape),
                       (k_out, span, a_blocks.shape[-1]), precision, alpha,
                       threshold, planes, run=run, out=out)


def spgemm_stream(a_cols, a_blocks, panel, plan, *, kb: int, k_out: int,
                  alpha: float, threshold: float):
    """Stream kernel (``csrc/spgemm_stream.cu``) on CUDA tensors, its
    plain version on CPU tensors."""
    if not _cuda.route(a_blocks, "SpGEMM"):
        return spgemm_stream_plain(a_cols, a_blocks, panel, plan, kb=kb,
                                   k_out=k_out, alpha=alpha,
                                   threshold=threshold)
    ac, pl, ab, bp = _check_panel(a_cols, a_blocks, panel, kb,
                                  {"plan": plan})
    R, KA = ac.shape
    bs = ab.shape[-1]
    out = ab.new_empty((R, k_out, bs, bs))
    nrm = ab.new_empty((R, k_out))
    _cuda.launch("ntp_spgemm_stream" + _cuda.SUFFIX[ab.dtype], launches,
                 "spgemm_stream", (ac, ab, bp, pl, out, nrm),
                 (R, KA, kb, bp.shape[0], k_out, bs), (alpha, threshold))
    return out, nrm


def spgemm_window(a_cols, a_blocks, panel, plan, wlo, *, kb: int,
                  k_out: int, g_rows: int, w: int,
                  precision: str = "highest", alpha: float,
                  threshold: float):
    """Window kernel (``csrc/spgemm_window.cu``) on CUDA tensors, its
    plain version on CPU tensors.  R is a multiple of g_rows: callers
    pad col ids with EMPTY, the plan with k_out and blocks with zeros.
    Tiers as ``kernel_tier``: float32 'high' is the bf16x3 split (the
    split pass on A and the panel, then the tensor cores) and float32
    'default' its hi part alone; 'highest' and float64 run exact
    products; 'bf16' takes bfloat16 operands (the tensor cores, no
    split) and writes float32."""
    kw = dict(kb=kb, k_out=k_out, g_rows=g_rows, w=w, precision=precision,
              alpha=alpha, threshold=threshold)
    if not _cuda.route(a_blocks, "SpGEMM"):
        return spgemm_window_plain(a_cols, a_blocks, panel, plan, wlo, **kw)
    return _run_window(a_cols, a_blocks, panel, plan, wlo, **kw)


def _run_window(a_cols, a_blocks, panel, plan, wlo, *, kb, k_out, g_rows,
                w, precision, alpha, threshold, planes=None):
    """Check and launch the window kernel on CUDA tensors.  ``planes``:
    the ``split_bf16`` planes of A and the panel, split already, for
    timing the tensor-core product alone."""
    dt = _window_types(a_cols, a_blocks, panel, wlo, g_rows, w, precision)
    ac, pl, wl, ab, bp = _check_panel(a_cols, a_blocks, panel, kb,
                                      {"plan": plan, "wlo": wlo},
                                      tuple(_WINDOW_OUT))
    R, KA = ac.shape
    bs = ab.shape[-1]
    out = torch.empty((R, k_out, bs, bs), dtype=dt, device=ab.device)
    nrm = torch.empty((R, k_out), dtype=dt, device=ab.device)
    ints = (R, KA, kb, bp.shape[0], k_out, bs, g_rows, w)
    tier = kernel_tier(ab.dtype, precision)
    if ab.dtype == torch.bfloat16 or tier != "highest":
        (ah, al), (bh, bl) = planes or _planes(ab, bp, tier)
        _cuda.launch("ntp_spgemm_window_tc", launches, "spgemm_window",
                     (ac, ah, al, bh, bl, pl, wl, out, nrm), ints,
                     (alpha, threshold))
    else:
        _cuda.launch("ntp_spgemm_window" + _cuda.SUFFIX[ab.dtype], launches,
                     "spgemm_window", (ac, ab, bp, pl, wl, out, nrm), ints,
                     (alpha, threshold))
    return out, nrm


def spgemm_uniform(a_cols, a_blocks, b_blocks, wlo, *, kb: int, k_out: int,
                   g_rows: int, w: int, span: int, addressing: str,
                   precision: str, alpha: float, threshold: float):
    """Uniform kernel (``csrc/spgemm_uniform.cu``) on CUDA tensors, its
    plain version on CPU tensors.  R is a multiple of g_rows: callers
    pad col ids with EMPTY and blocks with zeros.  'highest' runs exact
    products (float32 on the card, float32 or float64 on the CPU);
    'high' (float32 operands: the split pass, B's planes taken from A's
    when B is the leading part of A's storage) and 'bf16' (bfloat16
    operands, float32 output) run on the tensor cores."""
    kw = dict(kb=kb, k_out=k_out, g_rows=g_rows, w=w, span=span,
              addressing=addressing, precision=precision, alpha=alpha,
              threshold=threshold)
    if not _cuda.route(a_blocks, "SpGEMM"):
        return spgemm_uniform_plain(a_cols, a_blocks, b_blocks, wlo, **kw)
    return _run_uniform(a_cols, a_blocks, b_blocks, wlo, **kw)


def _run_uniform(a_cols, a_blocks, b_blocks, wlo, *, kb, k_out, g_rows, w,
                 span, addressing, precision, alpha, threshold,
                 planes=None):
    """Check and launch the uniform kernel on CUDA tensors.  ``planes``:
    the ``split_bf16`` planes of A and B, split already, for timing the
    tensor-core product alone."""
    dt = _uniform_types(a_cols, a_blocks, b_blocks, wlo, kb=kb,
                        g_rows=g_rows, w=w, span=span,
                        addressing=addressing, precision=precision)
    ac, wl, ab, bb = _cuda.operands({"a_cols": a_cols, "wlo": wlo},
                                    {"A": a_blocks, "B": b_blocks},
                                    (torch.float32, torch.bfloat16))
    R, KA = ac.shape
    bs = ab.shape[-1]
    dev = ab.device
    out = torch.empty((R, k_out, bs, bs), dtype=dt, device=dev)
    nrm = torch.empty((R, k_out, bs), dtype=dt, device=dev)
    ints = (R, KA, kb, bb.shape[0], k_out, span, bs, g_rows, w,
            int(addressing == "position"))
    if precision == "highest":
        _cuda.launch("ntp_spgemm_uniform_f32", launches, "spgemm_uniform",
                     (ac, ab, bb, wl, out, nrm), ints, (alpha, threshold))
    else:
        (ah, al), (bh, bl) = planes or _planes(ab, bb, precision)
        _cuda.launch("ntp_spgemm_uniform_tc", launches, "spgemm_uniform",
                     (ac, ah, al, bh, bl, wl, out, nrm), ints,
                     (alpha, threshold))
    return out, nrm


# ----------------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------------

PRECISIONS = ("highest", "high", "default", "bf16")


def spgemm(a_cols: Tensor, a_blocks: Tensor, b_cols: Tensor,
           b_blocks: Tensor, *, k_out: int, threshold=0.0, alpha=1.0,
           precision: str = "highest", band_mode: str = "auto"
           ) -> Tuple[Tensor, Tensor, Tensor]:
    """C = alpha * A @ B, threshold-filtered, on one shard.

    Returns (col_ids [R, k_out], blocks [R, k_out, bs, bs], ucnt [R] —
    exact structural fill per row, so ``ucnt > k_out`` flags overflow),
    with ``spgemm_pallas``'s contract: on overflow the lowest col ids are
    kept; slots whose block flushed to zero are EMPTY in place.

    band_mode: 'auto' runs the band kernel when the band plan holds and
    the general kernel otherwise, reading that choice back to the host
    (one scalar) so that only one kernel launches; 'select' makes the
    same choice on the device, as the reference's ``lax.cond``
    (spgemm_pallas.py:1082): both kernels launch on one output buffer
    under a device predicate (``run``), the unchosen one's blocks
    returning before any load, and nothing is read back, so that a
    chunk of solver iterations (``solvers/common.run_chunked``) runs,
    and is captured in a CUDA graph, with no host read; 'force' runs
    only the band kernel (the general one outside its regime, with a
    warning), and a violated band assumption poisons ucnt to EMPTY;
    'off' never uses the band kernel.

    precision: the kernels' tier (``kernel_tier``), as the reference's
    kernels run it: for float32 blocks 'high' is the bfloat16 hi/lo
    split (three products, float32 sums) and 'bf16' and 'default' the
    operands rounded to bfloat16 ('default' is the TPU's one bf16 pass),
    both on the tensor cores; 'highest' is exact, as is float64 at every
    tier.  alpha and threshold are rounded to float32 first, as the
    reference does.  alpha may be a 0-d tensor on the device (a chunked
    solve's scalar): the kernels then run at alpha 1 and threshold 0,
    and the prune epilogue (alpha, the flush) follows in torch with the
    same arithmetic as the kernels' epilogue.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if band_mode not in ("auto", "select", "force", "off"):
        raise ValueError(f"band_mode {band_mode!r}")
    R, KA = a_cols.shape
    NBK, KB = b_cols.shape
    dt = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
    if dt.is_complex:
        raise TypeError("the SpGEMM kernels are real-only")
    with trace.span("ntp.structure"):
        plan, occp, ucnt = structure_plan(a_cols, b_cols, k_out)
    threshold = float(np.float32(threshold))
    alpha_dev = None
    if isinstance(alpha, torch.Tensor):
        alpha_dev = alpha.to(torch.float32).to(dt)
        alpha, kernel_threshold = 1.0, 0.0
    else:
        alpha = float(np.float32(alpha))
        kernel_threshold = threshold
    args = (a_cols, a_blocks.to(dt), b_cols, b_blocks.to(dt))
    kw = dict(k_out=k_out, alpha=alpha, threshold=kernel_threshold,
              precision=precision)

    g_rows, wv4 = _v4_pick(KA, KB, k_out, R, NBK)
    if band_mode == "off":
        g_rows = None
    if band_mode == "force" and g_rows is None:
        warnings.warn(
            f"spgemm(band_mode='force'): shape R={R}, KA={KA}, KB={KB}, "
            f"k_out={k_out} is outside the band kernel's regime; running "
            "the general kernel instead")
    occ_used = occp
    if g_rows is not None:
        span = _v4_span(KA, KB, k_out)
        with trace.span("ntp.structure"):
            pad = -R % g_rows
            ac_p = torch.cat([a_cols, a_cols.new_full((pad, KA), EMPTY)])
            _, width = _v3_window(ac_p, g_rows)
            gg0, occ0, band_ok = band_plan(a_cols, b_cols, k_out,
                                           span=span)
            use_band = (width <= wv4) & band_ok
            occ_band = occ0[:, None] + torch.arange(
                k_out, dtype=torch.int32, device=occ0.device)
        if band_mode == "select":
            cb, nm = _select(args, gg0, plan, use_band, span, kw)
            occ_used = torch.where(use_band, occ_band, occp)
        elif band_mode == "force" or trace.read(use_band):
            cb, nm = spgemm_band(*args, gg0, span=span, **kw)
            occ_used = occ_band
            if band_mode == "force":
                ucnt = torch.where(use_band, ucnt,
                                   ucnt.new_full((), EMPTY))
        else:
            cb, nm = spgemm_general(*args, plan, **kw)
    else:
        cb, nm = spgemm_general(*args, plan, **kw)
    if alpha_dev is not None:
        cb, nm = _epilogue(cb, alpha_dev, threshold)
    cc = torch.where(nm > 0, occ_used, occ_used.new_full((), EMPTY))
    return cc, cb, ucnt


def _select(args, gg0, plan, use_band, span, kw):
    """The band and general kernels on one output buffer, each under its
    side of the device predicate ``use_band`` (band_mode 'select'); on
    the tensor-core tiers A and B are split once for both."""
    a_cols, ab, b_cols, bb = args
    R, bs = a_cols.shape[0], ab.shape[-1]
    shape = (R, kw["k_out"], bs, bs)
    cuda = _cuda.on_card(ab)
    new = torch.empty if cuda else torch.zeros
    out = (new(shape, dtype=ab.dtype, device=ab.device),
           new(shape[:2], dtype=ab.dtype, device=ab.device))
    planes = None
    tier = kernel_tier(ab.dtype, kw["precision"])
    if cuda and tier != "highest":
        planes = _planes(ab.contiguous(), bb.contiguous(), tier)
    run = use_band.to(torch.int32).reshape(1)
    out = spgemm_band(*args, gg0, span=span, run=run, out=out,
                      planes=planes, **kw)
    return spgemm_general(*args, plan, run=1 - run, out=out, planes=planes,
                          **kw)
