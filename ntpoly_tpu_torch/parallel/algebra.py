"""Algebra on PSMatrix (one device).

Counterpart of ``ntpoly_tpu/parallel/algebra.py`` on the 1 x 1 x 1 grid:
the SpGEMM with its capacity policy (grow, trim, warn, deferred
checks), the fused N-operand increment, and the scalar reductions the
solvers read.  The reference's SUMMA collectives and its row-chunked
variants (``_compact_rows``, the chunked ``dot_pair`` and
``increment_n``), which bound the TPU's 16 GB of memory, are not needed
on one 80 GB card and are left out.

The working threshold of a multiply is the caller's threshold (one
slice), as in the reference.
"""
from __future__ import annotations

import contextlib
import threading
import warnings

import torch

from ..config import EMPTY
from ..core import bell
from ..ops import spgemm as sp
from ..utils.errors import NTPolyError
from .pmatrix import PSMatrix

# ----------------------------------------------------------------------------
# ambient capacity policy
# ----------------------------------------------------------------------------

_policy = threading.local()


def _policy_get(attr):
    return getattr(_policy, attr, None)


@contextlib.contextmanager
def capacity_policy(k_out: int | None = None,
                    on_overflow: str | None = None,
                    precision: str | None = None,
                    method: str | None = None, defer: bool = False):
    """Ambient capacity defaults for matmul/increment.

    Solvers install this from SolverParameters.  ``defer``: overflow and
    band-violation checks in non-growing modes are queued as device
    scalars instead of read back per operation, and materialized in ONE
    sync by :func:`drain_deferred_checks` when the policy exits."""
    names = ("k_out", "on_overflow", "precision", "method", "defer")
    prev = tuple(_policy_get(n) for n in names)
    for n, v in zip(names, (k_out, on_overflow, precision, method,
                            defer)):
        setattr(_policy, n, v)
    try:
        yield
    finally:
        for n, v in zip(names, prev):
            setattr(_policy, n, v)
        if defer and not _policy_get("defer"):
            drain_deferred_checks()


# deferred overflow / band-violation checks: entries are
# (device int32 need, capacity_or_None, op label, is_band)
_pending_checks: list = []


def _defer_check(need, cap_k, op: str, band: bool = False):
    _pending_checks.append((need, cap_k, op, band))
    if len(_pending_checks) >= 512:       # backstop if never drained
        drain_deferred_checks()


def drain_deferred_checks():
    """Materialize every deferred check in ONE host sync: raise on a
    poisoned band-mode fill, warn once per truncating op."""
    global _pending_checks
    if not _pending_checks:
        return
    pend, _pending_checks = _pending_checks, []
    vals = torch.stack([p[0] for p in pend]).tolist()
    band_bad = [p for p, v in zip(pend, vals) if p[3] and v >= EMPTY]
    over = [(p, v) for p, v in zip(pend, vals)
            if p[1] is not None and EMPTY > v > p[1]]
    for (need, cap_k, op, _), v in over:
        warnings.warn(f"{op}: structural fill {v} exceeds capacity "
                      f"{cap_k} — result truncated")
    if band_bad:
        raise NTPolyError(
            "matmul(method='pallas_band'): operands violate the band "
            "assumption (contiguous B rows, spans within k_out); use "
            "method='auto' or 'pallas' (detected at solve granularity "
            "under a deferring capacity_policy)")


# ----------------------------------------------------------------------------
# SpGEMM
# ----------------------------------------------------------------------------

def _summa(a: PSMatrix, b: PSMatrix, alpha, threshold, *, k_out: int,
           method: str, want_fill: bool, precision: str):
    """The local multiply of the 1 x 1 x 1 grid: returns (cc, cb, stats)
    with stats = [structural fill, max used slot] as one device tensor."""
    agc, agb = a.col_ids[0], a.blocks[0]
    bgc, bgb = b.col_ids[0], b.blocks[0]
    dev = agc.device
    if want_fill:
        fill = sp.structural_fill(agc, bgc).amax()
    else:
        fill = torch.zeros((), dtype=torch.int32, device=dev)
    # FULL-SPAN band multiply: the band kernel's contiguous output window
    # cannot express a top-k_out-by-rank truncation, so when the capacity
    # is below the product span (ka + kb - 1) the kernel runs at the full
    # span, the threshold flush empties the decayed tails, and
    # bell.compact re-bases to k_out.  The fill stat then reports the
    # filtered need (surviving slots).
    k_run = k_out
    band = method == "pallas_band"
    if band:
        k_run = max(k_out, min(a.panel_nb,
                               agc.shape[-1] + bgc.shape[-1] - 1))
    cc, cb, bucnt = sp.spgemm(agc, agb, bgc, bgb, k_out=k_run,
                              threshold=threshold, alpha=alpha,
                              precision=precision,
                              band_mode="force" if band else "auto")
    if band and k_run > k_out:
        bad = bucnt.amax() >= EMPTY
        cnt = (cc != EMPTY).sum(dim=-1).amax().to(torch.int32)
        cc, cb = bell.compact(cc, cb, k_out)
        fill = torch.where(bad, torch.tensor(EMPTY, dtype=torch.int32,
                                             device=dev), cnt)
    elif band:
        fill = torch.maximum(fill, bucnt.amax())
    stats = torch.stack([fill.to(torch.int32),
                         bell.used_slots(cc).amax().to(torch.int32)])
    return cc[None], cb[None], stats


def fill_bound(a: PSMatrix, b: PSMatrix) -> int:
    """Exact structural capacity A @ B needs: the largest fill of any
    row (one host read)."""
    return int(sp.structural_fill(a.col_ids[0], b.col_ids[0]).amax())


def _k_bucket(n: int, cap: int) -> int:
    """Round capacity up to a multiple of 4 to bound shape variety."""
    return min(-(-max(n, 1) // 4) * 4, cap)


_UNPORTED = ("the reference's XLA tiers ('acc', 'cand', 'dense') are "
             "not ported yet")


def _pick_method(a: PSMatrix, b: PSMatrix) -> str:
    """The kernel tier whenever the kernels take the dtype and block
    size (on a CUDA device they launch; on the CPU their plain versions
    run).  Other shapes need the reference's XLA tiers."""
    if sp.eligible(torch.promote_types(a.dtype, b.dtype), a.bs):
        return "pallas"
    raise ValueError(f"matmul of {a.dtype} at bs={a.bs}: {_UNPORTED}")


def matmul(a: PSMatrix, b: PSMatrix, alpha=1.0, threshold=0.0,
           k_out: int | None = None, method: str = "auto",
           on_overflow: str | None = None,
           precision: str | None = None) -> PSMatrix:
    """C = alpha * A @ B, threshold-filtered.

    method: 'pallas' (the kernels: band or general, chosen per call),
    'pallas_band' (band kernel only, full span + compact; a violated
    band assumption raises), 'auto' (the policy's method, else
    :func:`_pick_method`).  'acc', 'cand' and 'dense' are not ported.

    on_overflow: 'grow' (default) re-runs with enough capacity when the
    structural fill exceeds k_out, and trims unused capacity; 'warn'
    keeps the capacity and warns (deferred under a deferring policy);
    'truncate'/'ignore' keep it silently.  Overflowing rows keep the
    lowest col ids.
    """
    if not (a.grid == b.grid and a.nb == b.nb and a.bs == b.bs):
        raise ValueError("matmul operands differ in grid or geometry")
    cap = a.panel_nb
    k_out = min(k_out or _policy_get("k_out") or max(a.k, b.k), cap)
    on_overflow = on_overflow or _policy_get("on_overflow") or "grow"
    precision = precision or _policy_get("precision") or "high"
    requested = method
    grow = on_overflow == "grow"
    while True:
        if requested == "auto":
            method = _policy_get("method") or _pick_method(a, b)
        if method not in ("pallas", "pallas_band"):
            raise ValueError(f"matmul method {method!r}: {_UNPORTED}")
        band = method == "pallas_band"
        # as in the reference, eager 'warn' without the band method
        # does not measure the structural fill (ROADMAP Queue C)
        cc, cb, stats = _summa(a, b, alpha, threshold, k_out=k_out,
                               method=method, want_fill=grow or band,
                               precision=precision)
        growing = grow and k_out < cap
        if not growing and not band and on_overflow != "warn":
            break                         # nothing reads the stats
        if not growing and _policy_get("defer"):
            _defer_check(stats[0],
                         k_out if on_overflow == "warn" else None,
                         "matmul", band)
            break
        need, used = stats.tolist()       # ONE host sync per multiply
        if band and need >= EMPTY:
            raise NTPolyError(
                "matmul(method='pallas_band'): operands violate the "
                "band assumption (contiguous B rows, spans within "
                "k_out); use method='auto' or 'pallas'")
        if on_overflow == "warn" and need > k_out:
            warnings.warn(f"matmul: structural fill {need} exceeds "
                          f"capacity {k_out} — result truncated")
        if not grow or k_out >= cap:
            break
        if need <= k_out:
            # trim grown-but-unused capacity (holes allowed, so by the
            # highest used slot)
            k_eff = _k_bucket(used, cap)
            if k_eff < k_out:
                cc = cc[..., :k_eff]
                cb = cb[..., :k_eff, :, :]
            break
        k_out = _k_bucket(need, cap)
    return PSMatrix(cc, cb, a.dim, a.bs, a.grid)


# ----------------------------------------------------------------------------
# slot-wise ops and reductions
# ----------------------------------------------------------------------------

def _increment_n(mats, coeffs, threshold, k_out: int):
    cols_l = [m.col_ids for m in mats]
    blocks_l = [m.blocks for m in mats]
    cc, cb = bell.add_n(cols_l, blocks_l, coeffs, threshold=threshold,
                        k_out=k_out)
    fill = bell.union_fill_n(cols_l).amax()
    used = bell.used_slots(cc).amax()
    a = mats[0]
    return (PSMatrix(cc, cb, a.dim, a.bs, a.grid),
            torch.stack([fill, used]))


def increment(a: PSMatrix, b: PSMatrix, alpha=1.0, beta=1.0, threshold=0.0,
              k_out: int | None = None,
              on_overflow: str | None = None) -> PSMatrix:
    """alpha*A + beta*B (see :func:`increment_n`)."""
    return increment_n((a, b), (alpha, beta), threshold=threshold,
                       k_out=k_out, on_overflow=on_overflow)


def increment_n(mats, coeffs, threshold=0.0, k_out: int | None = None,
                on_overflow: str | None = None) -> PSMatrix:
    """sum_i coeffs[i] * M_i in ONE fused k-way merge.  Capacity policy
    as :func:`matmul`: 'grow' reads the fill back (regrow + trim), 'warn'
    warns (deferred under a deferring policy), 'truncate'/'ignore' never
    sync."""
    mats = tuple(mats)
    cap = mats[0].panel_nb
    k = min(k_out or _policy_get("k_out") or max(m.k for m in mats), cap)
    on_overflow = on_overflow or _policy_get("on_overflow") or "grow"
    while True:
        out, stats = _increment_n(mats, tuple(coeffs), threshold, k)
        if on_overflow in ("truncate", "ignore"):
            return out
        if on_overflow == "warn":
            if _policy_get("defer"):
                _defer_check(stats[0], k, "increment")
                return out
            need = int(stats[0])
            if need > k:
                warnings.warn(f"increment: structural fill {need} "
                              f"exceeds capacity {k} — result truncated")
            return out
        need, ue = stats.tolist()         # ONE sync ('grow')
        if k >= cap or need <= k:
            k_eff = _k_bucket(ue, cap)
            if k_eff < out.k:
                out = out.with_data(out.col_ids[..., :k_eff],
                                    out.blocks[..., :k_eff, :, :])
            return out
        k = _k_bucket(need, cap)


def scale(a: PSMatrix, c) -> PSMatrix:
    return a.with_data(a.col_ids,
                       a.blocks * torch.as_tensor(c, dtype=a.dtype))


def trace(a: PSMatrix) -> torch.Tensor:
    """Matrix trace (0-d tensor on the device)."""
    return bell.trace(a.col_ids, a.blocks)


def dot(a: PSMatrix, b: PSMatrix) -> torch.Tensor:
    """sum_ij A_ij B_ij (0-d tensor on the device)."""
    return bell.dot(a.col_ids, a.blocks, b.col_ids, b.blocks)


def trace_pair(a: PSMatrix) -> torch.Tensor:
    """Compensated trace -> [2] (hi, lo)."""
    d = bell.trace_blocks(a.col_ids, a.blocks)
    return bell.comp_sum(torch.diagonal(d, dim1=-2, dim2=-1))


def dot_pair(a: PSMatrix, b: PSMatrix) -> torch.Tensor:
    """Compensated dot -> [2] (hi, lo), resolving the sum to ~n*eps^2."""
    prod = bell.align_mul(a.col_ids, a.blocks, b.col_ids, b.blocks)
    return bell.comp_sum(prod)


def host_pair(p) -> float:
    """(hi, lo) pair -> float64 on the host (one readback)."""
    hi, lo = (float(v) for v in p.double().tolist())
    return hi + lo


def column_sums(a: PSMatrix) -> torch.Tensor:
    """Per-column sums of |v| -> [logical_dim]."""
    cs = bell.col_abs_sums(a.col_ids[0], a.blocks[0], a.panel_nb)
    return cs.reshape(a.logical_dim)


def diagonal_values(a: PSMatrix) -> torch.Tensor:
    """The matrix diagonal -> [logical_dim]."""
    d = bell.trace_blocks(a.col_ids, a.blocks).sum(dim=0)   # [NB, bs, bs]
    return torch.diagonal(d, dim1=-2, dim2=-1).reshape(-1)


def gershgorin_bounds(a: PSMatrix):
    """Spectral bounds (lo, hi) as 0-d tensors: min/max over columns of
    center -/+ radius.  Padded columns contribute [0, 0]."""
    cs = column_sums(a)
    d = diagonal_values(a)
    radius = cs - d.abs()
    return (d - radius).amin(), (d + radius).amax()


def is_identity(a: PSMatrix) -> bool:
    """Exact identity check: one pass and one scalar readback."""
    pc, nbr, k = a.col_ids.shape
    bs = a.bs
    dev = a.device
    rows = torch.arange(nbr, device=dev)[None, :, None]
    eye = torch.eye(bs, dtype=a.dtype, device=dev)
    gi = rows[..., None, None] * bs + torch.arange(bs, device=dev)[:, None]
    want = torch.where((a.col_ids == rows)[..., None, None] & (gi < a.dim),
                       eye, 0)
    return float((a.blocks - want).abs().sum()) == 0.0


# ----------------------------------------------------------------------------
# transpose, norm and the two-sided products
# ----------------------------------------------------------------------------

def filter_small(a: PSMatrix, threshold) -> PSMatrix:
    """Drop |v| <= threshold, re-packed at the same capacity."""
    cc, cb = bell.filter_small(a.col_ids, a.blocks, threshold)
    return a.with_data(cc, cb)


def _transpose(a: PSMatrix, k_out: int):
    """A^T at capacity k_out (overflowing rows keep their lowest col
    ids), and the largest fill of any output row as a device scalar."""
    pc, nb, k = a.col_ids.shape
    rows, cols, blocks, valid = bell.to_block_coo(
        a.col_ids.reshape(pc * nb, k),
        bell.transpose_blocks(a.blocks).reshape(pc * nb, k, a.bs, a.bs))
    rows = rows % nb                 # every panel lists the same nb rows
    # output fill per (panel of the old row, new row = old col)
    pidx = (rows // a.panel_nb).long()
    counts = torch.zeros((pc, nb + 1), dtype=torch.int32, device=a.device)
    counts.index_put_((pidx, torch.where(valid, cols, nb).long()),
                      torch.ones_like(rows), accumulate=True)
    fill = counts[:, :nb].amax()
    oc, ob = bell.from_block_coo(
        torch.where(valid, cols, nb), rows, blocks, valid, nbr=nb,
        k=k_out, panels=pc, panel_nbc=a.panel_nb)
    return a.with_data(oc, ob), fill


def transpose(a: PSMatrix, k_out: int | None = None,
              on_overflow: str | None = None) -> PSMatrix:
    """A^T by a block-COO flip and rebuild; a row of A^T can need more
    slots than A has, and 'grow' (the default) re-runs at the fill it
    needs.  Other policies keep the capacity, and overflowing rows keep
    their lowest col ids."""
    cap = a.panel_nb
    k = min(k_out or _policy_get("k_out") or a.k, cap)
    on_overflow = on_overflow or _policy_get("on_overflow") or "grow"
    while True:
        out, fill = _transpose(a, k)
        if on_overflow != "grow" or k >= cap:
            return out
        need = int(fill)
        if need <= k:
            return out
        k = _k_bucket(need, cap)


def norm(a: PSMatrix) -> torch.Tensor:
    """The max column 1-norm (0-d tensor on the device)."""
    return column_sums(a).amax()


def similarity_transform(a: PSMatrix, p: PSMatrix, pinv: PSMatrix,
                         threshold=0.0, k_out=None) -> PSMatrix:
    """P @ A @ Pinv.  When P and Pinv are both the identity the
    multiplies are skipped: A itself, filtered when threshold > 0."""
    if p.k <= 1 and pinv.k <= 1 and is_identity(p) and is_identity(pinv):
        return filter_small(a, threshold) if threshold > 0 else a
    tmp = matmul(a, pinv, threshold=threshold, k_out=k_out)
    return matmul(p, tmp, threshold=threshold, k_out=k_out)


def load_balance(a: PSMatrix, perm: PSMatrix, perm_t: PSMatrix,
                 threshold=0.0) -> PSMatrix:
    """P A P^T by two multiplies, for permutation matrices P and P^T."""
    return matmul(perm, matmul(a, perm_t, threshold=threshold),
                  threshold=threshold)
