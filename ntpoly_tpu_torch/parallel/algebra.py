"""Algebra on PSMatrix: the 3D SUMMA and the grid's reductions.

Counterpart of ``ntpoly_tpu/parallel/algebra.py``: the SpGEMM with its
capacity policy (grow, trim, warn, deferred checks), the fused N-operand
increment, and the scalar reductions the solvers read.  Every rank runs
the same calls on its own tile (SPMD); the reference's mesh collectives
become the grid's process groups (``grid.group``):

    A's block rows over 'cols'   -> all-gather of A's tiles (its row panel)
    B's block cols over 'rows'   -> all-gather of B's tiles (its col panel)
    slice split-k                -> slot masking (col % S == s), gather
                                    over 'slices' + k-way threshold merge
    stats pmax                   -> one MAX all-reduce over the grid

With S slices the local multiplies prune at threshold / (S * 1000) and
the full threshold is applied on the slice sum (reference
MatrixMultiply.f90:23-29).  Reductions sum over the rows x cols ranks of
a slice only (slices are replicas), gathering every rank's partial and
adding in rank order, so that every rank holds the same bits; vectors
(column sums, the diagonal, ``spmm``) come back replicated.  On the
1 x 1 x 1 grid every collective is the identity.  A rank's own part of
a trace or dot, plain or compensated, comes from the slot reductions of
``ops/reduce.py``: one kernel pass on the card, whose plain trace or dot
is the float64 value of the compensated pair (for float32 matrices too:
the same cost, and the digits that differences of such sums need), and
elsewhere (the CPU, complex data, other block sizes) the reference's
sums in the matrices' dtype.  Host decisions (the 'grow' policy,
deferred checks, the solvers' monitors) read only such grid-wide
values, so that every rank takes the same branch.

The reference's row-chunked variants (``_compact_rows``, the chunked
``dot_pair`` and ``increment_n``), which bound the TPU's 16 GB of
memory, are not needed on an 80 GB card and are left out.
"""
from __future__ import annotations

import contextlib
import threading
import warnings

import torch

from ..config import EMPTY
from ..core import bell
from ..ops import _cuda
from ..ops import compact as cmp
from ..ops import merge as mrg
from ..ops import reduce as red
from ..ops import spgemm as sp
from ..utils import trace as tr
from ..utils.errors import ComplexSupportError, NTPolyError
from ..utils.logging import logger
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
                    method: str | None = None, defer: bool = False,
                    verbose: bool = False, collect: list | None = None):
    """Ambient capacity defaults for matmul/increment.

    Solvers install this from SolverParameters.  ``defer``: overflow and
    band-violation checks in non-growing modes are queued as device
    scalars instead of read back per operation, and materialized in ONE
    sync by :func:`drain_deferred_checks` when the policy exits.
    ``verbose``: a multiply that grows past the pinned ``k_out`` writes
    "capacity regrown" to the YAML log, as the reference's chunked
    solves (``run_chunked``) do when their pin overflows.

    ``collect``: a list to which every capacity-bounded op (``matmul``,
    ``increment``, ``increment_n``) appends its exact structural fill,
    a 0-d int32 tensor on the device.  Under a collecting policy no op
    reads a device value to the host: capacities stay as the policy
    pins them (with ``on_overflow='truncate'``), and 'auto' picks the
    band or general kernel on the device (``sp.spgemm``'s 'select').
    The chunked solver driver (``solvers/common.run_chunked``) runs its
    steps so and reads the largest fill once per chunk, so that a
    truncation is detected, never silent."""
    names = ("k_out", "on_overflow", "precision", "method", "defer",
             "verbose", "collect")
    prev = tuple(_policy_get(n) for n in names)
    for n, v in zip(names, (k_out, on_overflow, precision, method,
                            defer, verbose, collect)):
        setattr(_policy, n, v)
    try:
        yield
    finally:
        for n, v in zip(names, prev):
            setattr(_policy, n, v)
        if defer and not _policy_get("defer"):
            drain_deferred_checks()


# matmul calls, counted as the kernels' launches are (the counter group
# 'multiplies' of utils/trace.py, reset with reset_multiplies)
multiplies = tr.counter_group("multiplies", ("matmul",))


def reset_multiplies() -> None:
    tr.reset_counters("multiplies")


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
    vals = tr.read(torch.stack([p[0] for p in pend]))
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


__all__ = [
    "matmul", "increment", "scale", "trace", "dot",
    "norm", "grand_sum",
    "pairwise_multiply", "filter_small", "transpose", "conjugate",
    "diagonal_scale", "measure_asymmetry", "symmetrize",
    "similarity_transform", "column_sums", "gershgorin_bounds", "spmv",
    "spmm", "matrix_sigma", "load_balance", "capacity_policy", "fill_bound",
]


# ----------------------------------------------------------------------------
# SpGEMM
# ----------------------------------------------------------------------------

def _panels(a: PSMatrix, b: PSMatrix, blocks: bool = True):
    """(A's row panel [nbr, Pc * KA], its blocks, B's column panel
    [NB, KB], its blocks): A's tiles gathered over 'cols', side by side
    as the reference's (algebra.py:195-198), B's over 'rows', stacked.
    Without ``blocks`` only the col ids are gathered (None for the
    blocks)."""
    g = a.grid
    agc, agb = a.col_ids[0], a.blocks[0] if blocks else None
    bgc, bgb = b.col_ids[0], b.blocks[0] if blocks else None
    if g.cols > 1:
        cols = g.group("cols")
        agc = torch.stack(cols.all_gather(agc), 1).reshape(a.nbr, -1)
        if blocks:
            agb = torch.stack(cols.all_gather(agb), 1).reshape(
                a.nbr, g.cols * a.k, a.bs, a.bs)
    if g.rows > 1:
        rows = g.group("rows")
        bgc = torch.cat(rows.all_gather(bgc))
        if blocks:
            bgb = torch.cat(rows.all_gather(bgb))
    return agc, agb, bgc, bgb


def _gather_slices(g, cc, cb):
    """Every slice's [nbr, k] product side by side -> [nbr, S * k]."""
    sl = g.group("slices")
    nbr, k, bs = cc.shape[0], cc.shape[1], cb.shape[-1]
    gc = torch.stack(sl.all_gather(cc), 1).reshape(nbr, g.slices * k)
    gb = torch.stack(sl.all_gather(cb), 1).reshape(
        nbr, g.slices * k, bs, bs)
    return gc, gb


def _summa(a: PSMatrix, b: PSMatrix, alpha, threshold, *, k_out: int,
           method: str, want_fill: bool, precision: str,
           select: bool = False):
    """The 3D SUMMA (reference ``_summa``, algebra.py:183-279): returns
    this rank's (cc, cb) and stats = [structural fill, max used slot],
    the max over the grid, as one device tensor.  ``select``: the
    kernels' 'auto' choice is made on the device (``sp.spgemm``'s
    'select'), with no host read."""
    g = a.grid
    S = g.slices
    wt = threshold / (S * 1000.0) if S > 1 else threshold
    agc, agb, bgc, bgb = _panels(a, b)
    dev = agc.device
    if want_fill:
        with tr.span("ntp.structure"):
            fill = sp.structural_fill(agc, bgc).amax()
    else:
        fill = torch.zeros((), dtype=torch.int32, device=dev)
    if S > 1:
        keep = (agc != EMPTY) & (agc % S == g.my_slice)
        agc = torch.where(keep, agc, EMPTY)
        agb = agb * keep[..., None, None].to(agb.dtype)
    c0 = a.col_offset
    # FULL-SPAN band multiply: the band kernel's contiguous output window
    # cannot express a top-k_out-by-rank truncation, so when the capacity
    # is below the product span (ka + kb - 1) the kernel runs at the full
    # span, the threshold flush empties the decayed tails, and the
    # compact (``ops/compact.py``: one kernel pass on the card,
    # bell.compact elsewhere) re-bases to k_out.  The fill stat then
    # reports the filtered need (surviving slots).
    band = method == "pallas_band"
    compacted = False
    if method in XLA_TIERS:
        cc, cb = _xla_tier(method, agc, agb, bgc, bgb, alpha, wt,
                           k_out=k_out, nbc_out=a.panel_nb, col_offset=c0)
    else:
        k_run = k_out
        if band:
            k_run = max(k_out, min(a.panel_nb,
                                   agc.shape[-1] + bgc.shape[-1] - 1))
        cc, cb, bucnt = sp.spgemm(agc, agb, bgc, bgb, k_out=k_run,
                                  threshold=wt, alpha=alpha,
                                  precision=precision,
                                  band_mode="force" if band else
                                  "select" if select else "auto")
        if band and k_run > k_out:
            with tr.span("ntp.compact", timed=True):
                bad = bucnt.amax() >= EMPTY
                cnt = (cc != EMPTY).sum(dim=-1).amax().to(torch.int32)
                cc, cb = cmp.slot_compact(cc, cb, k_out)
                fill = torch.where(bad, torch.full((), EMPTY,
                                                   dtype=torch.int32,
                                                   device=dev), cnt)
            compacted = True
        elif band:
            fill = torch.maximum(fill, bucnt.amax())
    if S > 1:
        gc, gb = _gather_slices(g, cc, cb)
        with tr.span("ntp.compact", timed=True):
            if compacted:
                # the merged need, not each slice's filtered count:
                # slices that each fit k_out can overflow it together.
                # One merge at full width; a slot is its id's rank, so
                # its first k_out slots are the merge at k_out
                mc, mb = bell.merge(gc, gb, gc.shape[-1], threshold)
                merged = (mc != EMPTY).sum(dim=-1).amax().to(torch.int32)
                fill = torch.where(fill >= EMPTY, fill,
                                   torch.maximum(fill, merged))
                cc = mc[..., :k_out].contiguous()
                cb = mb[..., :k_out, :, :].contiguous()
            else:
                cc, cb = bell.merge(gc, gb, k_out, threshold)
    stats = torch.stack([fill.to(torch.int32),
                         bell.used_slots(cc).amax().to(torch.int32)])
    return cc[None], cb[None], g.group("all").max(stats)


# the reference's XLA tiers, plain torch here (``core/bell.py``)
XLA_TIERS = ("acc", "cand", "dense")
METHODS = ("pallas", "pallas_band") + XLA_TIERS


def _xla_tier(method, agc, agb, bgc, bgb, alpha, threshold, *, k_out,
              nbc_out, col_offset):
    if method == "dense":
        return bell.spgemm_dense(agc, agb, bgc, bgb, col_offset=col_offset,
                                 nbc_out=nbc_out, k_out=k_out,
                                 nbk=bgc.shape[0], threshold=threshold,
                                 alpha=alpha)
    if method == "cand":
        return bell.spgemm_candidates(agc, agb, bgc, bgb,
                                      col_offset=col_offset, k_out=k_out,
                                      threshold=threshold, alpha=alpha)
    return bell.spgemm(agc, agb, bgc, bgb, col_offset=col_offset,
                       nbc_out=nbc_out, k_out=k_out, threshold=threshold,
                       alpha=alpha)


def fill_bound(a: PSMatrix, b: PSMatrix) -> int:
    """Exact structural capacity A @ B needs: the largest fill of any
    row of the product over the grid (one host read; collective)."""
    agc, _, bgc, _ = _panels(a, b, blocks=False)
    fill = sp.structural_fill(agc, bgc).amax().reshape(1)
    return int(tr.read(a.grid.group("all").max(fill))[0])


def _k_bucket(n: int, cap: int) -> int:
    """Round capacity up to a multiple of 4 to bound shape variety."""
    return min(-(-max(n, 1) // 4) * 4, cap)


def _pick_method(a: PSMatrix, b: PSMatrix, k_out: int) -> str:
    """The kernel tier whenever the kernels take the dtype and block
    size (on a CUDA device they launch; on the CPU their plain versions
    run).  Other shapes take the reference's arms for the shapes its
    kernels refuse (reference parallel/algebra.py ``_pick_method``):
    'dense' at 90% block occupancy, 'cand' while a row's candidates
    stay within max(64, 8 k_out), else 'acc'."""
    if _cuda.eligible(torch.promote_types(a.dtype, b.dtype), a.bs):
        return "pallas"
    if min(a.k, b.k) >= 0.9 * a.nb:
        return "dense"
    n_cand = a.grid.cols * a.k * b.k
    return "cand" if n_cand <= max(64, 8 * k_out) else "acc"


@tr.spanned("ntp.matmul", timed=True)
def matmul(a: PSMatrix, b: PSMatrix, alpha=1.0, threshold=0.0,
           k_out: int | None = None, method: str = "auto",
           on_overflow: str | None = None,
           precision: str | None = None, *, beta=0.0,
           c: PSMatrix | None = None) -> PSMatrix:
    """alpha * A @ B + beta * C, threshold-filtered.

    ``beta`` and ``c`` are keyword-only here (the reference takes them
    positionally after ``alpha``): given ``c``, the product is added to
    beta * C by :func:`increment` at the same threshold.  The kernels
    are real: complex operands raise, and complex data is multiplied
    as its 2 x 2 real embedding (``core/cplx.py``).

    method: 'pallas' (the kernels: band or general, chosen per call),
    'pallas_band' (band kernel only, full span + compact; a violated
    band assumption raises), 'acc', 'cand' and 'dense' (the
    reference's XLA tiers in plain torch, ``core/bell.py``: for the
    dtypes and block sizes the kernels do not take), 'auto' (the
    policy's method, else :func:`_pick_method`).

    on_overflow: 'grow' (default) re-runs with enough capacity when the
    structural fill exceeds k_out, and trims unused capacity; 'warn'
    keeps the capacity and warns (deferred under a deferring policy);
    'truncate'/'ignore' keep it silently.  Overflowing rows keep the
    lowest col ids.
    """
    if not (a.grid == b.grid and a.nb == b.nb and a.bs == b.bs):
        raise ValueError("matmul operands differ in grid or geometry")
    if a.dtype.is_complex or b.dtype.is_complex:
        raise ComplexSupportError(
            "matmul of complex operands: the kernels are real; multiply "
            "the 2 x 2 real embedding instead (core/cplx.embed, and "
            "cplx.extract for the result), as the JAX package does on "
            "the TPU")
    multiplies["matmul"] += 1
    cap = a.panel_nb
    k_out = min(k_out or _policy_get("k_out") or max(a.k, b.k), cap)
    on_overflow = on_overflow or _policy_get("on_overflow") or "grow"
    precision = precision or _policy_get("precision") or "high"
    collector = _policy_get("collect")
    requested = method
    grow = on_overflow == "grow"
    while True:
        if requested == "auto":
            method = _policy_get("method") or _pick_method(a, b, k_out)
        if method not in METHODS:
            raise ValueError(f"matmul method {method!r} not in {METHODS}")
        band = method == "pallas_band"
        # as in the reference, eager 'warn' without the band method
        # does not measure the structural fill (ROADMAP Queue C)
        chunk = collector is not None
        cc, cb, stats = _summa(a, b, alpha, threshold, k_out=k_out,
                               method=method,
                               want_fill=grow or band or chunk,
                               precision=precision, select=chunk)
        if chunk:
            collector.append(stats[0])        # no host read in a chunk
            break
        growing = grow and k_out < cap
        if not growing and not band and on_overflow != "warn":
            break                         # nothing reads the stats
        if not growing and _policy_get("defer"):
            _defer_check(stats[0],
                         k_out if on_overflow == "warn" else None,
                         "matmul", band)
            break
        need, used = tr.read(stats)       # ONE host sync per multiply
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
        tr.counts["matmul.regrows"] += 1
        if _policy_get("verbose") and _policy_get("k_out"):
            logger.write_comment(f"capacity regrown to {k_out} (fill "
                                 f"{need})")
    out = PSMatrix(cc, cb, a.dim, a.bs, a.grid)
    if c is not None:
        out = increment(c, out, alpha=beta, beta=1.0, threshold=threshold)
    return out


# ----------------------------------------------------------------------------
# slot-wise ops and reductions
# ----------------------------------------------------------------------------

def _increment_n(mats, coeffs, threshold, k_out: int):
    cc, cb, stats = mrg.slot_add_n([m.col_ids for m in mats],
                                   [m.blocks for m in mats], coeffs,
                                   threshold=threshold, k_out=k_out)
    a = mats[0]
    return (PSMatrix(cc, cb, a.dim, a.bs, a.grid),
            a.grid.group("all").max(stats))


def increment(a: PSMatrix, b: PSMatrix, alpha=1.0, beta=1.0, threshold=0.0,
              k_out: int | None = None,
              on_overflow: str | None = None) -> PSMatrix:
    """alpha*A + beta*B (see :func:`increment_n`)."""
    return increment_n((a, b), (alpha, beta), threshold=threshold,
                       k_out=k_out, on_overflow=on_overflow)


@tr.spanned("ntp.increment", timed=True)
def increment_n(mats, coeffs, threshold=0.0, k_out: int | None = None,
                on_overflow: str | None = None) -> PSMatrix:
    """sum_i coeffs[i] * M_i in ONE fused k-way merge; a coefficient may
    be a 0-d tensor on the device.  Capacity policy as :func:`matmul`:
    'grow' reads the fill back (regrow + trim), 'warn' warns (deferred
    under a deferring policy), 'truncate'/'ignore' never sync, and a
    collecting policy takes the fill as a device scalar."""
    mats = tuple(mats)
    cap = mats[0].panel_nb
    k = min(k_out or _policy_get("k_out") or max(m.k for m in mats), cap)
    on_overflow = on_overflow or _policy_get("on_overflow") or "grow"
    collector = _policy_get("collect")
    while True:
        out, stats = _increment_n(mats, tuple(coeffs), threshold, k)
        if collector is not None:
            collector.append(stats[0])
            return out
        if on_overflow in ("truncate", "ignore"):
            return out
        if on_overflow == "warn":
            if _policy_get("defer"):
                _defer_check(stats[0], k, "increment")
                return out
            need = int(tr.read(stats[0]))
            if need > k:
                warnings.warn(f"increment: structural fill {need} "
                              f"exceeds capacity {k} — result truncated")
            return out
        need, ue = tr.read(stats)         # ONE sync ('grow')
        if k >= cap or need <= k:
            k_eff = _k_bucket(ue, cap)
            if k_eff < out.k:
                out = out.with_data(out.col_ids[..., :k_eff],
                                    out.blocks[..., :k_eff, :, :])
            return out
        k = _k_bucket(need, cap)


def scale(a: PSMatrix, c) -> PSMatrix:
    """c * A; ``c`` a number or a 0-d tensor on A's device."""
    return a.with_data(a.col_ids,
                       a.blocks * torch.as_tensor(c, dtype=a.dtype))


def _sum(a: PSMatrix, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the rows x cols ranks of a's slice, added
    in rank order (the same bits on every rank)."""
    plane = a.grid.group("plane")
    if plane.size == 1:
        return x
    return plane.sum_ordered(x.reshape(1)).reshape(x.shape)


def _sum_pair(a: PSMatrix, p: torch.Tensor) -> torch.Tensor:
    """(hi, lo) pairs of the rows x cols ranks combined in rank order by
    two-sums, so that the pair keeps resolving the total to ~eps^2 and
    every rank holds the same bits."""
    plane = a.grid.group("plane")
    if plane.size == 1:
        return p
    parts = plane.all_gather(p)
    hi, lo = parts[0][0], parts[0][1]
    for q in parts[1:]:
        s = hi + q[0]
        t = s - hi
        err = (hi - (s - t)) + (q[0] - t)
        hi, lo = s, lo + q[1] + err
    return torch.stack([hi, lo])


def _local_trace(a: PSMatrix, compensated: bool) -> torch.Tensor:
    return red.slot_trace(a.col_ids, a.blocks, a.row_offset,
                          compensated=compensated)


def _local_dot(a: PSMatrix, b: PSMatrix, compensated: bool) -> torch.Tensor:
    return red.slot_dot(a.col_ids, a.blocks, b.col_ids, b.blocks,
                        compensated=compensated)


@tr.spanned("ntp.reduce", timed=True)
def trace(a: PSMatrix) -> torch.Tensor:
    """Matrix trace (0-d tensor on the device, float64 where the kernel
    computes it; collective)."""
    return _sum(a, _local_trace(a, False))


@tr.spanned("ntp.reduce", timed=True)
def dot(a: PSMatrix, b: PSMatrix) -> torch.Tensor:
    """sum_ij conj(A_ij) B_ij (0-d tensor on the device, float64 where
    the kernel computes it; collective)."""
    return _sum(a, _local_dot(a, b, False))


@tr.spanned("ntp.reduce", timed=True)
def grand_sum(a: PSMatrix) -> torch.Tensor:
    """The sum of every stored value (0-d tensor; collective)."""
    return _sum(a, bell.grand_sum(a.blocks))


@tr.spanned("ntp.reduce", timed=True)
def trace_pair(a: PSMatrix) -> torch.Tensor:
    """Compensated trace -> [2] (hi, lo)."""
    return _sum_pair(a, _local_trace(a, True))


@tr.spanned("ntp.reduce", timed=True)
def dot_pair(a: PSMatrix, b: PSMatrix) -> torch.Tensor:
    """Compensated dot -> [2] (hi, lo), resolving the sum to ~n*eps^2."""
    return _sum_pair(a, _local_dot(a, b, True))


def pairwise_multiply(a: PSMatrix, b: PSMatrix) -> PSMatrix:
    """Hadamard product on A's slots, compacted at A's capacity."""
    prod = bell.align_mul(a.col_ids, a.blocks, b.col_ids, b.blocks)
    cc, cb = bell.compact(a.col_ids, prod, min(max(a.k, 1), a.panel_nb))
    return PSMatrix(cc, cb, a.dim, a.bs, a.grid)


def conjugate(a: PSMatrix) -> PSMatrix:
    return a.conjugate()


def diagonal_scale(a: PSMatrix, dvals, side: str = "right") -> PSMatrix:
    """Scale columns ('right': A diag(d)) or rows ('left': diag(d) A) by
    ``dvals`` (numpy or a tensor over the whole dimension, zero-padded
    to the logical dimension), on A's device."""
    d = torch.as_tensor(dvals).to(device=a.device, dtype=a.dtype)
    d = torch.nn.functional.pad(d, (0, a.logical_dim - d.shape[0]))
    d = d.reshape(a.nb, a.bs)
    if side == "right":
        b = bell.diagonal_scale(a.col_ids, a.blocks, dvec_cols=d)
    else:
        d = d[a.row_offset:a.row_offset + a.nbr]
        b = bell.diagonal_scale(a.col_ids, a.blocks, dvec_rows=d)
    return a.with_data(a.col_ids, b)


def host_pair(p) -> float:
    """(hi, lo) pair -> float64 on the host (one readback)."""
    hi, lo = (float(v) for v in tr.read(p.double()))
    return hi + lo


def _rows_sum(a: PSMatrix, x: torch.Tensor, over: str, along: str):
    """Sum ``x`` over the group ``over`` (in rank order), then gather
    it along ``along`` into one replicated tensor."""
    g = a.grid
    if g.group(over).size > 1:
        x = g.group(over).sum_ordered(x)
    if g.group(along).size > 1:
        x = torch.cat(g.group(along).all_gather(x))
    return x


def column_sums(a: PSMatrix) -> torch.Tensor:
    """Per-column sums of |v| -> [logical_dim], the same on every rank
    (collective)."""
    cols = a.col_ids[0]
    if a.col_offset:
        cols = torch.where(cols != EMPTY, cols - a.col_offset, EMPTY)
    cs = bell.col_abs_sums(cols, a.blocks[0], a.panel_nb)
    return _rows_sum(a, cs, "rows", "cols").reshape(a.logical_dim)


def diagonal_values(a: PSMatrix) -> torch.Tensor:
    """The matrix diagonal -> [logical_dim], the same on every rank
    (collective)."""
    d = bell.trace_blocks(a.col_ids, a.blocks, a.row_offset).sum(dim=0)
    d = torch.diagonal(d, dim1=-2, dim2=-1).reshape(-1)     # [nbr * bs]
    return _rows_sum(a, d, "cols", "rows")


@tr.spanned("ntp.reduce", timed=True)
def gershgorin_bounds(a: PSMatrix):
    """Spectral bounds (lo, hi) as 0-d tensors: min/max over columns of
    center -/+ radius.  Padded columns contribute [0, 0]."""
    cs = column_sums(a)
    d = diagonal_values(a)
    radius = cs - d.abs()
    return (d - radius).amin(), (d + radius).amax()


def spmv(a: PSMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a dense vector x[logical_dim], in A's dtype."""
    return spmm(a, x[:, None])[:, 0]


def spmm(a: PSMatrix, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a dense block of vectors X[logical_dim, m], the
    same on every rank: one (bs, bs) x (bs, m) product per slot, EMPTY
    slots masked, summed over the slots in A's dtype (full precision:
    TF32 is off), then over the panels (an ordered sum over 'cols') and
    gathered over 'rows' (collective)."""
    m = x.shape[-1]
    xb = x.to(a.dtype).reshape(a.nb, a.bs, m)
    valid = a.col_ids != EMPTY
    loc = torch.where(valid, a.col_ids, 0).long()
    xg = xb[loc] * valid[..., None, None].to(a.dtype)   # [1,NBR,K,bs,m]
    y = torch.einsum("prkij,prkjm->rim", a.blocks, xg)
    y = y.reshape(a.nbr * a.bs, m)
    return _rows_sum(a, y, "cols", "rows")


def matrix_sigma(a: PSMatrix) -> torch.Tensor:
    """Ozaki's sigma for the Hotelling start, 1 / (max column sum)^2
    (0-d tensor on the device)."""
    return 1.0 / column_sums(a).amax() ** 2


def is_identity(a: PSMatrix) -> bool:
    """Exact identity check: one pass and one scalar readback."""
    pc, nbr, k = a.col_ids.shape
    bs = a.bs
    dev = a.device
    rows = (torch.arange(nbr, device=dev) + a.row_offset)[None, :, None]
    eye = torch.eye(bs, dtype=a.dtype, device=dev)
    gi = rows[..., None, None] * bs + torch.arange(bs, device=dev)[:, None]
    want = torch.where((a.col_ids == rows)[..., None, None] & (gi < a.dim),
                       eye, 0)
    return tr.read(_sum(a, (a.blocks - want).abs().sum())) == 0.0


# ----------------------------------------------------------------------------
# transpose, norm and the two-sided products
# ----------------------------------------------------------------------------

def filter_small(a: PSMatrix, threshold) -> PSMatrix:
    """Drop |v| <= threshold, re-packed at the same capacity."""
    cc, cb = bell.filter_small(a.col_ids, a.blocks, threshold)
    return a.with_data(cc, cb)


def _transposed_coo(a: PSMatrix):
    """A^T's blocks as block-COO on their owners (each slice within its
    own rows x cols ranks, one all-to-all): (local rows, cols, blocks),
    and the largest fill of any output row as a device scalar."""
    rows, cols, blocks, valid = bell.to_block_coo(
        a.col_ids[0], bell.transpose_blocks(a.blocks[0]),
        row_offset=a.row_offset)
    idx = torch.nonzero(valid).reshape(-1)
    new_r, new_c, blocks = cols[idx], rows[idx], blocks[idx]
    g = a.grid
    plane = g.group("plane")
    if plane.size > 1:
        dest = ((new_r // a.nbr) * g.cols + new_c // a.panel_nb).long()
        order = torch.argsort(dest, stable=True)
        counts = tr.read(torch.bincount(dest, minlength=plane.size))
        ij = plane.all_to_all_v(torch.stack([new_r, new_c], -1)[order],
                                counts)
        bl = blocks[order]
        cplx = bl.is_complex()
        bl = plane.all_to_all_v(torch.view_as_real(bl) if cplx else bl,
                                counts)
        blocks = torch.view_as_complex(bl.contiguous()) if cplx else bl
        new_r, new_c = ij[:, 0], ij[:, 1]
    new_r = new_r - a.row_offset
    counts = torch.zeros(a.nbr, dtype=torch.int32, device=a.device)
    counts.index_put_((new_r.long(),), torch.ones_like(new_r),
                      accumulate=True)
    return new_r, new_c, blocks, counts.amax()


def transpose(a: PSMatrix, k_out: int | None = None,
              on_overflow: str | None = None) -> PSMatrix:
    """A^T by a block-COO flip, an exchange to the new owners and a
    rebuild; a row of A^T can need more slots than A has, and 'grow'
    (the default) builds it at the fill it needs.  Other policies keep
    the capacity, and overflowing rows keep their lowest col ids."""
    cap = a.panel_nb
    k = min(k_out or _policy_get("k_out") or a.k, cap)
    on_overflow = on_overflow or _policy_get("on_overflow") or "grow"
    rows, cols, blocks, fill = _transposed_coo(a)
    if on_overflow == "grow" and k < cap:
        need = int(tr.read(a.grid.group("all").max(fill.reshape(1)))[0])
        if need > k:
            k = _k_bucket(need, cap)
    oc, ob = bell.from_block_coo(rows, cols, blocks,
                                 torch.ones_like(rows, dtype=torch.bool),
                                 nbr=a.nbr, k=k)
    return a.with_data(oc, ob)


def norm(a: PSMatrix) -> torch.Tensor:
    """The max column 1-norm (0-d tensor on the device)."""
    return column_sums(a).amax()


def measure_asymmetry(a: PSMatrix) -> torch.Tensor:
    """norm(A - A^T), the max column 1-norm (0-d tensor)."""
    return norm(increment(transpose(a), a, alpha=-1.0, beta=1.0))


def symmetrize(a: PSMatrix) -> PSMatrix:
    """(A + A^T) / 2."""
    return increment(scale(a, 0.5), transpose(scale(a, 0.5)))


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
