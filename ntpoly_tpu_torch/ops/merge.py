"""The k-way merge of block-ELL operands: sum_i coeffs[i] * M_i to k_out
slots, the increment of the algebra.

``slot_add_n(cols_list, blocks_list, coeffs, threshold, k_out)`` returns
what ``core/bell.py``'s ``add_n`` returns (the candidates every
operand's slots side by side; output slot j the j-th smallest distinct
non-EMPTY id, the lowest k_out kept on overflow; each block the sum of
the coefficient, rounded to the result dtype, times each candidate
block of its id; entries with -threshold <= v <= threshold flushed to
+0; a slot whose flushed block has no L1 norm > 0 EMPTY in place), and
the int32[2] stats that ``increment_n`` reads: the largest structural
fill of a row (``union_fill_n``) and its highest used slot count
(``used_slots``).

On CUDA blocks whose result dtype (the operands' promoted dtype, as
``add_n`` computes in) and block size the kernels take (``_cuda.takes``:
real float32/float64, bs a multiple of 8 up to 128) it launches
``csrc/merge.cu``: one pass that reads each contributing block once and
writes each output block once, with the stats, and no host read.  It
departs from the plain version in two ways only.  Sum order: a slot with
one contribution has the plain version's bits; where two or more
candidates carry one id the kernel sums them in candidate order, which
may differ from the plain one-hot product's order by the rounding of
the additions (so an entry within that rounding of the threshold, or a
block whose only entries are, may flush otherwise).  Non-finite values:
the plain product turns a non-finite candidate into NaN in every output
slot of its row (0 * inf); the kernel keeps it in its own slot.  On
that route an input the kernel cannot take is at fault and raises:
col ids that are not int32, operands on two devices or whose blocks do
not match their col ids or one another's rows, more than
``MAX_OPERANDS`` operands, a threshold that is not a real number,
k_out < 1, and a coefficient that is neither a real number nor a real
one-element tensor on the blocks' device.  Every other input, CPU
tensors, complex data and other dtypes and block sizes, takes the
plain version, ``bell.add_n``, with the stats from ``union_fill_n`` and
``used_slots``, as the slot reductions route (``ops/reduce.py``).  On
the card every merge of the port (``parallel/algebra.py``'s
``increment_n``: two or three operands, a float threshold,
coefficients that are numbers or device scalars) takes the kernel at
those dtypes and block sizes.

``merges`` counts the merges run on the card (the counter group
'merges' of ``utils/trace.py``; each is a memset and one kernel launch,
and the plain version counts nothing).
"""
from __future__ import annotations

import functools
import math
import numbers
from typing import Tuple

import torch

from ..config import EMPTY
from ..core.bell import _ranks, add_n, union_fill_n, used_slots
from ..utils import trace
from . import _cuda

Tensor = torch.Tensor

merges = trace.counter_group("merges", ("slot_add_n",))

# the operands one launch takes
MAX_OPERANDS = 4


def slot_add_n(cols_list, blocks_list, coeffs, threshold=0.0,
               k_out: int | None = None) -> Tuple[Tensor, Tensor, Tensor]:
    """sum_i coeffs[i] * M_i over [..., R, K_i] slots -> ([..., R, k_out]
    col ids, blocks, int32[2] (largest fill, largest used slot count)):
    the merge kernel (``csrc/merge.cu``) where ``_cuda.takes`` the result
    dtype and the blocks, else the plain version (``add_n``).  A
    coefficient may be a 0-d tensor on the device; k_out defaults to the
    widest operand."""
    cols_list, blocks_list = list(cols_list), list(blocks_list)
    coeffs = list(coeffs)
    if k_out is None:
        k_out = max(c.shape[-1] for c in cols_list)
    first = blocks_list[0]
    dt = functools.reduce(torch.promote_types,
                          (b.dtype for b in blocks_list))
    if not _cuda.takes(dt, first):
        cc, cb = add_n(cols_list, blocks_list, coeffs, threshold=threshold,
                       k_out=k_out)
        stats = torch.stack([union_fill_n(cols_list).amax(),
                             used_slots(cc).amax()])
        return cc, cb, stats
    values, at = _arguments(cols_list, blocks_list, coeffs, threshold,
                            k_out, dt)
    lead = tuple(cols_list[0].shape[:-1])
    bs = first.shape[-1]
    ops = _cuda.slot_operands(dt, *zip(cols_list, blocks_list))
    cols, blocks = ops[0::2], ops[1::2]
    rows = cols[0].shape[0]
    dev = first.device
    out_c = torch.empty((rows, k_out), dtype=torch.int32, device=dev)
    out_b = torch.empty((rows, k_out, bs, bs), dtype=dt, device=dev)
    stats = torch.empty((2,), dtype=torch.int32, device=dev)
    pad = [None] * (MAX_OPERANDS - len(cols))
    zero = [0] * (MAX_OPERANDS - len(cols))
    _cuda.launch("ntp_slot_add_n" + _cuda.SUFFIX[dt], merges, "slot_add_n",
                 (*cols, *pad, *blocks, *pad, *at, *pad, out_c, out_b,
                  stats),
                 (*[c.stride(0) for c in cols], *zero,
                  *[b.stride(0) for b in blocks], *zero,
                  *[c.shape[1] for c in cols], *zero, len(cols), rows,
                  k_out, bs),
                 (*values, *[0.0] * (MAX_OPERANDS - len(values)),
                  threshold))
    return (out_c.reshape(lead + (k_out,)),
            out_b.reshape(lead + (k_out, bs, bs)), stats)


def _arguments(cols_list, blocks_list, coeffs, threshold, k_out, dt):
    """The kernel's scalar arguments: (each coefficient as a float, 0.0
    where it is a tensor; each as the one-element tensor of ``dt`` on the
    blocks' device that the kernel reads, None where it is a number).  A
    merge the kernel cannot take raises."""
    n, dev = len(blocks_list), blocks_list[0].device
    if not 0 < n <= MAX_OPERANDS or len(cols_list) != n \
            or len(coeffs) != n:
        raise ValueError(f"the merge kernel takes 1 to {MAX_OPERANDS} "
                         f"operands, each with its col ids and a "
                         f"coefficient; got {n} blocks, {len(cols_list)} "
                         f"col ids, {len(coeffs)} coefficients")
    if not isinstance(threshold, numbers.Real):
        raise ValueError(f"the merge kernel takes a real number for the "
                         f"threshold, got {type(threshold).__name__}")
    if k_out < 1:
        raise ValueError(f"the merge kernel takes k_out >= 1, got {k_out}")
    values, at = [], []
    for a in coeffs:
        if isinstance(a, torch.Tensor):
            if a.device != dev or a.numel() != 1 or a.is_complex():
                raise ValueError(f"a coefficient tensor must be one real "
                                 f"element on {dev}, got {a.dtype} "
                                 f"{tuple(a.shape)} on {a.device}")
            values.append(0.0)
            at.append(a.reshape(()).to(dt))
        elif isinstance(a, numbers.Real):
            values.append(float(a))
            at.append(None)
        else:
            raise ValueError(f"a coefficient must be a real number or a "
                             f"tensor, got {type(a).__name__}")
    return values, at


def departures(cols_list, blocks_list, coeffs, threshold, k_out, got,
               want, ulps: int = 4):
    """Two merges of the same operands, ``got`` (the kernel's) and
    ``want`` (``add_n``'s), each (col ids, blocks), held to each other
    within the kernel's sum order -> (block rows where they part beyond
    it, block rows with a summed entry within ``ulps`` roundings of the
    threshold, the largest |got - want| entry: 0.0 where every bit
    agrees, inf where one alone is NaN).

    A slot of one contribution has the same bits in both.  An entry of a
    slot summed from two or more lies within ``ulps`` roundings (of its
    sum of |product|) of the float64 sum of the rounded products, or has
    ``want``'s bits, or lies that near the threshold itself; and the col
    ids agree but in rows with such an entry, where the two orders may
    flush a block otherwise.  The float64 sums are taken on the
    operands' device, about 256 MiB of candidates at a time."""
    dt, bs = want[1].dtype, want[1].shape[-1]
    rows = math.prod(cols_list[0].shape[:-1])
    cols = torch.cat([c.reshape(rows, -1) for c in cols_list], dim=-1)
    parts_of = [(b.reshape(rows, -1, bs, bs), torch.as_tensor(a, dtype=dt))
                for b, a in zip(blocks_list, coeffs)]
    gc, wc = (x[0].reshape(rows, k_out) for x in (got, want))
    gb, wb = (x[1].reshape(rows, k_out, bs, bs).contiguous()
              for x in (got, want))
    ints = torch.int32 if wb.element_size() == 4 else torch.int64
    tol = ulps * torch.finfo(dt).eps
    ko = torch.arange(k_out, device=cols.device)
    step = max(1, (256 << 20) // (cols.shape[-1] * bs * bs * 8))
    none = torch.zeros((0,), dtype=torch.long, device=cols.device)
    bad, near_rows, err = [none], [none], 0.0
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        c = cols[r0:r1]
        _, rank = _ranks(c)
        hot = ((c != EMPTY)[..., None] & (rank[..., None] == ko)).double()
        p = torch.cat([torch.mul(b[r0:r1].to(dt), a) for b, a in parts_of],
                      dim=1).double()
        exact = torch.einsum("rwk,rwxy->rkxy", hot, p)
        mag = torch.einsum("rwk,rwxy->rkxy", hot, p.abs())
        summed = (hot.sum(dim=1) > 1)[..., None, None]
        g, w = gb[r0:r1], wb[r0:r1]
        same = g.view(ints) == w.view(ints)
        near = summed & ((exact.abs() - threshold).abs() <= tol * mag)
        kept = (wc[r0:r1] != EMPTY)[..., None, None]
        close = (g.double() - torch.where(kept, exact, 0.0)).abs() \
            <= tol * mag
        ok = torch.where(summed, close | same | near, same)
        near_r = near.flatten(1).any(dim=-1)
        ok = ok.flatten(1).all(dim=-1) & (
            (gc[r0:r1] == wc[r0:r1]).all(dim=-1) | near_r)
        bad.append((~ok).nonzero().flatten() + r0)
        near_rows.append(near_r.nonzero().flatten() + r0)
        d = torch.where(same, 0.0, (g.double() - w.double()).abs())
        err = max(err, float(torch.nan_to_num(d, nan=math.inf).max()))
    return torch.cat(bad), torch.cat(near_rows), err
