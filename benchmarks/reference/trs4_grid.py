"""The plain reference of a TRS4 density solve, split over a world.

``trs4.py``'s solve holds whole bands; at 2^22 rows in float64 one band
of half-width 2 is 21.5 GB and the solve holds four or five of them, more
than a card has.  Here every rank of a ``torch.distributed`` world holds
one slab of block rows of each band (:class:`Split`): the slabs cut the
block rows into ``parts`` equal pieces, and ranks that share a part hold
the same slab and compute alike.  The mathematics is ``trs4.py``'s, step
for step; what differs is where the numbers live:

  * a product's block rows need the ``w`` block rows of its right
    operand beyond each edge of the slab: these halos come from the
    neighbouring slabs (an all-gather of every slab's edge rows) before
    each product and each matvec, zero beyond the matrix's edges;
  * a trace, a dot or a Lanczos inner product is the sum of the slabs'
    parts, each part counted once (from the first rank that holds it)
    and added in part order, so that every rank holds the same bits and
    takes the same branch;
  * the Gershgorin bounds are the min and max over the slabs;
  * :func:`gap_edges` draws the same start vector as ``trs4.py``'s (the
    whole vector from the same seed on the same device), each rank
    keeping its slab's rows.

Sums of the slabs' parts are added in another order than ``trs4.py``'s
one-process sums, so the two agree to rounding, not bit for bit.
Nothing here imports the measured program; its output is read only as
plain tensors (:func:`slab_from_ell`).  Without a world (one rank, one
part) every collective is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as tdist

from . import band as B
from . import trs4 as R


@dataclass(frozen=True)
class Split:
    """This rank's slab of a matrix of ``nb`` block rows: part ``part``
    of ``parts`` equal pieces.  ``layout`` gives every world rank's part,
    in rank order (a rank of the world is counted once per part, by the
    first rank that holds it)."""
    nb: int
    layout: tuple

    @property
    def parts(self) -> int:
        return max(self.layout) + 1

    @property
    def rank(self) -> int:
        return tdist.get_rank() if tdist.is_initialized() else 0

    @property
    def part(self) -> int:
        return self.layout[self.rank]

    @property
    def rows(self) -> int:                 # block rows of a slab
        return self.nb // self.parts

    @property
    def row0(self) -> int:
        return self.part * self.rows

    def counted(self) -> list[int]:
        """The world rank that counts each part, in part order."""
        return [self.layout.index(p) for p in range(self.parts)]


def split(nb: int, parts: int, ranks_per_part: int = 1) -> Split:
    """``parts`` slabs of ``nb`` block rows over a world of ``parts *
    ranks_per_part`` ranks, rank r holding part r // ranks_per_part."""
    if nb % parts:
        raise ValueError(f"{nb} block rows are not {parts} equal slabs")
    return Split(nb, tuple(r // ranks_per_part
                           for r in range(parts * ranks_per_part)))


# ----------------------------------------------------------------------------
# the world's collectives
# ----------------------------------------------------------------------------

def _gather(x: torch.Tensor) -> list:
    if not tdist.is_initialized() or tdist.get_world_size() == 1:
        return [x]
    out = [torch.empty_like(x) for _ in range(tdist.get_world_size())]
    tdist.all_gather(out, x.contiguous())
    return out


def sum_parts(sp: Split, x: torch.Tensor) -> torch.Tensor:
    """The slabs' parts of ``x`` (float64) added in part order."""
    parts = _gather(x.double())
    if len(parts) == 1:
        return parts[0]
    out = parts[sp.counted()[0]]
    for r in sp.counted()[1:]:
        out = out + parts[r]
    return out


def total(sp: Split, *values: float) -> list[float]:
    """Floats summed over the slabs (one gather for all of them)."""
    dev = _device()
    got = sum_parts(sp, torch.tensor(values, dtype=torch.float64,
                                     device=dev))
    return [float(v) for v in got.tolist()]


def world_sum(*values: float) -> list[float]:
    """Floats summed over every rank of the world, in rank order."""
    parts = _gather(torch.tensor(values, dtype=torch.float64,
                                 device=_device()))
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return [float(v) for v in out.tolist()]


def world_max(*values: float) -> list[float]:
    parts = _gather(torch.tensor(values, dtype=torch.float64,
                                 device=_device()))
    return [float(v) for v in torch.stack(parts).amax(0).tolist()]


def _device():
    """The device of the world's collectives: this rank's card where
    the backend carries CUDA tensors, else the host."""
    if (tdist.is_initialized() and torch.cuda.is_available()
            and "nccl" in str(tdist.get_backend())):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _on(x: torch.Tensor) -> torch.Tensor:
    return x.to(_device())


def halo(sp: Split, x: torch.Tensor, w: int, dim: int) -> tuple:
    """(top, bottom): the ``w`` rows (along ``dim``) of the slabs above
    and below this one, zero beyond the matrix."""
    edges = torch.stack([x.narrow(dim, 0, w),
                         x.narrow(dim, x.shape[dim] - w, w)])
    parts = _gather(_on(edges))
    first = sp.counted()
    zero = torch.zeros_like(edges[0])
    top = (parts[first[sp.part - 1]][1].to(x.device) if sp.part > 0
           else zero)
    bottom = (parts[first[sp.part + 1]][0].to(x.device)
              if sp.part + 1 < sp.parts else zero)
    return top, bottom


# ----------------------------------------------------------------------------
# slab algebra
# ----------------------------------------------------------------------------

def slab_from_values(fn, n: int, bs: int, w: int, halfwidth: int,
                     sp: Split, dtype=torch.float64,
                     device="cpu") -> torch.Tensor:
    """``band.from_values`` restricted to this rank's slab: block rows
    [row0, row0 + rows) of the band."""
    if n % bs or n // bs != sp.nb:
        raise ValueError(f"{n} rows are not {sp.nb} blocks of {bs}")
    m, row0 = sp.rows, sp.row0
    band = torch.zeros((2 * w + 1, m, bs, bs), dtype=dtype, device=device)
    ar = torch.arange(bs, device=device)
    for lo in range(0, m, B.ROWS_PER_PIECE):
        hi = min(m, lo + B.ROWS_PER_PIECE)
        blk = torch.arange(row0 + lo, row0 + hi, device=device)
        gi = (blk * bs)[:, None, None] + ar[None, :, None]
        for o in range(-w, w + 1):
            gj = ((blk + o) * bs)[:, None, None] + ar[None, None, :]
            inside = ((gi - gj).abs() <= halfwidth) & (gj >= 0) & (gj < n)
            vals = fn(gi, gj.clamp(0, n - 1))
            band[w + o, lo:hi] = torch.where(inside, vals, 0).to(dtype)
    return band


def matmul(a: torch.Tensor, b: torch.Tensor, edges: tuple,
           operands=None) -> torch.Tensor:
    """``band.matmul`` on slabs: A's slab times B, B's rows beyond the
    slab's edges taken from ``edges`` (:func:`halo` of B), each block's
    products added in ``band.matmul``'s order."""
    top, bottom = edges
    if operands is not None:
        a, b = operands(a), operands(b)
        top, bottom = operands(top), operands(bottom)
    w = B.half_width(a)
    m = a.shape[1]
    c = torch.zeros_like(a)
    for e in range(-w, w + 1):
        lo, hi = max(0, -e), min(m, m - e)
        for f in range(-w, w + 1):
            d = e + f
            if abs(d) > w:
                continue
            out = c[w + d]
            out[lo:hi].baddbmm_(a[w + e, lo:hi], b[w + f, lo + e:hi + e])
            if e < 0:
                out[:lo].baddbmm_(a[w + e, :lo], top[w + f, w + e:])
            elif e > 0:
                out[hi:].baddbmm_(a[w + e, hi:], bottom[w + f, :e])
    return c


def matvec(a: torch.Tensor, v: torch.Tensor, edges: tuple) -> torch.Tensor:
    """``band.matvec`` on a slab, v's rows beyond the edges from
    ``edges`` (:func:`halo` of v)."""
    top, bottom = edges
    w = B.half_width(a)
    m = a.shape[1]
    y = torch.zeros_like(v)
    for o in range(-w, w + 1):
        lo, hi = max(0, -o), min(m, m - o)
        y[lo:hi] += torch.bmm(a[w + o, lo:hi],
                              v[lo + o:hi + o, :, None])[..., 0]
        if o < 0:
            y[:lo] += torch.bmm(a[w + o, :lo], top[w + o:, :, None])[..., 0]
        elif o > 0:
            y[hi:] += torch.bmm(a[w + o, hi:], bottom[:o, :, None])[..., 0]
    return y


def gershgorin(sp: Split, a: torch.Tensor) -> tuple[float, float]:
    lo, hi = B.gershgorin(a)
    neg_lo, top = world_max(-lo, hi)
    return -neg_lo, top


# ----------------------------------------------------------------------------
# the solve
# ----------------------------------------------------------------------------

def trs4(h: torch.Tensor, nel: float, sp: Split, *, dtype=torch.float64,
         operands=None, tol: float = 1e-12,
         max_iterations: int = 60) -> R.Solution:
    """``trs4.trs4`` of the Hamiltonian whose slab is ``h`` -> this
    rank's slab of the density, and the solve's scalars (the same on
    every rank)."""
    h = h.to(dtype)
    w = B.half_width(h)
    m, bs = h.shape[1], h.shape[2]
    e_min, e_max = gershgorin(sp, h)
    span = e_max - e_min
    x = B.identity(m, bs, w, dtype, h.device).mul_(e_max / span)
    x.sub_(h, alpha=1.0 / span)
    sigmas = []
    last = float("inf")
    idem = last
    n = 0
    for n in range(1, max_iterations + 1):
        x2 = matmul(x, x, halo(sp, x, w, 1), operands)
        d1, d2, t2, tx = total(sp, B.dot(x2, x), B.dot(x2, x2),
                               B.trace(x2), B.trace(x))
        trace_fx = 4.0 * d1 - 3.0 * d2
        trace_gx = t2 - 2.0 * d1 + d2
        if abs(trace_gx) < 1e-14:
            sigma = 0.5 * (R.SIGMA_MAX - R.SIGMA_MIN)
        else:
            sigma = (nel - trace_fx) / trace_gx
        sigmas.append(sigma)
        if sigma > R.SIGMA_MAX:
            x = x.mul_(2.0).sub_(x2)
        elif sigma < R.SIGMA_MIN:
            x = x2
        else:
            poly = x2.mul(sigma - 3.0).add_(x, alpha=4.0 - 2.0 * sigma)
            poly[w].diagonal(dim1=-2, dim2=-1).add_(sigma)
            del x
            x = matmul(x2, poly, halo(sp, poly, w, 1), operands)
            del poly
        del x2
        idem = abs(tx - t2) / nel
        if idem < tol or (idem >= last and last < 1e-6):
            break
        last = idem
    energy, = total(sp, B.dot(x, h))
    mu = R.chemical_potential(sigmas, e_min, e_max)
    return R.Solution(x, energy, mu, n, idem)


def _top_ritz(sp: Split, op, v: torch.Tensor, steps: int) -> float:
    """``trs4._top_ritz`` with every inner product summed over the
    slabs."""
    basis = torch.zeros((steps,) + tuple(v.shape), dtype=v.dtype,
                        device=v.device)
    flat = basis.view(steps, -1)
    alphas, betas = [], []
    q = v / total(sp, float((v * v).sum()))[0] ** 0.5
    for j in range(steps):
        basis[j] = q
        z = op(q)
        alphas.append(total(sp, float((q * z).sum()))[0])
        for _ in range(2):
            coef = sum_parts(sp, _on(flat[:j + 1] @ z.reshape(-1)))
            z -= (flat[:j + 1].T @ coef.to(z.device, z.dtype)).view_as(z)
        beta = total(sp, float((z * z).sum()))[0] ** 0.5
        if j + 1 == steps or beta <= 1e-10 * abs(alphas[-1]):
            break
        betas.append(beta)
        q = z / beta
    t = torch.diag(torch.tensor(alphas, dtype=torch.float64))
    if betas:
        off = torch.tensor(betas, dtype=torch.float64)
        t += torch.diag(off, 1) + torch.diag(off, -1)
    return float(torch.linalg.eigvalsh(t).max())


def gap_edges(sp: Split, h: torch.Tensor, k: torch.Tensor,
              steps: int = R.EDGE_STEPS, seed: int = 0) -> tuple[float,
                                                               float]:
    """``trs4.gap_edges`` from this rank's slabs of H and K."""
    w = B.half_width(h)
    e_min, e_max = gershgorin(sp, h)
    gen = torch.Generator(device=h.device)
    gen.manual_seed(seed)
    r = torch.randn((sp.nb, h.shape[2]), generator=gen, dtype=h.dtype,
                    device=h.device)[sp.row0:sp.row0 + sp.rows]

    def mv(a, v):
        return matvec(a, v, halo(sp, v, w, 0))

    def occupied(v):
        v = mv(k, v)
        return mv(k, mv(h, v) - e_min * v)

    def empty(v):
        v = v - mv(k, v)
        u = e_max * v - mv(h, v)
        return u - mv(k, u)

    homo = e_min + _top_ritz(sp, occupied, mv(k, r), steps)
    lumo = e_max - _top_ritz(sp, empty, r - mv(k, r), steps)
    return homo, lumo


# ----------------------------------------------------------------------------
# reading the program's tile
# ----------------------------------------------------------------------------

def slab_from_ell(col_ids: torch.Tensor, blocks: torch.Tensor, w: int,
                  sp: Split, device, dtype=torch.float64
                  ) -> tuple[torch.Tensor, float]:
    """``band.from_ell`` for block rows [row0, row0 + rows) held as
    block-ELL with global col ids (``col_ids[rows, k]``, a slot whose id
    is not in [0, nb) unused; ``blocks`` may lie on another device:
    they are moved one slot at a time) -> this slab's band of half-width
    ``w`` on ``device`` and the squared Frobenius norm of the blocks
    outside it."""
    m, k, bs, _ = blocks.shape
    band = torch.zeros((2 * w + 1, m, bs, bs), dtype=dtype, device=device)
    flat = band.view(-1, bs, bs)
    rows = torch.arange(m, device=device) + sp.row0
    outside = 0.0
    for s in range(k):
        cols = col_ids[:, s].to(device).long()
        used = (cols >= 0) & (cols < sp.nb)
        off = cols - rows
        near = used & (off.abs() <= w)
        far = used & ~near
        slot = blocks[:, s].to(device)
        if bool(far.any()):
            outside += float(slot[far].double().pow(2).sum())
        idx = ((off + w) * m + rows - sp.row0)[near]
        flat.index_add_(0, idx, slot[near].to(dtype))
        del slot
    return band, outside


def slab_to_ell(band: torch.Tensor, sp: Split, col_lo: int, col_hi: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(col_ids[rows, 2w + 1], blocks) of a slab's band, with global col
    ids, the slots of blocks outside block columns [col_lo, col_hi) or
    outside the matrix given the id -1."""
    w = B.half_width(band)
    m = band.shape[1]
    rows = torch.arange(m, device=band.device)[:, None] + sp.row0
    cols = rows + torch.arange(-w, w + 1, device=band.device)[None, :]
    keep = (cols >= max(0, col_lo)) & (cols < min(sp.nb, col_hi))
    return (torch.where(keep, cols, -1).to(torch.int32),
            band.transpose(0, 1).contiguous())


def panel_difference(got: torch.Tensor, ref: torch.Tensor, sp: Split,
                     col_lo: int, col_hi: int) -> tuple[float, float]:
    """(||got - ref||_F^2, ||ref||_F^2) over the blocks of this slab that
    lie in block columns [col_lo, col_hi): ``got`` a slab's band holding
    only such blocks, overwritten."""
    w = B.half_width(ref)
    m = ref.shape[1]
    norm = 0.0
    for o in range(-w, w + 1):
        # block row i of the slab meets column row0 + i + o
        lo = max(0, col_lo - sp.row0 - o)
        hi = min(m, col_hi - sp.row0 - o)
        if lo >= hi:
            continue
        part = ref[w + o, lo:hi]
        got[w + o, lo:hi].sub_(part.to(got.dtype))
        norm += float(part.double().pow(2).sum())
    return B.dot(got, got), norm
