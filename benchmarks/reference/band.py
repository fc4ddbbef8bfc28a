"""Block-band matrices in plain PyTorch: the reference's own storage.

A matrix of ``n = nb * bs`` rows whose blocks lie within ``w`` block
diagonals of the main one is held as ``band[2w + 1, nb, bs, bs]``:
``band[w + o, i]`` is block (i, i + o).  Blocks that fall outside the
matrix are zero and stay zero under every operation here.  A product
keeps the blocks within ``w`` diagonals and drops the rest: the
matrices the reference forms (functions of a gapped, banded
Hamiltonian) decay exponentially away from the diagonal, and the
tests hold a product and a density against dense ones.

Nothing here imports the measured program: the program's output is
read only as plain tensors (``from_ell``).
"""
from __future__ import annotations

import torch

# block rows per piece when a whole-matrix pass would need a temporary
# as large as the matrix
ROWS_PER_PIECE = 512


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits: the operands of a TF32 product."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


def half_width(band: torch.Tensor) -> int:
    return (band.shape[0] - 1) // 2


def _chunks(nb: int):
    for lo in range(0, nb, ROWS_PER_PIECE):
        yield lo, min(nb, lo + ROWS_PER_PIECE)


def from_values(fn, n: int, bs: int, w: int, halfwidth: int,
                dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The band of entry values ``fn(i, j)`` for |i - j| <= halfwidth
    (zero elsewhere), ``fn`` an elementwise function of int64 index
    tensors that broadcast, its values converted to ``dtype``."""
    if n % bs:
        raise ValueError(f"{n} rows are not whole blocks of {bs}")
    nb = n // bs
    band = torch.zeros((2 * w + 1, nb, bs, bs), dtype=dtype, device=device)
    ar = torch.arange(bs, device=device)
    for lo, hi in _chunks(nb):
        blk = torch.arange(lo, hi, device=device)
        gi = (blk * bs)[:, None, None] + ar[None, :, None]   # [m, bs, 1]
        for o in range(-w, w + 1):
            gj = ((blk + o) * bs)[:, None, None] + ar[None, None, :]
            inside = ((gi - gj).abs() <= halfwidth) & (gj >= 0) & (gj < n)
            vals = fn(gi, gj.clamp(0, n - 1))
            band[w + o, lo:hi] = torch.where(inside, vals, 0).to(dtype)
    return band


def identity(nb: int, bs: int, w: int, dtype=torch.float64,
             device="cpu") -> torch.Tensor:
    band = torch.zeros((2 * w + 1, nb, bs, bs), dtype=dtype, device=device)
    band[w].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    return band


def matmul(a: torch.Tensor, b: torch.Tensor, operands=None) -> torch.Tensor:
    """A @ B kept within A's band.  Block (i, i + e) of A times block
    (i + e, i + e + f) of B adds to block (i, i + e + f) of C.
    ``operands`` (a function of a tensor) is applied to both operands
    first: the control rounds them to a lower precision there."""
    if operands is not None:
        a, b = operands(a), operands(b)
    w = half_width(a)
    nb = a.shape[1]
    c = torch.zeros_like(a)
    for e in range(-w, w + 1):
        lo, hi = max(0, -e), min(nb, nb - e)
        if lo >= hi:
            continue
        for f in range(-w, w + 1):
            d = e + f
            if abs(d) > w:
                continue
            c[w + d, lo:hi].baddbmm_(a[w + e, lo:hi],
                                     b[w + f, lo + e:hi + e])
    return c


def matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ v for a vector held as ``v[nb, bs]`` (row i * bs + r at
    ``v[i, r]``)."""
    w = half_width(a)
    nb = a.shape[1]
    y = torch.zeros_like(v)
    for o in range(-w, w + 1):
        lo, hi = max(0, -o), min(nb, nb - o)
        if lo < hi:
            y[lo:hi] += torch.bmm(a[w + o, lo:hi],
                                  v[lo + o:hi + o, :, None])[..., 0]
    return y


def dot(a: torch.Tensor, b: torch.Tensor) -> float:
    """sum(A * B) over every entry, accumulated in float64."""
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    for lo, hi in _chunks(a.shape[1]):
        total += (a[:, lo:hi].double() * b[:, lo:hi].double()).sum()
    return float(total)


def trace(a: torch.Tensor) -> float:
    w = half_width(a)
    return float(a[w].diagonal(dim1=-2, dim2=-1).double().sum())


def frobenius(a: torch.Tensor) -> float:
    return dot(a, a) ** 0.5


def gershgorin(a: torch.Tensor) -> tuple[float, float]:
    """(min, max) over the rows of a[i, i] -/+ sum_{j != i} |a[i, j]|."""
    w = half_width(a)
    rows = torch.zeros(a.shape[1:3], dtype=torch.float64, device=a.device)
    for o in range(2 * w + 1):
        rows += a[o].abs().double().sum(-1)
    d = a[w].diagonal(dim1=-2, dim2=-1).double()
    radius = rows - d.abs()
    return float((d - radius).min()), float((d + radius).max())


def from_ell(col_ids: torch.Tensor, blocks: torch.Tensor, w: int,
             dtype=torch.float64) -> tuple[torch.Tensor, float]:
    """A block-ELL matrix -- ``col_ids[nb, k]`` the block column of
    each slot (a slot whose id is not in [0, nb) is unused),
    ``blocks[nb, k, bs, bs]`` -- as a band of half-width ``w``, and the
    squared Frobenius norm of its blocks that lie outside that band.
    Blocks of one position in two slots add."""
    nb, k, bs, _ = blocks.shape
    band = torch.zeros((2 * w + 1, nb, bs, bs), dtype=dtype,
                       device=blocks.device)
    flat = band.view(-1, bs, bs)
    rows = torch.arange(nb, device=blocks.device)
    outside = 0.0
    for s in range(k):
        cols = col_ids[:, s].long()
        used = (cols >= 0) & (cols < nb)
        off = cols - rows
        near = used & (off.abs() <= w)
        far = used & ~near
        if bool(far.any()):
            outside += float(blocks[far, s].double().pow(2).sum())
        idx = ((off + w) * nb + rows)[near]
        flat.index_add_(0, idx, blocks[near, s].to(dtype))
    return band, outside


def to_ell(band: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(col_ids[nb, 2w + 1], blocks[nb, 2w + 1, bs, bs]) of a band; the
    slots of blocks outside the matrix get the id -1."""
    w = half_width(band)
    nb = band.shape[1]
    rows = torch.arange(nb, device=band.device)[:, None]
    cols = rows + torch.arange(-w, w + 1, device=band.device)[None, :]
    cols = torch.where((cols >= 0) & (cols < nb), cols, -1)
    return cols.to(torch.int32), band.transpose(0, 1).contiguous()
