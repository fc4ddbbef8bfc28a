"""The low-K banded SpGEMM profile on one card.

Counterpart of the JAX package's ``profile_lowk.py``.  The operand is
the tight-binding chain (``systems.chain_fn``) at 2^19 rows, bs 128 and
element half-width 24: 4096 block rows of KA = KB = 3 block slots, the
shape a >= 1M-row linear-scaling Hamiltonian has.  X @ X runs through
every SpGEMM kernel, and each arm is timed with CUDA events after a
warm-up:

  matmul             ``algebra.matmul`` end to end (its 'auto' picks
                     the band kernel)
  structure_pass     ``structure_plan`` alone
  general            the general kernel, one call
  stream             the stream kernel, one call
  window_<tier>      the window kernel at 'highest', 'high' and 'bf16'
  band_<tier>        the band kernel at 'highest', 'high' and 'bf16'
  dense_same_flops   a dense float32 ``torch.matmul`` of the kernels'
                     FLOPs (TF32 off)
  stream_same_bytes  an elementwise pass that reads and writes the
                     bytes the kernels must move (A, the panel, C)

The window and band kernels run the reference's tiers: 'highest'
exact and, on float32 X, 'high' the bf16x3 split, as the split pass
plus the tensor-core product (the window kernel splits A and the panel,
two storages; the band kernel X once).  The band kernel's 'bf16' is the
hi part of X's split; the window kernel's reads bfloat16 operands, the
tensor cores taking them as they are.

Two of the reference's arms are not carried over: the row-chunked v1
and v2 variants (with ``_row_chunk``, and the single v1 call that
overflowed the TPU's scalar memory).  The chunking existed for the
TPU's scalar-memory limits; the port's kernels take every row in one
call.

On a machine with a CUDA card:

    from ntpoly_tpu_torch.profiling import lowk
    result = lowk.profile("cuda")

``profile`` returns a dict and writes no file.  ``operand`` and
``arms`` build the same calls at any size on any device, so that the
arms can be held against one another on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import EMPTY
from ..ops import spgemm as sp
from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..parallel.grid import ProcessGrid
from ..systems import chain_fn

DIM = 1 << 19
BS = 128
BAND = 24
THRESHOLD = 1e-6
REPS = 10

Tensor = torch.Tensor


@dataclass(frozen=True)
class LowK:
    """The chain operand X and everything the arms of X @ X share."""
    h: PM.PSMatrix
    k_out: int           # fill_bound(X, X)
    threshold: float
    plan: Tensor         # [R, KA*KB] rank-form output slots
    panel: Tensor        # [NBK, bs, KB*bs] (sp.b_panel)
    g_rows: int          # window kernel: rows per group (_v3_pick)
    w: int               # window kernel: window rows
    width: int           # widest group window the col ids need
    wlo: Tensor          # [ceil(R / g_rows)] window starts
    span: int            # band kernel: computed output width
    gg0: Tensor          # [R, KA] band offsets

    @property
    def cols(self) -> Tensor:
        return self.h.col_ids[0]

    @property
    def blocks(self) -> Tensor:
        return self.h.blocks[0]

    @property
    def pad(self) -> int:
        """Rows added to make whole window groups."""
        return -self.cols.shape[0] % self.g_rows

    def padded(self):
        """(col ids, blocks, plan) padded to whole groups: EMPTY, zero
        blocks and k_out, as the reference pads them."""
        ac, ab, plan = self.cols, self.blocks, self.plan
        if not self.pad:
            return ac, ab, plan
        ka = ac.shape[1]
        return (torch.cat([ac, ac.new_full((self.pad, ka), EMPTY)]),
                torch.cat([ab, ab.new_zeros((self.pad,) + ab.shape[1:])]),
                torch.cat([plan, plan.new_full((self.pad, plan.shape[1]),
                                               self.k_out)]))

    def products(self) -> int:
        """Candidate block products of X @ X (valid A slot, valid B
        slot)."""
        return int((sp._candidate_ids(self.cols, self.cols) != EMPTY).sum())

    def flops(self) -> int:
        return 2 * self.h.bs ** 3 * self.products()

    def bytes_moved(self) -> int:
        """Least float32 traffic of one X @ X: A once, the panel once,
        the k_out output blocks of each row once."""
        rows, ka = self.cols.shape
        blk = self.h.bs ** 2 * 4
        return (2 * rows * ka + rows * self.k_out) * blk


def operand(device, dim: int = DIM, bs: int = BS, band: int = BAND) -> LowK:
    """Build the chain operand on ``device`` with its plans."""
    h = PM.banded(dim, band, chain_fn(dim), bs=bs,
                  grid=ProcessGrid(device=device), dtype=torch.float32)
    k_out = alg.fill_bound(h, h)
    ac = h.col_ids[0]
    rows, ka = ac.shape
    g_rows, w = sp._v3_pick(ka, ka, k_out, rows, rows)
    if g_rows is None:
        raise ValueError(f"rows {rows}, KA {ka}, k_out {k_out}: outside "
                         "the window kernel's regime")
    pad = -rows % g_rows
    wlo, width = sp._v3_window(
        torch.cat([ac, ac.new_full((pad, ka), EMPTY)]), g_rows)
    span = sp._v4_span(ka, ka, k_out)
    gg0, _, band_ok = sp.band_plan(ac, ac, k_out, span=span)
    if not bool(band_ok):
        raise ValueError("the chain operand fails the band plan")
    return LowK(h=h, k_out=k_out, threshold=THRESHOLD,
                plan=sp.structure_plan(ac, ac, k_out)[0],
                panel=sp.b_panel(ac, h.blocks[0]), g_rows=g_rows, w=w,
                width=int(width), wlo=wlo, span=span, gg0=gg0)


def arms(op: LowK) -> dict:
    """name -> zero-argument call of each SpGEMM arm of X @ X (every
    kernel through its wrapper: the kernel on a CUDA device, its plain
    version on the CPU)."""
    ac, ab = op.cols, op.blocks
    ka = ac.shape[1]
    kw = dict(k_out=op.k_out, alpha=1.0, threshold=op.threshold)
    ac3, ab3, plan3 = op.padded()
    win = dict(kb=ka, g_rows=op.g_rows, w=op.w, **kw)
    ab3_bf16 = ab3.to(torch.bfloat16)
    panel_bf16 = op.panel.to(torch.bfloat16)

    def window(precision):
        if precision == "bf16":
            return lambda: sp.spgemm_window(ac3, ab3_bf16, panel_bf16,
                                            plan3, op.wlo, precision="bf16",
                                            **win)
        return lambda: sp.spgemm_window(ac3, ab3, op.panel, plan3, op.wlo,
                                        precision=precision, **win)

    def band(precision):
        return lambda: sp.spgemm_band(ac, ab, ac, ab, op.gg0, span=op.span,
                                      precision=precision, **kw)

    return {
        "matmul": lambda: alg.matmul(op.h, op.h, threshold=op.threshold,
                                     k_out=op.k_out,
                                     on_overflow="truncate"),
        "structure_pass": lambda: sp.structure_plan(ac, ac, op.k_out),
        "general": lambda: sp.spgemm_general(ac, ab, ac, ab, op.plan, **kw),
        "stream": lambda: sp.spgemm_stream(ac, ab, op.panel, op.plan,
                                           kb=ka, **kw),
        "window_highest": window("highest"),
        "window_high": window("high"),
        "window_bf16": window("bf16"),
        "band_highest": band("highest"),
        "band_high": band("high"),
        "band_bf16": band("bf16"),
    }


def anchors(op: LowK) -> dict:
    """name -> call of the two roofline anchors: a dense float32 matmul
    of the arms' FLOPs (n^3 * 2 = flops) and an elementwise pass that
    reads and writes the bytes the arms must move."""
    dev = op.blocks.device
    gen = torch.Generator(device=dev).manual_seed(0)
    n = round((op.flops() / 2) ** (1 / 3))
    dense = torch.rand((n, n), generator=gen, device=dev)
    flat = torch.rand(op.bytes_moved() // 8, generator=gen, device=dev)
    return {"dense_same_flops": lambda: torch.matmul(dense, dense),
            "stream_same_bytes": lambda: flat * 1.0000001}


def cuda_time(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA stream: CUDA
    events around ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile(device="cuda", *, op: LowK | None = None) -> dict:
    """Time every arm and anchor on a CUDA device (``op``: an operand
    already built, else the full-size one).  Raises on any other device:
    CPU timings are not the card's."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the low-K profile times a CUDA card; got {dev}")
    assert not torch.backends.cuda.matmul.allow_tf32   # config.py
    op = op or operand(dev)
    calls = {**arms(op), **anchors(op)}
    ms = {name: cuda_time(fn, REPS) for name, fn in calls.items()}
    rows, ka = op.cols.shape
    return {
        "device": torch.cuda.get_device_name(dev),
        "shape": dict(dim=op.h.dim, bs=op.h.bs, rows=rows, k=ka,
                      k_out=op.k_out, threshold=op.threshold,
                      g_rows=op.g_rows, w=op.w, width=op.width,
                      span=op.span, nnz=op.h.nnz),
        "products": op.products(), "flops": op.flops(),
        "bytes": op.bytes_moved(), "reps": REPS, "ms": ms,
    }
