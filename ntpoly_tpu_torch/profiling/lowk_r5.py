"""The round-5 low-K profile on one card.

Counterpart of the JAX package's ``profile_lowk_r5.py``, beside
``lowk.py`` (the counterpart of ``profile_lowk.py``).  It takes
``lowk.operand`` -- the chain at 2^19 rows, bs 128, element half-width
24, so R = NBK = 4096 block rows, KA = KB = 3, k_out = span = 5,
threshold 1e-6, float32 -- and times X @ X with ``lowk.cuda_time``
through these arms (line numbers of ``profile_lowk_r5.py``):

  matmul_high, matmul_highest  ``algebra.matmul`` end to end, 'auto'
                               (the band kernel), at both tiers (:99-109)
  matmul_band_high             ``method='pallas_band'`` at 'high'
                               (:111-120)
  band_<tier>                  the band kernel at 'highest', 'high' and
                               'bf16' (:122-148)
  uniform_col_<tier>           the uniform kernel with col-addressed
                               window rows at 'highest' and 'high', in
                               the band kernel's groups (v6, :175-303)
  uniform_pos_<tier>_g<G>      the uniform kernel with positional window
                               rows at 'highest', 'high' and 'bf16', G =
                               8 and 16 (v7, :305-437; v9 and v10,
                               :439-769, compute v7's function)
  diag_<tier>                  v8's diagonal form (:771-815) in plain
                               torch: KA batched products over shifted
                               panels, TF32 off; the library yardstick
  dense_same_flops, stream_same_bytes   the anchors of ``lowk``

The band kernel (and so ``matmul``) and the uniform kernel run the
TPU's tiers: 'highest' exact, 'high' the bf16x3 split and 'bf16' the
operands rounded to bfloat16, the last two on the tensor cores (the
band kernel after its split pass, on float32 X; the uniform kernel's
'bf16' on a bfloat16 copy of X).  The
uniform and diag arms compute the experiments' functions, which equal X
@ X only on the interior rows (``interior``): at the edges the static
offsets and the positional rows read other blocks, as on the TPU.

The band kernel's group-size sweep (:150-173) has no counterpart: the
port's band kernel addresses every row on its own and has no group.

On a machine with a CUDA card:

    from ntpoly_tpu_torch.profiling import lowk_r5
    result = lowk_r5.profile("cuda")

``profile`` returns a dict and writes no file.  ``arms`` builds the same
calls on any device, so that they can be held against one another on
the CPU.
"""
from __future__ import annotations

import torch

from ..config import EMPTY
from ..ops import spgemm as sp
from ..parallel import algebra as alg
from . import lowk

GROUPS = (8, 16)
TIERS = ("highest", "high", "bf16")

Tensor = torch.Tensor


def v4_group(op: lowk.LowK) -> int:
    """The band kernel's group at this shape (``_v4_pick``), which the
    col-addressed arms use, as v6 used v4's."""
    rows, ka = op.cols.shape
    g, _ = sp._v4_pick(ka, ka, op.k_out, rows, rows)
    if g is None:
        raise ValueError(f"rows {rows}, KA {ka}, k_out {op.k_out}: outside "
                         "the band kernel's regime")
    return g


def _pad(x: Tensor, g: int, fill) -> Tensor:
    """x padded along its first axis to whole groups of g with ``fill``;
    x itself when its rows are whole groups already."""
    pad = -x.shape[0] % g
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])


def uniform_args(op: lowk.LowK) -> dict:
    """arm -> (positional, keyword arguments) of ``sp.spgemm_uniform``
    (and of its plain version) for every uniform arm: A = B = X, A
    padded to whole groups (EMPTY, zero blocks) and B its leading rows
    as raw blocks, one storage, so that 'high' splits X once.  The
    'bf16' arms take one bfloat16 copy of X for both, as the others take
    X itself."""
    ka = op.cols.shape[1]
    x_of = {"highest": op.blocks, "high": op.blocks,
            "bf16": op.blocks.to(torch.bfloat16)}
    out = {}
    for addressing, tiers, groups in (
            ("col", ("highest", "high"), (v4_group(op),)),
            ("position", TIERS, GROUPS)):
        for g in groups:
            ac = _pad(op.cols, g, EMPTY)
            wlo = sp._v3_window(ac, g)[0]
            for tier in tiers:
                xp = _pad(x_of[tier], g, 0)
                name = (f"uniform_col_{tier}" if addressing == "col"
                        else f"uniform_pos_{tier}_g{g}")
                out[name] = (
                    (ac, xp, xp[:op.cols.shape[0]], wlo),
                    dict(kb=ka, k_out=op.k_out, g_rows=g, w=ka + g - 1,
                         span=op.span, addressing=addressing, precision=tier,
                         alpha=1.0, threshold=op.threshold))
    return out


def interior(op: lowk.LowK, g: int | None = None) -> Tensor:
    """[R] rows where the arms compute X @ X: cols r-1, r, r+1 with band
    offsets gg0 == s, and (given a group size g) positional window rows
    r + s - 1.  There output slot t of every arm holds col r - 2 + t."""
    rows, ka = op.cols.shape
    dev = op.cols.device
    band = (torch.arange(rows, device=dev)[:, None]
            + torch.arange(ka, device=dev) - 1)
    ok = ((op.cols == band).all(1)
          & (op.gg0 == torch.arange(ka, device=dev)).all(1))
    if g is not None:
        ac = _pad(op.cols, g, EMPTY)
        wlo = sp._v3_window(ac, g)[0]
        pos = sp._uniform_rows(ac, wlo, g, ka + g - 1, rows, "position")
        ok &= (pos[:rows] == band).all(1)
    return ok


def _shift_rows(x: Tensor, d: int) -> Tensor:
    """x[r + d] along the first axis, zero outside."""
    if d == 0:
        return x
    z = x.new_zeros((abs(d),) + x.shape[1:])
    return torch.cat([x[d:], z]) if d > 0 else torch.cat([z, x[:d]])


def _bmm_f32(a: Tensor, b: Tensor) -> Tensor:
    """Batched product of bfloat16 operands with float32 output: one
    cuBLAS call on the card; on the CPU, which has no such call, the
    same exact products summed in float32."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _diag_bmm(a: Tensor, b: Tensor, precision: str) -> Tensor:
    if precision == "highest":
        return torch.bmm(a, b)
    if precision == "bf16":
        return _bmm_f32(a, b)
    (ah, al), (bh, bl) = sp.split_bf16x3(a), sp.split_bf16x3(b)
    return _bmm_f32(ah, bh) + _bmm_f32(al, bh) + _bmm_f32(ah, bl)


def diag(ab: Tensor, braw: Tensor, *, span: int, threshold: float,
         precision: str):
    """v8's diagonal form: slot s of row r reads B row r + s - 1 (zero
    outside the matrix) and lands at offset s; the threshold flush
    (alpha 1); per-block norms.  -> (blocks [nb, span, bs, bs] float32,
    norms [nb, span])."""
    nb, ka, bs, _ = ab.shape
    kb = braw.shape[1]
    bp = braw.transpose(1, 2).reshape(nb, bs, kb * bs)
    acc = torch.zeros((nb, bs, span * bs), dtype=torch.float32,
                      device=ab.device)
    for s in range(ka):
        acc[:, :, s * bs:(s + kb) * bs] += _diag_bmm(
            ab[:, s], _shift_rows(bp, s - 1), precision)
    fl = torch.where(acc.abs() > threshold, acc, acc.new_zeros(()))
    blocks = fl.reshape(nb, bs, span, bs).transpose(1, 2)
    return blocks, blocks.abs().sum(dim=(-1, -2))


def arms(op: lowk.LowK) -> dict:
    """name -> zero-argument call of each arm of X @ X (every kernel
    through its wrapper: the kernel on a CUDA device, its plain version
    on the CPU)."""
    kw = dict(threshold=op.threshold, k_out=op.k_out, on_overflow="truncate")
    base = lowk.arms(op)
    out = {
        "matmul_high": lambda: alg.matmul(op.h, op.h, precision="high", **kw),
        "matmul_highest": lambda: alg.matmul(op.h, op.h,
                                             precision="highest", **kw),
        "matmul_band_high": lambda: alg.matmul(
            op.h, op.h, method="pallas_band", precision="high", **kw),
        **{name: base[name] for name in ("band_highest", "band_high",
                                         "band_bf16")},
    }
    for name, (args, kwargs) in uniform_args(op).items():
        out[name] = lambda a=args, k=kwargs: sp.spgemm_uniform(*a, **k)
    x_bf16 = op.blocks.to(torch.bfloat16)
    for tier in TIERS:
        x = x_bf16 if tier == "bf16" else op.blocks
        out[f"diag_{tier}"] = lambda x=x, p=tier: diag(
            x, x, span=op.span, threshold=op.threshold, precision=p)
    return out


def uniform_products(op: lowk.LowK) -> int:
    """Block products the uniform kernel computes over the real rows:
    every static (s, t - s) pair of every slot t < min(span, k_out),
    edges included."""
    rows, ka = op.cols.shape
    kb = ka
    return rows * sum(min(ka - 1, t) - max(0, t - kb + 1) + 1
                      for t in range(min(op.span, op.k_out)))


def profile(device="cuda", *, op: lowk.LowK | None = None) -> dict:
    """Time every arm and anchor on a CUDA device (``op``: an operand
    already built, else the full-size one).  Raises on any other device:
    CPU timings are not the card's."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the round-5 low-K profile times a CUDA card; "
                           f"got {dev}")
    assert not torch.backends.cuda.matmul.allow_tf32   # config.py
    op = op or lowk.operand(dev)
    calls = {**arms(op), **lowk.anchors(op)}
    ms = {name: lowk.cuda_time(fn, lowk.REPS) for name, fn in calls.items()}
    rows, ka = op.cols.shape
    return {
        "device": torch.cuda.get_device_name(dev),
        "shape": dict(dim=op.h.dim, bs=op.h.bs, rows=rows, k=ka,
                      k_out=op.k_out, threshold=op.threshold, span=op.span,
                      groups=dict(col=v4_group(op), position=GROUPS)),
        "uniform_products": uniform_products(op),
        "products": op.products(), "flops": op.flops(),
        "bytes": op.bytes_moved(), "reps": lowk.REPS, "ms": ms,
    }
