"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line each with its seconds:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles the SpGEMM kernels (csrc/) with nvcc.
3. kernels: each kernel against its plain PyTorch version on seeded
   random block-ELL cases (holes, a ragged row, an empty row, alpha !=
   1, threshold > 0, an overflowing capacity, a band violation, a
   capacity-padded span), f32 and f64, bs 8, 32 and 128: the band and
   general kernels through the entry point at every tier ('highest',
   'high' and 'bf16' in f32, where 'high' must also lie nearer its
   bf16x3 plain version than the exact product; f64 exact at 'highest'
   and 'high'), f32 'default' (the TPU's one bf16 pass) bit for bit the
   band and general kernels' 'bf16', the split pass bit for bit, the
   stream and window kernels through their wrappers (the window kernel
   at 'highest', at 'high' in f32, where it must also lie nearer its
   bf16x3 plain version than the exact product, with bf16 operands,
   and at 'default' in f32, bit for bit its 'bf16', and on the
   scattered case, whose col ids leave their group's window and are
   clamped), and the uniform kernel through its wrapper (both
   addressings, f32 at 'highest' and 'high', bf16; first groups at wlo
   = 0, last groups clamped to NBK - W, a padded last group, holes, a
   col id outside its window, k_out > span; blocks and column norms;
   'high' nearer its bf16x3 plain version than the exact float32
   product; f64 refused).
4. timing: kernels and plain versions on the card at the main path's
   shapes: the band kernel at the flagship X @ X at 'highest' and
   'high' (split pass included; 'high' must be at least twice as
   fast), the split pass alone on that X and the band kernel's
   tensor-core product alone on X split once (bit for bit the
   wrapper's), the general kernel at the same product in rank form at
   'high' and at the parity shape (f64).
5. lowk: the low-K profile (ntpoly_tpu_torch/profiling/lowk.py) at
   full size, 2^19 rows of the chain at bs 128, every arm timed, and
   torch.bmm in float32 over the same number of dense block products
   as the FP32 yardstick of the exact arms; then on its operand every
   kernel arm (general, stream, window and band at each tier) held
   against its plain version on the same inputs ('high' also nearer it
   than the exact product), the general, stream and window kernels
   against one another at 'highest' (bit for bit: one exact core, one
   order of FMAs), the window
   kernel's 'high' against the general kernel's on the same operand
   (and whether the two agree bit for bit), the `matmul` arm (band
   kernel at 'high') against the band kernel's plain version, and the
   plain versions timed.
6. lowk_r5: the round-5 low-K profile (profiling/lowk_r5.py) on the
   same operand, every arm timed; then every uniform arm against its
   plain version on the same inputs (blocks, column norms and, for
   'high', the distance from the exact float32 product),
   `uniform_pos_highest_g8` against the diag form,
   `uniform_pos_high_g8` (bf16x3 on the tensor cores) against the band
   kernel's exact float32 and against the band kernel's own bf16x3 on
   the interior rows (and whether the two agree bit for bit), and the
   plain versions timed.  The diag arms are the library yardstick.
7. parity: TRS4 at dim 8192, bs 32, k_out 10, f64 through the general
   kernel on the card, and through the plain versions on the CPU.
8. flagship: TRS4 of the 2^20-row gapped chain at bs 128 in f32 through
   the band kernel at 'high' (the reference's setting: the split pass
   and the tensor cores), with its certificates (idempotency,
   commutator, electron count) computed at 'highest'; then the same
   solve at 'highest' for the speed and accuracy trade.
9. overlap: the non-orthogonal path (profiling/overlap.py) at the
   flagship's width: the inverse square root of the overlap S of
   `systems.overlap_fn` (Taylor order 5, 'highest'; max|ISQ S ISQ^T -
   I| <= 1e-5), then TRS4, TRS2, PM and HPCP with it at 'highest'
   (each within its iteration cap and the bars on the generalized
   certificates ||KSK - K||/||K||, |tr(KS) - nel|/nel and ||HKS -
   SKH||/||HKS||; the four energies within 1e-6 of one another), TRS4
   once more at 'high' (idempotency and commutator bars), each timed
   after a 2-iteration warm-up; then the ISQ, PM at 'highest' and TRS4
   at 'high' once more at that width with every product of the band
   and general kernels held against its plain version on the same card
   tensors, once for each kernel, tier and shape (KA, KB, k_out) the
   path gives them (blocks to the tier's tolerance at the depth KA * bs,
   relative to max |C|; a block kept on one side only within rounding
   of the threshold; at 'high' nearer the bf16x3 plain version than the
   exact product), and the split pass bit for bit on each operand it
   splits there; then S -> ISQ -> TRS4 and TRS2 at dim 4096, bs 32, f64
   on the card against the CPU (energies to 1e-10, equal iteration
   counts).

Kernel launches are counted on each kernel's own path, with the counts
reset just before the path and read just after it: the band and
general kernels in the card's TRS4 solves of phases 7 and 8 at the
flagship's 'high' and in phase 9's ISQ and timed solves (the `kernels`
line reports their sum), the split pass in those solves, the stream
and window kernels in the low-K profile of phase 5, the uniform kernel
in the round-5 profile of phase 6.  The band, window and uniform
kernels' entries time their tensor-core products alone at 'high' on
planes split once beforehand (bit for bit their wrappers' output;
`plain_ms` the whole multiply's plain version); the split pass has its
own entry.  Each kernel's
`bound_ms` is the larger of its least bytes
(each input read once, an operand passed as both A and B once, each
output written once) over 3.35 TB/s and its operations over the peak
of their type (FP32
67 TFLOP/s, FP64 67 TFLOP/s on the tensor cores, bf16 989 TFLOP/s), at
the inputs its `ms` was timed on.  No single PyTorch call computes a
threshold-pruned block-ELL product, so `library_ms` is null.  Any
failed phase ends the run with a non-zero exit code.  The last line is
the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import subprocess
import sys
import time
import warnings

import torch

from ntpoly_tpu_torch.config import EMPTY
from ntpoly_tpu_torch.core import bell
from ntpoly_tpu_torch.ops import spgemm as sp
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.profiling import lowk, lowk_r5, overlap, trs4_tiers
from ntpoly_tpu_torch.profiling.trs4_tiers import (flagship_params,
                                                   purity_invariants, solve)
from ntpoly_tpu_torch.solvers import density
from ntpoly_tpu_torch.systems import gapped_fn

KERNELS = {
    "spgemm_band": dict(source="ntpoly_tpu_torch/csrc/spgemm_band.cu",
                        replaces="ntpoly_tpu/ops/spgemm_pallas.py:485"),
    "spgemm_general": dict(
        source="ntpoly_tpu_torch/csrc/spgemm_general.cu",
        replaces="ntpoly_tpu/ops/spgemm_pallas.py:144"),
    "spgemm_stream": dict(
        source="ntpoly_tpu_torch/csrc/spgemm_stream.cu",
        replaces="ntpoly_tpu/ops/spgemm_pallas.py:223"),
    "spgemm_window": dict(
        source="ntpoly_tpu_torch/csrc/spgemm_window.cu",
        replaces="ntpoly_tpu/ops/spgemm_pallas.py:288"),
    "spgemm_uniform": dict(
        source="ntpoly_tpu_torch/csrc/spgemm_uniform.cu",
        replaces="profile_lowk_r5.py:189, profile_lowk_r5.py:310, "
                 "profile_lowk_r5.py:455, profile_lowk_r5.py:605"),
    # the split inside _kernel_v4 (and _kernel), as one pass before the
    # tensor-core product
    "split_bf16": dict(
        source="ntpoly_tpu_torch/csrc/spgemm_band.cu",
        replaces="ntpoly_tpu/ops/spgemm_pallas.py:559, "
                 "ntpoly_tpu/ops/spgemm_pallas.py:169"),
}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the overlap phase's iteration caps: ~40% over the counts that the
# CPU runs of the same path predicted (PERF.md, section 6)
OVERLAP_CAPS = {"trs4": 10, "trs2": 18, "pm": 10, "hpcp": 10}
# published peaks of one H100 SXM (NVIDIA's data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "fp64_tensor": 67e12, "bf16_tensor": 989e12}
# the uniform arm whose time stands for the kernel in the `kernels` line
UNIFORM_ARM = "uniform_pos_high_g8"
# the band and uniform kernels' bf16x3 on the low-K interior rows, of
# max |C|: two float32 sums of the same terms in another order differ by
# ~sqrt(depth) eps (4.1e-7 read on the H100 between two designs), while
# bf16x3 lies ~1.1e-5 from exact float32 there, so a 'high' as far from
# bf16x3 as exact float32 fails
BF16X3_PAIR_TOL = 3e-6


def timed(ms: float, plain_ms: float, flops: float, peak: str, tensors):
    """A kernel's times with its bound: the larger of the bytes of its
    inputs and outputs (``tensors``, each storage moved once, so that X
    passed as both A and B of X @ X counts once) over the HBM rate and
    its operations over the peak of their type."""
    seen = {}
    for x in tensors:
        key = x.untyped_storage().data_ptr()
        seen[key] = max(seen.get(key, 0), x.numel() * x.element_size())
    nbytes = sum(seen.values())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bound_text(t: dict) -> str:
    return (f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}, "
            f"{100 * t['bound_ms'] / t['ms']:.0f}% reached)")


# ----------------------------------------------------------------------------
# random block-ELL operands
# ----------------------------------------------------------------------------

def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)


def band_operand(gen, rows, k, bs, dtype, holes=0.0, capacity=None):
    """Banded block-ELL [rows, capacity]: row r holds cols lo..lo+k-1
    (lo = r - k // 2, clipped to the matrix), random holes, row 3 empty
    and row 5 ragged (one block)."""
    cap = capacity or k
    cols = torch.full((rows, cap), EMPTY, dtype=torch.int32)
    for r in range(rows):
        lo = min(max(0, r - k // 2), max(0, rows - k))
        n = 0 if r == 3 else 1 if r == 5 else k
        cols[r, :n] = torch.arange(lo, lo + n, dtype=torch.int32)
    if holes:
        hit = torch.rand((rows, cap), generator=gen) < holes
        cols = torch.where(hit, EMPTY, cols).to(torch.int32)
    blocks = _randn(gen, (rows, cap, bs, bs), dtype)
    blocks = blocks * (cols != EMPTY)[..., None, None].to(dtype)
    return cols, blocks


def scattered_operand(gen, rows, k, bs, dtype):
    """Block-ELL with k random sorted cols per row (not banded)."""
    cols = torch.stack([torch.sort(torch.randperm(rows, generator=gen)[:k])
                        .values for _ in range(rows)]).to(torch.int32)
    return cols, _randn(gen, (rows, k, bs, bs), dtype)


def kernel_cases(gen, bs, dtype):
    """(name, A, B, k_out, alpha, threshold) for one block size."""
    rows = 136                   # >= the band gate, not a multiple of 16
    thr = 0.5 * math.sqrt(bs)
    band = band_operand(gen, rows, 3, bs, dtype, holes=0.15)
    band2 = band_operand(gen, rows, 3, bs, dtype, holes=0.15)
    scat = scattered_operand(gen, rows, 3, bs, dtype)
    pad = band_operand(gen, rows, 2, bs, dtype, capacity=8)
    return [
        ("band_holes", band, band2, 5, 1.7, thr),
        ("overflow", band, band2, 3, 1.0, thr),
        ("not_banded", scat, band2, 6, 0.8, thr),
        ("capacity_padded", pad, pad, 8, 1.0, 0.0),
    ]


def _errors(got, want, threshold=0.0):
    """(max abs error, max error relative to max |want|).  An entry that
    one side flushed and the other kept counts as agreeing when it lies
    within rounding of the threshold: the flush decision there depends
    on the order of the sums."""
    got, want = got.double(), want.double().to(got.device)
    diff = (got - want).abs()
    edge = (((got == 0) != (want == 0))
            & (torch.maximum(got.abs(), want.abs())
               <= threshold * (1 + 1e-4)))
    diff = torch.where(edge, 0.0, diff)
    err = float(diff.max()) if diff.numel() else 0.0
    return err, err / max(float(want.abs().max()), 1e-300)


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test needs the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from ntpoly_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    _cuda.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_cuda.library_path().name})")


def split_case(errs):
    """The split pass on the card against its plain version, bit for
    bit, on float32 values over sixty decades, zeros and rounding ties.
    -> the launches made."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(1 << 16, generator=gen)
         * torch.logspace(-30, 30, 1 << 16))
    ties = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -0.0, 0.0])
    x = torch.cat([x, ties])
    for lo in (True, False):
        hi, low = sp.split_bf16(x.cuda(), lo=lo)
        torch.cuda.synchronize()
        ph, pl = sp.split_bf16(x, lo=lo)
        same = torch.equal(hi.cpu().view(torch.int16), ph.view(torch.int16))
        if lo:
            same = same and torch.equal(low.cpu().view(torch.int16),
                                        pl.view(torch.int16))
        print(f"  split_bf16 {'hi and lo' if lo else 'hi'} on {x.numel()} "
              f"values: {'bit for bit' if same else 'MISMATCH'}")
        if not same:
            raise AssertionError("the split pass disagrees with its plain "
                                 "version")
    errs["split_bf16"] = 0.0
    return 2


def entry_tol(precision, dtype, depth):
    """The blocks' tolerance of the band and general kernels against
    their plain versions: the uniform kernel's at the kernels' tier."""
    return uniform_tol(sp.kernel_tier(dtype, precision), dtype, depth)


def phase_kernels(errs):
    """Every case through the entry point on the card (kernels) and on
    the CPU (plain versions) at each tier: col ids and fill counts
    exactly, blocks to the tier's tolerance relative to max |C| (the
    depth KA * bs of the sums), and at 'high' nearer the bf16x3 plain
    version than the exact product."""
    gen = torch.Generator().manual_seed(20261016)
    used = {k: 0 for k in KERNELS}
    used["split_bf16"] += split_case(errs)
    tiers = {torch.float32: ("highest", "high", "bf16"),
             torch.float64: ("highest", "high")}
    for dtype in (torch.float32, torch.float64):
        for bs in (8, 32, 128):
            for name, (ac, ab), (bc, bb), k_out, alpha, thr in \
                    kernel_cases(gen, bs, dtype):
                for mode, prec in itertools.product(
                        ("off", "auto", "force"), tiers[dtype]):
                    kw = dict(k_out=k_out, alpha=alpha, threshold=thr,
                              band_mode=mode)
                    before = dict(sp.launches)
                    got = sp.spgemm(ac.cuda(), ab.cuda(), bc.cuda(),
                                    bb.cuda(), precision=prec, **kw)
                    torch.cuda.synchronize()
                    want = sp.spgemm(ac, ab, bc, bb, precision=prec, **kw)
                    kern = [k for k in used if sp.launches[k] > before[k]]
                    for k in kern:
                        used[k] += 1
                    cc, cb, uc = (x.cpu() for x in got)
                    aerr, err = _errors(cb, want[1], thr)
                    tol = entry_tol(prec, dtype, ac.shape[1] * bs)
                    exact = ""
                    ok = (torch.equal(cc, want[0])
                          and torch.equal(uc, want[2]) and err <= tol)
                    if sp.kernel_tier(dtype, prec) == "high":
                        ex = sp.spgemm(ac, ab, bc, bb, precision="highest",
                                       **kw)[1]
                        ex_err = _errors(cb, ex, thr)[1]
                        ok = ok and err < ex_err
                        exact = f", vs exact {ex_err:.2e}"
                    for k in kern:
                        if k != "split_bf16":   # held bit for bit
                            errs[k] = max(errs[k], aerr)
                    print(f"  {str(dtype)[6:]} bs={bs} {name} {mode} {prec} "
                          f"[{','.join(kern)}]: max rel err {err:.2e} "
                          f"(tolerance {tol:.1e}){exact}"
                          f"{'' if ok else '  MISMATCH'}")
                    if not ok:
                        raise AssertionError(
                            f"kernel case {name}/{mode}/{prec} bs={bs} "
                            f"{dtype} disagrees with the plain version")
                for kern in panel_kernel_cases(
                        errs, (name, (ac, ab), (bc, bb), k_out, alpha, thr),
                        dtype, bs):
                    used[kern] += 1
                if dtype == torch.float32:
                    for kern in default_case(
                            f"bs={bs} {name}", (ac, ab), (bc, bb),
                            dict(k_out=k_out, alpha=alpha, threshold=thr)):
                        used[kern] += 1
    for bs in (8, 32, 128):
        used["spgemm_uniform"] += uniform_kernel_cases(errs, gen, bs)
    for k, n in used.items():
        if not n:
            raise AssertionError(f"no case launched {k}")


def default_case(what, a, b, kw):
    """float32 'default' is the TPU's one bf16 pass: through the entry
    point on the card, the band (band_mode 'force') and general ('off')
    kernels give the same bits at 'default' as at 'bf16' on the same
    float32 operands (col ids, blocks, fill counts).  -> the kernels
    launched."""
    (ac, ab), (bc, bb) = ([x.cuda() for x in a], [x.cuda() for x in b])
    used = []
    for mode in ("force", "off"):
        before = dict(sp.launches)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = sp.spgemm(ac, ab, bc, bb, precision="default",
                            band_mode=mode, **kw)
            want = sp.spgemm(ac, ab, bc, bb, precision="bf16",
                             band_mode=mode, **kw)
        torch.cuda.synchronize()
        kern = [k for k in ("spgemm_band", "spgemm_general")
                if sp.launches[k] > before[k]]
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        print(f"  float32 {what} {mode} default vs bf16 [{','.join(kern)}]: "
              f"{'bit for bit' if same else 'MISMATCH'}")
        if not same:
            raise AssertionError(f"'default' differs from 'bf16' on {what} "
                                 f"({mode})")
        used += kern
    return used


def panel_kernel_cases(errs, case, dtype, bs):
    """The stream and window kernels on one case (B as a panel), on the
    card against their plain versions on the CPU: occupancy (norms > 0)
    exactly, blocks to the output dtype's tolerance relative to max |C|.
    The window kernel runs at 'highest', and for f32 also at 'high'
    (the tolerance of a sum of three terms, and nearer the bf16x3 plain
    version than the exact product), at 'bf16' on the operands rounded
    to bf16, and at 'default' on the f32 operands, which must give the
    'bf16' run's bits.  -> the kernels launched."""
    name, (ac, ab), (bc, bb), k_out, alpha, thr = case
    plan = sp.structure_plan(ac, bc, k_out)[0]
    panel = sp.b_panel(bc, bb)
    (rows, ka), (nbk, kb) = ac.shape, bc.shape
    kw = dict(kb=kb, k_out=k_out, alpha=alpha, threshold=thr)
    runs = [("spgemm_stream", "highest", "", (ac, ab, panel, plan),
             lambda *x, precision: sp.spgemm_stream(*x, **kw))]
    g_rows, w = sp._v3_pick(ka, kb, k_out, rows, nbk)
    assert g_rows is not None and rows % g_rows == 0
    wlo, width = sp._v3_window(ac, g_rows)
    clamp = " clamped" if int(width) > w else ""
    tiers = [("highest", ab, panel)]
    if dtype == torch.float32:
        tiers += [("high", ab, panel),
                  ("bf16", ab.to(torch.bfloat16), panel.to(torch.bfloat16)),
                  ("default", ab, panel)]
    for prec, a_in, p_in in tiers:
        runs.append(("spgemm_window", prec, f" {prec}{clamp}",
                     (ac, a_in, p_in, plan, wlo),
                     lambda *x, precision: sp.spgemm_window(
                         *x, g_rows=g_rows, w=w, precision=precision,
                         **kw)))
    window_out = {}
    for kern, prec, label, args, call in runs:
        before = sp.launches[kern]
        kb_, kn = call(*(x.cuda() for x in args), precision=prec)
        if kern == "spgemm_window":
            window_out[prec] = kb_, kn
        torch.cuda.synchronize()
        pb, pn = call(*args, precision=prec)
        if sp.launches[kern] != before + 1:
            raise AssertionError(f"{kern} did not launch exactly once")
        aerr, err = _errors(kb_, pb, thr)
        high = prec == "high"
        tol = uniform_tol(prec, pb.dtype, ka * bs) if high else TOL[pb.dtype]
        ok = err <= tol and torch.equal(kn.cpu() > 0, pn > 0)
        exact = ""
        if high:
            ex_err = _errors(kb_, call(*args, precision="highest")[0],
                             thr)[1]
            ok = ok and err < ex_err
            exact = f" (tolerance {tol:.1e}), vs exact {ex_err:.2e}"
        errs[kern] = max(errs[kern], aerr)
        print(f"  {str(dtype)[6:]} bs={bs} {name} [{kern}{label}]: "
              f"max rel err {err:.2e}{exact}{'' if ok else '  MISMATCH'}")
        if not ok:
            raise AssertionError(f"{kern}{label} on {name} bs={bs} "
                                 f"{dtype} disagrees with its plain version")
    if "default" in window_out:
        same = all(torch.equal(x, y) for x, y in zip(window_out["default"],
                                                     window_out["bf16"]))
        print(f"  {str(dtype)[6:]} bs={bs} {name} [spgemm_window]: 'default' "
              f"on float32 vs 'bf16' on bfloat16: "
              f"{'bit for bit' if same else 'MISMATCH'}")
        if not same:
            raise AssertionError(f"window 'default' differs from 'bf16' on "
                                 f"{name} bs={bs}")
    return [r[0] for r in runs]


def uniform_tol(precision, dtype, depth):
    """max(the dtype's flat tolerance, depth * unit roundoff), relative to
    max |C|; 'high' sums three terms a product, so thrice the depth."""
    depth *= 3 if precision == "high" else 1
    return max(TOL[dtype], depth * torch.finfo(dtype).eps / 2)


def _norm_error(kn, pn, kb, pb, threshold):
    """Max error of the kernel's column norms kn against the plain
    version's pn, relative to max pn.  A column may differ by each of
    its entries that one side flushed and the other kept within
    rounding of the threshold (as in ``_errors``)."""
    kb, pb = kb.double(), pb.double().to(kb.device)
    edge = (((kb == 0) != (pb == 0))
            & (torch.maximum(kb.abs(), pb.abs()) <= threshold * (1 + 1e-4)))
    slack = edge.sum(-2) * (threshold * (1 + 1e-4))
    pn = pn.double().to(kn.device)
    diff = ((kn.double() - pn).abs() - slack.to(kn.device)).clamp(min=0)
    return float(diff.max()) / max(float(pn.max()), 1e-300)


def uniform_check(what, out, args, kw, tol):
    """The uniform kernel's ``out`` (blocks, column norms) against its
    plain version on ``args``: blocks and norms within ``tol`` of max |C|
    and of the largest norm, occupancy (norms > 0) exactly; and at
    'high', the blocks nearer that bf16x3 plain version than the exact
    float32 product (the plain version at 'highest' on the same inputs),
    which a kernel that ran 'high' as exact float32 would not be.  Raises
    on failure.  -> the blocks' max abs error."""
    thr = kw["threshold"]
    pb, pn = sp.spgemm_uniform_plain(*args, **kw)
    kb, kn = (x.to(pb.device) for x in out)
    aerr, err = _errors(kb, pb, thr)
    nerr = _norm_error(kn, pn, kb, pb, thr)
    occupancy = torch.equal(kn > 0, pn > 0)
    del pb, pn
    exact = None
    if kw["precision"] == "high":
        eb = sp.spgemm_uniform_plain(*args, **{**kw, "precision": "highest"})
        exact = _errors(kb, eb[0], thr)[1]
        del eb
    _check(what, err, tol, occupancy, nerr, exact)
    return aerr


def uniform_kernel_cases(errs, gen, bs):
    """The uniform kernel on the card against its plain version on the
    CPU (``uniform_check``): A a 136-row band with holes, an empty and a
    ragged row and one row whose col ids leave its window; B raw blocks
    of another band; in groups of 8 (the last group's window clamped to
    NBK - W) and 16 (a padded last group); both addressings; f32 at
    'highest' and 'high', bf16 operands; alpha != 1 and k_out > span;
    threshold > 0.  float64 operands, which only the plain version
    takes, are refused on the card.  -> the launches made."""
    rows, ka = 136, 3
    thr = 0.5 * math.sqrt(bs)
    ac, ab = band_operand(gen, rows, ka, bs, torch.float64, holes=0.15)
    ac[7] = torch.tensor([0, 50, rows - 1], dtype=torch.int32)
    bb = band_operand(gen, rows, ka, bs, torch.float64)[1]
    tiers = (("highest", torch.float32), ("high", torch.float32),
             ("bf16", torch.bfloat16))
    n = 0
    for g in (8, 16):
        pad = -rows % g
        ac_p = torch.cat([ac, ac.new_full((pad, ka), EMPTY)])
        ab_p = torch.cat([ab, ab.new_zeros((pad, ka, bs, bs))])
        wlo = sp._v3_window(ac_p, g)[0]
        for (prec, dt), addr, (k_out, alpha) in itertools.product(
                tiers, ("col", "position"), ((5, 1.7), (7, 1.0))):
            args = (ac_p, ab_p.to(dt), bb.to(dt), wlo)
            kw = dict(kb=ka, k_out=k_out, g_rows=g, w=ka + g - 1, span=5,
                      addressing=addr, precision=prec, alpha=alpha,
                      threshold=thr)
            before = sp.launches["spgemm_uniform"]
            out = sp.spgemm_uniform(*(x.cuda() for x in args), **kw)
            torch.cuda.synchronize()
            if sp.launches["spgemm_uniform"] != before + 1:
                raise AssertionError("spgemm_uniform did not launch once")
            n += 1
            aerr = uniform_check(
                f"{str(dt)[6:]} bs={bs} g={g} [spgemm_uniform {prec} {addr} "
                f"k_out={k_out}]", out, args, kw,
                uniform_tol(prec, torch.float32, ka * bs))
            errs["spgemm_uniform"] = max(errs["spgemm_uniform"], aerr)
        try:
            sp.spgemm_uniform(*(x.cuda() for x in (ac_p, ab_p, bb, wlo)),
                              **{**kw, "precision": "highest"})
        except TypeError:
            pass
        else:
            raise AssertionError("spgemm_uniform took float64 on the card")
    return n


def tier_work(precision: str, flops: float):
    """(operations, the peak of their type) of a float32 product at a
    tier: three bf16 products on the tensor cores at 'high', one at
    'bf16', float32 on the FMA pipes at 'highest'."""
    if precision == "high":
        return 3 * flops, "bf16_tensor"
    if precision == "bf16":
        return flops, "bf16_tensor"
    return flops, "fp32"


def phase_timing(errs, times):
    """Kernels and plain versions on the card at the main path's shapes:
    the flagship X @ X through the band kernel at 'highest' and 'high'
    (split pass included), the split pass alone on its X, the general
    kernel on the same product in rank form at 'high', and the general
    kernel at the phase-7 X @ X (f64); then the band kernel's
    tensor-core product alone on X split once.  -> nothing; fills errs
    and times (the `kernels` line takes that product, the split pass
    and the general kernel at the parity shape)."""
    gen = torch.Generator().manual_seed(7)
    # flagship X @ X: 8192 rows, KA = KB = 5, full span 9, bs 128, f32
    ac, ab = band_operand(gen, 8192, 5, 128, torch.float32)
    ac, ab = ac.cuda(), ab.cuda() / 128
    gg0, _, ok = sp.band_plan(ac, ac, 9, span=9)
    assert bool(ok)
    flops = 2 * 128 ** 3 * int((sp._candidate_ids(ac, ac) != EMPTY).sum())
    plan9, _, _ = sp.structure_plan(ac, ac, 9)
    runs = []
    for prec in ("highest", "high"):
        kw = dict(k_out=9, span=9, alpha=1.0, threshold=1e-7,
                  precision=prec)
        runs.append((
            "spgemm_band", prec, "R=8192 KA=KB=5 k_out=9 bs=128 f32",
            lambda kw=kw: sp.spgemm_band(ac, ab, ac, ab, gg0, **kw),
            lambda kw=kw: sp.spgemm_band_plain(ac, ab, ac, ab, gg0, **kw),
            5, 5 * 128, *tier_work(prec, flops), (ac, ab, gg0)))
    kw = dict(k_out=9, alpha=1.0, threshold=1e-7, precision="high")
    runs.append((
        "spgemm_general", "high", "R=8192 KA=KB=5 k_out=9 bs=128 f32 rank "
        "form", lambda: sp.spgemm_general(ac, ab, ac, ab, plan9, **kw),
        lambda: sp.spgemm_general_plain(ac, ab, ac, ab, plan9, **kw), 5,
        5 * 128, *tier_work("high", flops), (ac, ab, plan9)))
    # phase-7 X @ X: 256 rows, KA = KB = 10, k_out 10, bs 32, f64
    gc, gb = band_operand(gen, 256, 10, 32, torch.float64)
    gc, gb = gc.cuda(), gb.cuda() / 32
    plan, _, _ = sp.structure_plan(gc, gc, 10)
    kw2 = dict(k_out=10, alpha=1.0, threshold=1e-7)
    runs.append((
        "spgemm_general", "highest", "R=256 KA=KB=10 k_out=10 bs=32 f64",
        lambda: sp.spgemm_general(gc, gb, gc, gb, plan, **kw2),
        lambda: sp.spgemm_general_plain(gc, gb, gc, gb, plan, **kw2), 20,
        10 * 32, 2 * 32 ** 3 * int((plan < 10).sum()), "fp64_tensor",
        (gc, gb, plan)))
    ms_of = {}
    for name, prec, shape, kern, plain, reps, depth, ops, peak, inputs \
            in runs:
        (kb, kn), (pb, pn) = kern(), plain()
        torch.cuda.synchronize()
        aerr, err = _errors(kb, pb, 1e-7)
        tol = entry_tol(prec, kb.dtype, depth)
        ok = err <= tol and torch.equal(kn > 0, pn > 0)
        exact = ""
        if prec == "high":
            ex = (sp.spgemm_band_plain if name == "spgemm_band"
                  else sp.spgemm_general_plain)
            ex_args = (ac, ab, ac, ab, gg0 if name == "spgemm_band"
                       else plan9)
            ex_kw = dict(k_out=9, alpha=1.0, threshold=1e-7)
            if name == "spgemm_band":
                ex_kw["span"] = 9
            ex_err = _errors(kb, ex(*ex_args, **ex_kw)[0], 1e-7)[1]
            ok = ok and err < ex_err
            exact = f", vs exact {ex_err:.2e}"
        del pb, pn
        if not ok:
            raise AssertionError(f"{name} {prec} at {shape}: error "
                                 f"{err:.2e} > {tol:.2e}{exact}")
        errs[name] = max(errs[name], aerr)
        ms, pms = lowk.cuda_time(kern, reps), lowk.cuda_time(plain, reps)
        ms_of[name, prec, shape] = ms, pms
        t = timed(ms, pms, ops, peak, (*inputs, kb, kn))
        if peak == "fp64_tensor":
            times[name] = t
        print(f"  {name} {prec} {shape}: kernel {ms:.3f} ms, plain "
              f"{pms:.3f} ms, {bound_text(t)}, max rel err {err:.2e} "
              f"(tolerance {tol:.1e}){exact}")
        del kb, kn
    # the split pass alone on the flagship X: what 'high' adds
    ms = lowk.cuda_time(lambda: sp.split_bf16(ab), 10)
    pms = lowk.cuda_time(lambda: sp.split_bf16x3(ab), 10)
    hi, lo = sp.split_bf16(ab)
    times["split_bf16"] = timed(ms, pms, 0.0, "fp32", (ab, hi, lo))
    del hi, lo
    print(f"  split_bf16 X {list(ab.shape)} f32: kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms, {bound_text(times['split_bf16'])}")
    # the band kernel's tensor-core product alone, on X split once: its
    # entry in the `kernels` line, as the split pass has its own (its
    # plain_ms is the plain version of the whole 'high' multiply)
    flag = "R=8192 KA=KB=5 k_out=9 bs=128 f32"
    planes = sp.split_bf16(ab)
    times["spgemm_band"] = product_alone(
        f"spgemm_band high {flag}", lambda: sp._run_kernel(
            "spgemm_band", ac, ab, ac, ab, gg0, tuple(ac.shape),
            (9, 9, 128), "high", 1.0, 1e-7, planes=(planes, planes)),
        runs[1][3](), ms_of["spgemm_band", "high", flag][1], flops,
        (ac, *planes, gg0))
    del planes
    fast = ms_of["spgemm_band", "highest", flag][0] / ms_of[
        "spgemm_band", "high", flag][0]
    print(f"  band kernel at the flagship X @ X: 'high' (split pass "
          f"included) {fast:.2f}x faster than 'highest'")
    if fast < 2:
        raise AssertionError("the band kernel's 'high' is not twice as "
                             "fast as its 'highest'")


def product_alone(what, run, wrapper_out, plain_ms, flops, inputs):
    """A kernel's tensor-core product alone at 'high', on planes split
    once beforehand (``run``), as the `kernels` line reads the band,
    window and uniform kernels: bit for bit the wrapper's output, timed,
    bound against its three bf16 products or its bytes (``inputs`` and
    its output).  The split pass has its own entry.  -> the timed
    dict."""
    kb, kn = run()
    if not (torch.equal(kb, wrapper_out[0])
            and torch.equal(kn, wrapper_out[1])):
        raise AssertionError(f"{what}: the product on planes split once "
                             "differs from the wrapper's output")
    ms = lowk.cuda_time(run, lowk.REPS)
    t = timed(ms, plain_ms, *tier_work("high", flops), (*inputs, kb, kn))
    print(f"  {what}, the product alone (split once beforehand): kernel "
          f"{ms:.3f} ms, {bound_text(t)}, bit for bit the wrapper's")
    return t


def lowk_plains(op):
    """arm -> (its kernel, the arm's inputs, the tier its products run
    at, the kernel's plain version on them) for every kernel arm of the
    low-K profile.  The window kernel's 'bf16' reads bfloat16
    operands."""
    ac, ab = op.cols, op.blocks
    ka = ac.shape[1]
    ac3, ab3, plan3 = op.padded()
    kw = dict(k_out=op.k_out, alpha=1.0, threshold=op.threshold)
    ab3_bf16, panel_bf16 = ab3.to(torch.bfloat16), op.panel.to(torch.bfloat16)

    def general():
        args = (ac, ab, ac, ab, op.plan)
        return ("spgemm_general", args, "highest",
                lambda: sp.spgemm_general_plain(*args, **kw))

    def stream():
        args = (ac, ab, op.panel, op.plan)
        return ("spgemm_stream", args, "highest",
                lambda: sp.spgemm_stream_plain(*args, kb=ka, **kw))

    def window(blocks, panel, precision):
        args = (ac3, blocks, panel, plan3, op.wlo)
        return ("spgemm_window", args, precision,
                lambda: sp.spgemm_window_plain(
                    *args, kb=ka, g_rows=op.g_rows, w=op.w,
                    precision=precision, **kw))

    def band(precision):
        args = (ac, ab, ac, ab, op.gg0)
        return ("spgemm_band", args, precision,
                lambda: sp.spgemm_band_plain(*args, span=op.span,
                                             precision=precision, **kw))

    return {
        "general": general(),
        "stream": stream(),
        "window_highest": window(ab3, op.panel, "highest"),
        "window_high": window(ab3, op.panel, "high"),
        "window_bf16": window(ab3_bf16, panel_bf16, "bf16"),
        "band_highest": band("highest"),
        "band_high": band("high"),
        "band_bf16": band("bf16"),
    }


def phase_lowk(errs, times, op):
    """The low-K profile at full size on the card (``op``, the chain
    operand), with the launches of each kernel counted over its run;
    then, on its operand, every kernel arm against its plain version on
    the same inputs (also on the card; at 'high' also nearer it than the
    kernel's exact plain version), the exact rank-form arms (general,
    stream, window 'highest') against one another, window 'high'
    against the general kernel at 'high' (the same pairs in the same
    order on the same planes), the `matmul` arm against the band
    kernel's plain version slot by col id, and the plain versions
    timed.  -> the profile's launch counts."""
    sp.reset_launches()
    res = lowk.profile("cuda", op=op)
    counts = dict(sp.launches)
    print(f"  shape {json.dumps(res['shape'])}, {res['products']} block "
          f"products, {res['flops'] / 1e9:.1f} GFLOP, "
          f"{res['bytes'] / 1e9:.2f} GB least traffic, launches {counts}")
    for name, ms in res["ms"].items():
        print(f"  {name}: {ms:.3f} ms")
    # the FP32 yardstick of the exact arms: cuBLAS on the same number of
    # dense bs^3 products in float32 (TF32 off, config.py); printed, not
    # the stream kernel's library_ms (it computes no pruned block-ELL
    # product) and never called by the port
    bs = op.h.bs
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((op.products(), bs, bs), device="cuda", generator=gen)
    bmm_ms = lowk.cuda_time(lambda: torch.bmm(x, x), lowk.REPS)
    del x
    print(f"  yardstick: torch.bmm in float32 over the same {op.products()} "
          f"products of {bs}^3: {bmm_ms:.3f} ms "
          f"({op.flops() / bmm_ms / 1e9:.1f} TFLOP/s); stream kernel "
          f"{res['ms']['stream']:.3f} ms "
          f"({op.flops() / res['ms']['stream'] / 1e9:.1f} TFLOP/s)")
    rows, ka = op.cols.shape
    arms = lowk.arms(op)
    # the bound of a sum of depth = KA * bs products in float32 at each
    # arm's tier, as in the timing phase (the 'bf16' arms accumulate
    # their bfloat16 inputs in float32)
    depth = ka * op.h.bs
    rank_form = ("general", "stream", "window_highest")
    first = None
    plains = lowk_plains(op)
    kw = dict(k_out=op.k_out, alpha=1.0, threshold=op.threshold)
    for arm, (kern, inputs, tier, plain) in plains.items():
        tol = uniform_tol(tier, torch.float32, depth)
        out = arms[arm]()
        blk, nrm = (x[:rows] for x in out)
        pb, pn = (x[:rows] for x in plain())
        torch.cuda.synchronize()
        aerr, err = _errors(blk, pb, op.threshold)
        ok = err <= tol and torch.equal(nrm > 0, pn > 0)
        same = ""
        if tier == "high":
            exact = ("band_highest" if kern == "spgemm_band"
                     else "window_highest")
            eb = plains[exact][3]()[0][:rows]
            ex_err = _errors(blk, eb, op.threshold)[1]
            del eb
            ok = ok and err < ex_err
            same = f", vs exact {ex_err:.2e}"
        if arm == "window_high":
            gb, gn = sp.spgemm_general(op.cols, op.blocks, op.cols,
                                       op.blocks, op.plan, precision="high",
                                       **kw)
            gerr = _errors(blk, gb, op.threshold)[1]
            bits = torch.equal(blk, gb) and torch.equal(nrm, gn)
            ok = ok and gerr <= tol and torch.equal(nrm > 0, gn > 0)
            same += (f", vs spgemm_general at 'high': max rel err "
                     f"{gerr:.2e}, "
                     f"{'bit for bit' if bits else 'not bit for bit'}")
            del gb, gn
        if arm in rank_form and first is None:
            first = (arm, blk, nrm)
        elif arm in rank_form:
            ferr = _errors(blk, first[1], op.threshold)[1]
            bits = torch.equal(blk, first[1]) and torch.equal(nrm, first[2])
            # one exact core, one order of FMAs: the same bits
            ok = ok and bits and ferr <= tol
            same = (f", vs {first[0]}: max rel err {ferr:.2e}, "
                    f"{'bit for bit' if bits else 'not bit for bit'}")
        errs[kern] = max(errs[kern], aerr)
        del blk, nrm, pb, pn
        pms = lowk.cuda_time(plain, 3)
        t = timed(res["ms"][arm], pms, *tier_work(tier, op.flops()),
                  (*inputs, *out))
        if arm == "stream":
            times[kern] = t
        print(f"  {arm} [{kern}]: kernel {t['ms']:.3f} ms, plain "
              f"{pms:.3f} ms, {bound_text(t)}, vs plain max rel err "
              f"{err:.2e} (tolerance {tol:.1e}){same}"
              f"{'' if ok else '  MISMATCH'}")
        if not ok:
            raise AssertionError(f"{arm} [{kern}] disagrees with its plain "
                                 "version on the low-K operand")
        if arm == "window_high":
            # A and the panel are two storages: two splits
            ac3, ab3, panel, plan3, wlo = inputs
            planes = sp._planes(ab3, panel, "high")
            win = dict(kb=ka, g_rows=op.g_rows, w=op.w, precision="high",
                       **kw)
            times[kern] = product_alone(
                "window_high", lambda: sp._run_window(
                    *inputs, **win, planes=planes), out, pms, op.flops(),
                (ac3, *planes[0], *planes[1], plan3, wlo))
            del planes
        del out
    del first
    # matmul ('auto', band kernel at 'high') against the band plain
    # version, each side's blocks gathered onto the other's col ids
    mm = arms["matmul"]()
    mc, mb = mm.col_ids[0], mm.blocks[0]
    occ0 = sp.band_plan(op.cols, op.cols, op.k_out, span=op.span)[1]
    pc = occ0[:, None] + torch.arange(op.k_out, dtype=occ0.dtype,
                                      device=occ0.device)
    pb = plains["band_high"][3]()[0]
    torch.cuda.synchronize()
    aerr, err = _errors(mb, bell.align(mc, pc, pb), op.threshold)
    err = max(err, _errors(bell.align(pc, mc, mb), pb, op.threshold)[1])
    errs["spgemm_band"] = max(errs["spgemm_band"], aerr)
    tol = uniform_tol("high", torch.float32, depth)
    print(f"  matmul [spgemm_band]: vs band plain at 'high' max rel err "
          f"{err:.2e} (tolerance {tol:.1e})")
    if err > tol:
        raise AssertionError("the matmul arm disagrees with the band "
                             "kernel's plain version on the low-K operand")
    return counts


def _check(what, err, tol, occupancy, norm_err=None, exact_err=None):
    """Print one comparison and raise unless the blocks' error (err) and,
    where given, the norms' (norm_err) are within tol, occupancy is
    exact and, where given, the blocks lie nearer their reference than
    the exact float32 product (exact_err)."""
    ok = (max(err, norm_err or 0.0) <= tol and occupancy
          and (exact_err is None or err < exact_err))
    print(f"  {what}: max rel err {err:.2e}"
          + ("" if norm_err is None else f", norms {norm_err:.2e}")
          + f" (tolerance {tol:.1e})"
          + ("" if exact_err is None else
             f", vs exact float32 {exact_err:.2e}")
          + f", occupancy {'exact' if occupancy else 'DIFFERS'}"
          + ("" if ok else "  MISMATCH"))
    if not ok:
        raise AssertionError(f"{what} disagree")


def phase_lowk_r5(errs, times, op):
    """The round-5 low-K profile at full size on the card, on the lowk
    phase's operand, with the launches counted over its run; then every
    uniform arm against its plain version on the same inputs (also on
    the card), `uniform_pos_highest_g8` against `diag_highest`, and
    `uniform_pos_high_g8` (bf16x3) against the band kernel at
    'highest' (exact float32) on the interior rows, and the plain
    versions timed.  -> the profile's launch counts."""
    sp.reset_launches()
    res = lowk_r5.profile("cuda", op=op)
    counts = dict(sp.launches)
    print(f"  shape {json.dumps(res['shape'])}, {res['uniform_products']} "
          f"uniform block products, launches {counts}")
    for name, ms in res["ms"].items():
        print(f"  {name}: {ms:.3f} ms")
    rows, ka = op.cols.shape
    bs, span = op.h.bs, op.span
    arms = lowk_r5.arms(op)
    kept = {}
    flops = 2 * bs ** 3 * lowk_r5.uniform_products(op)
    for name, (args, kw) in lowk_r5.uniform_args(op).items():
        out = arms[name]()
        torch.cuda.synchronize()
        pms = lowk.cuda_time(
            lambda a=args, k=kw: sp.spgemm_uniform_plain(*a, **k), 3)
        # 'high' is three bf16 products a block product on the tensor
        # cores, 'highest' one float32 product on the FMA pipes
        tier = kw["precision"]
        t = timed(res["ms"][name], pms, flops * (3 if tier == "high" else 1),
                  "fp32" if tier == "highest" else "bf16_tensor",
                  (*args, *out))
        aerr = uniform_check(
            f"{name} [spgemm_uniform]: kernel {t['ms']:.3f} ms, plain "
            f"{pms:.3f} ms, {bound_text(t)}; vs plain", out, args, kw,
            uniform_tol(tier, torch.float32, ka * bs))
        errs["spgemm_uniform"] = max(errs["spgemm_uniform"], aerr)
        if name == UNIFORM_ARM:
            # A is X and B its leading rows: one split
            planes = sp._planes(args[1], args[2], "high")
            times["spgemm_uniform"] = product_alone(
                name, lambda: sp._run_uniform(*args, **kw, planes=planes),
                out, pms, flops, (args[0], *planes[0], args[3]))
            del planes
        if name in ("uniform_pos_highest_g8", "uniform_pos_high_g8"):
            kept[name] = out
        del out
    print("  library yardstick, the diag form in cuBLAS (TF32 off): "
          + ", ".join(f"{p} {res['ms']['diag_' + p]:.3f} ms"
                      for p in lowk_r5.TIERS))
    # on the interior rows, slot t of every arm holds col r - 2 + t
    inner = lowk_r5.interior(op, 8)
    ub, un = (x[:rows][inner][:, :span] for x in
              kept.pop("uniform_pos_highest_g8"))
    db, dn = (x[inner] for x in arms["diag_highest"]())
    torch.cuda.synchronize()
    tol = uniform_tol("highest", torch.float32, 2 * ka * bs)
    _check(f"uniform_pos_highest_g8 vs diag_highest on {int(inner.sum())} "
           "interior rows", _errors(ub, db, op.threshold)[1], tol,
           torch.equal(un.sum(-1) > 0, dn > 0))
    del ub, un, db, dn
    # the bf16x3 split against exact float32: each product within 3 *
    # 2^-16 of |a||b| (the dropped lo x lo term and the rounding of the
    # two lo parts), plus both sides' float32 sums; in absolute terms
    # against the largest sum of |a||b|
    hb, hn = (x[:rows][inner][:, :span] for x in
              kept.pop("uniform_pos_high_g8"))
    eb, en = (x[inner] for x in arms["band_highest"]())
    abs_ab = op.blocks.abs()
    mag = sp.spgemm_band_plain(op.cols, abs_ab, op.cols, abs_ab, op.gg0,
                               k_out=op.k_out, span=span, alpha=1.0,
                               threshold=0.0)[0][inner].abs().max()
    torch.cuda.synchronize()
    aerr = _errors(hb, eb, op.threshold)[0]
    bound = float(mag) * (3 * 2.0 ** -16
                          + 4 * ka * bs * torch.finfo(torch.float32).eps / 2)
    scale = float(eb.abs().max())
    _check(f"uniform_pos_high_g8 (bf16x3) vs band_highest (f32) on "
           f"{int(inner.sum())} interior rows", aerr / scale, bound / scale,
           torch.equal(hn.sum(-1) > 0, en > 0))
    del en
    # the band kernel's bf16x3 against the uniform kernel's, both on
    # tc.cuh's product with the same pairs in the same order on the
    # interior rows: within BF16X3_PAIR_TOL, nearer each other than the
    # band kernel's 'high' is to exact float32, and bit for bit or not
    bb, bn = (x[inner][:, :span] for x in arms["band_high"]())
    torch.cuda.synchronize()
    ex_err = _errors(bb, eb, op.threshold)[1]
    del eb
    bits = torch.equal(bb, hb)
    _check(f"band_high (bf16x3) vs uniform_pos_high_g8 (bf16x3) on "
           f"{int(inner.sum())} interior rows, blocks "
           f"{'bit for bit' if bits else 'not bit for bit'}",
           _errors(bb, hb, op.threshold)[1], BF16X3_PAIR_TOL,
           torch.equal(bn > 0, hn.sum(-1) > 0), exact_err=ex_err)
    band_ms, uni_ms = res["ms"]["band_high"], res["ms"][UNIFORM_ARM]
    planes = sp.split_bf16(op.blocks)
    band_alone = lowk.cuda_time(lambda: sp._run_kernel(
        "spgemm_band", op.cols, op.blocks, op.cols, op.blocks, op.gg0,
        tuple(op.cols.shape), (op.k_out, span, bs), "high", 1.0,
        op.threshold, planes=(planes, planes)), lowk.REPS)
    del planes
    print(f"  low-K X @ X at 'high': band kernel {band_ms:.3f} ms, "
          f"{UNIFORM_ARM} {uni_ms:.3f} ms (split pass included in both); "
          f"products alone on X split once: band kernel {band_alone:.3f} "
          f"ms, {UNIFORM_ARM} {times['spgemm_uniform']['ms']:.3f} ms")
    return counts


def phase_parity():
    """TRS4 at the reference benchmark's CPU size in f64: general kernel
    on the card against plain versions on the CPU.  -> the card solve's
    launch counts."""
    dim, bs = 8192, 32
    results = {}
    for dev in ("cpu", "cuda"):
        grid = ProcessGrid(device=dev)
        h = PM.banded(dim, 16, gapped_fn, bs=bs, grid=grid,
                      dtype=torch.float64)
        isq = PM.identity(dim, bs=bs, grid=grid, dtype=torch.float64)
        t0 = time.perf_counter()
        _, energy, mu, n, counts = solve(h, isq, dim / 2,
                                         flagship_params(10, "pallas"))
        secs = time.perf_counter() - t0
        results[dev] = (energy, mu, n, counts)
        print(f"  {dev}: {n} iterations, energy {energy!r}, "
              f"mu {mu!r}, {secs:.2f} s, launches {counts}")
    (e0, m0, i0, c0), (e1, m1, i1, c1) = results["cpu"], results["cuda"]
    rel = abs(e1 - e0) / abs(e0)
    print(f"  energy rel diff {rel:.2e}")
    if rel > 1e-10 or i0 != i1:
        raise AssertionError("card and CPU solves disagree")
    if any(c0.values()) or not c1["spgemm_general"]:
        raise AssertionError("the CPU solve launched a kernel, or the card "
                             "solve never launched the general kernel")
    return c1


def phase_flagship():
    """The flagship solve on the card at 'high' (the reference's
    setting), timed, then its certificates at 'highest'; then the same
    at 'highest'.  Both must meet the bars.  -> the 'high' solve's
    launch counts."""
    config = trs4_tiers.CONFIGS["flagship"]
    h, isq, nel = trs4_tiers.system(config["dim"], config["bs"], "cuda")
    result = {}
    for precision in ("high", "highest"):
        params = flagship_params(config["k_out"], "pallas_band", precision)
        warm = params.copy()
        warm.max_iterations = 2
        density.trs4(h, isq, nel, warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rho, energy, mu, n, counts = solve(h, isq, nel, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        print(f"  '{precision}': {n} iterations, {wall:.3f} s wall, "
              f"{wall / n:.4f} s per iteration, energy {energy!r}, mu "
              f"{mu!r}, rho_nnz {rho.nnz}, peak memory {peak / 2**30:.2f} "
              f"GiB, launches {counts}")
        inv = purity_invariants(rho, h, nel, params.threshold)
        del rho
        torch.cuda.synchronize()
        print(f"  '{precision}' certificates (at 'highest'): "
              + json.dumps(inv))
        ok = (n <= 10 and inv["idempotency_rel"] <= 1e-5
              and inv["commutator_rel"] <= 5e-5
              and inv["trace_abs_err"] / nel <= 1e-6
              and math.isfinite(energy) and math.isfinite(mu))
        if not ok:
            raise AssertionError(f"flagship certificates at '{precision}' "
                                 "out of bounds")
        if not counts["spgemm_band"]:
            raise AssertionError("the flagship solve never launched the "
                                 "band kernel")
        result[precision] = (wall, counts)
    if not result["high"][1]["split_bf16"]:
        raise AssertionError("the flagship solve at 'high' never launched "
                             "the split pass")
    print(f"  'high' against 'highest': {result['high'][0]:.3f} s against "
          f"{result['highest'][0]:.3f} s")
    return result["high"][1]


def _certified(what: str, res: dict, nel: float, trace: bool = True):
    """Raise unless a solve's generalized certificates meet the
    flagship's bars (the trace bar only when ``trace``)."""
    ok = (res["idempotency_rel"] <= 1e-5 and res["commutator_rel"] <= 5e-5
          and (not trace or res["trace_abs_err"] / nel <= 1e-6)
          and math.isfinite(res["energy"]) and math.isfinite(res["mu"]))
    if not ok:
        raise AssertionError(f"{what}: certificates out of bounds")


def _overlap_line(name: str, r: dict, nel: float) -> str:
    return (f"  {name}: {r['iterations']} iterations, {r['seconds']:.3f} s "
            f"wall, {r['seconds_per_iteration']:.4f} s per iteration, "
            f"energy {r['energy']!r}, mu {r['mu']!r}, k {r['k']}, peak "
            f"memory {r['peak_gib']:.2f} GiB, launches {r['launches']}; "
            f"certificates (at 'highest'): idempotency "
            f"{r['idempotency_rel']!r}, trace error per electron "
            f"{r['trace_err'] / nel!r}, commutator {r['commutator_rel']!r}")


# the plain version of each wrapper that ``sp.spgemm`` dispatches to
PLAINS = {"spgemm_band": sp.spgemm_band_plain,
          "spgemm_general": sp.spgemm_general_plain}
# block rows of A per plain-version call when a path's product is held
HOLD_ROWS = 1024


def _hold_product(name, args, kw, out, errs) -> str:
    """A kernel's output ``out`` on the path's card tensors ``args`` (A,
    B and the band or general index) against its plain version on the
    same tensors, HOLD_ROWS block rows of A at a time: blocks to
    ``entry_tol`` at the depth KA * bs, relative to max |C|; a block
    kept on one side only must lie within rounding of the threshold;
    at 'high', nearer the bf16x3 plain version than the exact product.
    -> the product's line."""
    kb, kn = out
    ac, ab, bc, bb, ix = args
    prec, thr = kw["precision"], kw["threshold"]
    R, KA = ac.shape
    bs = ab.shape[-1]
    tol = entry_tol(prec, kb.dtype, KA * bs)
    diff = {"tier": 0.0, "exact": 0.0}
    top, odd, ok = 0.0, 0, True
    for r0 in range(0, R, HOLD_ROWS):
        rs = slice(r0, min(r0 + HOLD_ROWS, R))
        part = (ac[rs], ab[rs], bc, bb, ix[rs])
        pb, pn = PLAINS[name](*part, **kw)
        diff["tier"] = max(diff["tier"], _errors(kb[rs], pb, thr)[0])
        top = max(top, float(pb.abs().max()))
        one_side = (kn[rs] > 0) != (pn > 0)
        odd += int(one_side.sum())
        kept = torch.maximum(kb[rs].abs().amax((-1, -2)),
                             pb.abs().amax((-1, -2)))[one_side]
        ok = ok and bool((kept <= thr * (1 + 1e-4)).all())
        del pb, pn
        if prec == "high":
            eb, _ = PLAINS[name](*part, **{**kw, "precision": "highest"})
            diff["exact"] = max(diff["exact"], _errors(kb[rs], eb, thr)[0])
            del eb
    err = diff["tier"] / max(top, 1e-300)
    ok = ok and err <= tol
    exact = ""
    if prec == "high":
        ex_err = diff["exact"] / max(top, 1e-300)
        ok = ok and (err < ex_err or err == 0.0)
        exact = f", vs exact {ex_err:.2e}"
    what = (f"{name} {prec} R={R} KA={KA} KB={bc.shape[1]} "
            f"k_out={kw['k_out']} bs={bs} {str(kb.dtype)[6:]}")
    if not ok:
        raise AssertionError(f"{what} on the overlap path: error "
                             f"{err:.2e} > {tol:.2e}{exact}, or one of "
                             f"{odd} blocks kept on one side only lies "
                             "above the threshold")
    errs[name] = max(errs[name], diff["tier"])
    return (f"{what}: max rel err {err:.2e} (tolerance {tol:.1e}){exact}, "
            f"{odd} blocks kept on one side only")


def _hold_split(x, lo, out) -> str:
    """The split pass's planes ``out`` of the path's operand ``x`` against
    its plain version on the same card tensor, bit for bit."""
    want = sp.split_bf16x3(x) if lo else (x.to(torch.bfloat16), None)
    same = all(g is None or torch.equal(g.view(torch.int16),
                                        w.view(torch.int16))
               for g, w in zip(out, want))
    what = f"split_bf16 {'hi and lo' if lo else 'hi'} {list(x.shape)}"
    if not same:
        raise AssertionError(f"{what} on the overlap path disagrees with "
                             "its plain version")
    return f"{what}: bit for bit"


@contextlib.contextmanager
def _held_on_path(errs, held: dict):
    """While open, each product of the band and general kernels that
    ``sp.spgemm`` launches, and each split pass, is held against its
    plain version on the same card tensors, once for each (kernel,
    tier, KA, KB, k_out) or split shape; ``held`` maps each to its
    line."""
    wrappers = {name: getattr(sp, name) for name in (*PLAINS, "split_bf16")}

    def product(name):
        def call(*args, **kw):
            out = wrappers[name](*args, **kw)
            key = (name, kw["precision"], args[0].shape[1],
                   args[2].shape[1], kw["k_out"])
            if key not in held:
                held[key] = _hold_product(name, args, kw, out, errs)
            return out
        return call

    def split(x, *, lo=True):
        out = wrappers["split_bf16"](x, lo=lo)
        key = ("split_bf16", lo, tuple(x.shape))
        if key not in held:
            held[key] = _hold_split(x, lo, out)
        return out

    for name in PLAINS:
        setattr(sp, name, product(name))
    sp.split_bf16 = split
    try:
        yield
    finally:
        for name, fn in wrappers.items():
            setattr(sp, name, fn)


def overlap_products(errs):
    """The band and general kernels and the split pass held against their
    plain versions at the shapes that the overlap path gives them: the
    ISQ (at 'highest'), PM at 'highest' and TRS4 at 'high' run once more
    at the flagship's width inside ``_held_on_path``.  Their launches
    are not counted."""
    config = trs4_tiers.CONFIGS["flagship"]
    h, s, nel = overlap.system(config["dim"], config["bs"], "cuda")
    held = {}
    with _held_on_path(errs, held):
        isq_m, _, _ = overlap.isq(s)
        del s
        for name, precision in (("pm", "highest"), ("trs4", "high")):
            overlap.solve(name, h, isq_m, nel,
                          overlap.solve_params(precision))
    torch.cuda.synchronize()
    for line in held.values():
        print(f"  held on the path: {line}")
    kinds = {key[:2] for key in held}
    if not {("spgemm_band", "highest"), ("spgemm_general", "highest"),
            ("spgemm_band", "high"), ("split_bf16", True)} <= kinds:
        raise AssertionError("the overlap path's products held did not "
                             "cover the band and general kernels at "
                             "'highest' and the band kernel with its "
                             "split at 'high'")


def overlap_parity():
    """S -> ISQ -> TRS4 and TRS2 at dim 4096, bs 32, f64: the kernels on
    the card against the plain versions on the CPU.  -> the card's
    launch counts."""
    dim, bs = 4096, 32
    results = {}
    for dev in ("cpu", "cuda"):
        h, s, nel = overlap.system(dim, bs, dev, torch.float64)
        t0 = time.perf_counter()
        isq, n_isq, counts = overlap.isq(s)
        out = {"isq": n_isq}
        for name in ("trs4", "trs2"):
            _, energy, _, n, c = overlap.solve(name, h, isq, nel)
            out[name] = (energy, n)
            counts = {k: counts[k] + c[k] for k in counts}
        secs = time.perf_counter() - t0
        results[dev] = (out, counts)
        print(f"  parity {dev}: ISQ {n_isq} iterations, " + ", ".join(
            f"{name} {n} iterations energy {e!r}"
            for name, (e, n) in ((k, out[k]) for k in ("trs4", "trs2")))
            + f", {secs:.2f} s, launches {counts}")
    (cpu, c0), (card, c1) = results["cpu"], results["cuda"]
    rel = max(abs(card[k][0] - cpu[k][0]) / abs(cpu[k][0])
              for k in ("trs4", "trs2"))
    print(f"  parity: energies' largest rel diff {rel:.2e}")
    if (rel > 1e-10 or cpu["isq"] != card["isq"]
            or any(cpu[k][1] != card[k][1] for k in ("trs4", "trs2"))):
        raise AssertionError("card and CPU disagree on the overlap path")
    if any(c0.values()) or not (c1["spgemm_general"] or c1["spgemm_band"]):
        raise AssertionError("the CPU path launched a kernel, or the card "
                             "path launched neither the band nor the "
                             "general kernel")
    return c1


def phase_overlap(errs):
    """The non-orthogonal path at the flagship's width
    (``profiling/overlap.py``): the overlap's inverse square root, then
    TRS4, TRS2, PM and HPCP with it at 'highest', each within the bars
    on the generalized certificates and their energies within 1e-6 of
    one another; TRS4 once more at 'high' (idempotency and commutator
    bars); then its kernels against their plain versions at the path's
    shapes (``overlap_products``, into ``errs``); then S -> ISQ -> TRS4,
    TRS2 on the card against the CPU in f64.  -> the launch counts of
    the ISQ and the timed solves."""
    config = trs4_tiers.CONFIGS["flagship"]
    nel = config["dim"] / 2
    res = overlap.run(config["dim"], config["bs"], "cuda")
    r = res["isq"]
    print(f"  ISQ: {r['iterations']} iterations, {r['seconds']:.3f} s, "
          f"k {r['k']}, max|ISQ S ISQ^T - I| {r['residual']!r} (at "
          f"'highest'), launches {r['launches']}")
    if not r["residual"] <= 1e-5:
        raise AssertionError("the overlap's inverse square root misses "
                             "its residual bar")
    counts = dict(r["launches"])
    energies = []
    for name in overlap.SOLVERS + ("trs4_high",):
        r = res[name]
        print(_overlap_line(name, r, nel))
        counts = {k: counts[k] + r["launches"][k] for k in counts}
        if name == "trs4_high":
            _certified(name, r, nel, trace=False)
            continue
        _certified(name, r, nel)
        if r["iterations"] > OVERLAP_CAPS[name]:
            raise AssertionError(f"{name} took {r['iterations']} "
                                 f"iterations, over its cap")
        energies.append(r["energy"])
    spread = (max(energies) - min(energies)) / abs(min(energies))
    print(f"  energies' spread {spread:.2e} (relative)")
    if spread > 1e-6:
        raise AssertionError("the four solvers' energies disagree")
    if not (counts["spgemm_band"] or counts["spgemm_general"]):
        raise AssertionError("the overlap path launched neither the band "
                             "nor the general kernel")
    overlap_products(errs)
    parity = overlap_parity()
    print(f"  launches on the path: {counts}; parity path {parity}")
    return counts


def main() -> int:
    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: ok, {time.perf_counter() - t0:.2f} s",
              flush=True)
        return out

    smi = run("device", phase_device)
    run("build", phase_build)
    errs = {k: 0.0 for k in KERNELS}
    times = {}
    run("kernels", phase_kernels, errs)
    run("timing", phase_timing, errs, times)
    # each kernel's own path counts its launches: the low-K profiles for
    # the stream, window and uniform kernels, the card solves for the
    # others
    op = lowk.operand("cuda")
    low = run("lowk", phase_lowk, errs, times, op)
    low_r5 = run("lowk_r5", phase_lowk_r5, errs, times, op)
    del op
    parity = run("parity", phase_parity)
    flagship = run("flagship", phase_flagship)
    non_orth = run("overlap", phase_overlap, errs)
    counts = {k: parity[k] + flagship[k] + non_orth[k]
              for k in ("spgemm_band", "spgemm_general", "split_bf16")}
    counts.update({k: low[k] for k in ("spgemm_stream", "spgemm_window")})
    counts["spgemm_uniform"] = low_r5["spgemm_uniform"]
    print(f"launches on each kernel's path: {counts} (parity solve "
          f"{parity}, flagship solve {flagship}, overlap path {non_orth}, "
          f"low-K profile {low}, round-5 low-K profile {low_r5})")
    for name, n in counts.items():
        if not n:
            raise AssertionError(f"{name} never launched on its path")
    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=counts[name], max_abs_err=errs[name],
                    **times[name], library_ms=None)
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
