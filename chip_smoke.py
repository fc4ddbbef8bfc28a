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
   general kernels through the entry point, the stream and window
   kernels through their wrappers (the window kernel also with bf16
   operands, and on the scattered case, whose col ids leave their
   group's window and are clamped), and the uniform kernel through its
   wrapper (both addressings, f32 at 'highest' and 'high', bf16; first
   groups at wlo = 0, last groups clamped to NBK - W, a padded last
   group, holes, a col id outside its window, k_out > span; blocks and
   column norms; 'high' nearer its bf16x3 plain version than the exact
   float32 product; f64 refused); then the band and general kernels
   and their plain versions timed at the shapes the TRS4 path gives
   them.
4. lowk: the low-K profile (ntpoly_tpu_torch/profiling/lowk.py) at
   full size, 2^19 rows of the chain at bs 128, every arm timed; then
   on its operand every kernel arm (general, stream, window and band
   at each tier) held against its plain version on the same inputs,
   the general, stream and window kernels against one another, the
   `matmul` arm against the band kernel's plain version, and the
   plain versions timed.
5. lowk_r5: the round-5 low-K profile (profiling/lowk_r5.py) on the
   same operand, every arm timed; then every uniform arm against its
   plain version on the same inputs (blocks, column norms and, for
   'high', the distance from the exact float32 product),
   `uniform_pos_highest_g8` against the diag form and
   `uniform_pos_high_g8` (bf16x3 on the tensor cores) against the band
   kernel's exact float32 on the interior rows, and the plain versions
   timed.  The diag arms are the library yardstick.
6. parity: TRS4 at dim 8192, bs 32, k_out 10, f64 through the general
   kernel on the card, and through the plain versions on the CPU.
7. flagship: TRS4 of the 2^20-row gapped chain at bs 128 in f32 through
   the band kernel, with its certificates (idempotency, commutator,
   electron count).

Kernel launches are counted on each kernel's own path, with the counts
reset just before the path and read just after it: the band and
general kernels in the card's TRS4 solves of phases 6 and 7 (the
`kernels` line reports their sum), the stream and window kernels in the
low-K profile of phase 4, the uniform kernel in the round-5 profile of
phase 5.  Each kernel's `bound_ms` is the larger of its least bytes
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

import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

from ntpoly_tpu_torch.config import EMPTY
from ntpoly_tpu_torch.core import bell
from ntpoly_tpu_torch.ops import spgemm as sp
from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.profiling import lowk, lowk_r5
from ntpoly_tpu_torch.solvers import density
from ntpoly_tpu_torch.solvers.parameters import SolverParameters
from ntpoly_tpu_torch.systems import gapped_fn
from ntpoly_tpu_torch.utils.logging import activate_logger, deactivate_logger

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
}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# published peaks of one H100 SXM (NVIDIA's data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "fp64_tensor": 67e12, "bf16_tensor": 989e12}
# the uniform arm whose time stands for the kernel in the `kernels` line
UNIFORM_ARM = "uniform_pos_high_g8"


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


def flagship_params(k_out: int, method: str) -> SolverParameters:
    """The flagship TRS4 settings: idempotency plateau, compensated
    scalars, pinned capacity, deferred overflow warnings."""
    return SolverParameters(converge_diff=1e-3, threshold=1e-7,
                            iters_per_sync=1, compensated_scalars=True,
                            convergence_metric="idempotency", k_out=k_out,
                            matmul_method=method, on_overflow="warn")


def purity_invariants(rho, h, nel: float, threshold: float) -> dict:
    """Certificates of a converged density matrix K, with residuals
    formed before their norms:
      idempotency_rel = ||K^2 - K||_F / ||K||_F
      trace_abs_err   = |tr K - nel|  (compensated trace)
      commutator_rel  = ||KH - HK||_F / ||KH||_F"""
    with alg.capacity_policy(k_out=max(rho.k, h.k), method="pallas_band",
                             on_overflow="truncate"):
        k2 = alg.matmul(rho, rho, threshold=threshold)
        r = alg.increment(k2, rho, 1.0, -1.0)
        del k2
        idem = math.sqrt(max(float(alg.dot(r, r)), 0.0)
                         / float(alg.dot(rho, rho)))
        del r
        tr = alg.host_pair(alg.trace_pair(rho))
        kh = alg.matmul(rho, h, threshold=threshold)
        hk = alg.matmul(h, rho, threshold=threshold)
        c = alg.increment(kh, hk, 1.0, -1.0)
        del hk
        comm = math.sqrt(max(float(alg.dot(c, c)), 0.0)
                         / float(alg.dot(kh, kh)))
    return {"idempotency_rel": idem, "trace_abs_err": abs(tr - nel),
            "commutator_rel": comm}


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


def phase_kernels(errs):
    """Every case through the entry point on the card (kernels) and on
    the CPU (plain versions): col ids and fill counts exactly, blocks
    to the dtype's tolerance relative to max |C|."""
    gen = torch.Generator().manual_seed(20261016)
    used = {k: 0 for k in KERNELS}
    for dtype in (torch.float32, torch.float64):
        for bs in (8, 32, 128):
            for name, (ac, ab), (bc, bb), k_out, alpha, thr in \
                    kernel_cases(gen, bs, dtype):
                for mode in ("off", "auto", "force"):
                    before = dict(sp.launches)
                    got = sp.spgemm(ac.cuda(), ab.cuda(), bc.cuda(),
                                    bb.cuda(), k_out=k_out, alpha=alpha,
                                    threshold=thr, band_mode=mode)
                    torch.cuda.synchronize()
                    want = sp.spgemm(ac, ab, bc, bb, k_out=k_out,
                                     alpha=alpha, threshold=thr,
                                     band_mode=mode)
                    kern = [k for k in used if sp.launches[k] > before[k]]
                    for k in kern:
                        used[k] += 1
                    cc, cb, uc = (x.cpu() for x in got)
                    aerr, err = _errors(cb, want[1], thr)
                    ok = (torch.equal(cc, want[0])
                          and torch.equal(uc, want[2])
                          and err <= TOL[dtype])
                    for k in kern:
                        errs[k] = max(errs[k], aerr)
                    print(f"  {str(dtype)[6:]} bs={bs} {name} {mode} "
                          f"[{','.join(kern)}]: max rel err {err:.2e}"
                          f"{'' if ok else '  MISMATCH'}")
                    if not ok:
                        raise AssertionError(
                            f"kernel case {name}/{mode} bs={bs} {dtype} "
                            "disagrees with the plain version")
                for kern in panel_kernel_cases(
                        errs, (name, (ac, ab), (bc, bb), k_out, alpha, thr),
                        dtype, bs):
                    used[kern] += 1
    for bs in (8, 32, 128):
        used["spgemm_uniform"] += uniform_kernel_cases(errs, gen, bs)
    for k, n in used.items():
        if not n:
            raise AssertionError(f"no case launched {k}")


def panel_kernel_cases(errs, case, dtype, bs):
    """The stream and window kernels on one case (B as a panel), on the
    card against their plain versions on the CPU: occupancy (norms > 0)
    exactly, blocks to the output dtype's tolerance relative to max |C|.
    The window kernel runs at 'highest', and for f32 also at 'bf16' on
    the operands rounded to bf16.  -> the kernels launched."""
    name, (ac, ab), (bc, bb), k_out, alpha, thr = case
    plan = sp.structure_plan(ac, bc, k_out)[0]
    panel = sp.b_panel(bc, bb)
    (rows, ka), (nbk, kb) = ac.shape, bc.shape
    kw = dict(kb=kb, k_out=k_out, alpha=alpha, threshold=thr)
    runs = [("spgemm_stream", "", (ac, ab, panel, plan),
             lambda *x: sp.spgemm_stream(*x, **kw))]
    g_rows, w = sp._v3_pick(ka, kb, k_out, rows, nbk)
    assert g_rows is not None and rows % g_rows == 0
    wlo, width = sp._v3_window(ac, g_rows)
    clamp = " clamped" if int(width) > w else ""
    tiers = [("highest", ab, panel)]
    if dtype == torch.float32:
        tiers.append(("bf16", ab.to(torch.bfloat16),
                      panel.to(torch.bfloat16)))
    for prec, a_in, p_in in tiers:
        runs.append(("spgemm_window", f" {prec}{clamp}",
                     (ac, a_in, p_in, plan, wlo),
                     lambda *x, p=prec: sp.spgemm_window(
                         *x, g_rows=g_rows, w=w, precision=p, **kw)))
    for kern, label, args, call in runs:
        before = sp.launches[kern]
        kb_, kn = call(*(x.cuda() for x in args))
        torch.cuda.synchronize()
        pb, pn = call(*args)
        if sp.launches[kern] != before + 1:
            raise AssertionError(f"{kern} did not launch exactly once")
        aerr, err = _errors(kb_, pb, thr)
        ok = err <= TOL[pb.dtype] and torch.equal(kn.cpu() > 0, pn > 0)
        errs[kern] = max(errs[kern], aerr)
        print(f"  {str(dtype)[6:]} bs={bs} {name} [{kern}{label}]: "
              f"max rel err {err:.2e}{'' if ok else '  MISMATCH'}")
        if not ok:
            raise AssertionError(f"{kern}{label} on {name} bs={bs} "
                                 f"{dtype} disagrees with its plain version")
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


def phase_timing(errs, times):
    """Kernel and plain version on the card at the main path's shapes:
    the flagship X @ X (band) and the phase-4 X @ X (general)."""
    gen = torch.Generator().manual_seed(7)
    # flagship X @ X: 8192 rows, KA = KB = 5, full span 9, bs 128, f32
    ac, ab = band_operand(gen, 8192, 5, 128, torch.float32)
    ac, ab = ac.cuda(), ab.cuda() / 128
    gg0, _, ok = sp.band_plan(ac, ac, 9, span=9)
    assert bool(ok)
    kw = dict(k_out=9, span=9, alpha=1.0, threshold=1e-7)
    shapes = [("spgemm_band", "R=8192 KA=KB=5 k_out=9 bs=128 f32",
               lambda: sp.spgemm_band(ac, ab, ac, ab, gg0, **kw),
               lambda: sp.spgemm_band_plain(ac, ab, ac, ab, gg0, **kw), 5)]
    # the work each computes: every candidate product lands inside the
    # band's full span; the general kernel drops the ones past k_out
    work = {"spgemm_band": (
        int((sp._candidate_ids(ac, ac) != EMPTY).sum()), "fp32",
        (ac, ab, ac, ab, gg0))}
    # phase-4 X @ X: 256 rows, KA = KB = 10, k_out 10, bs 32, f64
    gc, gb = band_operand(gen, 256, 10, 32, torch.float64)
    gc, gb = gc.cuda(), gb.cuda() / 32
    plan, _, _ = sp.structure_plan(gc, gc, 10)
    kw2 = dict(k_out=10, alpha=1.0, threshold=1e-7)
    shapes.append(
        ("spgemm_general", "R=256 KA=KB=10 k_out=10 bs=32 f64",
         lambda: sp.spgemm_general(gc, gb, gc, gb, plan, **kw2),
         lambda: sp.spgemm_general_plain(gc, gb, gc, gb, plan, **kw2), 20))
    work["spgemm_general"] = (int((plan < 10).sum()), "fp64_tensor",
                              (gc, gb, gc, gb, plan))
    depth_of = {"spgemm_band": 5 * 128, "spgemm_general": 10 * 32}
    for name, shape, kern, plain, reps in shapes:
        (kb, kn), (pb, pn) = kern(), plain()
        torch.cuda.synchronize()
        aerr, err = _errors(kb, pb, 1e-7)
        # worst-case bound of a sum of `depth` products in the working
        # dtype (depth * unit roundoff), relative to max |C|
        depth = depth_of[name]
        tol = max(TOL[kb.dtype], depth * torch.finfo(kb.dtype).eps / 2)
        if err > tol or not torch.equal(kn > 0, pn > 0):
            raise AssertionError(f"{name} at {shape}: error {err:.2e} "
                                 f"> {tol:.2e}")
        errs[name] = max(errs[name], aerr)
        ms, pms = lowk.cuda_time(kern, reps), lowk.cuda_time(plain, reps)
        products, peak, inputs = work[name]
        bs = kb.shape[-1]
        times[name] = timed(ms, pms, 2 * bs ** 3 * products, peak,
                            (*inputs, kb, kn))
        print(f"  {name} {shape}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"{bound_text(times[name])}, max rel err {err:.2e} "
              f"(tolerance {tol:.1e})")


def lowk_plains(op):
    """arm -> (its kernel, the arm's inputs, the kernel's plain version
    on them) for every kernel arm of the low-K profile."""
    ac, ab = op.cols, op.blocks
    ka = ac.shape[1]
    ac3, ab3, plan3 = op.padded()
    kw = dict(k_out=op.k_out, alpha=1.0, threshold=op.threshold)
    ab3_bf16, panel_bf16 = ab3.to(torch.bfloat16), op.panel.to(torch.bfloat16)
    ab_bf16 = ab.to(torch.bfloat16).to(torch.float32)

    def general():
        args = (ac, ab, ac, ab, op.plan)
        return ("spgemm_general", args,
                lambda: sp.spgemm_general_plain(*args, **kw))

    def stream():
        args = (ac, ab, op.panel, op.plan)
        return ("spgemm_stream", args,
                lambda: sp.spgemm_stream_plain(*args, kb=ka, **kw))

    def window(blocks, panel, precision):
        args = (ac3, blocks, panel, plan3, op.wlo)
        return ("spgemm_window", args, lambda: sp.spgemm_window_plain(
            *args, kb=ka, g_rows=op.g_rows, w=op.w, precision=precision,
            **kw))

    def band(blocks):
        args = (ac, blocks, ac, blocks, op.gg0)
        return ("spgemm_band", args,
                lambda: sp.spgemm_band_plain(*args, span=op.span, **kw))

    return {
        "general": general(),
        "stream": stream(),
        "window_highest": window(ab3, op.panel, "highest"),
        "window_high": window(ab3, op.panel, "high"),
        "window_bf16": window(ab3_bf16, panel_bf16, "bf16"),
        "band_highest": band(ab),
        "band_high": band(ab),
        "band_bf16": band(ab_bf16),
    }


def phase_lowk(errs, times, op):
    """The low-K profile at full size on the card (``op``, the chain
    operand), with the launches of each kernel counted over its run;
    then, on its operand, every kernel arm against its plain version on
    the same inputs (also on the card), the rank-form arms (general,
    stream, window 'highest' and 'high') against one another, the
    `matmul` arm against the band kernel's plain version slot by col
    id, and the plain versions timed.  -> the profile's launch
    counts."""
    sp.reset_launches()
    res = lowk.profile("cuda", op=op)
    counts = dict(sp.launches)
    print(f"  shape {json.dumps(res['shape'])}, {res['products']} block "
          f"products, {res['flops'] / 1e9:.1f} GFLOP, "
          f"{res['bytes'] / 1e9:.2f} GB least traffic, launches {counts}")
    for name, ms in res["ms"].items():
        print(f"  {name}: {ms:.3f} ms")
    rows, ka = op.cols.shape
    arms = lowk.arms(op)
    # the bound of a sum of depth = KA * bs products in float32, as at
    # the timed shapes of the timing phase (the 'bf16' arms accumulate
    # their bfloat16 inputs in float32)
    depth = ka * op.h.bs
    tol = max(TOL[torch.float32], depth * torch.finfo(torch.float32).eps / 2)
    rank_form = ("general", "stream", "window_highest", "window_high")
    first = None
    plains = lowk_plains(op)
    for arm, (kern, inputs, plain) in plains.items():
        out = arms[arm]()
        blk, nrm = (x[:rows] for x in out)
        pb, pn = (x[:rows] for x in plain())
        torch.cuda.synchronize()
        aerr, err = _errors(blk, pb, op.threshold)
        ok = err <= tol and torch.equal(nrm > 0, pn > 0)
        same = ""
        if arm in rank_form and first is None:
            first = (arm, blk, nrm)
        elif arm in rank_form:
            ferr = _errors(blk, first[1], op.threshold)[1]
            bits = torch.equal(blk, first[1]) and torch.equal(nrm, first[2])
            ok = ok and ferr <= tol and torch.equal(nrm > 0, first[2] > 0)
            same = (f", vs {first[0]}: max rel err {ferr:.2e}, "
                    f"{'bit for bit' if bits else 'not bit for bit'}")
        errs[kern] = max(errs[kern], aerr)
        del blk, nrm, pb, pn
        pms = lowk.cuda_time(plain, 3)
        t = timed(res["ms"][arm], pms, op.flops(),
                  "bf16_tensor" if inputs[1].dtype == torch.bfloat16
                  else "fp32", (*inputs, *out))
        if arm in ("stream", "window_highest"):
            times[kern] = t
        del out
        print(f"  {arm} [{kern}]: kernel {t['ms']:.3f} ms, plain "
              f"{pms:.3f} ms, {bound_text(t)}, vs plain max rel err "
              f"{err:.2e} (tolerance {tol:.1e}){same}"
              f"{'' if ok else '  MISMATCH'}")
        if not ok:
            raise AssertionError(f"{arm} [{kern}] disagrees with its plain "
                                 "version on the low-K operand")
    del first
    # matmul ('auto', band kernel at 'high') against the band plain
    # version, each side's blocks gathered onto the other's col ids
    mm = arms["matmul"]()
    mc, mb = mm.col_ids[0], mm.blocks[0]
    occ0 = sp.band_plan(op.cols, op.cols, op.k_out, span=op.span)[1]
    pc = occ0[:, None] + torch.arange(op.k_out, dtype=occ0.dtype,
                                      device=occ0.device)
    pb = plains["band_high"][2]()[0]
    torch.cuda.synchronize()
    aerr, err = _errors(mb, bell.align(mc, pc, pb), op.threshold)
    err = max(err, _errors(bell.align(pc, mc, mb), pb, op.threshold)[1])
    errs["spgemm_band"] = max(errs["spgemm_band"], aerr)
    print(f"  matmul [spgemm_band]: vs band plain max rel err {err:.2e} "
          f"(tolerance {tol:.1e})")
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
            times["spgemm_uniform"] = t
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
    return counts


def solve(h, isq, nel, params):
    """density.trs4 -> (rho, energy, mu, iterations, launches).  The
    iteration count is read from the solver's log, as the JAX package's
    bench.py reads it; the kernel launch counts are reset just before
    the solve and read just after it."""
    params = params.copy()
    params.be_verbose = True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trs4.yaml")
        activate_logger(path)
        try:
            sp.reset_launches()
            rho, energy, mu = density.trs4(h, isq, nel, params)
            counts = dict(sp.launches)
        finally:
            deactivate_logger()
        with open(path) as f:
            log = f.read()
    n = int(re.search(r"^ *Total Iterations: (\d+)$", log, re.M).group(1))
    return rho, energy, mu, n, counts


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
    """The flagship solve on the card, timed, then its certificates.
    -> the solve's launch counts."""
    dim, bs = 1 << 20, 128
    nel = dim / 2
    grid = ProcessGrid(device="cuda")
    h = PM.banded(dim, 16, gapped_fn, bs=bs, grid=grid,
                  dtype=torch.float32)
    isq = PM.identity(dim, bs=bs, grid=grid, dtype=torch.float32)
    params = flagship_params(5, "pallas_band")
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
    print(f"  {n} iterations, {wall:.3f} s wall, {wall / n:.4f} s per "
          f"iteration, energy {energy!r}, mu {mu!r}, rho_nnz {rho.nnz}, "
          f"peak memory {peak / 2**30:.2f} GiB, launches {counts}")
    inv = purity_invariants(rho, h, nel, params.threshold)
    torch.cuda.synchronize()
    print("  certificates: " + json.dumps(inv))
    ok = (n <= 10 and inv["idempotency_rel"] <= 1e-5
          and inv["commutator_rel"] <= 5e-5
          and inv["trace_abs_err"] / nel <= 1e-6
          and math.isfinite(energy) and math.isfinite(mu))
    if not ok:
        raise AssertionError("flagship certificates out of bounds")
    if not counts["spgemm_band"]:
        raise AssertionError("the flagship solve never launched the band "
                             "kernel")
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
    counts = {k: parity[k] + flagship[k] for k in ("spgemm_band",
                                                   "spgemm_general")}
    counts.update({k: low[k] for k in ("spgemm_stream", "spgemm_window")})
    counts["spgemm_uniform"] = low_r5["spgemm_uniform"]
    print(f"launches on each kernel's path: {counts} (parity solve "
          f"{parity}, flagship solve {flagship}, low-K profile {low}, "
          f"round-5 low-K profile {low_r5})")
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
