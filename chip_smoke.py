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
   group's window and are clamped); then the band and general kernels
   and their plain versions timed at the shapes the TRS4 path gives
   them.
4. lowk: the low-K profile (ntpoly_tpu_torch/profiling/lowk.py) at
   full size, 2^19 rows of the chain at bs 128, every arm timed; then
   on its operand every kernel arm (general, stream, window and band
   at each tier) held against its plain version on the same inputs,
   the general, stream and window kernels against one another, the
   `matmul` arm against the band kernel's plain version, and the
   plain versions timed.
5. parity: TRS4 at dim 8192, bs 32, k_out 10, f64 through the general
   kernel on the card, and through the plain versions on the CPU.
6. flagship: TRS4 of the 2^20-row gapped chain at bs 128 in f32 through
   the band kernel, with its certificates (idempotency, commutator,
   electron count).

Kernel launches are counted on each kernel's own path, with the counts
reset just before the path and read just after it: the band and
general kernels in the card's TRS4 solves of phases 5 and 6 (the
`kernels` line reports their sum), the stream and window kernels in the
low-K profile of phase 4.  Any failed phase ends the run with a
non-zero exit code.  The last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

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
from ntpoly_tpu_torch.profiling import lowk
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
}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


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
    # phase-4 X @ X: 256 rows, KA = KB = 10, k_out 10, bs 32, f64
    gc, gb = band_operand(gen, 256, 10, 32, torch.float64)
    gc, gb = gc.cuda(), gb.cuda() / 32
    plan, _, _ = sp.structure_plan(gc, gc, 10)
    kw2 = dict(k_out=10, alpha=1.0, threshold=1e-7)
    shapes.append(
        ("spgemm_general", "R=256 KA=KB=10 k_out=10 bs=32 f64",
         lambda: sp.spgemm_general(gc, gb, gc, gb, plan, **kw2),
         lambda: sp.spgemm_general_plain(gc, gb, gc, gb, plan, **kw2), 20))
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
        times[name] = (ms, pms)
        print(f"  {name} {shape}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"max rel err {err:.2e} (tolerance {tol:.1e})")


def lowk_plains(op):
    """arm -> (its kernel, the kernel's plain version on the arm's own
    inputs) for every kernel arm of the low-K profile."""
    ac, ab = op.cols, op.blocks
    ka = ac.shape[1]
    ac3, ab3, plan3 = op.padded()
    kw = dict(k_out=op.k_out, alpha=1.0, threshold=op.threshold)
    ab3_bf16, panel_bf16 = ab3.to(torch.bfloat16), op.panel.to(torch.bfloat16)
    ab_bf16 = ab.to(torch.bfloat16).to(torch.float32)

    def window(blocks, panel, precision):
        return lambda: sp.spgemm_window_plain(
            ac3, blocks, panel, plan3, op.wlo, kb=ka, g_rows=op.g_rows,
            w=op.w, precision=precision, **kw)

    def band(blocks):
        return lambda: sp.spgemm_band_plain(ac, blocks, ac, blocks, op.gg0,
                                            span=op.span, **kw)

    return {
        "general": ("spgemm_general", lambda: sp.spgemm_general_plain(
            ac, ab, ac, ab, op.plan, **kw)),
        "stream": ("spgemm_stream", lambda: sp.spgemm_stream_plain(
            ac, ab, op.panel, op.plan, kb=ka, **kw)),
        "window_highest": ("spgemm_window", window(ab3, op.panel, "highest")),
        "window_high": ("spgemm_window", window(ab3, op.panel, "high")),
        "window_bf16": ("spgemm_window", window(ab3_bf16, panel_bf16,
                                                "bf16")),
        "band_highest": ("spgemm_band", band(ab)),
        "band_high": ("spgemm_band", band(ab)),
        "band_bf16": ("spgemm_band", band(ab_bf16)),
    }


def phase_lowk(errs, times):
    """The low-K profile at full size on the card, with the launches of
    each kernel counted over its run; then, on its operand, every
    kernel arm against its plain version on the same inputs (also on
    the card), the rank-form arms (general, stream, window 'highest'
    and 'high') against one another, the `matmul` arm against the band
    kernel's plain version slot by col id, and the plain versions
    timed.  -> the profile's launch counts."""
    op = lowk.operand("cuda")
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
    for arm, (kern, plain) in plains.items():
        blk, nrm = (x[:rows] for x in arms[arm]())
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
        if arm in ("stream", "window_highest"):
            times[kern] = (res["ms"][arm], pms)
        print(f"  {arm} [{kern}]: kernel {res['ms'][arm]:.3f} ms, plain "
              f"{pms:.3f} ms, vs plain max rel err {err:.2e} (tolerance "
              f"{tol:.1e}){same}{'' if ok else '  MISMATCH'}")
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
    pb = plains["band_high"][1]()[0]
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
    # each kernel's own path counts its launches: the low-K profile for
    # the stream and window kernels, the card solves for the others
    low = run("lowk", phase_lowk, errs, times)
    parity = run("parity", phase_parity)
    flagship = run("flagship", phase_flagship)
    counts = {k: parity[k] + flagship[k] for k in ("spgemm_band",
                                                   "spgemm_general")}
    counts.update({k: low[k] for k in ("spgemm_stream", "spgemm_window")})
    print(f"launches on each kernel's path: {counts} (parity solve "
          f"{parity}, flagship solve {flagship}, low-K profile {low})")
    for name, n in counts.items():
        if not n:
            raise AssertionError(f"{name} never launched on its path")
    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=counts[name], max_abs_err=errs[name],
                    ms=times[name][0], plain_ms=times[name][1])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
