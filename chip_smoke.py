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
   'high' and at the parity shape (f64); each of these launches once
   more under the device predicate (``run``): with 1 bit for bit the
   plain launch and timed beside it, with 0 its output untouched and
   timed.
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
   of the threshold; at 'high' the kernel's departure from the exact
   product carries the bf16x3 tier's, its projection on bf16x3 minus
   exact at least half of it), and the split pass bit for bit on each
   operand it splits there; then S -> ISQ -> TRS4 and TRS2 at dim
   4096, bs 32, f64 on the card against the CPU (energies to 1e-10,
   equal iteration counts).
10. functions: the matrix-function path (profiling/functions.py) at the
   flagship's width, 2^20 rows, bs 128, f32, each solve timed after a
   warm-up with its iterations, multiplies, launches and peak memory:
   the overlap's inverse (Hotelling), inverse square root by
   `compute_inverse_root` and cube root, CG, TRS4 of H for mu, the sign
   of H - mu I, sine and cosine of H, exp (Chebyshev, Taylor) and log
   of the ring Laplacian, held to `functions.BARS` (relative Frobenius
   errors, 1e-4, the trace 1e-5 per electron); the sign once more at
   'high', printed; then the path once more with every band and general
   product and split pass held against its plain version as in phase
   9; the dense and finite-temperature parity at 8192 rows, bs 128,
   f64 (`functions.DENSE_BARS`: the eigendecomposition, the dense
   density, inverse square root, sign and exponential against their
   iterative solvers, WOM_C and WOM_GC at inverse temperature 50
   against the dense Fermi-Dirac density); and sign, inverse, exp/log,
   dense FOE and WOM_C at 2048 rows, bs 32, f64 on the card against
   the CPU (1e-9 relative).
11. chunked: the chunked driver (profiling/chunked.py; solvers/common
   ``run_chunked``) at 2^20 rows: (a) the flagship of phase 8 at 'high'
   with iters_per_sync 4 and 8, each solve captured as CUDA graphs
   (one a chunk, captured in the solve), once more warm (replays only),
   once under torch.profiler, and uncaptured (``common.uncaptured``),
   the captured solve bit for bit the uncaptured one (D's slots and
   blocks, energy, mu, iterations), within phase 8's bars (<= 10
   iterations; idempotency, commutator and electron count at
   'highest'), its wall seconds and the device's idle share printed
   beside the eager solve's; (b) PM, TRS2 and HPCP of phase 9's H with
   its ISQ, and the Hotelling inverse, the order-2 Newton-Schulz ISQ,
   ``compute_inverse_root(S, 2)``, CG of S X = H and the sign of H - mu
   I of phase 10, at 'highest', 'grow', the automatic kernel choice
   and 4 iterations a chunk, the pin from the carry's capacity up
   (k_out 2), each captured bit for bit its uncaptured twin and within
   its eager solve's bars (phase 9's certificates and iteration caps,
   `functions.BARS`, the ISQ residual 1e-5), one regrowing its pin at
   least; (c) the uncaptured solves of (a) and (b) with every band and
   general product and split pass held against its plain version as in
   phase 9, and every (kernel, tier, KA, KB, k_out) key the captured
   solves launched held there (a key launched under the device
   predicate by the band or the general kernel, whichever computed);
   (d) each chunked solve's peak memory under 80 GB, printed beside the
   eager peaks.
12. analysis: the analysis path (profiling/analysis.py) at the
   flagship's width, 2^20 rows, bs 128, f32, 'highest', threshold 1e-7,
   each solve timed after a warm-up (the path once at 4096 rows) with
   its iterations, multiplies, launches and peak memory, held to
   `analysis.BARS`: the blocked Cholesky of S at 2^18 rows (a cut:
   PERF.md section 4), ||S - L L^T|| / ||S|| <= 1e-4 formed sparsely by
   `matmul(..., beta=1, c=S)`, no entry above the diagonal; the rank-256
   pivoted Cholesky of S within the trace bounds 0 <= tr(S - L L^T) <=
   tr(S) (1 - 256/N), every column below 256; `reduce_dimension` of the
   gapped chain with a barrier from row 1024, its eigenvalues within
   1e-2 of the 1024 lowest of the leading 4096 rows; the purification
   extrapolation of TRS4's K to the overlap one geometry step later
   inside the generalized certificates (1e-5, 1e-6 per electron); the
   Lowdin extrapolation (distances printed); LOBPCG of S for 8 pairs at
   `tol=None` (its iterations printed: the epsilon rule stops it after
   one at this size) and for 200 iterations (residuals <= 1e-3
   lambda_max, max |V^T V - I| <= 1e-5, eigenvalues within 1e-4 of the
   symbol's minimum, none below it); then the path once more with every
   band and general product held against its plain version as in phase
   9; the f64 parity at 8192 rows (`analysis.DENSE_BARS`: the Cholesky
   factor against `torch.linalg.cholesky`, LOBPCG against `eigvalsh`);
   and the Cholesky, pivoted Cholesky, `reduce_dimension`, both
   extrapolations and LOBPCG, real and complex, at 2048 rows, bs 32,
   f64 on the card against the CPU (1e-9 relative; eigenvectors through
   V V^H).
13. api: the NTPoly-compatible surface (profiling/api.py) through
   ``import ntpoly_tpu_torch as nt`` at the flagship's width, 2^20 rows,
   bs 128, f32: H and S written with WriteToBinary (and H with
   WriteToMatrixMarket) and read back through nt.Matrix_ps, slot for
   slot, each write and read timed; S -> ISQ -> TRS4 through the API at
   threshold 1e-7, 'high' (`api.BARS`; TRS4 at the PremadeMatrix
   example's converge_density 1e-5) and the same solves called directly
   on the same handles, equal bit for bit; a 2^16-row slice of the
   density written and read back; Gemm, Increment, Dot, Trace, Norm,
   PairwiseMultiply, DiagonalScale, MeasureAsymmetry, Symmetrize,
   Transpose and MapVectorized each timed and equal to the lower-layer
   call; the complex exponential of a Hermitian band of 2^19 complex
   rows through the API equal to the real solver on `cplx.embed` of the
   same data; then the ISQ, TRS4, the 2^19-row complex exponential and
   the six examples through the API once more with every band and
   general product and split pass held against its plain version as in
   phase 9; the complex exponential at 8192 rows, f64, against the
   dense oracle (1e-4); the six examples at their ReadMe sizes in f64
   on the card (`api.EXAMPLE_BARS`); and the PremadeMatrix workflow at
   2048 rows, f64, on the card against the CPU (densities within 1e-12
   relative).
14. guide: the user guide (ntpoly_tpu_torch/docs/guide.md) run as
   written on the card: its python blocks in order in one namespace
   (``docs.run_guide``), DEVICE "cuda", at its own sizes (the flagship's
   band shape at 2^18 rows, bs 128, f32): H and S written as Matrix
   Market and read back through ``nt``, S -> ISQ -> TRS4 through the
   API, X @ X at each tier against the float64 product, TRS4 at 'high'
   and 'highest', the exponential of a complex band against its dense
   oracle, TRS4 at the flagship's settings and chunked (iters_per_sync
   4, captured bit for bit its uncaptured twin), the logger, timers and
   counters; every band and general product and split pass held against
   its plain version as in phase 9 (a chunk's products while it is
   being captured recorded and held on the uncaptured steps of the same
   keys); the tiers' errors ordered (bf16x3 'high' nearer the float64
   product than 'bf16', 'default' equal to 'bf16', 'highest' within
   float32 rounding), the complex exponential within 1e-4, the quick
   start's density at 'high' within the PremadeMatrix example's bars
   (its generalized certificates computed at 'highest') and phase api's
   commutator bar, and the 'highest' TRS4's density within phase 8's
   bars.
15. mesh: the multi-device layer (parallel/dist.py, the sharded
   PSMatrix, the 3D SUMMA). (a) the flagship at 'high' on a 1 x 1 x 1
   grid inside a one-rank world (cpu:gloo,cuda:nccl): iterations,
   energy, mu and D slot for slot equal to the same solve on the default
   grid and to phase 8's, both wall times printed; (b) a world of four
   ranks spawned on the one card (``parallel/launch.py``, gloo, device
   cuda:0, every collective staged through host memory and listed), grid
   2 x 2 x 1, the flagship's H at 2^18 rows: TRS4 at 'highest' (the
   kernel chosen per multiply, the capacity grown: ``mesh_params``) with
   the iterations of the 1 x 1 x 1 solve of the same H on the card, the
   energy within 1e-6 of it, the certificates of phase 8, equal scalars
   on every rank, the same solve run first with each band and general
   product held against its plain version inside the ranks (every key
   a rank's timed solve launched, both kernels in the world), D
   written collectively as binary and read back on the same grid, tile
   for tile, and a few triplets a rank gathered in rank order; (c) the
   same with eight ranks on 2 x 2 x 2 at 2^16 rows (the slices' split-k
   and merge). A rank that fails fails the phase.

``python3 chip_smoke.py --cards`` runs only phases 1, 2 and phase 15's
world (d), on a host with four cards: one rank on each card over the
cpu:gloo,cuda:nccl pair, 2 x 2 x 1, the flagship's H at 2^20 rows,
held as (b) and (c) are.

Kernel launches are counted on each kernel's own path, with the counts
reset just before the path and read just after it: the band and
general kernels in the card's TRS4 solves of phases 7 and 8 at the
flagship's 'high', in phase 9's ISQ and timed solves, in the timed
solves of phase 10, in phase 11's captured solves (band and general
launches under the device predicate counted apart, as the `kernels`
line's `launches_predicated`), in the timed solves of phase 12, in
phase 13's calls through the API, in phase 14's run of the guide
and in phase 15's timed solves
(every rank's; the `kernels` line reports
their sum), the split pass in those
solves, the stream and window kernels in the low-K profile of phase 5,
the uniform kernel
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
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

# expandable segments: the chunked solves' pinned widths and the held
# products' plain versions allocate blocks of many sizes, and with fixed
# segments the caching allocator kept ~15 GiB reserved but unusable by
# the analysis phase's held products (read before torch's first CUDA
# allocation, so set before the import)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch

import ntpoly_tpu_torch as nt
from ntpoly_tpu_torch.config import EMPTY
from ntpoly_tpu_torch.core import bell
from ntpoly_tpu_torch.ops import spgemm as sp
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.profiling import (analysis, chunked, functions,
                                        lowk, lowk_r5, overlap, trs4_tiers)
from ntpoly_tpu_torch.profiling import api as api_path
from ntpoly_tpu_torch.profiling.trs4_tiers import (flagship_params,
                                                   purity_invariants, solve)
from ntpoly_tpu_torch.solvers import common, density
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
            lambda kw=kw, **x: sp.spgemm_band(ac, ab, ac, ab, gg0, **kw,
                                              **x),
            lambda kw=kw: sp.spgemm_band_plain(ac, ab, ac, ab, gg0, **kw),
            5, 5 * 128, *tier_work(prec, flops), (ac, ab, gg0)))
    kw = dict(k_out=9, alpha=1.0, threshold=1e-7, precision="high")
    runs.append((
        "spgemm_general", "high", "R=8192 KA=KB=5 k_out=9 bs=128 f32 rank "
        "form", lambda **x: sp.spgemm_general(ac, ab, ac, ab, plan9, **kw,
                                              **x),
        lambda: sp.spgemm_general_plain(ac, ab, ac, ab, plan9, **kw), 5,
        5 * 128, *tier_work("high", flops), (ac, ab, plan9)))
    # phase-7 X @ X: 256 rows, KA = KB = 10, k_out 10, bs 32, f64
    gc, gb = band_operand(gen, 256, 10, 32, torch.float64)
    gc, gb = gc.cuda(), gb.cuda() / 32
    plan, _, _ = sp.structure_plan(gc, gc, 10)
    kw2 = dict(k_out=10, alpha=1.0, threshold=1e-7)
    runs.append((
        "spgemm_general", "highest", "R=256 KA=KB=10 k_out=10 bs=32 f64",
        lambda **x: sp.spgemm_general(gc, gb, gc, gb, plan, **kw2, **x),
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
        predicated(name, prec, shape, kern, kb, kn, reps, inputs[1])
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


def predicated(name, prec, shape, kern, kb, kn, reps, x) -> None:
    """The same launch under the device predicate (``run``, as the
    chunked solves' 'select' launches it): with 1, bit for bit the
    plain launch's output ``kb``, ``kn`` and timed beside it (the split
    pass included at 'high', as there); with 0, the output buffers
    untouched, timed on X (``x``) split once beforehand at 'high', as
    'select' shares one split between the two kernels: what the
    unchosen kernel of a 'select' multiply costs."""
    tier = sp.kernel_tier(x.dtype, prec)
    planes = None if tier == "highest" else sp._planes(x, x, tier)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    zero = one - 1
    out = (torch.full_like(kb, 7.0), torch.full_like(kn, 7.0))
    got = kern(run=one, out=(out[0].clone(), out[1].clone()))
    off = kern(run=zero, out=(out[0].clone(), out[1].clone()))
    same = torch.equal(got[0], kb) and torch.equal(got[1], kn)
    kept = torch.equal(off[0], out[0]) and torch.equal(off[1], out[1])
    if not (same and kept):
        raise AssertionError(f"{name} {prec} at {shape} under the "
                             f"predicate: run 1 bit for bit {same}, run "
                             f"0 leaves the output {kept}")
    del got, off
    ms1 = lowk.cuda_time(lambda: kern(run=one, out=out), reps)
    ms0 = lowk.cuda_time(lambda: kern(run=zero, out=out, planes=planes),
                         reps)
    print(f"  {name} {prec} {shape} under the predicate: run 1 "
          f"{ms1:.3f} ms (bit for bit), run 0 {ms0:.3f} ms (output "
          f"untouched)")


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
        FLAGSHIP_HIGH.setdefault(precision, (n, energy, mu))
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
    at 'high', the kernel's departure from the exact product must carry
    the bf16x3 tier's: its projection on (bf16x3 plain - exact plain)
    at least half of that difference (``signature``, 1 for the bf16x3
    tier and 0 for the exact one; where the two plain versions agree
    bit for bit, the kernel must agree too).  The projection reads every
    entry: the largest-entry distance cannot tell the tiers apart where
    max |C| sits on entries that both tiers compute alike (a diagonal of
    ones) and the tiers' difference lies below the kernel's rounding
    there.  -> the product's line."""
    kb, kn = out
    ac, ab, bc, bb, ix = args
    prec, thr = sp.kernel_tier(ab.dtype, kw["precision"]), kw["threshold"]
    R, KA = ac.shape
    bs = ab.shape[-1]
    tol = entry_tol(prec, kb.dtype, KA * bs)
    diff = {"tier": 0.0, "exact": 0.0}
    top, odd, ok = 0.0, 0, True
    proj, gap = 0.0, 0.0
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
        del pn
        if prec == "high":
            eb, _ = PLAINS[name](*part, **{**kw, "precision": "highest"})
            diff["exact"] = max(diff["exact"], _errors(kb[rs], eb, thr)[0])
            d = (pb - eb).double()
            proj += float(((kb[rs] - eb).double() * d).sum())
            gap += float((d * d).sum())
            del eb, d
        del pb
    err = diff["tier"] / max(top, 1e-300)
    within = err <= tol
    tier_ok = True
    exact = ""
    if prec == "high":
        ex_err = diff["exact"] / max(top, 1e-300)
        signature = proj / gap if gap else float("nan")
        tier_ok = signature >= 0.5 if gap else err == 0.0
        exact = f", vs exact {ex_err:.2e}, bf16x3 signature {signature:.3f}"
    what = (f"{name} {prec} R={R} KA={KA} KB={bc.shape[1]} "
            f"k_out={kw['k_out']} bs={bs} {str(kb.dtype)[6:]}")
    if not (ok and within and tier_ok):
        raise AssertionError(
            f"{what} on the path: error {err:.2e} (tolerance "
            f"{tol:.2e}){exact}; within tolerance {within}, the tier's "
            f"signature shown {tier_ok}, {odd} blocks kept on one side "
            f"only, all within rounding of the threshold {ok}")
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
        raise AssertionError(f"{what} on the path disagrees with "
                             "its plain version")
    return f"{what}: bit for bit"


def _capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def _held_on_path(errs, held: dict, hold: bool = True):
    """While open, each product of the band and general kernels that
    ``sp.spgemm`` launches, and each split pass, is held against its
    plain version on the same card tensors, once for each (kernel,
    tier, KA, KB, k_out, dtype) or split shape; ``held`` maps each to
    its line.  A launch under the device predicate (``run``; the
    chunked solves' 'select') is held where the predicate chose it and
    skipped where its blocks all returned.  With ``hold`` off the keys
    are only recorded (to None; a predicated launch's key with "pred"
    appended), the launches untouched and nothing read from the card:
    this records the keys of a solve being captured.  With ``hold`` on,
    a launch made while the current stream is being captured into a
    CUDA graph is recorded the same way, its key with "captured"
    appended (nothing can be read from the card there): its plain key
    is held on an uncaptured launch of the same shapes
    (``_missing_keys``)."""
    wrappers = {name: getattr(sp, name) for name in (*PLAINS, "split_bf16")}

    def product(name):
        def call(*args, **kw):
            out = wrappers[name](*args, **kw)
            run = kw.get("run")
            capturing = hold and _capturing()
            holding = hold and not capturing
            if holding and run is not None and not bool(run):
                return out
            key = (name, sp.kernel_tier(args[1].dtype, kw["precision"]),
                   args[0].shape[1], args[2].shape[1], kw["k_out"],
                   args[1].dtype)
            if not holding and run is not None:
                key = key + ("pred",)
            if capturing:
                key = key + ("captured",)
            if key not in held:
                plain_kw = {k: v for k, v in kw.items()
                            if k not in ("run", "out", "planes")}
                held[key] = (_hold_product(name, args, plain_kw, out, errs)
                             if holding else None)
            return out
        return call

    def split(x, *, lo=True):
        out = wrappers["split_bf16"](x, lo=lo)
        key = ("split_bf16", lo, tuple(x.shape))
        holding = hold and not _capturing()
        if hold and not holding:
            key = key + ("captured",)
        if key not in held:
            held[key] = _hold_split(x, lo, out) if holding else None
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


# the timed solves of the functions phase, in the order they run
FUNCTION_SOLVES = ("isq", "invert", "inv_root_2", "root_3", "cg", "trs4",
                   "sign", "sign_high", "sine", "cosine", "exp",
                   "exp_taylor", "log")
PATH_KERNELS = ("spgemm_band", "spgemm_general", "split_bf16")


def _solve_line(name: str, r: dict) -> str:
    checks = {k: v for k, v in r.items() if isinstance(v, float)
              and k not in ("seconds", "peak_gib")}
    return (f"  {name}: iterations {r['iterations']}, {r['seconds']:.3f} "
            f"s wall, {r['multiplies']} multiplies, launches "
            f"{r['launches']}, peak memory {r['peak_gib']:.2f} GiB"
            + "".join(f", {k} {v!r}" for k, v in checks.items()))


def functions_products(errs):
    """The band and general kernels and the split pass held against their
    plain versions at the shapes the functions path gives them: the
    path once more at the flagship's width, without warm-ups, inside
    ``_held_on_path``.  Its launches are not counted."""
    held = {}
    with _held_on_path(errs, held):
        functions.run(1 << 20, 128, "cuda", warm_up=False)
    torch.cuda.synchronize()
    for line in held.values():
        print(f"  held on the path: {line}")
    kinds = {key[:2] for key in held}
    if not ({("spgemm_band", "highest"), ("spgemm_general", "highest"),
             ("split_bf16", True)} <= kinds
            and kinds & {("spgemm_band", "high"),
                         ("spgemm_general", "high")}):
        raise AssertionError("the functions path's products held did not "
                             "cover the band and general kernels at "
                             "'highest', a kernel at 'high' and the split")


def functions_dense():
    """The dense and finite-temperature parity at 8192 rows in f64
    (``functions.dense``), every check within its bar."""
    res = functions.dense(8192, 128, "cuda")
    for name, r in res.items():
        if isinstance(r, dict):
            print(f"  dense {name}: " + ", ".join(
                f"{k} {v!r}" for k, v in r.items()))
    bad = functions.failures(res, functions.DENSE_BARS)
    if bad:
        raise AssertionError("dense parity out of bounds: "
                             + "; ".join(bad))


def functions_twin():
    """Sign, inverse, exp/log, the dense Fermi-Dirac density and
    ``wom_c`` at 2048 rows, bs 32, f64: the card against the CPU, each
    result within 1e-9 relative (Frobenius)."""
    out = {}
    for dev in ("cpu", "cuda"):
        sp.reset_launches()
        t0 = time.perf_counter()
        out[dev] = functions.twin(2048, 32, dev)
        launched = {k: sp.launches[k] for k in PATH_KERNELS}
        print(f"  twin {dev}: {time.perf_counter() - t0:.2f} s, launches "
              f"{launched}")
        if (dev == "cpu") == any(launched.values()):
            raise AssertionError(f"the {dev} twin launched "
                                 f"{'a' if dev == 'cpu' else 'no'} kernel")
    diffs = {k: float(np.linalg.norm(out["cuda"][k] - v)
                      / np.linalg.norm(v)) for k, v in out["cpu"].items()}
    print(f"  twin card against CPU (relative): {diffs}")
    if not all(d <= 1e-9 for d in diffs.values()):
        raise AssertionError("card and CPU disagree on the functions twin")


def phase_functions(errs):
    """The matrix-function path at the flagship's width
    (``profiling/functions.py``): each solve timed after a warm-up and
    held to ``functions.BARS`` (the 'high' sign solve's readings only
    printed); then its kernels against their plain versions at the
    path's shapes (``functions_products``, into ``errs``), the dense
    parity at 8192 rows and the card-against-CPU twin.  -> the launch
    counts of the timed solves."""
    res = functions.run(1 << 20, 128, "cuda")
    counts = dict.fromkeys(PATH_KERNELS, 0)
    for name in FUNCTION_SOLVES:
        r = res[name]
        print(_solve_line(name, r))
        counts = {k: counts[k] + r["launches"][k] for k in counts}
    bad = functions.failures(res, functions.BARS)
    if bad:
        raise AssertionError("functions path out of bounds: "
                             + "; ".join(bad))
    if not (counts["spgemm_band"] and counts["spgemm_general"]
            and res["sign_high"]["launches"]["split_bf16"]):
        raise AssertionError("the functions path did not launch both the "
                             "band and the general kernel, or the 'high' "
                             "sign solve never launched the split pass")
    functions_products(errs)
    functions_dense()
    functions_twin()
    print(f"  launches on the path: {counts}")
    return counts


# phase chunked: the flagship's 'iters_per_sync' values, the chunked
# loops at the path's width, and the eager peaks of PERF.md section 6
# that a chunked solve's peak is printed beside
CHUNKED_DIM = 1 << 20
EAGER_PEAK_GIB = "35.0-40.5 (overlap path), 22.5-54.0 (functions path)"
CHUNKED_KERNELS = PATH_KERNELS + ("spgemm_band_pred", "spgemm_general_pred")


def _chunked_line(name: str, r: dict) -> str:
    unc, secs = r["uncaptured"], r["seconds"]
    return (f"  {name}: iterations {r['iterations']}, captured {secs:.3f} "
            f"s (capture included), uncaptured {unc['seconds']:.3f} "
            f"s, bit for bit {r['same']}, pins regrown to {r['pins']}, "
            f"peak memory {r['peak_gib']:.2f} GiB, launches "
            f"{r['launches']}" + "".join(
                f", {k} {v!r}" for k, v in r.items()
                if isinstance(v, float) and k not in ("seconds",
                                                      "peak_gib")))


def _chunked_counts(*readings) -> dict:
    return {k: sum(r["launches"][k] for r in readings)
            for k in CHUNKED_KERNELS}


def _missing_keys(held: dict, recorded) -> None:
    """Every key that captured solves launched (``recorded``) was held
    on uncaptured launches (``held``, a line for each key held): a plain
    launch's key itself, a predicated launch's (tier, KA, KB, k_out,
    dtype) by the band or the general kernel, whichever the device's
    choice ran."""
    missing = []
    for key in recorded:
        if key[-1] != "pred":
            ok = held.get(key) is not None
        else:
            ok = any(held.get((name,) + key[1:-1]) is not None
                     for name in PLAINS)
        if not ok:
            missing.append(key)
    if missing:
        raise AssertionError(f"captured keys never held: {missing}")


def _chunked_held(held: dict, recorded: dict) -> None:
    """``_missing_keys``, and the band and general kernels and the split
    pass each held at least once."""
    _missing_keys(held, recorded)
    kinds = {key[0] for key in held}
    if not {"spgemm_band", "spgemm_general", "split_bf16"} <= kinds:
        raise AssertionError("the chunked path's products held did not "
                             "cover the band and general kernels and "
                             "the split pass")


def phase_chunked(errs):
    """The chunked driver (``profiling/chunked.py``; nothing of it is
    eager): (a) the flagship TRS4 at 2^20 rows with ``iters_per_sync``
    4 and 8, each solve captured as CUDA graphs bit for bit its
    uncaptured twin, at the flagship's bars, its wall time and the
    device's idle share beside the eager solve's; (b) the other eight
    chunked loops at 2^20 rows at 'highest', 'grow', the automatic
    kernel choice and 4 iterations a chunk, each bit for bit its
    uncaptured twin and within its eager solve's bars, one regrowing
    its pin at least; (c) the uncaptured solves inside
    ``_held_on_path``, every key of the captured solves held; (d) each
    chunked solve's peak memory under 80 GB, printed beside the eager
    peaks.  -> the captured solves' launch counts."""
    held, recorded = {}, {}

    def hold():
        return _held_on_path(errs, held)

    def record():
        return _held_on_path(errs, recorded, hold=False)

    flag = chunked.flagship(CHUNKED_DIM, hold=hold, record=record)
    e = flag["eager"]
    print(f"  flagship eager: {e['iterations']} iterations, "
          f"{e['seconds']:.3f} s wall, idle share {e['idle_share']:.4f} "
          f"(traced {e['traced_s']:.3f} s), peak memory "
          f"{e['peak_gib']:.2f} GiB, launches {e['launches']}")
    solves = []
    for ips in chunked.FLAGSHIP_IPS:
        r = flag[f"ips_{ips}"]
        c = r["captured"]
        solves.append(c)
        print(f"  flagship iters_per_sync {ips}: {c['iterations']} "
              f"iterations, captured {c['seconds']:.3f} s (capture "
              f"included), warm {r['warm']['seconds']:.3f} s (replays "
              f"only), uncaptured {r['uncaptured']['seconds']:.3f} s, "
              f"idle share {r['idle_share']:.4f} (traced "
              f"{r['traced_s']:.3f} s), bit for bit {r['same']}, energy "
              f"{c['energy']!r}, mu {c['mu']!r}, peak memory "
              f"{c['peak_gib']:.2f} GiB (warm {r['warm']['peak_gib']:.2f}"
              f"), launches {c['launches']}; certificates (at "
              f"'highest'): idempotency {c['idempotency_rel']!r}, "
              f"commutator {c['commutator_rel']!r}, trace error per "
              f"electron {c['trace_err_per_electron']!r}")
    bad = chunked.flagship_failures(flag)
    loops = chunked.loops(CHUNKED_DIM, hold=hold, record=record)
    for name in chunked.LOOP_BARS:
        print(_chunked_line(name, loops[name]))
        solves.append(loops[name])
    bad += chunked.loop_failures(loops)
    if not any(loops[name]["pins"] for name in chunked.LOOP_BARS):
        bad.append("no chunked loop regrew its pin")
    over = [r["peak_gib"] for r in solves if r["peak_gib"] * 2**30 >= 80e9]
    if over:
        bad.append(f"chunked peaks at or over 80 GB: {over} GiB")
    if bad:
        raise AssertionError("phase chunked: " + "; ".join(bad))
    torch.cuda.synchronize()
    for key, line in held.items():
        print(f"  held on the path: {line}")
    _chunked_held(held, recorded)
    peaks = [r["peak_gib"] for r in solves]
    print(f"  chunked peaks {min(peaks):.2f}-{max(peaks):.2f} GiB against "
          f"the flagship's eager {e['peak_gib']:.2f} GiB and the eager "
          f"paths' {EAGER_PEAK_GIB} GiB (PERF.md section 6)")
    counts = _chunked_counts(*solves)
    print(f"  launches on the path (captured solves): {counts}")
    common.release_graphs()
    return counts


# the analysis phase: the path's rows, and the Cholesky's (a cut, PERF.md
# section 4), the timed solves in the order they run
ANALYSIS_DIM = 1 << 20
ANALYSIS_CHOL_DIM = 1 << 18
ANALYSIS_SOLVES = ("cholesky", "pivoted", "reduce", "purification",
                   "lowdin", "lobpcg_eps", "lobpcg")


def analysis_products(errs):
    """The band and general kernels held against their plain versions at
    the shapes the analysis path gives them: the path once more at the
    flagship's width, without its warm-up, inside ``_held_on_path``.
    Its launches are not counted."""
    held = {}
    with _held_on_path(errs, held):
        analysis.run(ANALYSIS_DIM, 128, "cuda", warm_up=False,
                     chol_dim=ANALYSIS_CHOL_DIM)
    torch.cuda.synchronize()
    for line in held.values():
        print(f"  held on the path: {line}")
    kinds = {key[:2] for key in held}
    if not {("spgemm_band", "highest"),
            ("spgemm_general", "highest")} <= kinds:
        raise AssertionError("the analysis path's products held did not "
                             "cover the band and general kernels at "
                             "'highest'")


def analysis_dense():
    """The float64 parity at 8192 rows (``analysis.dense``), every check
    within its bar."""
    res = analysis.dense(8192, 128, "cuda")
    for name, r in res.items():
        if isinstance(r, dict):
            print(f"  dense {name}: " + ", ".join(
                f"{k} {v!r}" for k, v in r.items()))
    bad = analysis.failures(res, analysis.DENSE_BARS)
    if bad:
        raise AssertionError("analysis dense parity out of bounds: "
                             + "; ".join(bad))


def analysis_twin():
    """The Cholesky, the pivoted Cholesky, ``reduce_dimension``, both
    extrapolations and LOBPCG (real, and complex through the embedding)
    at 2048 rows, bs 32, f64: the card against the CPU, each reading
    within 1e-9 relative (Frobenius; eigenvectors through V V^H)."""
    out = {}
    for dev in ("cpu", "cuda"):
        sp.reset_launches()
        t0 = time.perf_counter()
        out[dev] = analysis.twin(2048, 32, dev)
        launched = {k: sp.launches[k] for k in PATH_KERNELS}
        print(f"  twin {dev}: {time.perf_counter() - t0:.2f} s, launches "
              f"{launched}")
        if (dev == "cpu") == any(launched.values()):
            raise AssertionError(f"the {dev} twin launched "
                                 f"{'a' if dev == 'cpu' else 'no'} kernel")
    diffs = {k: float(np.linalg.norm(out["cuda"][k] - v)
                      / np.linalg.norm(v)) for k, v in out["cpu"].items()}
    print(f"  twin card against CPU (relative): {diffs}")
    if not all(d <= 1e-9 for d in diffs.values()):
        raise AssertionError("card and CPU disagree on the analysis twin")


def phase_analysis(errs):
    """The analysis path at the flagship's width
    (``profiling/analysis.py``; the Cholesky at ANALYSIS_CHOL_DIM rows):
    each solve timed after a warm-up and held to ``analysis.BARS`` (the
    LOBPCG run at ``tol=None`` and the Lowdin distances only printed);
    then its kernels against their plain versions at the path's shapes
    (``analysis_products``, into ``errs``), the dense parity at 8192 rows
    and the card-against-CPU twin.  -> the launch counts of the timed
    solves."""
    res = analysis.run(ANALYSIS_DIM, 128, "cuda",
                       chol_dim=ANALYSIS_CHOL_DIM)
    counts = dict.fromkeys(PATH_KERNELS, 0)
    for name in ANALYSIS_SOLVES:
        r = res[name]
        print(_solve_line(name, r))
        counts = {k: counts[k] + r["launches"][k] for k in counts}
    eps = res["lobpcg_eps"]
    print(f"  LOBPCG at tol=None: {eps['iterations'][-1]} iterations, "
          f"the epsilon rule stopped the loop before {analysis.MAX_ITERS}: "
          f"{eps['stopped_early']}")
    bad = analysis.failures(res, analysis.BARS)
    if bad:
        raise AssertionError("analysis path out of bounds: "
                             + "; ".join(bad))
    if not (counts["spgemm_band"] and counts["spgemm_general"]):
        raise AssertionError("the analysis path did not launch both the "
                             "band and the general kernel")
    analysis_products(errs)
    analysis_dense()
    analysis_twin()
    print(f"  launches on the path: {counts}")
    return counts


# the api phase: the path's rows and the density slice written back
API_DIM = 1 << 20
API_SLICE = 1 << 16
API_DENSE = 8192
TWIN_BAR = 1e-12


def _api_lines(res: dict) -> None:
    io = res["io"]
    for key in ("h_bin", "s_bin", "h_mtx"):
        for op in ("write", "read"):
            r = io[f"{op}_{key}"]
            print(f"  {op} {key}: {r['seconds']!r} s, {r['bytes']} bytes, "
                  f"{r['mb_per_s']!r} MB/s")
    print(f"  read-back slot for slot: H binary {io['same_h_bin']}, S "
          f"binary {io['same_s_bin']}, H Matrix Market {io['same_h_mtx']}")
    for name in ("isq", "trs4"):
        r = res[name]
        print(f"  {name} through the API: " + ", ".join(
            f"{k} {v!r}" for k, v in r.items()))
    print(f"  direct solves on the same handles: {res['direct']}")
    print(f"  density slice: {res['slice']}")
    for name, r in res["algebra"].items():
        print(f"  {name}: " + ", ".join(f"{k} {v!r}" for k, v in r.items()))
    print(f"  complex exponential: {res['complex']}")


def api_products(errs):
    """The band and general kernels and the split pass held against
    their plain versions at the shapes that the counted calls of phase
    api give them: S -> ISQ -> TRS4 at the path's width, the complex
    exponential at its API_DIM / 2 complex rows and the six examples
    (float64), once more inside ``_held_on_path``.  Their launches are
    not counted."""
    import tempfile
    held = {}
    nt.ConstructGlobalProcessGrid(device="cuda")
    h, s, nel = overlap.system(API_DIM, 128, "cuda")
    n = API_DIM // 2
    rows, cols, vals = api_path.hermitian_triplets(n)
    with _held_on_path(errs, held):
        api_path.solve(nt.Matrix_ps(h), nt.Matrix_ps(s), nel)
        del h, s
        c = nt.Matrix_ps(n)
        c.FillFromTripletList(nt.TripletList_c._from_arrays(rows, cols,
                                                            vals))
        nt.ExponentialSolvers.ComputeExponential(c, nt.Matrix_ps(n),
                                                 api_path.params())
        del c
        with tempfile.TemporaryDirectory() as work:
            api_path.examples("cuda", work)
    torch.cuda.synchronize()
    for line in held.values():
        print(f"  held on the path: {line}")
    kinds = {key[:2] for key in held}
    f64 = {key[:2] for key in held if key[-1] == torch.float64}
    if not ({("spgemm_band", "high"), ("spgemm_general", "high"),
             ("split_bf16", True)} <= kinds and f64):
        raise AssertionError("the api path's products held did not cover "
                             "the band and general kernels and the split "
                             "at 'high' and the examples' float64 "
                             "products")


def api_twin():
    """The PremadeMatrix workflow at 2048 rows, f64: the card's written
    density against the CPU's, within TWIN_BAR relative."""
    import tempfile
    out = {}
    for dev in ("cpu", "cuda"):
        sp.reset_launches()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            out[dev] = api_path.twin(dev, work)
        launched = {k: sp.launches[k] for k in PATH_KERNELS}
        print(f"  twin {dev}: {time.perf_counter() - t0:.2f} s, launches "
              f"{launched}")
        if (dev == "cpu") == any(launched.values()):
            raise AssertionError(f"the {dev} twin launched "
                                 f"{'a' if dev == 'cpu' else 'no'} kernel")
    diff = float(np.linalg.norm(out["cuda"] - out["cpu"])
                 / np.linalg.norm(out["cpu"]))
    print(f"  twin card against CPU (relative): {diff!r}")
    if not diff <= TWIN_BAR:
        raise AssertionError("card and CPU disagree on the PremadeMatrix "
                             "workflow")


def phase_api(errs):
    """The NTPoly-compatible surface at the flagship's width
    (``profiling/api.py``): files, S -> ISQ -> TRS4 and the algebra
    through ``nt``, each held against the layer below
    (``api.checks``); the products held against their plain versions;
    the complex exponential's dense parity; the six examples; the
    card-against-CPU twin.  -> the launch counts of the calls through
    the API (the solves, the complex exponential, the examples)."""
    import tempfile
    res = api_path.run(API_DIM, "cuda", slice_rows=API_SLICE)
    _api_lines(res)
    bad = api_path.checks(res)
    try:
        _certified("api trs4", res["trs4"], API_DIM / 2, trace=False)
    except AssertionError as exc:
        bad.append(str(exc))
    counts = {k: res["isq"]["launches"][k] + res["trs4"]["launches"][k]
              + res["complex"]["launches"][k] for k in PATH_KERNELS}
    if bad:
        raise AssertionError("api path out of bounds: " + "; ".join(bad))
    api_products(errs)
    dense = api_path.dense(API_DENSE, "cuda")
    print(f"  dense {dense}")
    bad = functions.failures(dense, api_path.DENSE_BARS)
    sp.reset_launches()
    with tempfile.TemporaryDirectory() as work:
        ex = api_path.examples("cuda", work)
    for k in PATH_KERNELS:
        counts[k] += sp.launches[k]
    for name, r in ex.items():
        print(f"  example {name}: " + ", ".join(
            f"{k} {v!r}" for k, v in r.items()))
    bad += functions.failures(ex, api_path.EXAMPLE_BARS)
    if bad:
        raise AssertionError("api dense parity or examples out of bounds: "
                             + "; ".join(bad))
    api_twin()
    print(f"  launches on the path: {counts}")
    if not all(counts.values()):
        raise AssertionError("the api path did not launch the band and "
                             "general kernels and the split pass")
    return counts


# the guide phase's bars: each tier's largest error of X @ X relative to
# max |C| against the float64 product ('high' at most this; 'highest'
# within float32 rounding), and the complex exponential's relative
# Frobenius error against its dense oracle (the reference's 1e-4)
GUIDE_BARS = {"high": 2e-5, "highest": 1e-6, "complex": 1e-4}


def _guide_checks(ns: dict) -> list[str]:
    """The guide's readings against ``GUIDE_BARS``; the quick start's
    density (its last TRS4 through the API, at 'high') within the
    PremadeMatrix example's bars (``api.EXAMPLE_BARS``: idempotency
    1e-3, the electron count 1e-4 an electron) and phase api's
    commutator bar; the density of its TRS4 at 'highest' within the
    flagship's (phase flagship)."""
    bad = []
    te = ns["tier_error"]
    if not te["high"] <= GUIDE_BARS["high"] < te["bf16"]:
        bad.append(f"tier 'high' {te['high']!r} not within "
                   f"{GUIDE_BARS['high']} below 'bf16' {te['bf16']!r}")
    if te["default"] != te["bf16"]:
        bad.append("'default' is not 'bf16'")
    if not te["highest"] <= GUIDE_BARS["highest"]:
        bad.append(f"tier 'highest' {te['highest']!r}")
    if not ns["complex_error"] <= GUIDE_BARS["complex"]:
        bad.append(f"complex exponential {ns['complex_error']!r}")
    values = [ns["energy"], ns["mu"], ns["e_flag"], ns["e4"],
              *(v for out in ns["solved"].values() for v in out[1:])]
    if not all(math.isfinite(v) for v in values):
        bad.append(f"a reading is not finite: {values}")
    nel = ns["NEL"]
    quick = purity_invariants(ns["kmat"]._m, ns["hamiltonian"]._m, nel,
                              api_path.THRESHOLD, s=ns["overlap"]._m)
    exact = purity_invariants(ns["solved"]["highest"][0], ns["x"], nel,
                              api_path.THRESHOLD)
    for what, inv in (("quick start ('high')", quick),
                      ("TRS4 'highest'", exact)):
        print(f"  {what} density, certificates (at 'highest'): "
              + json.dumps(inv))
    premade = {k: api_path.EXAMPLE_BARS[f"premade_matrix.{k}"]
               for k in ("idempotency_rel", "trace_err")}
    # the example's trace bar holds its ten electrons
    if not (quick["idempotency_rel"] <= premade["idempotency_rel"]
            and quick["trace_abs_err"] / nel <= premade["trace_err"] / 10
            and quick["commutator_rel"]
            <= api_path.BARS["trs4.commutator_rel"]):
        bad.append("the quick start's density out of bounds")
    if not (exact["idempotency_rel"] <= 1e-5
            and exact["commutator_rel"] <= 5e-5
            and exact["trace_abs_err"] / nel <= 1e-6):
        bad.append("the 'highest' TRS4 density out of bounds")
    return bad


def phase_guide(errs):
    """The user guide run as written on the card (``docs.run_guide``:
    its python blocks in order, DEVICE "cuda", at its own sizes) inside
    ``_held_on_path``; the keys of the chunk captured in it held on its
    uncaptured steps; its readings checked (``_guide_checks``).  -> the
    launch counts of the guide's run."""
    from ntpoly_tpu_torch import docs
    held = {}
    # the guide resets the counts itself (its observability block): keep
    # what each reset drops
    dropped = dict.fromkeys(sp.launches, 0)
    reset = sp.reset_launches

    def keep_and_reset():
        for k, v in sp.launches.items():
            dropped[k] += v
        reset()

    reset()
    t0 = time.perf_counter()
    sp.reset_launches = keep_and_reset
    try:
        with _held_on_path(errs, held):
            ns = docs.run_guide()
    finally:
        sp.reset_launches = reset
    torch.cuda.synchronize()
    counts = {k: sp.launches[k] + dropped[k] for k in PATH_KERNELS}
    print(f"  the guide's blocks: {time.perf_counter() - t0:.2f} s, "
          f"launches {counts}")
    for line in held.values():
        if line is not None:
            print(f"  held on the path: {line}")
    captured = [key[:-1] for key in held if key[-1] == "captured"]
    print(f"  keys launched while capturing: {captured}")
    _missing_keys(held, captured)
    print(f"  tiers: {ns['tier_error']}, complex exponential "
          f"{ns['complex_error']!r}")
    bad = _guide_checks(ns)
    if bad:
        raise AssertionError("phase guide: " + "; ".join(bad))
    if not (counts["spgemm_band"] or counts["spgemm_general"]):
        raise AssertionError("the guide launched neither the band nor "
                             "the general kernel")
    return counts


# phase mesh: the worlds (grid, rows), the ranks' threads, each world's
# time limit (s), and the flagship's 'high' solve of phase flagship
MESH_WORLDS = {"b": ((2, 2, 1), 1 << 18), "c": ((2, 2, 2), 1 << 16)}
# with --cards: one rank on each of four cards, at the flagship's rows
MESH_CARDS = {"d": ((2, 2, 1), 1 << 20)}
MESH_THREADS = {4: 2, 8: 1}
MESH_TIMEOUT = 420.0


def mesh_params():
    """The worlds' TRS4 settings: the flagship's at 'highest', but with
    the kernel chosen per multiply and the capacity grown to each
    product's need.  On a grid of several panels the gathered row panel
    of A holds EMPTY gaps between the panels' slots, which the band plan
    refuses: 'pallas_band' raises there, and the general kernel at the
    flagship's pinned k_out 5 keeps the 5 lowest of a row's 9 candidate
    columns before the threshold flush (ROADMAP Queue C)."""
    params = flagship_params(None, "pallas", "highest")
    params.on_overflow = "grow"
    return params
FLAGSHIP_HIGH: dict = {}


def _grid_system(dim: int, bs: int, grid):
    """The flagship's H (gapped chain, half-width 16, f32) and identity
    ISQ on ``grid``."""
    h = PM.banded(dim, trs4_tiers.HALFWIDTH, gapped_fn, bs=bs, grid=grid,
                  dtype=torch.float32)
    return h, PM.identity(dim, bs=bs, grid=grid, dtype=torch.float32)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def mesh_rank(workdir: str, shape, dim: int, device: str | None,
              bs: int = 128, hold: bool = True) -> None:
    """One rank of phase mesh's worlds: the flagship's TRS4 at 'highest'
    on a rows x cols x slices grid of ``dim`` rows on ``device`` (None:
    this rank's own card); first with every band and general product
    held against its plain version (``_held_on_path``, not counted; a
    2-iteration warm-up instead with ``hold`` off), then timed with its
    launches counted and the keys of its products recorded; its
    certificates; D written collectively as binary and read back on the
    same grid, tile for tile; every rank's triplets gathered by
    ``dist.allgather_triplets``.  Writes rank{r}.json under
    ``workdir``."""
    import torch.distributed as tdist
    from ntpoly_tpu_torch.io import binary
    from ntpoly_tpu_torch.parallel import algebra as alg
    from ntpoly_tpu_torch.parallel import dist
    from ntpoly_tpu_torch.profiling.api import same_slots
    me = dist.process_index()
    grid = ProcessGrid(*shape, device=device)
    h, isq = _grid_system(dim, bs, grid)
    nel = dim / 2
    params = mesh_params()
    held, errs = {}, dict.fromkeys(KERNELS, 0.0)
    if hold:
        # the timed solve's settings, to convergence: it warms up too
        with _held_on_path(errs, held):
            density.trs4(h, isq, nel, params)
    else:
        warm = params.copy()
        warm.max_iterations = 2
        density.trs4(h, isq, nel, warm)
    _sync(grid.device)
    grid.group("all").barrier()
    launched = {}
    t0 = time.perf_counter()
    with _held_on_path(errs, launched, hold=False):
        rho, energy, mu, n, counts = solve(h, isq, nel, params)
    _sync(grid.device)
    wall = time.perf_counter() - t0
    # with the overlap I, the certificates' products choose their kernel
    # per call, as the solve's do
    inv = purity_invariants(rho, h, nel, params.threshold, s=isq)
    path = str(Path(workdir) / "d.bin")
    t0 = time.perf_counter()
    binary.write(rho, path)
    t_write = time.perf_counter() - t0
    ref = alg.filter_small(rho, 0.0)        # the stored nonzeros, packed
    t0 = time.perf_counter()
    back = binary.read(path, bs=bs, grid=grid, k=ref.k,
                       dtype=torch.float32)
    t_read = time.perf_counter() - t0
    # a few triplets a rank, complex, gathered in rank order
    size = dist.process_count()
    rows = np.arange(3 * me, 3 * me + 3)
    vals = rows * (1.0 - 2.0j)
    gi, gj, gv = dist.allgather_triplets(rows, rows[::-1], vals)
    want = np.arange(3 * size)
    union = (bool((gi == want).all()) and bool((gv == want * (1.0 - 2.0j))
                                               .all())
             and bool((gj == want.reshape(size, 3)[:, ::-1].ravel()).all()))
    out = dict(rank=me, iterations=n, energy=repr(energy), mu=repr(mu),
               wall=wall, invariants=inv, launches=counts,
               held=sorted(v for v in held.values() if v is not None),
               held_kinds=sorted(map(list, {k[:2] for k in held})),
               unheld=sorted(map(str, set(launched) - set(held))) if hold
               else [], errs=errs,
               write_s=t_write, read_s=t_read, file_bytes=os.path.getsize(
                   path), same=bool(same_slots(back, ref)), union=union,
               backend=str(tdist.get_backend()), device=str(grid.device),
               staged=sorted(dist.staged), nnz=int(rho.nnz))
    (Path(workdir) / f"rank{me}.json").write_text(json.dumps(out))


def mesh_one_rank():
    """(a) The flagship at 'high' on a 1 x 1 x 1 grid inside a one-rank
    world (cpu:gloo,cuda:nccl): iterations, energy, mu and D slot for
    slot equal to
    the same solve on the default grid, which equals phase flagship's.
    -> the world solve's launches."""
    import tempfile
    from ntpoly_tpu_torch.parallel import dist
    from ntpoly_tpu_torch.profiling.api import same_slots
    config = trs4_tiers.CONFIGS["flagship"]
    dim, bs, nel = config["dim"], config["bs"], config["dim"] / 2
    params = flagship_params(config["k_out"], "pallas_band", "high")
    warm = params.copy()
    warm.max_iterations = 2
    runs = {}
    with tempfile.TemporaryDirectory() as work:
        for where in ("default", "world"):
            if where == "world":
                dist.initialize(init_method=f"file://{work}/store",
                                rank=0, world_size=1, timeout=300)
                grid = ProcessGrid(1, 1, 1, device="cuda:0")
            else:
                grid = ProcessGrid(device="cuda")
            try:
                h, isq = _grid_system(dim, bs, grid)
                density.trs4(h, isq, nel, warm)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rho, energy, mu, n, counts = solve(h, isq, nel, params)
                torch.cuda.synchronize()
                runs[where] = (rho, energy, mu, n, counts,
                               time.perf_counter() - t0)
                del h, isq
            finally:
                if where == "world":
                    dist.shutdown()
    (r0, e0, m0, n0, _, t_default), (r1, e1, m1, n1, c1, t_world) = (
        runs["default"], runs["world"])
    print(f"  (a) 1 x 1 x 1 in a one-rank world: {n1} iterations, "
          f"{t_world:.3f} s wall; default grid {n0} iterations, "
          f"{t_default:.3f} s; energy {e1!r} / {e0!r}, mu {m1!r} / "
          f"{m0!r}; launches {c1}")
    same = (n0, e0, m0) == (n1, e1, m1) and bool(same_slots(r0, r1))
    flag = FLAGSHIP_HIGH.get("high")
    print(f"  (a) bit for bit with the default grid: {same}; phase "
          f"flagship's 'high' solve: {flag}")
    if not same or (n0, e0, m0) != flag:
        raise AssertionError("the 1 x 1 x 1 grid in a world is not bit for "
                             "bit the default grid's solve")
    return c1


def mesh_world(tag: str, errs):
    """(b)/(c): a world of ranks spawned on the one card (gloo, device
    cuda:0), or with ``--cards`` (d): one rank on each card (the
    cpu:gloo,cuda:nccl pair), each running :func:`mesh_rank`; held to
    the 1 x 1 x 1 solve of the same H on the card: equal iterations,
    energy within 1e-6, the certificates of PERF.md section 2, equal
    scalars on every rank, every key a rank's timed solve launched held
    on that rank and both kernels held in the world, D read back tile
    for tile, the triplets' union.  -> the ranks' summed launches."""
    import tempfile
    from ntpoly_tpu_torch.parallel import launch
    shape, dim = {**MESH_WORLDS, **MESH_CARDS}[tag]
    size = int(np.prod(shape))
    # one card each where there are enough, as dist.initialize decides
    device = None if size <= torch.cuda.device_count() else "cuda:0"
    bs = trs4_tiers.CONFIGS["flagship"]["bs"]
    params = mesh_params()
    h, isq = _grid_system(dim, bs, ProcessGrid(device="cuda"))
    t0 = time.perf_counter()
    _, e1, _, n1, _ = solve(h, isq, dim / 2, params)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    del h, isq
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        launch.run("chip_smoke:mesh_rank", size,
                   args=(work, list(shape), dim, device, bs),
                   workdir=work, timeout=MESH_TIMEOUT,
                   threads=MESH_THREADS[size])
        t_world = time.perf_counter() - t0
        ranks = [json.loads((Path(work) / f"rank{r}.json").read_text())
                 for r in range(size)]
    r0 = ranks[0]
    inv = r0["invariants"]
    what = f"({tag}) {'x'.join(map(str, shape))}, {dim} rows"
    print(f"  {what}: backend {r0['backend']}, devices "
          f"{[r['device'] for r in ranks]}")
    print(f"  {what}: {r0['iterations']} iterations in {r0['wall']:.3f} s "
          f"(rank 0; ranks {[round(r['wall'], 3) for r in ranks]}), the "
          f"world {t_world:.1f} s with start-up; 1 x 1 x 1 on the card "
          f"{n1} iterations in {t_one:.3f} s; energy {r0['energy']} "
          f"against {e1!r}; certificates {json.dumps(inv)}")
    print(f"  {what}: D {r0['file_bytes']} bytes written in "
          f"{max(r['write_s'] for r in ranks):.2f} s, read back in "
          f"{max(r['read_s'] for r in ranks):.2f} s, tile for tile "
          f"{[r['same'] for r in ranks]}; triplets gathered "
          f"{[r['union'] for r in ranks]}; collectives staged through the "
          f"host (gloo): {r0['staged']}")
    for line in r0["held"]:
        print(f"  {what} held on rank 0: {line}")
    # the band plan takes only the ranks whose gathered row panel has no
    # gaps, so each kernel need not run on every rank; both must run in
    # the world, and each rank's timed keys must all have been held
    kinds = {tuple(k) for r in ranks for k in r["held_kinds"]}
    both = {("spgemm_band", "highest"), ("spgemm_general", "highest")}
    held_ok = [bool(r["held"]) and not r["unheld"] for r in ranks]
    print(f"  {what}: kernels held per rank "
          f"{[[k[0] for k in r['held_kinds']] for r in ranks]}; every key "
          f"the timed solve launched held, per rank: {held_ok}"
          + "".join(f"; rank {r['rank']} not held: {r['unheld']}"
                    for r in ranks if r["unheld"]))
    energy = float(r0["energy"])
    ok = (all((r["iterations"], r["energy"], r["mu"], r["invariants"])
              == (r0["iterations"], r0["energy"], r0["mu"], inv)
              for r in ranks)
          and r0["iterations"] == n1
          and abs(energy - e1) <= 1e-6 * abs(e1)
          and inv["idempotency_rel"] <= 1e-5
          and inv["commutator_rel"] <= 5e-5
          and inv["trace_abs_err"] / (dim / 2) <= 1e-6
          and all(r["same"] and r["union"] for r in ranks)
          and all(held_ok) and both <= kinds)
    if not ok:
        raise AssertionError(f"phase mesh {what} out of bounds")
    for r in ranks:
        for k, v in r["errs"].items():
            errs[k] = max(errs[k], v)
    counts = {k: sum(r["launches"][k] for r in ranks) for k in PATH_KERNELS}
    print(f"  {what}: launches over the ranks {counts}")
    if not counts["spgemm_band"]:
        raise AssertionError(f"the {what} solve never launched the band "
                             "kernel")
    return counts


def phase_mesh(errs):
    """The multi-device layer: (a) the flagship on a 1 x 1 x 1 grid in a
    one-rank world, bit for bit the default grid's; (b) TRS4 of the
    flagship's H at 2^18 rows in a world of four ranks on the card
    (2 x 2 x 1); (c) at 2^16 rows in a world of eight (2 x 2 x 2, the
    slices' split-k and merge).  -> the launches of the three."""
    one = mesh_one_rank()
    worlds = [mesh_world(tag, errs) for tag in MESH_WORLDS]
    counts = {k: one[k] + sum(w[k] for w in worlds) for k in PATH_KERNELS}
    print(f"  launches on the path: {counts}")
    return counts


def _run(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    held = torch.cuda.memory_allocated() / 2**30
    print(f"phase {name}: ok, {time.perf_counter() - t0:.2f} s "
          f"({held:.2f} GiB of device memory still allocated)", flush=True)
    return out


def _result() -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main_cards() -> int:
    """``--cards``: only phase mesh's world (d), one rank on each of
    four cards over the cpu:gloo,cuda:nccl pair, at the flagship's 2^20
    rows, held as (b) and (c) are."""
    smi = _run("device", phase_device)
    if torch.cuda.device_count() < 4:
        raise RuntimeError("--cards needs four cards")
    _run("build", phase_build)
    errs = dict.fromkeys(KERNELS, 0.0)
    counts = _run("mesh_cards", mesh_world, "d", errs)
    print(json.dumps({"mesh_cards": counts, "max_abs_err": errs}))
    print(smi)
    _result()
    return 0


def main() -> int:
    run = _run
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
    funcs = run("functions", phase_functions, errs)
    chunk = run("chunked", phase_chunked, errs)
    anal = run("analysis", phase_analysis, errs)
    surface = run("api", phase_api, errs)
    guide = run("guide", phase_guide, errs)
    mesh = run("mesh", phase_mesh, errs)
    counts = {k: parity[k] + flagship[k] + non_orth[k] + funcs[k]
              + chunk[k] + anal[k] + surface[k] + guide[k] + mesh[k]
              for k in PATH_KERNELS}
    counts.update({k: low[k] for k in ("spgemm_stream", "spgemm_window")})
    counts["spgemm_uniform"] = low_r5["spgemm_uniform"]
    pred = {k: chunk[k + "_pred"] for k in ("spgemm_band",
                                            "spgemm_general")}
    print(f"launches on each kernel's path: {counts} (parity solve "
          f"{parity}, flagship solve {flagship}, overlap path {non_orth}, "
          f"functions path {funcs}, chunked path {chunk}, analysis path "
          f"{anal}, api path {surface}, guide {guide}, mesh path {mesh}, "
          f"low-K profile "
          f"{low}, round-5 low-K profile {low_r5}); under the device "
          f"predicate (chunked 'auto', band and general each launched, "
          f"one computing): {pred}")
    for name, n in list(counts.items()) + list(pred.items()):
        if not n:
            raise AssertionError(f"{name} never launched on its path")
    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=counts[name], max_abs_err=errs[name],
                    **times[name], library_ms=None)
               for name in KERNELS]
    for entry in kernels:
        if entry["name"] in pred:
            entry["launches_predicated"] = pred[entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    _result()
    return 0


if __name__ == "__main__":
    sys.exit(main_cards() if sys.argv[1:] == ["--cards"] else main())
