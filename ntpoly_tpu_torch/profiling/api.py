"""The NTPoly-compatible surface at the flagship's width, from files to
the density matrix, timed, with its checks.

A chemistry code drives the library through ``import ntpoly_tpu_torch
as nt``: it reads H and S from files, computes S^-1/2, purifies, and
writes the density (the PremadeMatrix example's workflow).  ``run``
drives that path through the public names only, and holds each step
against the layer below on the same handles:

  io        H (the gapped chain, ``systems.gapped_fn``) and S
            (``systems.overlap_fn``), half-width 16, f32, written with
            ``WriteToBinary`` (both) and ``WriteToMatrixMarket`` (H)
            into a temporary directory and read back through
            ``nt.Matrix_ps(path, True)`` / ``nt.Matrix_ps(path)``: every
            read-back matrix equal to the written one slot for slot
            (col ids and blocks bitwise); seconds, MB/s and file sizes
            of each write and read;
  isq/trs4  ``nt.SquareRootSolvers.InverseSquareRoot(S, ISQ, sp)`` and
            ``nt.DensityMatrixSolvers.TRS4(H, ISQ, nel, D, sp)`` on the
            read-back matrices, threshold 1e-7, the API's defaults
            otherwise ('high'): max |ISQ S ISQ^T - I| (``BARS``), the
            generalized certificates of D, its iterations; the same two
            solves called directly (``squareroot.inverse_square_root``,
            ``density.trs4``) on the same handles must give the same
            iterations, energy and mu bitwise, and ISQ and D slot for
            slot (``same_*``: 1 when equal);
  slice     ``GetMatrixSlice`` of D's leading ``slice_rows`` rows written
            with ``WriteToBinary`` and read back: equal triplets;
  algebra   ``Gemm`` (alpha, beta, threshold), ``Increment``, ``Dot``,
            ``Trace``, ``Norm``, ``PairwiseMultiply``, ``DiagonalScale``,
            ``MeasureAsymmetry``/``Symmetrize`` (on H + 1e-3 A, A a
            banded antisymmetric matrix), ``Transpose`` and
            ``MatrixMapper.MapVectorized`` on the read-back H and S,
            each timed and equal bitwise to the lower-layer call on the
            same handles;
  complex   a complex Hermitian band (half-width 16) of ``dim / 2``
            complex rows through ``nt.ExponentialSolvers.
            ComputeExponential``: the API's embedding equal to
            ``cplx.embed`` of the same data slot for slot, and the
            result equal to ``exponential.compute_exponential`` on it.

``dense`` holds the complex exponential through the API to the dense
oracle V exp(w) V^H (``torch.linalg.eigh``) in f64, the JAX package's
bar 1e-4.  ``examples`` runs the six examples in-process at their
ReadMe sizes and checks each output (``EXAMPLE_BARS``).  ``twin`` runs
the PremadeMatrix workflow at 2048 rows, f64, and returns the written
density for a card-against-CPU comparison.

On a machine with a CUDA card, from the repository root:

    python3 -m ntpoly_tpu_torch.profiling.api

prints one JSON object for the path at 2^20 rows (bs 128, f32), one
for the dense parity at 8192 complex rows and one for the examples;
``--floor 1024 --device cpu`` prints ``floor_readings``, the ISQ's and
TRS4's readings at each tier and cutoff behind ``BARS``.
On the CPU, ``run(1024, "cpu", slice_rows=512)``, ``dense(256, "cpu")``
and ``examples("cpu", workdir)`` drive the same calls.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import io as _io
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

import ntpoly_tpu_torch as nt

from ..api import _auto_bs
from ..core import cplx
from ..ops import _cuda
from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..parallel.grid import global_grid
from ..solvers import density, exponential, squareroot
from ..systems import gapped_fn, overlap_fn
from ..utils import maps
from ..utils.permutation import Permutation
from .functions import _counted, failures
from .overlap import HALFWIDTH, residual
from .trs4_tiers import purity_invariants

THRESHOLD = 1e-7
# TRS4's convergence cutoff: the PremadeMatrix example's
# --converge_density.  At the library's 1e-6, 'high' iterates on in the
# bf16x3 noise: on the H100 at 2^20 rows TRS4's idempotency then reads
# 1.43e-5, over its bar, against 4.1e-6 at 1e-5 (``floor_readings``)
CONVERGE_DENSITY = 1e-5
# reading -> the largest value it may take.  TRS4 at 'high' is held to
# the bars of phase overlap's 'high' TRS4; the ISQ residual at 'high'
# to 5e-5, not phase overlap's 1e-5 at 'highest': bf16x3 keeps 16 bits
# of each float32 operand (|x - hi - lo| ~ 2^-17 |x|), and the ISQ's
# residual settles at 1.74e-5 on the H100 at 2^20 rows at either cutoff
# (6.0e-7 at 'highest'; ``floor_readings``)
BARS = {
    "isq.residual": 5e-5,
    "trs4.idempotency_rel": 1e-5, "trs4.commutator_rel": 5e-5,
    "trs4.iterations": 10,
}
# the reference's oracle bar (tests/conftest.py THRESHOLD)
DENSE_BARS = {"exp.rel": 1e-4}
# the checks of tests/test_examples.py (PremadeMatrix), and 1e-4 against
# a dense oracle of each example's own input for the others
EXAMPLE_BARS = {
    "premade_matrix.idempotency_rel": 1e-3,
    "premade_matrix.trace_err": 1e-3,
    "complex_matrix.rel": 1e-4, "graph_theory.rel": 1e-4,
    "hydrogen_atom.idempotency_rel": 1e-3,
    "hydrogen_atom.trace_err": 1e-3, "matrix_maps.rel": 1e-4,
    "overlap_matrix.rel": 1e-4,
}
# the OverlapMatrix example at 16 basis functions: at the ReadMe's 64,
# its Gaussian overlap cut at 1e-6 is indefinite (the smallest
# eigenvalue -6.3e-7), no S^-1/2 exists and the Taylor ISQ of both
# packages diverges to inf (ROADMAP Queue C)
OVERLAP_BASIS = 16
TWIN_SEED = 11


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(device, fn, *args):
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return out, time.perf_counter() - t0


def same_slots(a: PM.PSMatrix, b: PM.PSMatrix) -> bool:
    """Equal col ids and blocks, bit for bit."""
    return (a.col_ids.shape == b.col_ids.shape and a.dim == b.dim
            and a.dtype == b.dtype and torch.equal(a.col_ids, b.col_ids)
            and torch.equal(a.blocks.contiguous().view(torch.uint8),
                            b.blocks.contiguous().view(torch.uint8)))


def same_triplets(a: PM.PSMatrix, b: PM.PSMatrix) -> bool:
    """Equal stored entries in (row, col) order (the block sizes may
    differ)."""
    def ordered(m):
        r, c, v = PM.to_triplets(m)
        o = np.lexsort((c, r))
        return r[o], c[o], v[o]
    return all(np.array_equal(x, y)
               for x, y in zip(ordered(a), ordered(b)))


def params() -> nt.SolverParameters:
    """The API's parameters with threshold 1e-7, the defaults
    otherwise."""
    p = nt.SolverParameters()
    p.SetThreshold(THRESHOLD)
    return p


def antisymmetric_fn(i, j):
    """A banded antisymmetric value function: sign(j - i) / (1 + |i -
    j|)^2."""
    off = (i - j).abs().to(torch.float32)
    return torch.sign((j - i).to(torch.float32)) / (1.0 + off) ** 2


def hermitian_triplets(n: int, halfwidth: int = HALFWIDTH):
    """(rows, cols, vals) of a complex Hermitian band of n rows: real
    part 0.1 / (1 + d)^2 (1 on the diagonal), imaginary part 0.05
    sign(j - i) / (1 + d)^2, d = |i - j| <= halfwidth."""
    offs = np.arange(-halfwidth, halfwidth + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    d = np.abs(rows - cols)
    re = np.where(d == 0, 1.0, 0.1 / (1.0 + d) ** 2)
    im = 0.05 * np.sign(cols - rows) / (1.0 + d) ** 2
    return rows, cols, re + 1j * im


def _file_line(path: str, seconds: float) -> dict:
    size = os.path.getsize(path)
    return {"seconds": seconds, "bytes": size,
            "mb_per_s": size / 1e6 / max(seconds, 1e-12)}


def io_phase(h: PM.PSMatrix, s: PM.PSMatrix, tmp: str, device) -> tuple:
    """Write H (binary, Matrix Market) and S (binary), read them back
    -> (readings, H read from binary, S read from binary)."""
    out = {}
    H, S = nt.Matrix_ps(h), nt.Matrix_ps(s)
    paths = {"h_bin": os.path.join(tmp, "H.ntx"),
             "s_bin": os.path.join(tmp, "S.ntx"),
             "h_mtx": os.path.join(tmp, "H.mtx")}
    for key, fn in (("h_bin", H.WriteToBinary),
                    ("s_bin", S.WriteToBinary),
                    ("h_mtx", H.WriteToMatrixMarket)):
        _, sec = _timed(device, fn, paths[key])
        out[f"write_{key}"] = _file_line(paths[key], sec)
    reads = {}
    for key, binary in (("h_bin", True), ("s_bin", True),
                        ("h_mtx", False)):
        args = (paths[key], True) if binary else (paths[key],)
        reads[key], sec = _timed(device, nt.Matrix_ps, *args)
        out[f"read_{key}"] = _file_line(paths[key], sec)
    out["same_h_bin"] = int(same_slots(reads["h_bin"]._m, h))
    out["same_s_bin"] = int(same_slots(reads["s_bin"]._m, s))
    out["same_h_mtx"] = int(same_slots(reads["h_mtx"]._m, h))
    return out, reads["h_bin"], reads["s_bin"]


def _counted_call(fn, *args) -> tuple:
    """fn(*args) with the logger on and the launches counted -> (result,
    readings: seconds, iterations, multiplies, launches)."""
    res = {}
    with _counted(res):
        t0 = time.perf_counter()
        out = fn(*args)
        dev = next((a._m.device for a in args
                    if isinstance(a, nt.Matrix_ps)), None)
        if dev is not None:
            _sync(dev)
        res["seconds"] = time.perf_counter() - t0
    return out, res


def solver_params() -> tuple:
    """(ISQ's, TRS4's) API parameters, verbose."""
    sp, sp_d = params(), params()
    sp.SetVerbosity(True)
    sp_d.SetVerbosity(True)
    sp_d.SetConvergeDiff(CONVERGE_DENSITY)
    return sp, sp_d


def solve(H, S, nel: float) -> tuple:
    """S -> ISQ -> TRS4 through the API -> (ISQ, D, energy, mu,
    readings of each solve)."""
    sp, sp_d = solver_params()
    ISQ = nt.Matrix_ps(H.GetActualDimension())
    D = nt.Matrix_ps(H.GetActualDimension())
    out = {}
    _, out["isq"] = _counted_call(nt.SquareRootSolvers.InverseSquareRoot,
                                  S, ISQ, sp)
    (energy, mu), out["trs4"] = _counted_call(
        nt.DensityMatrixSolvers.TRS4, H, ISQ, nel, D, sp_d)
    return ISQ, D, energy, mu, out


def workflow(H, S, nel: float) -> tuple:
    """ISQ and TRS4 through the API, then the same solves directly on
    the same handles."""
    sp, sp_d = solver_params()
    ISQ, D, energy, mu, out = solve(H, S, nel)
    out["isq"]["iterations"] = out["isq"]["iterations"][-1]
    out["trs4"]["iterations"] = out["trs4"]["iterations"][-1]
    out["isq"]["residual"] = residual(ISQ._m, S._m)
    out["trs4"].update(energy=energy, mu=mu, k=D._m.k)
    out["trs4"].update(purity_invariants(D._m, H._m, nel, THRESHOLD,
                                         s=S._m))
    # the layer below, on the same handles
    isq2, r_isq = _counted_call(squareroot.inverse_square_root, S._m, sp._p)
    (d2, e2, mu2), r_trs4 = _counted_call(density.trs4, H._m, isq2, nel,
                                          sp_d._p)
    out["direct"] = {
        "same_isq": int(same_slots(isq2, ISQ._m)),
        "same_isq_iterations": int(r_isq["iterations"][-1]
                                   == out["isq"]["iterations"]),
        "same_d": int(same_slots(d2, D._m)),
        "same_trs4_iterations": int(r_trs4["iterations"][-1]
                                    == out["trs4"]["iterations"]),
        "same_energy": int(e2 == energy), "same_mu": int(mu2 == mu),
        "isq_seconds": r_isq["seconds"], "trs4_seconds": r_trs4["seconds"],
    }
    return out, D


def slice_phase(D, rows: int, tmp: str, device) -> dict:
    sub = nt.Matrix_ps(rows)
    _, sec_slice = _timed(device, D.GetMatrixSlice, sub, 0, rows - 1, 0,
                          rows - 1)
    path = os.path.join(tmp, "D_slice.ntx")
    _, sec_w = _timed(device, sub.WriteToBinary, path)
    back, sec_r = _timed(device, nt.Matrix_ps, path, True)
    return {"rows": rows, "slice_seconds": sec_slice,
            "write": _file_line(path, sec_w),
            "read": _file_line(path, sec_r),
            "same": int(same_triplets(back._m, sub._m))}


def _double_lower(i, j, v):
    return i, j, 2.0 * v, i >= j


def algebra_phase(H, S, device) -> dict:
    """Each call through the API, timed, against the lower layer."""
    h, s = H._m, S._m
    out = {}

    def check(name, api_fn, lower_fn, compare=None):
        """The API call timed, against the lower layer (matrices slot
        for slot unless ``compare`` is given)."""
        got, sec = _timed(device, api_fn)
        want = lower_fn()
        same = (compare(got, want) if compare
                else same_slots(got._m, want))
        out[name] = {"seconds": sec, "same": int(same)}

    def gemm():
        c = nt.Matrix_ps(S)
        c.Gemm(H, S, alpha=0.5, beta=0.25, threshold=THRESHOLD)
        return c
    check("gemm", gemm, lambda: alg.matmul(h, s, alpha=0.5,
                                           threshold=THRESHOLD, beta=0.25,
                                           c=s))

    def increment():
        x = nt.Matrix_ps(H)
        x.Increment(S, alpha=-0.5, threshold=THRESHOLD)
        return x
    check("increment", increment,
          lambda: alg.increment(h, s, 1.0, -0.5, THRESHOLD))
    scalar = (lambda got, want: got == want)
    check("dot", lambda: H.Dot(S), lambda: float(alg.dot(h, s)), scalar)
    check("trace", lambda: H.Trace(), lambda: float(alg.trace(h)), scalar)
    check("norm", lambda: H.Norm(), lambda: float(alg.norm(h)), scalar)

    def pairwise():
        p = nt.Matrix_ps(H.GetActualDimension())
        p.PairwiseMultiply(H, S)
        return p
    check("pairwise", pairwise, lambda: alg.pairwise_multiply(h, s))
    n = H.GetActualDimension()
    dvals = 1.0 + np.arange(n) % 7 / 7.0
    idx = np.arange(n)
    tl = nt.TripletList_r._from_arrays(idx, idx, dvals)

    def diag():
        x = nt.Matrix_ps(H)
        x.DiagonalScale(tl)
        return x
    np_dtype = torch.empty(0, dtype=h.dtype).numpy().dtype
    check("diagonal_scale", diag,
          lambda: alg.diagonal_scale(h, dvals.astype(np_dtype)))
    a = PM.banded(n, HALFWIDTH, antisymmetric_fn, bs=h.bs, grid=h.grid,
                  dtype=h.dtype)
    ha = alg.increment(h, a, 1.0, 1e-3)
    HA = nt.Matrix_ps(ha)
    check("asymmetry", lambda: HA.MeasureAsymmetry(),
          lambda: float(alg.measure_asymmetry(ha)), scalar)
    out["asymmetry"]["value"] = HA.MeasureAsymmetry()

    def symmetrize():
        x = nt.Matrix_ps(HA)
        x.Symmetrize()
        return x
    check("symmetrize", symmetrize, lambda: alg.symmetrize(ha))
    sym = nt.Matrix_ps(alg.symmetrize(ha))
    out["symmetrize"]["asymmetry_after"] = sym.MeasureAsymmetry()

    def transpose():
        t = nt.Matrix_ps(H.GetActualDimension())
        t.Transpose(H)
        return t
    check("transpose", transpose, lambda: alg.transpose(h))

    def mapped():
        m = nt.Matrix_ps(H.GetActualDimension())
        nt.MatrixMapper.MapVectorized(H, m, _double_lower)
        return m
    check("map_vectorized", mapped,
          lambda: maps.map_triplets(h, _double_lower))
    return out


def _same_as_host(m: PM.PSMatrix, host: tuple, rows: int = 1024) -> bool:
    """``m`` against a host copy of a matrix (col ids, blocks), bit for
    bit, ``rows`` block rows at a time on m's device."""
    cols, blocks = host
    if m.col_ids.shape != cols.shape or m.dtype != blocks.dtype:
        return False
    if not torch.equal(m.col_ids.cpu(), cols):
        return False
    for r0 in range(0, m.nb, rows):
        got = m.blocks[:, r0:r0 + rows].contiguous().view(torch.uint8)
        want = blocks[:, r0:r0 + rows].to(m.device).contiguous()
        if not torch.equal(got, want.view(torch.uint8)):
            return False
    return True


def complex_phase(n: int, device, sp=None) -> tuple:
    """The complex Hermitian band of ``n`` rows through the API's
    exponential -> (readings, the real solver's result on ``cplx.embed``
    of the same data, bit for bit the API's when
    ``readings["same_result"]``, the triplets).  The API's result is
    held on the host while the real solver runs, so that the card holds
    one exponential's working set at a time."""
    rows, cols, vals = hermitian_triplets(n)
    sp = sp or params()
    cuda = torch.device(device).type == "cuda"
    H = nt.Matrix_ps(n)
    _, sec_fill = _timed(device, H.FillFromTripletList,
                         nt.TripletList_c._from_arrays(rows, cols, vals))
    E = nt.Matrix_ps(n)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _, res = _counted_call(nt.ExponentialSolvers.ComputeExponential, H, E,
                           sp)
    out = {"rows": n, "fill_seconds": sec_fill, "seconds": res["seconds"],
           "launches": res["launches"], "k": E._m.k,
           "embedded": int(E._embedded)}
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    host = (E._m.col_ids.cpu(), E._m.blocks.cpu())
    del E
    grid = H._m.grid
    c = PM.fill_from_triplets(
        PM.empty(n, bs=H._m.bs, grid=grid,
                 dtype=nt.config.default_complex_dtype()), rows, cols, vals)
    emb = cplx.embed(c, real_dtype=H._m.dtype)
    out["same_embedding"] = int(same_slots(emb, H._m))
    del c, H
    direct = exponential.compute_exponential(emb, sp._p)
    del emb
    out["same_result"] = int(_same_as_host(direct, host))
    return out, direct, (rows, cols, vals)


def run(dim: int, device="cuda", slice_rows: int = 1 << 16,
        complex_rows: int | None = None) -> dict:
    """The path at one size (see the module's docstring) -> readings."""
    nt.ConstructGlobalProcessGrid(1, 1, 1, device=device)
    if torch.device(device).type == "cuda":
        _cuda.library()                   # the kernels' build, untimed
        torch.cuda.empty_cache()
    bs = _auto_bs(dim)
    grid = global_grid()
    h = PM.banded(dim, HALFWIDTH, gapped_fn, bs=bs, grid=grid,
                  dtype=torch.float32)
    s = PM.banded(dim, HALFWIDTH, overlap_fn, bs=bs, grid=grid,
                  dtype=torch.float32)
    nel = dim / 2
    out = {"dim": dim, "bs": bs}
    with tempfile.TemporaryDirectory() as tmp:
        out["io"], H, S = io_phase(h, s, tmp, device)
        del h, s
        wf, D = workflow(H, S, nel)
        out.update(wf)
        out["slice"] = slice_phase(D, slice_rows, tmp, device)
        del D
    out["algebra"] = algebra_phase(H, S, device)
    del H, S
    out["complex"] = complex_phase(complex_rows or dim // 2, device)[0]
    return out


def checks(readings: dict) -> list[str]:
    """Every bar of ``BARS`` and every equality the path holds."""
    bad = failures(readings, BARS)
    flags = {f"io.{k}": v for k, v in readings["io"].items()
             if k.startswith("same")}
    flags.update({f"direct.{k}": v for k, v in readings["direct"].items()
                  if k.startswith("same")})
    flags["slice.same"] = readings["slice"]["same"]
    flags.update({f"algebra.{k}.same": v["same"]
                  for k, v in readings["algebra"].items()})
    flags.update({f"complex.{k}": readings["complex"][k]
                  for k in ("embedded", "same_embedding", "same_result")})
    bad += [f"{k} failed" for k, v in flags.items() if v != 1]
    sym = readings["algebra"]["symmetrize"]["asymmetry_after"]
    if not (math.isfinite(sym) and sym == 0.0):
        bad.append(f"asymmetry after Symmetrize {sym!r} != 0")
    return bad


@contextlib.contextmanager
def default_dtype(dtype):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def dense(n: int, device="cuda") -> dict:
    """The complex exponential through the API in f64 against the dense
    oracle V exp(w) V^H."""
    nt.ConstructGlobalProcessGrid(1, 1, 1, device=device)
    with default_dtype(torch.float64):
        sp = nt.SolverParameters()
        sp.SetThreshold(1e-10)
        res, E, (rows, cols, vals) = complex_phase(n, device, sp)
        a = torch.zeros((n, n), dtype=torch.complex128, device=device)
        a[torch.from_numpy(rows).to(device),
          torch.from_numpy(cols).to(device)] = \
            torch.from_numpy(vals).to(device)
        w, v = torch.linalg.eigh(a)
        want = (v * torch.exp(w)[None, :]) @ v.conj().T
        r, c, x, _ = cplx.extract_triplets(*PM.to_triplets(E), E.dim)
        got = torch.zeros_like(want)
        got[torch.from_numpy(r).to(device), torch.from_numpy(c).to(device)] \
            = torch.from_numpy(x).to(device)
        res["rel"] = float(torch.linalg.norm(got - want)
                           / torch.linalg.norm(want))
    return {"exp": res}


# ----------------------------------------------------------------------------
# the examples
# ----------------------------------------------------------------------------

def _example(name: str, argv: list[str]) -> str:
    """Run an example module's main(argv) -> its standard output."""
    mod = importlib.import_module(f"ntpoly_tpu_torch.examples.{name}")
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


def _read(path: str) -> np.ndarray:
    """A Matrix Market file as a dense numpy array."""
    i, j, v, (r, c) = nt.io.matrix_market.read_triplets_shape(path)
    out = np.zeros((r, c), v.dtype)
    np.add.at(out, (i, j), v)
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _fn_of_hermitian(a: np.ndarray, fn) -> np.ndarray:
    w, v = np.linalg.eigh(a)
    return (v * fn(w)[None, :]) @ v.conj().T


def example_argv(device: str, work: str) -> dict:
    """Each example's ReadMe arguments (OverlapMatrix at OVERLAP_BASIS),
    on ``device``, its files under ``work``."""
    f = lambda name: os.path.join(work, name)  # noqa: E731
    dev = ["--device", device]
    return {
        "premade_generate": ["--hamiltonian", f("Hamiltonian.mtx"),
                             "--overlap", f("Overlap.mtx")] + dev,
        "premade_matrix": [
            "--hamiltonian", f("Hamiltonian.mtx"), "--overlap",
            f("Overlap.mtx"), "--number_of_electrons", "10",
            "--threshold", "1e-6", "--converge_overlap", "1e-3",
            "--converge_density", "1e-5", "--density", f("Density.mtx")]
        + dev,
        "complex_matrix": ["--number_of_nodes", "48", "--threshold", "1e-7",
                           "--exponential_file", f("Exponential.mtx")]
        + dev,
        "graph_theory": [
            "--number_of_nodes", "128", "--extra_connections", "10",
            "--attenuation", "0.7", "--threshold", "1e-6",
            "--convergence_threshold", "1e-8", "--output_file",
            f("Resolvent.mtx")] + dev,
        "hydrogen_atom": ["--grid_points", "64", "--threshold", "1e-6",
                          "--convergence_threshold", "1e-8", "--density",
                          f("HydrogenDensity.mtx")] + dev,
        "matrix_maps": ["--input_matrix", f("input.mtx"), "--output_matrix",
                        f("output.mtx")] + dev,
        "overlap_matrix": [
            "--basis_functions", str(OVERLAP_BASIS), "--threshold", "1e-6",
            "--convergence_threshold", "1e-7", "--output_file",
            f("ISQOverlap.mtx")] + dev,
    }


def _list_dense(tlist, n: int) -> np.ndarray:
    i, j, v = tlist._arrays()
    out = np.zeros((n, n), v.dtype)
    np.add.at(out, (i, j), v)
    return out


def example_oracles(work: str) -> dict:
    """Each example's output against the checks of ``EXAMPLE_BARS``."""
    from ..examples import complex_matrix, graph_theory, hydrogen_atom
    out = {}
    d = _read(os.path.join(work, "Density.mtx"))
    s = _read(os.path.join(work, "Overlap.mtx"))
    out["premade_matrix"] = {
        "idempotency_rel": float(np.linalg.norm(d @ s @ d - d)
                                 / np.linalg.norm(d)),
        "trace_err": float(abs(np.trace(d @ s) - 10.0))}
    a = complex_matrix.generate_digraph(48)
    g = 0.5 * (a + a.T) + 0.5j * (a - a.T)
    out["complex_matrix"] = {"rel": _rel(
        _read(os.path.join(work, "Exponential.mtx")),
        _fn_of_hermitian(g, np.exp))}
    net = _list_dense(graph_theory.build_network(128, 10), 128)
    out["graph_theory"] = {"rel": _rel(
        _read(os.path.join(work, "Resolvent.mtx")),
        np.linalg.inv(np.eye(128) - 0.7 * net))}
    # the hydrogen density at the example's settings lies 5.8e-4 from
    # the exact projector on the two lowest states (f64), so it is held
    # to PremadeMatrix's bars, its oracle distance printed
    h = _list_dense(hydrogen_atom.build_hamiltonian(64), 64)
    occ = np.linalg.eigh(h)[1][:, :2]
    dh = _read(os.path.join(work, "HydrogenDensity.mtx"))
    out["hydrogen_atom"] = {
        "idempotency_rel": float(np.linalg.norm(dh @ dh - dh)
                                 / np.linalg.norm(dh)),
        "trace_err": float(abs(np.trace(dh) - 2.0)),
        "oracle_rel": _rel(dh, occ @ occ.T)}
    m = _read(os.path.join(work, "input.mtx"))
    out["matrix_maps"] = {"rel": _rel(
        _read(os.path.join(work, "output.mtx")), np.tril(2.0 * m))}
    x = np.linspace(0.0, 10.0, OVERLAP_BASIS)
    so = np.exp(-(x[:, None] - x[None, :]) ** 2)
    so = np.where(so > 1e-6, so, 0.0)
    out["overlap_matrix"] = {"rel": _rel(
        _read(os.path.join(work, "ISQOverlap.mtx")),
        _fn_of_hermitian(so, lambda e: e ** -0.5))}
    return out


def examples(device: str, work: str, dtype=torch.float64) -> dict:
    """Every example at its ReadMe size, in ``dtype`` (float64, as
    tests/test_examples.py runs the JAX package's) -> {example:
    readings}: seconds and the oracle checks."""
    secs = {}
    with default_dtype(dtype):
        for name, argv in example_argv(device, work).items():
            t0 = time.perf_counter()
            _example(name, argv)
            _sync(device)
            secs[name] = time.perf_counter() - t0
    out = example_oracles(work)
    for name, sec in secs.items():
        out.setdefault(name, {})["seconds"] = sec
    return out


@contextlib.contextmanager
def seeded_permutations(seed: int = TWIN_SEED):
    """While open, ``SetRandomPermutation`` draws from ``seed``, so that
    two runs of the PremadeMatrix example permute alike."""
    orig = Permutation.set_random_permutation

    def seeded(self, dim, seed_=None):
        return orig(self, dim, seed=seed)
    Permutation.set_random_permutation = seeded
    try:
        yield
    finally:
        Permutation.set_random_permutation = orig


def twin(device: str, work: str, dim: int = 2048) -> np.ndarray:
    """The PremadeMatrix workflow (generate -> read -> ISQ -> TRS2 ->
    write) at ``dim`` rows in f64 on ``device`` -> the written
    density."""
    argv = example_argv(device, work)
    with default_dtype(torch.float64), seeded_permutations():
        _example("premade_generate", argv["premade_generate"]
                 + ["--dim", str(dim)])
        _example("premade_matrix", argv["premade_matrix"])
    return _read(os.path.join(work, "Density.mtx"))


def floor_readings(dim: int, device) -> dict:
    """The readings behind ``BARS`` at 'high': the ISQ's residual and
    TRS4's certificates, through the layer below at threshold 1e-7, at
    'high' and 'highest' and at the cutoffs 1e-6 (the library's) and
    1e-5, the ISQ and TRS4 at the same cutoff -> {"<tier> <cutoff>":
    readings}."""
    from ..parallel.grid import ProcessGrid
    from ..solvers.parameters import SolverParameters
    grid = ProcessGrid(device=device)
    bs = _auto_bs(dim)
    h = PM.banded(dim, HALFWIDTH, gapped_fn, bs=bs, grid=grid,
                  dtype=torch.float32)
    s = PM.banded(dim, HALFWIDTH, overlap_fn, bs=bs, grid=grid,
                  dtype=torch.float32)
    out = {}
    for precision in ("high", "highest"):
        for cutoff in (1e-6, 1e-5):
            p = SolverParameters(threshold=THRESHOLD, precision=precision,
                                 converge_diff=cutoff)
            isq = squareroot.inverse_square_root(s, p)
            k, _, _ = density.trs4(h, isq, dim / 2, p)
            inv = purity_invariants(k, h, dim / 2, THRESHOLD, s=s)
            out[f"{precision} {cutoff:g}"] = {
                "isq_residual": residual(isq, s),
                "idempotency_rel": inv["idempotency_rel"],
                "commutator_rel": inv["commutator_rel"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--floor", type=int, metavar="DIM",
                    help="print floor_readings(DIM) on --device instead")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.floor:
        print(json.dumps(floor_readings(args.floor, args.device)))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("the api path needs a CUDA card")
    res = run(1 << 20, "cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(0), **res}),
          flush=True)
    print(json.dumps(dense(8192, "cuda")), flush=True)
    with tempfile.TemporaryDirectory() as work:
        print(json.dumps(examples("cuda", work)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
