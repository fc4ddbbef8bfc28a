"""The matrix-function solvers at the flagship's width, timed, with their
checks.

Chemistry and graph codes call the library for more than the density
matrix: the overlap's inverse (Hotelling) and roots, the sign function
of the shifted Hamiltonian, exp and log of a graph Laplacian (the
reference's GraphTheory example), sine and cosine, and CG solves.
``run`` drives each of them once through its entry point, timed after a
warm-up, on three systems:

  S  the overlap of ``systems.overlap_fn`` at half-width 16
     (eigenvalues ~0.89-1.35);
  H  the flagship's gapped chain (``systems.gapped_fn``, half-width
     16), at nel = dim / 2;
  L  the ring Laplacian -0.25 L of the JAX package's ``bench.py``
     (``bench_cheby_exp_log``): -0.5 on the diagonal, 0.25 to both
     neighbours, the corners closing the ring, filled from triplets.

The solves, with the checks ``BARS`` holds them to (relative Frobenius
norms; 1e-4 is the reference's own oracle bar):

  invert       X = S^-1: ||S X - I|| / ||I||, and ||X - ISQ ISQ|| / ||X||
               against ISQ = ``squareroot.inverse_square_root(S)``;
  inv_root_2   Y = ``roots.compute_inverse_root(S, 2)``:
               ||Y - ISQ|| / ||ISQ||;
  root_3       R = ``roots.compute_root(S, 3)``: ||R R R - S|| / ||S||;
  sign         sign(H - mu I), mu from TRS4 of H in the same run; D =
               (I - sign) / 2 against TRS4's K, its trace error per
               electron and its idempotency ||D^2 - D|| / ||D||;
  exp, log     E = exp(L) (Chebyshev), log(E): ||log E - L|| / ||L||;
               the Taylor exponential against E;
  sine, cosine ||sin^2 H + cos^2 H - I|| / ||I||;
  cg           X with S X = H: ||S X - H|| / ||H||;
  sign_high    the sign solve once more at the library's default
               'high' (the split pass and the tensor-core product):
               its readings, not held to the bars.

Every solve but the last runs at 'highest' with the library's capacity
policy ('grow', automatic kernel choice, threshold 1e-7; 1e-9 for L, as
the reference's benchmark, and for the root and CG solves, which miss
their bars at 1e-7 in both packages), the check products at 'highest'
at the capacity they need.  ``dense`` is the dense and finite-temperature
parity in float64, where the dense path (``torch.linalg.eigh``) is the
oracle: the eigendecomposition of H, ``dense_density``, the dense
inverse square root, sign and exponential against their iterative
solvers, and the wave-operator minimizations ``wom_c`` and ``wom_gc``
at inverse temperature 50 against the dense Fermi-Dirac density.
``twin`` gives the readings that a card run and a CPU run of the same
solves must share.

On a machine with a CUDA card, from the repository root:

    python3 -m ntpoly_tpu_torch.profiling.functions

prints one JSON object for the path at 2^20 rows, bs 128, float32, and
one for the dense parity at 8192 rows, bs 128, float64; with
``--profile``, only the path, each solve traced by torch.profiler for
its device seconds (SpGEMM kernels, split pass, the rest) and the
device's idle share (the trace slows the wall time).  On the CPU,
``run(2048, 32, "cpu")`` and ``dense(256, 32, "cpu")`` drive the same
calls.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import re
import tempfile
import time

import numpy as np
import torch

from ..ops import spgemm as sp
from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..parallel.grid import ProcessGrid
from ..solvers import (density, eigen, exponential, fermi, inverse, linear,
                       roots, sign, squareroot, trigonometry)
from ..solvers.parameters import SolverParameters
from ..utils.logging import activate_logger, deactivate_logger
from .overlap import _sync, solve_params, system

THRESHOLD = 1e-7
# the ring's threshold in the reference's benchmark; also the root and
# CG solves', which miss their bars at 1e-7 in both packages (the
# filtered entries, not the precision: float64 misses them alike)
FINE_THRESHOLD = 1e-9
DENSE_THRESHOLD = 1e-10
INV_TEMP = 50.0
# reading -> the largest value it may take
BARS = {
    "invert.identity_rel": 1e-4, "invert.isq_rel": 1e-4,
    "inv_root_2.isq_rel": 1e-4, "root_3.cube_rel": 1e-4,
    "sign.density_rel": 1e-4, "sign.trace_err_per_electron": 1e-5,
    "sign.idempotency_rel": 1e-4,
    "log.round_trip_rel": 1e-4, "exp_taylor.chebyshev_rel": 1e-4,
    "cosine.pythagoras_rel": 1e-4, "cg.residual_rel": 1e-4,
}
DENSE_BARS = {
    "eigen.reconstruction_rel": 1e-10, "dense_density.trs4_rel": 1e-6,
    "dense_isq.isq_rel": 1e-6, "dense_sign.sign_rel": 1e-6,
    "dense_exp.exp_rel": 1e-6, "wom_c.foe_rel": 1e-4,
    "wom_gc.foe_rel": 1e-4,
}


def params(precision: str = "highest",
           threshold: float = THRESHOLD) -> SolverParameters:
    return SolverParameters(threshold=threshold, precision=precision)


def laplacian(dim: int, bs: int, device, dtype=torch.float32):
    """The ring Laplacian -0.25 L through ``fill_from_triplets``."""
    i = np.arange(dim)
    rows = np.concatenate([i, i, i])
    cols = np.concatenate([i, (i + 1) % dim, (i - 1) % dim])
    vals = np.concatenate([np.full(dim, -0.5), np.full(dim, 0.25),
                           np.full(dim, 0.25)])
    m = PM.empty(dim, bs=bs, grid=ProcessGrid(device=device), dtype=dtype)
    return PM.fill_from_triplets(m, rows, cols, vals)


@contextlib.contextmanager
def _counted(out: dict):
    """While open, the YAML logger writes to a temporary file and the
    kernel launches and ``alg.matmul`` calls count from 0; on exit
    ``out`` holds the 'Total Iterations' of every solve in the log (a
    list: nested solves log their own; LOBPCG logs 'Iterations'), the
    multiplies, the launches of every wrapper and the pinned capacities
    to which chunked solves regrew ("capacity regrown ... chunk
    redone")."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "solve.yaml")
        activate_logger(path)
        sp.reset_launches()
        alg.reset_multiplies()
        try:
            yield
        finally:
            deactivate_logger()
        with open(path) as f:
            log = f.read()
    out["iterations"] = [int(v) for v in re.findall(
        r"^ *(?:Total )?Iterations: (\d+)$", log, re.M)]
    out["multiplies"] = alg.multiplies["matmul"]
    out["pins"] = [int(k) for k in re.findall(
        r"capacity regrown to (\d+) \(fill \d+\); chunk redone", log)]
    out["launches"] = dict(sp.launches)


def _device_seconds(prof) -> dict:
    """Device seconds in a torch.profiler trace: the hand-written
    SpGEMM products (``pair_kernel``, ``product_kernel``), the split
    pass (``split_kernel``) and everything else the device ran."""
    out = dict.fromkeys(("spgemm", "split", "other"), 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ("split" if "split_kernel" in e.key else "spgemm"
               if "pair_kernel" in e.key or "product_kernel" in e.key
               else "other")
        out[key] += e.self_device_time_total * 1e-6
    return out


def measured(fn, *args, device, warm_up: bool = True,
             profile: bool = False):
    """fn(*args), timed after a warm-up with ``max_iterations`` 2 unless
    ``warm_up`` is off -> (result, readings: seconds, iterations,
    multiplies, launches and, on a CUDA device, peak GiB; with
    ``profile``, under torch.profiler, the device seconds by kind and
    the device's idle share of the wall time).  ``args`` ends with the
    solver parameters, which are copied with ``be_verbose`` on."""
    par = args[-1].copy()
    if warm_up:
        warm = par.copy()
        warm.max_iterations = 2
        fn(*args[:-1], warm)
    par.be_verbose = True
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res = {}
    trace = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        trace = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA])
    with _counted(res), trace as prof:
        t0 = time.perf_counter()
        out = fn(*args[:-1], par)
        _sync(device)
        res["seconds"] = time.perf_counter() - t0
    if cuda:
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if profile:
        res["device_s"] = _device_seconds(prof)
        res["idle_share"] = 1.0 - sum(res["device_s"].values()) / \
            res["seconds"]
    return out, res


def _timed(device, fn, *args):
    """fn(*args) -> (result, wall seconds), no warm-up."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return out, time.perf_counter() - t0


def _norm(m) -> float:
    """Frobenius norm."""
    return math.sqrt(max(float(alg.dot(m, m)), 0.0))


def rel(a, b, norm_of=None) -> float:
    """||a - b||_F / ||norm_of||_F (``norm_of`` b by default)."""
    return _norm(alg.increment(a, b, 1.0, -1.0)) / _norm(
        b if norm_of is None else norm_of)


def _exact():
    """The check products: 'highest', at the capacity they need."""
    return alg.capacity_policy(on_overflow="grow", precision="highest")


def _identity(m):
    return PM.identity(m.dim, bs=m.bs, grid=m.grid, dtype=m.dtype)


def run(dim: int, bs: int, device="cuda", dtype=torch.float32,
        warm_up: bool = True, profile: bool = False) -> dict:
    """The path at one size -> {solve: readings}, the checks of
    ``BARS`` among them (see the module's docstring); each solve timed
    after a warm-up unless ``warm_up`` is off, and traced with
    ``profile`` (see :func:`measured`)."""
    m = functools.partial(measured, device=device, warm_up=warm_up,
                          profile=profile)
    h, s, nel = system(dim, bs, device, dtype)
    eye = _identity(s)
    out = {"dim": dim, "bs": bs}
    hp = params()

    isq, out["isq"] = m(squareroot.inverse_square_root, s, hp)
    isq2 = alg.matmul(isq, isq, precision="highest")
    x, r = m(inverse.invert, s, hp)
    with _exact():
        r["identity_rel"] = rel(alg.matmul(s, x), eye)
    r["isq_rel"] = rel(x, isq2, norm_of=x)
    out["invert"] = r
    del x, isq2
    y, r = m(roots.compute_inverse_root, s, 2, hp)
    r["isq_rel"] = rel(y, isq)
    out["inv_root_2"] = r
    del y, isq
    fine = params(threshold=FINE_THRESHOLD)
    root, r = m(roots.compute_root, s, 3, fine)
    with _exact():
        r["cube_rel"] = rel(alg.matmul(alg.matmul(root, root), root), s)
    out["root_3"] = r
    del root

    x, r = m(linear.cg_solver, s, h, fine)
    with _exact():
        r["residual_rel"] = rel(alg.matmul(s, x), h)
    out["cg"] = r
    del x, s

    (k, energy, mu), r = m(density.trs4, h, eye, nel,
                           solve_params("highest"))
    out["trs4"] = dict(r, energy=energy, mu=mu)
    shifted = alg.increment(h, eye, 1.0, -mu)
    for key, precision in (("sign", "highest"), ("sign_high", "high")):
        sg, r = m(sign.sign_function, shifted, params(precision))
        d = alg.increment(eye, sg, 0.5, -0.5)
        del sg
        r["density_rel"] = rel(d, k)
        r["trace_err_per_electron"] = abs(
            alg.host_pair(alg.trace_pair(d)) - nel) / nel
        with _exact():
            r["idempotency_rel"] = rel(alg.matmul(d, d), d)
        out[key] = r
        del d
    del k, shifted

    sn, out["sine"] = m(trigonometry.sine, h, hp)
    cs, out["cosine"] = m(trigonometry.cosine, h, hp)
    with _exact():
        pyth = alg.increment_n((alg.matmul(sn, sn), alg.matmul(cs, cs),
                                eye), (1.0, 1.0, -1.0))
    out["cosine"]["pythagoras_rel"] = _norm(pyth) / _norm(eye)
    del sn, cs, pyth, h

    lap = laplacian(dim, bs, device, dtype)
    e, out["exp"] = m(exponential.compute_exponential, lap, fine)
    et, r = m(exponential.compute_exponential_taylor, lap, fine)
    r["chebyshev_rel"] = rel(et, e)
    out["exp_taylor"] = r
    del et
    lg, r = m(exponential.compute_logarithm, e, fine)
    r["round_trip_rel"] = rel(lg, lap)
    out["log"] = r
    return out


def failures(readings: dict, bars: dict) -> list[str]:
    """The readings of ``bars`` ('solve.key') that miss their bar or are
    not finite."""
    bad = []
    for name, bar in bars.items():
        solve, key = name.split(".")
        v = readings[solve][key]
        if not (math.isfinite(v) and v <= bar):
            bad.append(f"{name} = {v!r} > {bar}")
    return bad


def dense(dim: int, bs: int, device="cuda") -> dict:
    """The dense and finite-temperature parity in float64 at threshold
    1e-10 -> {check: readings}, the checks of ``DENSE_BARS`` among
    them."""
    h, s, nel = system(dim, bs, device, torch.float64)
    eye = _identity(h)
    p = params(threshold=DENSE_THRESHOLD)
    out = {"dim": dim, "bs": bs}

    (vals, vecs), secs = _timed(device, eigen.eigen_decomposition, h,
                                None, p)
    v = PM.to_dense(vecs)
    recon = (v * torch.diagonal(PM.to_dense(vals))[None, :]) @ v.T
    hd = PM.to_dense(h)
    out["eigen"] = {"seconds": secs, "reconstruction_rel": float(
        torch.linalg.norm(recon - hd) / torch.linalg.norm(hd))}
    del v, recon, hd, vals, vecs

    kd, ed, mu = density.dense_density(h, eye, nel, p)
    tp = solve_params("highest")
    tp.threshold = DENSE_THRESHOLD
    k, _, _ = density.trs4(h, eye, nel, tp)
    out["dense_density"] = {"energy": ed, "mu": mu,
                            "trs4_rel": rel(kd, k, norm_of=kd)}
    del kd, k

    isq = squareroot.inverse_square_root(s, p)
    out["dense_isq"] = {"isq_rel": rel(
        squareroot.dense_inverse_square_root(s, p), isq)}

    shifted = alg.increment(h, eye, 1.0, -mu)
    out["dense_sign"] = {"sign_rel": rel(
        sign.dense_sign_function(shifted, p), sign.sign_function(shifted, p))}
    del shifted

    lap = laplacian(dim, bs, device, torch.float64)
    out["dense_exp"] = {"exp_rel": rel(
        exponential.compute_dense_exponential(lap, p),
        exponential.compute_exponential(lap, p))}
    del lap

    wp = p.copy()
    wp.step_thresh = 1e-4
    foe, _, mu_t = fermi.compute_dense_foe(h, isq, nel, INV_TEMP, p)
    (kc, ec), secs = _timed(device, fermi.wom_c, h, isq, nel, INV_TEMP, wp)
    out["wom_c"] = dict(seconds=secs, energy=ec, mu=mu_t,
                        foe_rel=rel(kc, foe))
    del kc, foe
    # the grand-canonical oracle at the gap's midpoint: Fermi-Dirac of
    # the working Hamiltonian ISQ H ISQ^T at that mu, taken back
    with _exact():
        wh = alg.matmul(isq, alg.matmul(h, alg.transpose(isq)))
    w = eigen.eigh(wh)[0].double().cpu().numpy()
    n_occ = int(nel)
    mu_mid = float(0.5 * (w[n_occ - 1] + w[n_occ]))
    fd = eigen.dense_matrix_function(
        wh, lambda x: 1.0 / (1.0 + torch.exp(INV_TEMP * (x - mu_mid))), p)
    with _exact():
        foe = alg.matmul(alg.transpose(isq), alg.matmul(fd, isq),
                         threshold=DENSE_THRESHOLD)
    del wh, fd
    (kg, eg), secs = _timed(device, fermi.wom_gc, h, isq, mu_mid,
                            INV_TEMP, wp)
    out["wom_gc"] = dict(seconds=secs, energy=eg, mu=mu_mid,
                         foe_rel=rel(kg, foe))
    return out


def twin(dim: int, bs: int, device) -> dict:
    """Float64 solves whose results a card run and a CPU run must share:
    the sign of H - mu I, S^-1, exp and log of the ring Laplacian, the
    dense Fermi-Dirac density and ``wom_c`` at inverse temperature 50
    (at the library's step threshold, 1e-2: a tenth of the steps of
    1e-4) -> {name: dense result as a float64 numpy array}."""
    h, s, nel = system(dim, bs, device, torch.float64)
    eye = _identity(h)
    p = params(threshold=DENSE_THRESHOLD)
    _, _, mu = density.dense_density(h, eye, nel, p)
    out = {"sign": sign.sign_function(alg.increment(h, eye, 1.0, -mu), p),
           "invert": inverse.invert(s, p)}
    lap = laplacian(dim, bs, device, torch.float64)
    out["exp"] = exponential.compute_exponential(lap, p)
    out["log"] = exponential.compute_logarithm(out["exp"], p)
    isq = squareroot.inverse_square_root(s, p)
    out["dense_foe"] = fermi.compute_dense_foe(h, isq, nel, INV_TEMP, p)[0]
    out["wom_c"] = fermi.wom_c(h, isq, nel, INV_TEMP, p)[0]
    return {k: PM.to_dense(m).cpu().numpy() for k, m in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="only the path, each solve under torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("functions needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"device": name, **run(1 << 20, 128, "cuda",
                                            profile=args.profile)}),
          flush=True)
    if not args.profile:
        print(json.dumps({"device": name, **dense(8192, 128, "cuda")}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
