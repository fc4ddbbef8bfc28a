"""The analysis path at the flagship's width, timed, with its checks.

Chemistry codes call these routines between SCF steps: the overlap's
Cholesky factor (an alternative to S^-1/2), the pivoted Cholesky and
the dimension reduction for subspace methods, the extrapolation of the
density after a geometry step, and a few eigenpairs without densifying
(LOBPCG).  ``run`` drives each through its entry point on:

  S    the overlap of ``systems.overlap_fn`` at half-width 16
       (eigenvalues ~0.89-1.35; every diagonal entry 1);
  S'   the overlap one geometry step later,
       ``systems.displaced_overlap_fn`` (0.31 in place of 0.3);
  H    the flagship's gapped chain (``systems.gapped_fn``), nel = dim/2;
  H_b  the gapped chain with +2 on the diagonal from row ``reduced`` on
       (``systems.barrier_fn``): its ``reduced`` lowest states live on
       the first ``reduced`` sites, below a gap of about 1.

The solves, with the checks ``BARS`` holds them to:

  cholesky      L of S at ``chol_dim`` rows (the run's dim unless cut):
                ||S - L L^T||_F / ||S||_F, formed sparsely by
                ``matmul(L, L^T, alpha=-1, beta=1, c=S)``, and the
                count of stored entries above the diagonal
                (``to_triplets``), which must be 0;
  pivoted       the rank-256 pivoted Cholesky of S, with the bounds of
                the JAX package's test: 0 <= tr(S - L L^T) <= tr(S)
                (1 - 256/N) (each side relative to tr S), and every
                stored column of L below 256;
  reduce        ``reduce_dimension(H_b, reduced)``: its sorted
                eigenvalues against the ``reduced`` lowest of H_b's
                leading 4096 x 4096 block (``torch.linalg.eigh`` in
                float64), relative Frobenius error, the JAX package's
                bar 1e-2;
  purification  K from TRS4 with ISQ(S) at nel = dim/2, then
                ``purification_extrapolate(K, S', nel)`` at converge_diff
                1e-5 (``extrapolation_params``): the
                generalized certificates in S''s metric, ||K S' K -
                K|| / ||K|| <= 1e-5 and |tr(K S') - nel| / nel <= 1e-6;
  lowdin        ``lowdin_extrapolate(K, S, S')``; its distance from K'
                (TRS4 with ISQ(S')) and the purification result's are
                printed, not held;
  lobpcg_eps    ``eigen_decomposition_iterative(S, 8, max_iters=200)``
                with ``tol=None``: its iterations (in float32 at 2^20
                rows the epsilon rule's bound tol * 10 * n * (|AX| +
                theta) passes 1, and the loop stops after one);
  lobpcg        the same with ``tol=0`` (all 200 iterations): each
                residual ||S v - w v|| <= 1e-3 lambda_max (lambda_max
                from ``power_bounds``), max |V^T V - I| <= 1e-5, the
                eigenvalues within 1e-4 (relative Frobenius, the JAX
                package's test bar) of the minimum f_min of S's symbol
                1 + 2 sum_{d=1..16} 0.3/(1+d)^2 cos(d theta), where the
                lowest eigenvalues lie at 2^20 rows, and none below f_min
                by more than 1e-6.  The distance max(w) - f_min is
                printed: 200 iterations leave it at ~6e-6 - 8e-5 in
                both packages (``tests/test_torch_lobpcg.py``).

Every solve runs at 'highest' with the library's capacity policy
('grow', automatic kernel choice, threshold 1e-7); the check products
at 'highest' at the capacity they need.  With ``warm_up`` the whole
path runs once first at 4096 rows, untimed.  ``dense`` is the float64
parity at 8192 rows, ``twin`` the readings that a card run and a CPU
run share.

On a machine with a CUDA card, from the repository root:

    python3 -m ntpoly_tpu_torch.profiling.analysis [--chol-dim N]

prints one JSON object for the path at 2^20 rows, bs 128, float32 (the
Cholesky at ``--chol-dim`` rows, 2^20 unless given), and one for the
dense parity.  On the CPU, ``run(2048, 32, "cpu", reduced=256)``,
``dense(512, 32, "cpu")`` and ``twin(512, 32, "cpu")`` drive the same
calls.
"""
from __future__ import annotations

import argparse
import functools
import json
import math

import numpy as np
import torch

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..parallel.grid import ProcessGrid
from ..solvers import analysis, density, eigen, geometry, linear, squareroot
from ..solvers.eigenbounds import power_bounds
from ..solvers.parameters import SolverParameters
from ..systems import (barrier_fn, displaced_overlap_fn, gapped_fn,
                       overlap_fn)
# THRESHOLD and failures are the path's as much as the functions path's:
# callers read them here
from .functions import (THRESHOLD, _exact, _identity, _norm, _timed,
                        failures, measured, params, rel)
from .overlap import HALFWIDTH, isq_params, solve_params

RANK = 256
NVALS = 8
MAX_ITERS = 200
ORACLE_DIM = 4096
DENSE_THRESHOLD = 1e-12
# the purification extrapolation's cutoff (``extrapolation_params``)
EXTRAPOLATION_CUTOFF = 1e-5
# reading -> the largest value it may take
BARS = {
    "cholesky.residual_rel": 1e-4, "cholesky.upper_entries": 0.0,
    "pivoted.trace_low": 1e-6, "pivoted.trace_high": 1e-6,
    "pivoted.col_over_rank": 0.0,
    "reduce.eigen_rel": 1e-2,
    "purification.idempotency_rel": 1e-5,
    "purification.trace_err_per_electron": 1e-6,
    "lobpcg.residual_rel": 1e-3, "lobpcg.orthogonality": 1e-5,
    "lobpcg.eigen_rel": 1e-4, "lobpcg.below_symbol": 1e-6,
}
DENSE_BARS = {
    "cholesky.factor_rel": 1e-10, "lobpcg_s.eigen_rel": 1e-4,
    "lobpcg_defect.eigen_rel": 1e-8,
}


def extrapolation_params(converge_diff: float = EXTRAPOLATION_CUTOFF
                         ) -> SolverParameters:
    """``params()`` with the overlap path's cutoff: past convergence the
    purification extrapolation's trace test keeps choosing 2X - XSX,
    which doubles the eigenvalues below 0, so its error grows until the
    automatic monitor fires; at the library's converge_diff 1e-6 that
    is at ~1.2e-5 (both packages, ``tests/test_torch_analysis_path.py``),
    at 1e-5 it stops at the bottom."""
    p = params()
    p.converge_diff = converge_diff
    return p


def _grid(device):
    return ProcessGrid(device=device)


def overlap(dim, bs, device, dtype=torch.float32, fn=overlap_fn):
    return PM.banded(dim, HALFWIDTH, fn, bs=bs, grid=_grid(device),
                     dtype=dtype)


def symbol_minimum() -> float:
    """min over theta of 1 + 2 sum_{d=1..16} 0.3 / (1 + d)^2
    cos(d theta), on a grid of 2^20 + 1 points of [0, pi] in float64."""
    theta = np.linspace(0.0, np.pi, (1 << 20) + 1)
    f = np.ones_like(theta)
    for d in range(1, HALFWIDTH + 1):
        f += 2 * 0.3 / (1.0 + d) ** 2 * np.cos(d * theta)
    return float(f.min())


def defect(dim: int, bs: int, device, complex_: bool = False):
    """A seeded banded Hermitian matrix in float64 (complex128 for
    ``complex_``) with eight deep defect levels:
    N(0, 0.1) couplings within half-width 4 (complex for ``complex_``)
    and a diagonal of 1 + U(0, 1), except -2 - 0.25 j on eight sites
    j spread over the chain, built with numpy from seed 11."""
    rng = np.random.default_rng(11)
    hw = 4
    i = np.arange(dim)
    rows = np.tile(i, hw)
    cols = rows + np.repeat(np.arange(1, hw + 1), dim)
    keep = cols < dim
    rows, cols = rows[keep], cols[keep]
    vals = 0.1 * rng.standard_normal(rows.size)
    if complex_:
        vals = vals + 0.1j * rng.standard_normal(rows.size)
    diag = 1.0 + rng.random(dim)
    sites = (np.arange(NVALS) * dim) // NVALS + dim // (2 * NVALS)
    diag[sites] = -2.0 - 0.25 * np.arange(NVALS)
    r = np.concatenate([rows, cols, i])
    c = np.concatenate([cols, rows, i])
    v = np.concatenate([vals, np.conj(vals), diag])
    dtype = torch.complex128 if complex_ else torch.float64
    m = PM.empty(dim, bs=bs, dtype=dtype, grid=_grid(device))
    return PM.fill_from_triplets(m, r, c, v)


def graded(dim, bs, device):
    """S in float64 with 0.1 i / dim added on the diagonal: distinct
    diagonals, so that the pivot order does not hang on rounding."""
    def fn(i, j):
        return overlap_fn(i, j) + torch.where(
            i == j, 0.1 * i.to(torch.float64) / dim, 0.0)
    return overlap(dim, bs, device, torch.float64, fn)


def _residual(ell, s):
    """S - L L^H, formed sparsely at 'highest'."""
    with _exact():
        return alg.matmul(ell, alg.transpose(ell).conjugate(), alpha=-1.0,
                          beta=1.0, c=s)


def _trace(m) -> float:
    return alg.host_pair(alg.trace_pair(m))


def lobpcg_checks(s, w, v, lam_max: float, f_min: float) -> dict:
    """The LOBPCG readings of ``BARS`` for the pairs (w, v) of S."""
    vp = torch.nn.functional.pad(v, (0, 0, 0, s.logical_dim - v.shape[0]))
    res = (alg.spmm(s, vp) - vp * w[None, :]).double().square().sum(0)
    res = res.sqrt()
    vd = v.double()
    gram = vd.T @ vd
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    wd = w.double().cpu().numpy()
    return {"residual_rel": float(res.amax()) / lam_max,
            "orthogonality": float((gram - eye).abs().amax()),
            "eigen_rel": float(np.linalg.norm(wd - f_min)
                               / (f_min * math.sqrt(wd.size))),
            "below_symbol": float(max(f_min - wd.min(), 0.0)),
            "above_symbol_max": float(wd.max() - f_min)}


def _oracle_low(h, count: int) -> np.ndarray:
    """The ``count`` lowest eigenvalues of h's leading ORACLE_DIM x
    ORACLE_DIM block (all of h if smaller), in float64."""
    n = min(ORACLE_DIM, h.dim)
    lead = PM.get_slice(h, 0, n, 0, n)
    w = torch.linalg.eigvalsh(PM.to_dense(lead).double())
    return w[:count].cpu().numpy()


def _warm(bs, device, dtype):
    """The path once at 4096 rows, untimed: kernel builds, library
    handles and the allocator's first blocks."""
    run(4096, bs, device, dtype, warm_up=False, reduced=256)


def run(dim: int, bs: int, device="cuda", dtype=torch.float32,
        warm_up: bool = True, profile: bool = False,
        chol_dim: int | None = None, reduced: int = 1024) -> dict:
    """The path at one size -> {solve: readings}, the checks of
    ``BARS`` among them (see the module's docstring)."""
    if warm_up:
        _warm(bs, device, dtype)
    m = functools.partial(measured, device=device, warm_up=False,
                          profile=profile)
    hp = params()
    out = {"dim": dim, "bs": bs, "chol_dim": chol_dim or dim,
           "reduced": reduced}

    s = overlap(chol_dim or dim, bs, device, dtype)
    ell, r = m(linear.cholesky_decomposition, s, hp)
    r["residual_rel"] = _norm(_residual(ell, s)) / _norm(s)
    rows, cols, _ = PM.to_triplets(ell)
    r["upper_entries"] = float(np.count_nonzero(cols > rows))
    out["cholesky"] = r
    del ell, s, rows, cols

    s = overlap(dim, bs, device, dtype)
    ell, r = m(analysis.pivoted_cholesky_decomposition, s, RANK, hp)
    t_s = _trace(s)
    t_r = _trace(_residual(ell, s))
    r.update(trace_s=t_s, trace_residual=t_r,
             trace_low=-t_r / t_s,
             trace_high=(t_r - t_s * (1.0 - RANK / dim)) / t_s)
    r["col_over_rank"] = float(
        np.count_nonzero(PM.to_triplets(ell)[1] >= RANK))
    out["pivoted"] = r
    del ell

    hb = PM.banded(dim, HALFWIDTH, barrier_fn(reduced), bs=bs,
                   grid=_grid(device), dtype=dtype)
    red, r = m(analysis.reduce_dimension, hb, reduced, hp)
    w = torch.linalg.eigvalsh(PM.to_dense(red).double()).cpu().numpy()
    want = _oracle_low(hb, reduced)
    r["eigen_rel"] = float(np.linalg.norm(w - want) / np.linalg.norm(want))
    out["reduce"] = r
    del hb, red

    h = PM.banded(dim, HALFWIDTH, gapped_fn, bs=bs, grid=_grid(device),
                  dtype=dtype)
    nel = dim / 2
    s2 = overlap(dim, bs, device, dtype, displaced_overlap_fn)
    k_old, k_new = (density.trs4(
        h, squareroot.inverse_square_root(x, isq_params()), nel,
        solve_params("highest"))[0] for x in (s, s2))
    del h
    kp, r = m(geometry.purification_extrapolate, k_old, s2, nel,
              extrapolation_params())
    with _exact():
        ks = alg.matmul(kp, s2)
        r["idempotency_rel"] = rel(alg.matmul(ks, kp), kp)
    r["trace_err_per_electron"] = abs(_trace(ks) - nel) / nel
    r["distance_from_trs4"] = rel(kp, k_new)
    out["purification"] = r
    del ks, kp
    kl, r = m(geometry.lowdin_extrapolate, k_old, s, s2, hp)
    r["distance_from_trs4"] = rel(kl, k_new)
    out["lowdin"] = r
    del kl, k_old, k_new, s2

    lam_max = power_bounds(s)
    f_min = symbol_minimum()
    for key, tol in (("lobpcg_eps", None), ("lobpcg", 0.0)):
        def lobpcg(mat, nvals, par, tol=tol):
            return eigen.eigen_decomposition_iterative(mat, nvals, par,
                                                       MAX_ITERS, tol)
        (w, v), r = m(lobpcg, s, NVALS, hp)
        r["stopped_early"] = r["iterations"][-1] < MAX_ITERS
        r.update(lobpcg_checks(s, w, v, lam_max, f_min))
        out[key] = r
    out["lobpcg"].update(lambda_max=lam_max, f_min=f_min)
    return out


def dense(dim: int, bs: int, device="cuda") -> dict:
    """The float64 parity -> {check: readings}, the checks of
    ``DENSE_BARS`` among them: the Cholesky factor of S at threshold
    1e-12 against ``torch.linalg.cholesky`` of the dense S; LOBPCG's
    eight lowest eigenvalues of S (200 iterations, the epsilon rule)
    and of the defect matrix (converged by the epsilon rule) against
    ``torch.linalg.eigvalsh``."""
    p = params(threshold=DENSE_THRESHOLD)
    s = overlap(dim, bs, device, torch.float64)
    out = {"dim": dim, "bs": bs}
    ell, secs = _timed(device, linear.cholesky_decomposition, s, p)
    want = torch.linalg.cholesky(PM.to_dense(s))
    got = PM.to_dense(ell)
    out["cholesky"] = {"seconds": secs, "factor_rel": float(
        torch.linalg.norm(got - want) / torch.linalg.norm(want))}
    del ell, want, got
    for key, mat in (("lobpcg_s", s), ("lobpcg_defect",
                                       defect(dim, bs, device))):
        (w, _), secs = _timed(device, eigen.eigen_decomposition_iterative,
                              mat, NVALS, p)
        want = torch.linalg.eigvalsh(PM.to_dense(mat))[:NVALS]
        out[key] = {"seconds": secs, "eigen_rel": float(
            torch.linalg.norm(w - want) / torch.linalg.norm(want))}
    return out


def twin(dim: int, bs: int, device) -> dict:
    """Float64 solves whose results a card run and a CPU run must share
    -> {name: float64 or complex128 numpy array}: the Cholesky factor of
    S, the rank-64 pivoted factor of S with distinct diagonals
    (``graded``), the eigenvalues of ``reduce_dimension`` of H_b at
    dim/8, both extrapolations, and LOBPCG's eigenvalues and projector
    V V^H for the defect matrix, real and complex."""
    p = params(threshold=DENSE_THRESHOLD)
    # TRS4 picks each step's polynomial by sigma = (nel - tr F) / tr G,
    # and tr G cancels to rounding once X is nearly idempotent: at the
    # library's energy cutoff reduce_dimension's TRS4 (H_b, nel = dim /
    # 8) ended 3.6e-9 from idempotent on the card and 7.6e-13 on the CPU
    # (``twin_trs4``).  It stops one step earlier there (cutoff 1e-4 on
    # the idempotency metric: 9.3e-15 apart); K's TRS4 runs to the
    # plateau (1e-12), where card and CPU agreed to 2.3e-12
    tp = solve_params("highest")
    tp.threshold = DENSE_THRESHOLD
    tp.converge_diff = 1e-12
    rp = tp.copy()
    rp.converge_diff = 1e-4
    s = overlap(dim, bs, device, torch.float64)
    out = {"cholesky": linear.cholesky_decomposition(s, p),
           "pivoted": analysis.pivoted_cholesky_decomposition(
               graded(dim, bs, device), 64, p)}
    hb = PM.banded(dim, HALFWIDTH, barrier_fn(dim // 8), bs=bs,
                   grid=_grid(device), dtype=torch.float64)
    red = analysis.reduce_dimension(hb, dim // 8, rp)
    res = {"reduce": torch.linalg.eigvalsh(PM.to_dense(red)).cpu().numpy()}
    h = PM.banded(dim, HALFWIDTH, gapped_fn, bs=bs, grid=_grid(device),
                  dtype=torch.float64)
    s2 = overlap(dim, bs, device, torch.float64, displaced_overlap_fn)
    k = density.trs4(h, squareroot.inverse_square_root(s, p), dim / 2,
                     tp)[0]
    ep = extrapolation_params()
    ep.threshold = DENSE_THRESHOLD
    out["purification"] = geometry.purification_extrapolate(k, s2, dim / 2,
                                                            ep)
    out["lowdin"] = geometry.lowdin_extrapolate(k, s, s2, p)
    res.update({name: PM.to_dense(m).cpu().numpy() for name, m in
                out.items()})
    w, v = eigen.eigen_decomposition_iterative(defect(dim, bs, device),
                                               NVALS, p)
    res["lobpcg_w"] = w.cpu().numpy()
    res["lobpcg_projector"] = (v @ v.T).cpu().numpy()
    w, v = eigen.eigen_decomposition_iterative(
        defect(dim, bs, device, complex_=True), NVALS, p)
    res["lobpcg_complex_w"] = w
    res["lobpcg_complex_projector"] = v @ v.conj().T
    return res


def twin_trs4(device, cutoff: float | None = None) -> dict:
    """The twin's reduce_dimension TRS4 (H_b at 2048 rows, bs 32, f64,
    nel 256) -> its iterations, the logged convergence values, the
    density's ||P^2 - P|| / ||P|| and trace, and P as a numpy array:
    at the library's energy cutoff (``cutoff`` None, the twin's old
    setting) or on the idempotency metric at ``cutoff`` (the twin's)."""
    import os
    import re
    import tempfile

    from ..utils.logging import activate_logger, deactivate_logger
    dim = 2048
    hb = PM.banded(dim, HALFWIDTH, barrier_fn(dim // 8), bs=32,
                   grid=_grid(device), dtype=torch.float64)
    par = params(threshold=DENSE_THRESHOLD)
    if cutoff is not None:
        par = solve_params("highest")
        par.threshold = DENSE_THRESHOLD
        par.converge_diff = cutoff
    par.be_verbose = True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trs4.yaml")
        activate_logger(path)
        try:
            p = density.trs4(hb, _identity(hb), dim / 8, par)[0]
        finally:
            deactivate_logger()
        with open(path) as f:
            log = f.read()
    d = PM.to_dense(p).cpu().numpy()
    return {"iterations": int(re.search(r"Total Iterations: (\d+)",
                                        log).group(1)),
            "convergence": [float(v) for v in re.findall(
                r"Convergence: (\S+)", log)],
            "idempotency": float(np.linalg.norm(d @ d - d)
                                 / np.linalg.norm(d)),
            "trace": float(np.trace(d)), "density": d}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chol-dim", type=int, default=None,
                    help="rows of the Cholesky solve (the run's 2^20 "
                         "unless given)")
    ap.add_argument("--profile", action="store_true",
                    help="only the path, each solve under torch.profiler")
    ap.add_argument("--twin-trs4", action="store_true",
                    help="only the twin's reduce_dimension TRS4 on the CPU "
                         "and the card, at both cutoffs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("analysis needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    if args.twin_trs4:
        for cutoff in (None, 1e-4):
            res = {dev: twin_trs4(dev, cutoff) for dev in ("cpu", "cuda")}
            a, b = (res[dev].pop("density") for dev in ("cpu", "cuda"))
            print(json.dumps({"device": name, "cutoff": cutoff, **res,
                              "density_rel": float(np.linalg.norm(a - b)
                                                   / np.linalg.norm(a))}),
                  flush=True)
        return 0
    print(json.dumps({"device": name, **run(
        1 << 20, 128, "cuda", chol_dim=args.chol_dim,
        profile=args.profile)}), flush=True)
    if not args.profile:
        print(json.dumps({"device": name, **dense(8192, 128, "cuda")}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
