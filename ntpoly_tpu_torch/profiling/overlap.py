"""The non-orthogonal purification path, timed, with its certificates.

Chemistry codes work in a non-orthogonal basis: they compute the
inverse square root ISQ = S^-1/2 of the overlap S first and hand it to
a purification solver, which works on ISQ H ISQ^T and returns the
density matrix K in the basis of S.  This script runs that path:

  1. S and H: the overlap of ``systems.overlap_fn`` (ones on the
     diagonal, 0.3 / (1 + |i - j|)^2 off it) and the flagship's gapped
     chain (``systems.gapped_fn``), both at element half-width 16;
  2. ISQ = ``squareroot.inverse_square_root(S)`` (Taylor order 5,
     converge_diff 1e-5, at 'highest'), timed, with its residual
     max |ISQ S ISQ^T - I| (both multiplies at 'highest');
  3. TRS4, TRS2, PM and HPCP with that ISQ at nel = dim / 2, each timed
     after a 2-iteration warm-up, with the generalized certificates of
     ``trs4_tiers.purity_invariants(..., s=S)``; then TRS4 once more at
     the library's default 'high'.

The solves use the flagship's idempotency plateau and compensated
scalars at the tight cutoff 1e-5 (TRS2 reaches the flagship's 1e-3 per
electron while single eigenvalues are still far from 0 or 1), with
the library's capacity policy: no pinned capacity, 'grow', and the
automatic kernel choice (band or general, per multiply).

On a machine with a CUDA card, from the repository root:

    python3 -m ntpoly_tpu_torch.profiling.overlap

prints one JSON object for the flagship's size: 2^20 rows at bs 128 in
float32.  ``system``, ``isq`` and ``solve`` run the same
steps on any device.
"""
from __future__ import annotations

import json
import time

import torch

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..parallel.grid import ProcessGrid
from ..solvers import density, squareroot
from ..solvers.parameters import SolverParameters
from ..systems import gapped_fn, overlap_fn
from .trs4_tiers import logged, purity_invariants

HALFWIDTH = 16
THRESHOLD = 1e-7
SOLVERS = ("trs4", "trs2", "pm", "hpcp")
# the card path: each solver at 'highest', then TRS4 at the library's
# default 'high'
SOLVES = tuple((name, "highest") for name in SOLVERS) + (("trs4", "high"),)


def system(dim: int, bs: int, device, dtype=torch.float32):
    """(H, S, nel): the gapped chain and the overlap at half filling."""
    grid = ProcessGrid(device=device)
    h = PM.banded(dim, HALFWIDTH, gapped_fn, bs=bs, grid=grid, dtype=dtype)
    s = PM.banded(dim, HALFWIDTH, overlap_fn, bs=bs, grid=grid, dtype=dtype)
    return h, s, dim / 2


def isq_params() -> SolverParameters:
    return SolverParameters(threshold=THRESHOLD, converge_diff=1e-5,
                            precision="highest")


def solve_params(precision: str = "highest") -> SolverParameters:
    return SolverParameters(threshold=THRESHOLD, converge_diff=1e-5,
                            compensated_scalars=True,
                            convergence_metric="idempotency",
                            precision=precision)


def isq(s):
    """ISQ of S -> (ISQ, iterations, launches)."""
    return logged(squareroot.inverse_square_root, s, isq_params())


def residual(isq_m, s) -> float:
    """max |ISQ S ISQ^T - I|, both multiplies at 'highest'."""
    with alg.capacity_policy(precision="highest"):
        r = alg.matmul(isq_m, alg.matmul(s, alg.transpose(isq_m)))
        eye = PM.identity(s.dim, bs=s.bs, grid=s.grid, dtype=s.dtype)
        r = alg.increment(r, eye, 1.0, -1.0)
    return float(r.blocks.abs().amax())


def solve(name: str, h, isq_m, nel: float,
          params: SolverParameters | None = None):
    """density.<name> -> (K, energy, mu, iterations, launches)."""
    (k, energy, mu), n, counts = logged(getattr(density, name), h, isq_m,
                                        nel, params or solve_params())
    return k, energy, mu, n, counts


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(dim: int, bs: int, device="cuda") -> dict:
    """The path at one size: ISQ, then each (solver, precision) of
    ``SOLVES`` with that ISQ, timed (wall seconds, a 2-iteration
    warm-up excluded), with peak memory on a CUDA device and the
    certificates.  A solve's key is the solver's name, with
    ``_<precision>`` appended unless it is 'highest'."""
    h, s, nel = system(dim, bs, device)
    cuda = torch.device(device).type == "cuda"
    out = {"dim": dim, "bs": bs}
    _sync(device)
    t0 = time.perf_counter()
    isq_m, n, counts = isq(s)
    _sync(device)
    out["isq"] = dict(seconds=time.perf_counter() - t0, iterations=n,
                      k=isq_m.k, residual=residual(isq_m, s),
                      launches=counts)
    for name, precision in SOLVES:
        params = solve_params(precision)
        warm = params.copy()
        warm.max_iterations = 2
        getattr(density, name)(h, isq_m, nel, warm)
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        k, energy, mu, n, counts = solve(name, h, isq_m, nel, params)
        _sync(device)
        wall = time.perf_counter() - t0
        res = dict(seconds=wall, iterations=n, seconds_per_iteration=wall / n,
                   energy=energy, mu=mu, k=k.k, launches=counts)
        if cuda:
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res.update(purity_invariants(k, h, nel, THRESHOLD, s=s))
        del k
        out[name if precision == "highest" else f"{name}_{precision}"] = res
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("overlap needs a CUDA card")
    res = run(1 << 20, 128, "cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(0), **res}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
