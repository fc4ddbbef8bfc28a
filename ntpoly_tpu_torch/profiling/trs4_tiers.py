"""TRS4's certificates iteration by iteration, at each multiply route.

The flagship solve stops where its idempotency plateau says, and a tier
can move both the certificates and that stopping point.  This script
separates the two: it runs ``density.trs4`` for exactly n = 1 .. N
iterations (the energy monitor with converge_diff 0 and its automatic
rules off, so nothing stops a solve early) and computes the
certificates of each iterate at 'highest' (``purity_invariants``),
under three routes for the band kernel:

  kernel_high     the band kernel at 'high': the split pass and the
                  tensor-core product (float32 sums, a fresh sum per
                  stage added to the tile's rounding to nearest)
  plain_high      its plain version at 'high' in its place: the same
                  bf16x3 terms, each product exact in float32, summed by
                  ``torch.bmm`` (cuBLAS on the card, TF32 off)
  kernel_highest  the band kernel at 'highest' (exact float32)

Then each route runs the flagship's own plateau solve once, for the
iteration count its monitor picks.  Iterates of the same route agree
up to the shorter count, so the readings of the fixed counts are the
plateau solve's readings on its way.

Configurations (the JAX package's ``bench.py``): ``flagship``
(``bench_trs4_1m``: the gapped chain at 2^20 rows, bs 128, k_out 5) and
``trs4_100k`` (``bench_trs4_100k``: 102,400 rows, bs 128, k_out 8),
both at element half-width 16, threshold 1e-7, float32, through the
band kernel (``matmul_method='pallas_band'``).

On a machine with a CUDA card, from the repository root:

    python3 -m ntpoly_tpu_torch.profiling.trs4_tiers [--config flagship]
        [--iterations 10]

prints one JSON object per configuration.  ``history`` runs the same
solves on any device (on the CPU both 'high' routes are the plain
version).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import tempfile
from contextlib import contextmanager

import torch

from ..ops import spgemm as sp
from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..parallel.grid import ProcessGrid
from ..solvers import density
from ..solvers.parameters import SolverParameters
from ..systems import gapped_fn
from ..utils.logging import activate_logger, deactivate_logger

CONFIGS = {
    "flagship": dict(dim=1 << 20, bs=128, k_out=5),
    "trs4_100k": dict(dim=102400, bs=128, k_out=8),
}
HALFWIDTH = 16
THRESHOLD = 1e-7
ROUTES = {"kernel_high": ("kernel", "high"),
          "plain_high": ("plain", "high"),
          "kernel_highest": ("kernel", "highest")}


def flagship_params(k_out: int, method: str, precision: str = "high",
                    iterations: int | None = None) -> SolverParameters:
    """The flagship TRS4 settings: idempotency plateau, compensated
    scalars, pinned capacity, deferred overflow warnings, the library's
    default tier 'high'.  With ``iterations``: exactly that many (the
    energy monitor, converge_diff 0, automatic rules off)."""
    params = SolverParameters(converge_diff=1e-3, threshold=THRESHOLD,
                              iters_per_sync=1, compensated_scalars=True,
                              convergence_metric="idempotency", k_out=k_out,
                              matmul_method=method, on_overflow="warn",
                              precision=precision)
    if iterations is not None:
        params.convergence_metric = "energy"
        params.converge_diff = 0.0
        params.monitor_convergence = False
        params.max_iterations = iterations
    return params


def logged(fn, *args):
    """fn(*args) with the YAML logger on and the kernel launch counts
    reset just before -> (result, iterations, launches).  The iteration
    count is the log's 'Total Iterations', as the JAX package's
    bench.py reads it; ``args`` ends with the solver parameters, which
    are copied with ``be_verbose`` on."""
    params = args[-1].copy()
    params.be_verbose = True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "solve.yaml")
        activate_logger(path)
        try:
            sp.reset_launches()
            out = fn(*args[:-1], params)
            counts = dict(sp.launches)
        finally:
            deactivate_logger()
        with open(path) as f:
            log = f.read()
    n = int(re.search(r"^ *Total Iterations: (\d+)$", log, re.M).group(1))
    return out, n, counts


def solve(h, isq, nel, params):
    """density.trs4 -> (rho, energy, mu, iterations, launches), the
    launches counted over the solve alone (:func:`logged`)."""
    (rho, energy, mu), n, counts = logged(density.trs4, h, isq, nel, params)
    return rho, energy, mu, n, counts


def purity_invariants(rho, h, nel: float, threshold: float,
                      s=None) -> dict:
    """Certificates of a density matrix K, with residuals formed before
    their norms, every multiply at 'highest' so that the tier under test
    does not grade itself:
      idempotency_rel = ||K^2 - K||_F / ||K||_F
      trace_err       = tr K - nel  (compensated trace; trace_abs_err
                        its magnitude)
      commutator_rel  = ||KH - HK||_F / ||KH||_F
    With an overlap ``s`` (a non-orthogonal basis), their generalized
    forms: ||KSK - K||_F / ||K||_F, tr(KS) - nel and
    ||HKS - SKH||_F / ||HKS||_F, the multiplies at the capacity they
    need (KS exactly, unfiltered); ``s`` = I gives the values above."""
    if s is None:
        policy = alg.capacity_policy(k_out=max(rho.k, h.k),
                                     method="pallas_band",
                                     on_overflow="truncate",
                                     precision="highest")
    else:
        policy = alg.capacity_policy(on_overflow="grow",
                                     precision="highest")
    with policy:
        ks = rho if s is None else alg.matmul(rho, s)
        k2 = alg.matmul(ks, rho, threshold=threshold)
        r = alg.increment(k2, rho, 1.0, -1.0)
        del k2
        idem = math.sqrt(max(float(alg.dot(r, r)), 0.0)
                         / float(alg.dot(rho, rho)))
        del r
        tr = alg.host_pair(alg.trace_pair(ks))
        if s is None:
            kh = alg.matmul(rho, h, threshold=threshold)
            hk = alg.matmul(h, rho, threshold=threshold)
        else:
            kh = alg.matmul(h, ks, threshold=threshold)         # HKS
            hk = alg.matmul(alg.matmul(s, rho), h,
                            threshold=threshold)                # SKH
        del ks
        c = alg.increment(kh, hk, 1.0, -1.0)
        del hk
        comm = math.sqrt(max(float(alg.dot(c, c)), 0.0)
                         / float(alg.dot(kh, kh)))
    return {"idempotency_rel": idem, "trace_err": tr - nel,
            "trace_abs_err": abs(tr - nel), "commutator_rel": comm}


@contextmanager
def band_route(route: str):
    """'kernel': the band kernel as ``spgemm`` calls it; 'plain': its
    plain version in its place for the duration."""
    if route == "kernel":
        yield
        return
    kernel = sp.spgemm_band
    sp.spgemm_band = sp.spgemm_band_plain
    try:
        yield
    finally:
        sp.spgemm_band = kernel


def system(dim: int, bs: int, device):
    """(H, ISQ, nel): the gapped chain at half filling, float32."""
    grid = ProcessGrid(device=device)
    h = PM.banded(dim, HALFWIDTH, gapped_fn, bs=bs, grid=grid,
                  dtype=torch.float32)
    isq = PM.identity(dim, bs=bs, grid=grid, dtype=torch.float32)
    return h, isq, dim / 2


def history(dim: int, bs: int, k_out: int, iterations: int,
            device="cuda") -> dict:
    """route -> {"fixed": the certificates and energy after n = 1 ..
    ``iterations`` iterations, "plateau": the plateau solve's iteration
    count, certificates and energy}."""
    h, isq, nel = system(dim, bs, device)
    out = {}
    for name, (route, precision) in ROUTES.items():
        fixed = []
        with band_route(route):
            for n in range(1, iterations + 1):
                rho, energy, _, ran, _ = solve(h, isq, nel, flagship_params(
                    k_out, "pallas_band", precision, n))
                if ran != n:
                    raise RuntimeError(f"a solve of {n} iterations stopped "
                                       f"after {ran}")
                fixed.append(dict(iterations=n, energy=energy,
                                  **purity_invariants(rho, h, nel,
                                                      THRESHOLD)))
                del rho
            rho, energy, _, n, _ = solve(
                h, isq, nel, flagship_params(k_out, "pallas_band",
                                             precision))
            plateau = dict(iterations=n, energy=energy,
                           **purity_invariants(rho, h, nel, THRESHOLD))
            del rho
        out[name] = {"fixed": fixed, "plateau": plateau}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), action="append")
    ap.add_argument("--iterations", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trs4_tiers needs a CUDA card")
    for config in args.config or sorted(CONFIGS):
        res = history(**CONFIGS[config], iterations=args.iterations)
        print(json.dumps({"config": config, **CONFIGS[config],
                          "device": torch.cuda.get_device_name(0),
                          "routes": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
