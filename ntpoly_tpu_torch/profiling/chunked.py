"""The chunked driver on the card: each chunked loop captured as one CUDA
graph, held bit for bit against the same chunks run uncaptured.

With ``iters_per_sync`` n > 1 the nine loops that the JAX package
chunks take n iterations per host read (``solvers/common.run_chunked``):
on a card with a grid of one rank each chunk is captured once as a
CUDA graph and replayed.  This script runs:

  flagship  TRS4 of the flagship (``trs4_tiers``: the gapped chain at
            2^20 rows, bs 128, float32, k_out 5, 'pallas_band',
            'warn', compensated scalars, the idempotency plateau) at
            'high': eagerly, then for each n of ``FLAGSHIP_IPS`` a
            captured solve (the graph captured in it), a warm captured
            solve (the graph replayed only) and an uncaptured one
            (``common.uncaptured``), with the certificates of the
            captured solve; the eager and the warm captured solve once
            more under torch.profiler for the device's idle share;
  loops     the other eight loops at 'highest', 'grow', the automatic
            kernel choice and n = ``LOOP_IPS``: PM, TRS2 and HPCP of the
            overlap path's H with its ISQ (``overlap``); the Hotelling
            inverse, the order-2 Newton-Schulz ISQ,
            ``roots.compute_inverse_root(S, 2)`` (Taylor order 5), the
            sign of H - mu I and CG of S X = H (``functions``), each
            captured and uncaptured, with the checks of its eager solve
            (the generalized certificates and iteration caps of the
            overlap path, ``functions.BARS``, the ISQ residual bar).

Every solve of ``loops`` starts its pin at its carry's capacity (k_out
2: the pin is at least the carry's), so that 'grow' regrows it as the
fill needs (logged as "capacity regrown") and no matrix is wider than
the fill asks for.

A captured solve and its uncaptured twin must agree bit for bit: the
result's slots and blocks, energy, mu and iterations.  ``hold`` and
``record`` (functions that return a context manager, e.g. around
``chip_smoke._held_on_path``) wrap each uncaptured and each captured
solve.

On a machine with a CUDA card, from the repository root:

    python3 -m ntpoly_tpu_torch.profiling.chunked [--dim 1048576]

prints one JSON object per part.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import time

import torch

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..solvers import (common, density, inverse, linear, roots, sign,
                       squareroot)
from ..solvers.parameters import SolverParameters
from . import functions, overlap, trs4_tiers

FLAGSHIP_IPS = (4, 8)
LOOP_IPS = 4
# the overlap path's iteration caps (chip_smoke.OVERLAP_CAPS)
CAPS = {"trs2": 18, "pm": 10, "hpcp": 10}
ISQ_BAR = 1e-5
CERT_BARS = {"idempotency_rel": 1e-5, "commutator_rel": 5e-5,
             "trace_err_per_electron": 1e-6}


def same(a, b) -> bool:
    """Whether two results agree bit for bit: every matrix's slots and
    blocks, and every number."""
    if isinstance(a, PM.PSMatrix):
        return (isinstance(b, PM.PSMatrix) and a.k == b.k
                and torch.equal(a.col_ids, b.col_ids)
                and torch.equal(a.blocks.view(torch.int32 if a.dtype ==
                                              torch.float32 else
                                              torch.int64),
                                b.blocks.view(torch.int32 if b.dtype ==
                                              torch.float32 else
                                              torch.int64)))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)


def twin(fn, *args, device, hold=None, record=None, warm=False,
         profile=False) -> dict:
    """fn(*args) captured (the graphs released first, so that it
    captures; inside ``record``), then uncaptured (inside ``hold``) ->
    {"captured": (result, readings of ``functions.measured``),
    "uncaptured": readings, "same": bit for bit}.  ``warm``: a second
    captured solve, its graph replayed only (its readings, "warm");
    ``profile``: that solve once more under torch.profiler ("traced").
    Only the captured solve's result is kept, and the graphs are
    released before each solve but the warm and traced ones, so that
    each solve's peak memory is its own."""
    m = functools.partial(functions.measured, device=device, warm_up=False)
    out = {}
    common.release_graphs()
    with record() if record else contextlib.nullcontext():
        out["captured"] = m(fn, *args)
    if warm:
        out["warm"] = m(fn, *args)[1]
    if profile:
        out["traced"] = m(fn, *args, profile=True)[1]
    common.release_graphs()
    with common.uncaptured(), hold() if hold else contextlib.nullcontext():
        res, out["uncaptured"] = m(fn, *args)
    out["same"] = same(out["captured"][0], res)
    del res
    common.release_graphs()
    return out


def _readings(r: dict) -> dict:
    return {k: v for k, v in r.items()
            if k in ("seconds", "iterations", "multiplies", "launches",
                     "peak_gib", "pins", "idle_share", "device_s")}


def flagship(dim: int = 1 << 20, bs: int = 128, device="cuda",
             hold=None, record=None) -> dict:
    """Part (a): the flagship TRS4 eagerly and chunked (see the module's
    docstring) -> readings, with each chunked solve's certificates and
    its bit-for-bit check."""
    config = trs4_tiers.CONFIGS["flagship"]
    h, isq, nel = trs4_tiers.system(dim, bs, device)
    base = trs4_tiers.flagship_params(config["k_out"], "pallas_band")
    m = functools.partial(functions.measured, device=device, warm_up=False)
    trace = torch.device(device).type == "cuda"
    out = {"dim": dim, "bs": bs}

    def traced(r):
        return dict(idle_share=r["idle_share"], traced_s=r["seconds"],
                    device_s=r["device_s"]) if trace else {}

    # a warm-up, so that the eager solve pays no first call's costs
    warm = base.copy()
    warm.max_iterations = 2
    density.trs4(h, isq, nel, warm)
    (rho, energy, mu), r = m(density.trs4, h, isq, nel, base)
    del rho
    out["eager"] = dict(_readings(r), energy=energy, mu=mu)
    if trace:
        out["eager"].update(traced(m(density.trs4, h, isq, nel, base,
                                     profile=True)[1]))
    for ips in FLAGSHIP_IPS:
        params = base.copy()
        params.iters_per_sync = ips
        res = twin(density.trs4, h, isq, nel, params, device=device,
                   hold=hold, record=record, warm=True, profile=trace)
        (rho, energy, mu), r = res.pop("captured")
        inv = trs4_tiers.purity_invariants(rho, h, nel, params.threshold)
        inv["trace_err_per_electron"] = inv["trace_abs_err"] / nel
        del rho
        out[f"ips_{ips}"] = dict(
            captured=dict(_readings(r), energy=energy, mu=mu, **inv),
            warm=_readings(res["warm"]),
            uncaptured=_readings(res["uncaptured"]), same=res["same"],
            **(traced(res["traced"]) if trace else {}))
        del res
    return out


def flagship_failures(res: dict) -> list[str]:
    """The bars of part (a) that its readings miss."""
    bad = []
    for ips in FLAGSHIP_IPS:
        r = res[f"ips_{ips}"]
        c = r["captured"]
        if not r["same"]:
            bad.append(f"ips {ips}: captured and uncaptured solves differ")
        if max(c["iterations"]) > 10:
            bad.append(f"ips {ips}: {c['iterations']} iterations > 10")
        for k, bar in CERT_BARS.items():
            if not c[k] <= bar:
                bad.append(f"ips {ips}: {k} {c[k]!r} > {bar}")
        if not (math.isfinite(c["energy"]) and math.isfinite(c["mu"])):
            bad.append(f"ips {ips}: energy or mu not finite")
    return bad


def loop_params(precision: str = "highest",
                threshold: float = overlap.THRESHOLD, **kw):
    """The loops' settings: the automatic kernel choice, 'grow', the pin
    from the carry's capacity up (k_out 2), n = LOOP_IPS."""
    return SolverParameters(threshold=threshold, precision=precision,
                            iters_per_sync=LOOP_IPS, k_out=2, **kw)


def loops(dim: int = 1 << 20, bs: int = 128, device="cuda", hold=None,
          record=None) -> dict:
    """Part (b): the eight loops, each captured and uncaptured, with the
    checks of its eager solve -> {loop: readings and checks}."""
    h, s, nel = overlap.system(dim, bs, device)
    eye = functions._identity(s)
    isq, _, _ = overlap.isq(s)
    pair = functools.partial(twin, device=device, hold=hold, record=record)
    out = {"dim": dim, "bs": bs}

    def entry(res, **checks):
        return dict(_readings(res["captured"][1]), uncaptured=_readings(
            res["uncaptured"]), same=res["same"], **checks)

    dp = overlap.solve_params()
    for name in ("pm", "trs2", "hpcp"):
        res = pair(getattr(density, name), h, isq, nel,
                   loop_params(converge_diff=dp.converge_diff,
                               compensated_scalars=True,
                               convergence_metric="idempotency"))
        k, energy, mu = res["captured"][0]
        inv = trs4_tiers.purity_invariants(k, h, nel, overlap.THRESHOLD,
                                           s=s)
        inv["trace_err_per_electron"] = inv["trace_abs_err"] / nel
        out[name] = entry(res, energy=energy, mu=mu, **inv)
        del k, res

    with functions._exact():
        isq2 = alg.matmul(isq, isq)
    res = pair(inverse.invert, s, loop_params())
    x = res["captured"][0]
    with functions._exact():
        out["invert"] = entry(
            res, identity_rel=functions.rel(alg.matmul(s, x), eye),
            isq_rel=functions.rel(x, isq2, norm_of=x))
    del x, res, isq2

    res = pair(functools.partial(squareroot.inverse_square_root, order=2),
               s, loop_params(converge_diff=1e-5))
    out["isq_order2"] = entry(res, residual=overlap.residual(
        res["captured"][0], s))
    del res

    res = pair(roots.compute_inverse_root, s, 2, loop_params())
    out["inv_root"] = entry(res, isq_rel=functions.rel(
        res["captured"][0], isq))
    del res, isq

    res = pair(linear.cg_solver, s, h,
               loop_params(threshold=functions.FINE_THRESHOLD))
    with functions._exact():
        out["cg"] = entry(res, residual_rel=functions.rel(
            alg.matmul(s, res["captured"][0]), h))
    del res, s

    (k, _, mu), _ = functions.measured(
        density.trs4, h, eye, nel, overlap.solve_params(), device=device,
        warm_up=False)
    shifted = alg.increment(h, eye, 1.0, -mu)
    res = pair(sign.sign_function, shifted, loop_params())
    d = alg.increment(eye, res["captured"][0], 0.5, -0.5)
    checks = dict(density_rel=functions.rel(d, k),
                  trace_err_per_electron=abs(
                      alg.host_pair(alg.trace_pair(d)) - nel) / nel)
    with functions._exact():
        checks["idempotency_rel"] = functions.rel(alg.matmul(d, d), d)
    out["sign"] = entry(res, **checks)
    return out


# loop -> {reading: the largest value it may take}
LOOP_BARS = {
    **{name: CERT_BARS for name in ("pm", "trs2", "hpcp")},
    "invert": {"identity_rel": 1e-4, "isq_rel": 1e-4},
    "isq_order2": {"residual": ISQ_BAR},
    "inv_root": {"isq_rel": 1e-4},
    "cg": {"residual_rel": 1e-4},
    "sign": {"density_rel": 1e-4, "trace_err_per_electron": 1e-5,
             "idempotency_rel": 1e-4},
}


def loop_failures(res: dict) -> list[str]:
    """The bars of part (b) that its readings miss."""
    bad = []
    for name, bars in LOOP_BARS.items():
        r = res[name]
        if not r["same"]:
            bad.append(f"{name}: captured and uncaptured solves differ")
        for k, bar in bars.items():
            if not (math.isfinite(r[k]) and r[k] <= bar):
                bad.append(f"{name}: {k} {r[k]!r} > {bar}")
        if name in CAPS and max(r["iterations"]) > CAPS[name]:
            bad.append(f"{name}: {r['iterations']} iterations over "
                       f"{CAPS[name]}")
    return bad


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chunked needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    res = flagship(args.dim)
    print(json.dumps({"device": name, "part": "flagship", **res,
                      "failures": flagship_failures(res),
                      "seconds": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    res = loops(args.dim)
    print(json.dumps({"device": name, "part": "loops", **res,
                      "failures": loop_failures(res),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
