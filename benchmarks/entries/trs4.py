"""TRS4 density solves through ``ntpoly_tpu_torch.solvers.density.trs4``.

The caller is an SCF or MD driver: it hands the library one
Hamiltonian of the pool, waits for the density, and hands it the next.
The pool (``traffic/hamiltonians.py``) is built at set-up through the
port's public constructors (``parallel.pmatrix.banded``, ``identity``)
on the device; the warm-up is one whole solve, which builds the
kernels and, in chunked solves, captures the chunk's graph.

The check compares each kept call's density, energy and chemical
potential with the plain reference (``reference/trs4.py``) on the same
seeded values:

  density_rel_fro          ||K - K_ref||_F / ||K_ref||_F
  energy_err_per_electron  |E - E_ref| / nel
  mu_outside_gap           how far mu lies outside [homo, lumo], the
                           gap's edges bounded from the reference's
                           density (``reference.trs4.gap_edges``); 0
                           inside.  TRS4 may place mu anywhere in the
                           gap, so the gap is what it is held to.

A control (one of ``workloads/<cell>.json``'s ``controls``) is either
the program at a lower precision tier of its own (kind 'program', e.g.
'bf16' under 'high', 'high' under 'highest'), or the reference itself
in float32 with its operands rounded to TF32 (kind 'reference').
"""
from __future__ import annotations

import gc
import math
import os
import re
import statistics
import sys
import tempfile
from dataclasses import dataclass

import torch

from benchmarks import roofline
from benchmarks.reference import band as B
from benchmarks.reference import trs4 as R
from benchmarks.traffic import hamiltonians

from ntpoly_tpu_torch.ops import spgemm as sp
from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import common, density
from ntpoly_tpu_torch.solvers.parameters import SolverParameters
from ntpoly_tpu_torch.utils.logging import activate_logger, deactivate_logger

CHECKS = ("density_rel_fro", "energy_err_per_electron", "mu_outside_gap")
# L2 flush before each timed product: larger than the card's 50 MB L2
FLUSH_BYTES = 256 << 20
ROOFLINE_REPS = 5


OPERANDS = {"tf32": B.round_tf32}


@dataclass
class Output:
    index: int             # pool member
    cols: torch.Tensor     # block-ELL density: int[nb, k]
    blocks: torch.Tensor   # [nb, k, bs, bs]
    energy: float
    mu: float
    matrix: object = None  # the program's PSMatrix (not kept)


class Session:
    """One process's calls of one cell (see the module docstring)."""

    def __init__(self, cell, seed: int, device, control=None):
        self.cell = cell
        self.config = cfg = cell.config
        self.device = torch.device(device)
        self.rows, self.bs = int(cfg["rows"]), int(cfg["bs"])
        self.nel = float(cfg["electrons"])
        self.pool = int(cell.traffic["pool"])
        self.seed = seed
        self.control = control          # a ``controls`` entry, or None
        self.onsite = hamiltonians.onsite(
            int(cell.traffic["set_seed"]), self.pool, self.rows,
            float(cfg["assumed"]["disorder"]), self.device)
        self.order: list[int] = []
        self.hams, self.isq = [], None

    # -- the program -----------------------------------------------------

    def _values(self, i: int):
        return hamiltonians.value_function(self.config, self.onsite[i])

    def setup(self) -> None:
        """Build the pool on the device and warm up with one solve."""
        cfg = self.config
        dtype = getattr(torch, cfg["dtype"])
        if self.control and self.control["kind"] == "reference":
            self.hams = [B.from_values(self._values(i), self.rows, self.bs,
                                       self._band(), int(cfg["halfwidth"]),
                                       dtype, self.device)
                         for i in range(self.pool)]
        else:
            grid = ProcessGrid(device=self.device)
            with torch.profiler.record_function("bench.fill"):
                self.hams = [PM.banded(self.rows, int(cfg["halfwidth"]),
                                       self._values(i), bs=self.bs,
                                       grid=grid, dtype=dtype)
                             for i in range(self.pool)]
                self.isq = PM.identity(self.rows, bs=self.bs, grid=grid,
                                       dtype=dtype)
            solver = dict(self.cell.traffic["solver"])
            if self.control:
                solver["precision"] = self.control["precision"]
            self._params = SolverParameters(
                threshold=float(cfg["threshold"]), **solver)
        self.call(0)

    def call(self, n: int) -> Output:
        """The n-th call: a density of the pool member that the seeded
        order sends n-th."""
        if n >= len(self.order):
            self.order = hamiltonians.order(self.seed, self.pool,
                                            2 * n + self.pool)
        i = self.order[n]
        with torch.profiler.record_function("bench.solve"):
            if self.control and self.control["kind"] == "reference":
                sol = R.trs4(self.hams[i], self.nel,
                             dtype=self.hams[i].dtype,
                             operands=OPERANDS[self.control["operands"]])
                cols, blocks = B.to_ell(sol.density)
                out = Output(i, cols, blocks, sol.energy, sol.mu)
            else:
                k, energy, mu = density.trs4(self.hams[i], self.isq,
                                             self.nel, self._params)
                out = Output(i, k.col_ids[0], k.blocks[0], energy, mu, k)
        return out

    def keep(self, out: Output) -> Output:
        """A copy of ``out`` that later calls cannot overwrite (a
        chunked solve returns its graph's own output buffers)."""
        return Output(out.index, out.cols.clone(), out.blocks.clone(),
                      out.energy, out.mu)

    def counters(self) -> dict:
        return {"matmul": alg.multiplies["matmul"], **sp.launches}

    def logged_calls(self, first: int, count: int):
        """``count`` calls from the ``first``-th with the solver's YAML
        log on -> (their outputs, kept; the iterations of each from its
        'Total Iterations')."""
        params = self._params
        self._params = params.copy()
        self._params.be_verbose = True
        outs = []
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "solve.yaml")
            activate_logger(path)
            try:
                for n in range(first, first + count):
                    outs.append(self.keep(self.call(n)))
            finally:
                deactivate_logger()
                self._params = params
            with open(path) as f:
                log = f.read()
        its = [int(v) for v in
               re.findall(r"^ *Total Iterations: (\d+)$", log, re.M)]
        return outs, its

    def roofline(self, out: Output) -> dict:
        """One ``matmul(K, K)`` of the density of the call ``out`` at
        the cell's tier, threshold and capacity, timed with CUDA events
        with the L2 flushed before each launch -> {'bytes', 'flops',
        'seconds'} (the median of ROOFLINE_REPS launches)."""
        k, p = out.matrix, self._params
        policy = dict(k_out=p.k_out, precision=p.precision,
                      method=p.matmul_method, defer=True,
                      on_overflow={"ignore": "truncate", "warn": "warn"}
                      .get(p.on_overflow, "grow"))
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                            device=self.device)
        times = []
        with alg.capacity_policy(**policy):
            c = alg.matmul(k, k, threshold=p.threshold)
            work = roofline.product(k.col_ids[0], k.col_ids[0],
                                    c.col_ids[0], k.nb, k.bs,
                                    k.blocks.element_size(), same=True)
            del c
            for _ in range(ROOFLINE_REPS):
                flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                c = alg.matmul(k, k, threshold=p.threshold)
                end.record()
                torch.cuda.synchronize(self.device)
                times.append(start.elapsed_time(end) * 1e-3)
                del c
        return dict(work, seconds=statistics.median(times))

    def release(self) -> None:
        """Free the program's state: the pool, the captured graphs."""
        self.hams, self.isq = [], None
        common.release_graphs()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------
    def _band(self) -> int:
        return int(self.cell.spec["check"]["reference_band"])

    def check(self, kept: list) -> dict:
        """The largest reading of each of CHECKS over the kept outputs,
        against the float64 reference of each pool member once."""
        worst = dict.fromkeys(CHECKS, 0.0)
        w = self._band()
        with torch.profiler.record_function("bench.check"):
            for i in sorted({o.index for o in kept}):
                h = B.from_values(self._values(i), self.rows, self.bs, w,
                                  int(self.config["halfwidth"]),
                                  torch.float64, self.device)
                ref = R.trs4(h, self.nel)
                homo, lumo = R.gap_edges(h, ref.density)
                del h
                print(f"# check: pool member {i}: gap [{homo!r}, "
                      f"{lumo!r}], mu "
                      f"{[o.mu for o in kept if o.index == i]}",
                      file=sys.stderr)
                norm = B.frobenius(ref.density)
                for o in (o for o in kept if o.index == i):
                    got, outside = B.from_ell(o.cols, o.blocks, w)
                    got.sub_(ref.density)
                    rel = (B.dot(got, got) + outside) ** 0.5 / norm
                    del got
                    err = abs(o.energy - ref.energy) / self.nel
                    out = max(homo - o.mu, o.mu - lumo, 0.0)
                    for name, v in zip(CHECKS, (rel, err, out)):
                        # a reading that is not a number fails
                        v = v if math.isfinite(v) else math.inf
                        worst[name] = max(worst[name], v)
                del ref
        return worst
