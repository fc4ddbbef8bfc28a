"""Solver parameters and the convergence monitor.

Copied from ``ntpoly_tpu/solvers/parameters.py``: the fields, their
defaults and the monitor's rules are the reference's exactly, so a
solve makes the same decisions in both packages.  The fields beyond
the reference's keep the JAX package's names; what each does in this
package is said beside it:

  * ``precision`` picks the SpGEMM tier (``ops/spgemm.kernel_tier``);
  * ``matmul_method`` picks the kernel (``parallel/algebra.matmul``);
  * ``k_out`` and ``on_overflow`` the capacity policy
    (``parallel/algebra.capacity_policy``);
  * ``iters_per_sync`` the chunked driver
    (``solvers/common.run_chunked``);
  * ``compensated_scalars`` the two-float reductions
    (``ops/reduce``, ``solvers/density``);
  * ``row_chunk`` is accepted for parity with the reference and
    ignored: the reference chunks the rows of its TPU kernels to fit
    their scalar memory, and the CUDA kernels have no such limit.

Faithful ports of the control logic that gates every iterative solver:
reference Source/Fortran/SolverParametersModule.F90:14-113 and
ConvergenceMonitorModule.F90:122-191 (the windowed automatic-detection rules
must match exactly for iteration-count parity with the reference).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import Optional

from ..utils.logging import logger, sub_log

CONVERGENCE_DIFF_CONST = 1e-6
MAX_ITERATIONS_CONST = 1000


class Monitor:
    """Moving-window convergence monitor (reference
    ConvergenceMonitorModule.F90).

    Basic mode: converged when |last| <= tight_cutoff.  Automatic mode adds:
    enough samples seen, short/long window averages within 10x of each other,
    last value within 10x of the long average, last value non-negative and
    not still shrinking, and long average <= loose_cutoff.
    """

    def __init__(self, short_len: int = 3, long_len: int = 6,
                 loose_cutoff: float = 1e-2, tight_cutoff: float = 1e-8,
                 automatic: bool = True, plateau: bool = False):
        self.win_short = [0.0] * short_len
        self.win_long = [0.0] * long_len
        self.nval = 0
        self.loose_cutoff = loose_cutoff
        self.tight_cutoff = tight_cutoff
        self.automatic = automatic
        # Plateau mode (for monotone residual metrics like the
        # idempotency functional): converged at the FIRST non-decrease
        # once the previous value sat below loose_cutoff — a
        # quadratically-decaying residual hits its arithmetic floor and
        # upticks immediately, while the windowed rules wait for the
        # long average to wash out the decay tail, several iterations
        # more.
        self.plateau = plateau
        self.converged = False          # set once check_converged fires

    def append(self, value: float):
        self.win_short = self.win_short[1:] + [float(value)]
        self.win_long = self.win_long[1:] + [float(value)]
        self.nval += 1

    def would_converge(self, value: float) -> bool:
        """Whether appending ``value`` would make :meth:`check_converged`
        fire; the monitor is left as it is."""
        probe = copy.copy(self)
        probe.append(value)
        return probe.check_converged()

    def check_converged(self, be_verbose: bool = False) -> bool:
        last = self.win_short[-1]
        last2 = self.win_short[-2]
        if be_verbose:
            logger.write_list_element(key="Convergence", value=last)
        if abs(last) <= self.tight_cutoff:
            if be_verbose:
                with sub_log():
                    logger.write_element("Trigger", "Tight Criteria")
            self.converged = True
            return True
        if self.plateau:
            conv = (self.nval >= 2 and abs(last2) > 0
                    and abs(last) >= abs(last2)
                    and abs(last2) <= self.loose_cutoff)
            if conv and be_verbose:
                with sub_log():
                    logger.write_element("Trigger", "Plateau")
            self.converged = self.converged or conv
            return conv
        if not self.automatic:
            return False

        conv = True
        if self.nval < len(self.win_long):
            conv = False
        avg_short = sum(self.win_short) / len(self.win_short)
        avg_long = sum(self.win_long) / len(self.win_long)
        if be_verbose:
            with sub_log():
                logger.write_element("Avg Short", avg_short)
                logger.write_element("Avg Long", avg_long)
        if not (10 * avg_short > avg_long and avg_short / 10 < avg_long):
            conv = False
        if not (10 * last > avg_long and last / 10 < avg_long):
            conv = False
        if last < 0:
            conv = False
        if abs(last) < abs(last2):
            conv = False
        if avg_long > self.loose_cutoff:
            conv = False
        if conv and be_verbose:
            with sub_log():
                logger.write_element("Trigger", "Automatic")
        self.converged = self.converged or conv
        return conv


@dataclass
class SolverParameters:
    """reference SolverParametersModule.F90:14-113 plus the capacity,
    chunking, tier and kernel knobs of the JAX package, each with what
    it does here."""
    converge_diff: float = CONVERGENCE_DIFF_CONST
    max_iterations: int = MAX_ITERATIONS_CONST
    threshold: float = 0.0
    be_verbose: bool = False
    do_load_balancing: bool = False
    balance_permutation: Optional[object] = None   # Permutation
    step_thresh: float = 1e-2
    monitor_convergence: bool = True
    # Opt-in strictness: raise utils.errors.ConvergenceError when a solver
    # exhausts max_iterations without its monitor firing (the reference
    # logs totals and returns silently; strict callers want the raise).
    raise_on_nonconvergence: bool = False
    # Extensions absent in the reference.  Block capacity: slots per
    # block-row of every product (None: each multiply grows to the
    # structural fill it measures; parallel/algebra.capacity_policy).
    k_out: Optional[int] = None
    # Accepted for parity with the reference and ignored: the JAX
    # package chunks the rows of its TPU kernels to fit their scalar
    # memory; the CUDA kernels (ops/spgemm.py) take every row at once.
    row_chunk: Optional[int] = None
    # Iterations per host read (1 = exact reference semantics: converge
    # check every iteration).  With more, PM, TRS2, TRS4, HPCP, the
    # Hotelling inverse, CG and the Newton-Schulz square roots and sign
    # run solvers/common.run_chunked: a chunk of that many steps with no
    # host read, captured once as a CUDA graph on a card with a grid of
    # one rank and replayed (common.release_graphs() frees it,
    # common.uncaptured() runs the same chunk without a graph).  The
    # solve may overrun convergence by up to iters_per_sync - 1
    # iterations.  Every other solver runs eagerly, as in the reference.
    iters_per_sync: int = 1
    # Response when a product's structural fill exceeds the capacity
    # (parallel/algebra.matmul; a chunk's pinned capacity in
    # run_chunked): 'grow' (regrow, and redo a chunk, at the needed
    # capacity -- the reference's never-drop pool growth), 'warn',
    # 'raise', 'ignore'.  Truncation ('warn'/'ignore', or 'grow' capped
    # at the panel width) keeps each overflowing row's k_out LOWEST
    # column ids, as the reference's kernels do, not its k_out
    # largest-norm blocks, so a truncated solve can drop a row's
    # numerically largest block.  Size k_out (or let 'grow' run) so
    # truncation never fires on converged workloads.
    on_overflow: str = "grow"
    # The SpGEMM tier (ops/spgemm.kernel_tier), for float32 blocks:
    # 'high' (the default, as in the reference) is the bfloat16 hi/lo
    # split, a_hi b_hi + a_lo b_hi + a_hi b_lo with float32 sums, run
    # as the split pass and one wgmma product on the tensor cores
    # (csrc/tc.cuh); 'bf16' and 'default' the hi part alone on the same
    # product; 'highest' exact float32 FMAs on the cp.async ring
    # (csrc/tile.cuh).  float64 runs exact at every tier.
    precision: str = "high"
    # Convergence functional for the purification solvers (PM / TRS2 /
    # TRS4 / HPCP).  'energy' = successive energy differences (exact
    # reference parity, DensityMatrixSolversModule.F90:192-197);
    # 'idempotency' = the per-electron idempotency residual
    # (tr(X) - tr(X^2)) / nel, monitored as a value.  The residual
    # decays quadratically and then PLATEAUS at the arithmetic floor,
    # where the plateau monitor fires deterministically -- energy
    # differences instead wander in the noise of a reduced-precision
    # tier.  'auto' (default): 'energy' at precision='highest',
    # 'idempotency' otherwise.
    convergence_metric: str = "auto"
    # Compensated (two-float) scalar reductions for the monitor scalars
    # and the reported energy (ops/reduce.py): float32 sums
    # quantize a large energy at a coarse absolute step, so a
    # converge_diff below it cannot be certified at the 2^20-row scale
    # without them.  The products stay float32; only the traces and dots
    # feeding sigma, the monitor and the energy pay the extra passes
    # (solvers/density.py says which scalars each solver compensates).
    # On the card the kernels' plain traces and dots already are the
    # pairs' float64 values, so there it changes the reported energy
    # (else rounded to the matrices' dtype) and PM's and HPCP's choice
    # of traces.
    compensated_scalars: bool = False
    # SpGEMM method override (None = parallel/algebra.matmul's own
    # choice).  The names are the JAX package's.  'pallas' runs the
    # kernels, the band kernel (csrc/spgemm_band.cu) where the band plan
    # holds and the general kernel (csrc/spgemm_general.cu) otherwise;
    # 'pallas_band' runs only the band kernel, for workloads known to
    # stay banded: a violated band assumption is detected (poisoned
    # fill count -> the on_overflow machinery), never silently wrong;
    # 'acc', 'cand' and 'dense' are the reference's XLA tiers in plain
    # torch (core/bell.py), for block sizes the kernels do not take.
    matmul_method: Optional[str] = None

    def copy(self) -> "SolverParameters":
        return replace(self)

    def monitor(self) -> Monitor:
        return Monitor(automatic=self.monitor_convergence,
                       tight_cutoff=self.converge_diff)

    def print(self):
        with sub_log("Parameters"):
            logger.write_element("be_verbose", self.be_verbose)
            logger.write_element("converge_diff", self.converge_diff)
            logger.write_element("threshold", self.threshold)
            logger.write_element("max_iterations", self.max_iterations)
            logger.write_element("do_load_balancing",
                                 self.do_load_balancing)
            logger.write_element("step_thresh", self.step_thresh)
            logger.write_element("monitor_convergence",
                                 self.monitor_convergence)
