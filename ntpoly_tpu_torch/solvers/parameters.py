"""Solver parameters and the convergence monitor.

Copied from ``ntpoly_tpu/solvers/parameters.py``: the fields, their
defaults and the monitor's rules are the reference's exactly, so a
solve makes the same decisions in both packages.  Fields that name TPU
behaviour keep their names; ``precision`` and ``matmul_method`` mean
here what ``ops/spgemm.py`` and ``parallel/algebra.py`` say.

Faithful ports of the control logic that gates every iterative solver:
reference Source/Fortran/SolverParametersModule.F90:14-113 and
ConvergenceMonitorModule.F90:122-191 (the windowed automatic-detection rules
must match exactly for iteration-count parity with the reference).
"""
from __future__ import annotations

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
        # upticks immediately, while the windowed rules wait ~5 more
        # iterations for the long average to wash out the decay tail
        # (measured: trs4_10k at precision='high' took 14 iterations
        # windowed vs 9 for the energy monitor at 'highest').
        self.plateau = plateau
        self.converged = False          # set once check_converged fires

    def append(self, value: float):
        self.win_short = self.win_short[1:] + [float(value)]
        self.win_long = self.win_long[1:] + [float(value)]
        self.nval += 1

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
    """reference SolverParametersModule.F90:14-113 plus TPU-specific knobs."""
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
    # TPU-native extensions (absent in the reference): block capacity policy.
    k_out: Optional[int] = None          # slots per block-row for results
    row_chunk: Optional[int] = None      # SpGEMM accumulator chunking
    # Iterations fused into one compiled lax.scan between host syncs (1 =
    # exact reference semantics: converge check every iteration).  Higher
    # values amortize dispatch latency; the solve may overrun convergence
    # by up to iters_per_sync - 1 harmless extra iterations.
    iters_per_sync: int = 1
    # Chunked-mode response when measured structural fill exceeds the
    # pinned capacity: 'grow' (redo chunk at the needed capacity — the
    # reference's never-drop pool growth), 'warn', 'raise', 'ignore'.
    # Truncation quality note ('truncate'/'warn'/'ignore', or 'grow'
    # capped at the panel width): overflowing rows keep the k_out LOWEST
    # column ids — a structural rule, cheap in-kernel — not the k_out
    # largest-norm blocks, so a truncated solve can drop a row's
    # numerically largest block.  Size k_out (or let 'grow' run) so
    # truncation never fires on converged workloads.
    on_overflow: str = "grow"
    # MXU pass count for the SpGEMM kernel: 'high' (3 bf16 passes,
    # ~2x MXU throughput, ~1e-6 relative dot error — the DEFAULT since
    # r5: at solver level it converges in 10 iterations vs 9 for
    # 'highest' on the trs4_10k bench with oracle error 1.4e-5, well
    # inside the reference's 1e-4 acceptance bar, using the
    # plateau-robust idempotency monitor that 'auto' selects for it) or
    # 'highest' (full f32, 6 passes — exact energy-diff reference
    # parity, opt-in for tolerance-critical work).
    precision: str = "high"
    # Convergence functional for the purification solvers (PM / TRS2 /
    # TRS4 / HPCP).  'energy' = successive energy differences (exact
    # reference parity, DensityMatrixSolversModule.F90:192-197);
    # 'idempotency' = the per-electron idempotency residual
    # (tr(X) - tr(X^2)) / nel, monitored as a value.  The residual
    # decays quadratically and then PLATEAUS at the arithmetic floor,
    # where the windowed automatic monitor fires deterministically —
    # energy differences instead wander in the reduced-precision noise
    # (precision='high' cost trs4_10k 23 iterations vs 8 in r4).
    # 'auto' (default): 'energy' at precision='highest', 'idempotency'
    # otherwise.
    convergence_metric: str = "auto"
    # Compensated (two-float) scalar reductions for the monitor scalars
    # and reported energy: f32 quantizes an |E|~1e5 energy at ~0.01
    # absolute, so converge_diff below that is uncertifiable at the
    # 2^20-row scale without this.  The matmul stream stays f32; only
    # trace/dot feeding sigma, the monitor, and the energy pay the ~4
    # extra VPU passes (core/bell.py comp_sum).
    compensated_scalars: bool = False
    # SpGEMM dispatch override (None = measured auto gates).  The main
    # production value is 'pallas_band': compile ONLY the windowed band
    # kernel for workloads known to stay banded — the auto dispatch's
    # runtime cond also compiles the general fallback arm, whose chunk
    # buffers cost ~5 GB of reserved HBM at the 2^20-row bench shape.
    # A violated band assumption is detected (poisoned fill count ->
    # the on_overflow machinery), never silently wrong.
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
