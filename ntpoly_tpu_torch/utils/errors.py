"""Typed error discipline (reference Source/Fortran/ErrorModule.F90:8-207).

The reference carries an Error_t record through IO and solver calls and
aborts with a printed message; the idiomatic Python equivalent is a typed
exception hierarchy so callers can catch precisely.  Solvers additionally
surface non-convergence through the YAML log (the reference logs totals
and leaves detection to the caller; here `ConvergenceError` is available
for strict callers via SolverParameters.monitor_convergence handling).
"""
from __future__ import annotations


class NTPolyError(Exception):
    """Base class for all library errors."""


class GridError(NTPolyError, ValueError):
    """Invalid process-grid shape (reference ProcessGridModule.F90:162-176
    constraint checks)."""


class IOFormatError(NTPolyError, ValueError):
    """Malformed Matrix Market / binary checkpoint input (reference
    MatrixMarketModule.F90 ParseMMHeader error paths)."""


class ComplexSupportError(NTPolyError, TypeError):
    """Complex arithmetic asked of the real-only SpGEMM kernels.  Complex
    matrices are stored as they are; multiply their 2x2 real embedding
    (``core/cplx.py``) instead."""


class MatrixDimensionError(NTPolyError, ValueError):
    """A matrix dimension exceeds a representational bound (e.g. the int32
    coordinate payload of the multi-process triplet exchange)."""


class ConvergenceError(NTPolyError, RuntimeError):
    """An iterative solver hit max_iterations without satisfying its
    convergence monitor."""

    def __init__(self, solver: str, iterations: int, last_value: float):
        super().__init__(
            f"{solver} did not converge in {iterations} iterations "
            f"(last convergence value {last_value:g})")
        self.solver = solver
        self.iterations = iterations
        self.last_value = last_value
