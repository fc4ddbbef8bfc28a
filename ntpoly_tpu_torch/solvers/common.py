"""Shared skeleton of the iterative solvers.

Counterpart of ``ntpoly_tpu/solvers/common.py`` (the eager parts):
resolve params -> monitor -> verbose YAML header -> working Hamiltonian
-> iterate with the monitor -> transform back.  The chunked driver of
the reference (``run_chunked``) is ROADMAP Queue A item 7.
"""
from __future__ import annotations

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..utils.logging import logger, sub_log
from .parameters import SolverParameters, Monitor


def resolve(params: SolverParameters | None
            ) -> tuple[SolverParameters, Monitor]:
    params = params.copy() if params is not None else SolverParameters()
    return params, params.monitor()


class solver_log:
    """Verbose YAML block (header, method, citations, parameters), and
    the capacity policy of the solve: the pinned capacity
    params.k_out, 'grow' unless params.on_overflow is 'ignore'
    ('truncate') or 'warn' (checks deferred to one sync at the end)."""

    def __init__(self, params, header: str, method: str | None = None,
                 citations: tuple[str, ...] = ()):
        self.params, self.header = params, header
        self.method, self.citations = method, citations
        self._policy = None

    def __enter__(self):
        if self.params.be_verbose:
            logger.write_header(self.header)
            logger.enter_sub_log()
            if self.method:
                logger.write_element("Method", self.method)
            if self.citations:
                with sub_log("Citations"):
                    for c in self.citations:
                        logger.write_list_element(c)
            self.params.print()
        eager_mode = {"ignore": "truncate", "warn": "warn"}.get(
            self.params.on_overflow, "grow")
        self._policy = alg.capacity_policy(
            k_out=self.params.k_out, on_overflow=eager_mode,
            precision=self.params.precision,
            method=self.params.matmul_method, defer=True)
        self._policy.__enter__()
        return self

    def __exit__(self, *exc):
        if self._policy is not None:
            self._policy.__exit__(*exc)
            self._policy = None
        if self.params.be_verbose:
            logger.exit_sub_log()
        return False


class iteration_log:
    def __init__(self, params):
        self.params = params

    def __enter__(self):
        if self.params.be_verbose:
            logger.write_header("Iterations")
            logger.enter_sub_log()
        return self

    def step(self, **kv):
        """One per-iteration list item: the first key starts the item,
        the rest nest."""
        if self.params.be_verbose:
            items = list(kv.items())
            logger.write_list_element(key=items[0][0], value=items[0][1])
            with sub_log():
                for key, val in items[1:]:
                    logger.write_element(key, val)

    def __exit__(self, *exc):
        if self.params.be_verbose:
            logger.exit_sub_log()
        return False


def finish_iterations(params, total_iterations, mat=None, monitor=None,
                      solver: str = "Solver"):
    """Log totals; with params.raise_on_nonconvergence, raise
    ConvergenceError when the monitor never fired."""
    if params.be_verbose:
        logger.write_element("Total Iterations", total_iterations)
        if mat is not None:
            print_matrix_information(mat)
    if (monitor is not None and params.raise_on_nonconvergence
            and not monitor.converged):
        from ..utils.errors import ConvergenceError
        raise ConvergenceError(solver, total_iterations,
                               monitor.win_short[-1])


def print_matrix_information(mat):
    with sub_log("Matrix Information"):
        logger.write_element("Dimension", mat.dim)
        nnz = mat.nnz
        logger.write_element("Nonzeros", nnz)
        logger.write_element("Sparsity", nnz / float(mat.dim) ** 2)


def known_identity(m) -> bool:
    """True when m is the identity: free for a tagged identity
    (PM.identity), else one device check and one readback."""
    if getattr(m, "_known_identity", False):
        return True
    return m.k <= 1 and alg.is_identity(m)


def prologue_scalars(wh):
    """(e_min, e_max, trace) of the working Hamiltonian in ONE
    readback."""
    import torch
    lo, hi = alg.gershgorin_bounds(wh)
    tr = alg.trace(wh)
    v = torch.stack([lo, hi, tr]).tolist()
    return float(v[0]), float(v[1]), float(v[2])


def orthogonalize(h, isq, params):
    """WH = ISQ @ H @ ISQ^T.  An identity ISQ short-circuits (H itself;
    matrices are immutable).  Any other ISQ needs similarity_transform,
    which is not ported yet."""
    if known_identity(isq):
        return h, isq
    raise ValueError(
        "a non-identity ISQ needs similarity_transform, which is not "
        "ported yet (ROADMAP Queue A item 3)")


def deorthogonalize(x, isq, isqt, params):
    """K = ISQ^T @ X @ ISQ; the identity short-circuit of
    :func:`orthogonalize` returned isqt IS isq."""
    if isqt is isq:
        return x
    raise ValueError(
        "a non-identity ISQ needs similarity_transform, which is not "
        "ported yet (ROADMAP Queue A item 3)")


def identity_like(mat) -> PM.PSMatrix:
    """Identity at capacity 1 (every op handles mixed slot counts)."""
    return PM.identity(mat.dim, bs=mat.bs, dtype=mat.dtype, grid=mat.grid)


def real_scalar(x) -> float:
    return float(x)
