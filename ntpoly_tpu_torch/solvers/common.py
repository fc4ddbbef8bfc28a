"""Shared skeleton of the iterative solvers.

Counterpart of ``ntpoly_tpu/solvers/common.py`` (the eager parts):
resolve params -> monitor -> verbose YAML header -> similarity
transform into the orthogonal basis -> optional load-balance
permutation -> iterate with the monitor -> undo the permutation ->
transform back.  The chunked driver of the reference (``run_chunked``)
is ROADMAP Queue A item 7: every solver refuses ``iters_per_sync > 1``
through :func:`eager_only`.
"""
from __future__ import annotations

from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..utils.logging import logger, sub_log
from ..utils.permutation import permute_matrix, undo_permute_matrix
from .parameters import SolverParameters, Monitor


def resolve(params: SolverParameters | None
            ) -> tuple[SolverParameters, Monitor]:
    params = params.copy() if params is not None else SolverParameters()
    return params, params.monitor()


def eager_only(params: SolverParameters) -> None:
    """Refuse the chunked driver's setting."""
    if params.iters_per_sync > 1:
        raise ValueError(
            "iters_per_sync > 1 needs the chunked driver, which is not "
            "ported yet (ROADMAP Queue A item 7)")


class solver_log:
    """Verbose YAML block (header, method, citations, parameters), and
    the capacity policy of the solve: the pinned capacity
    params.k_out, 'grow' unless params.on_overflow is 'ignore'
    ('truncate') or 'warn' (checks deferred to one sync at the end)."""

    def __init__(self, params, header: str, method: str | None = None,
                 citations: tuple[str, ...] = (), extra: dict | None = None):
        self.params, self.header = params, header
        self.method, self.citations = method, citations
        self.extra = extra or {}
        self._policy = None

    def __enter__(self):
        if self.params.be_verbose:
            logger.write_header(self.header)
            logger.enter_sub_log()
            if self.method:
                logger.write_element("Method", self.method)
            for key, val in self.extra.items():
                logger.write_element(key, val)
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
    """WH = ISQ @ H @ ISQ^H -> (WH, ISQ^H).  An identity ISQ
    short-circuits before the transpose (H itself, and ISQ as its own
    transpose; matrices are immutable)."""
    if known_identity(isq):
        return h, isq
    isqt = alg.transpose(isq).conjugate()
    wh = alg.similarity_transform(h, isq, isqt, threshold=params.threshold)
    return wh, isqt


def deorthogonalize(x, isq, isqt, params):
    """K = ISQ^H @ X @ ISQ; the identity short-circuit of
    :func:`orthogonalize` returned isqt IS isq."""
    if isqt is isq:
        return x
    return alg.similarity_transform(x, isqt, isq, threshold=params.threshold)


def maybe_permute(params, *mats):
    """Each matrix permuted by params.balance_permutation when load
    balancing is on, else the matrices as they are (a tuple)."""
    if params.do_load_balancing and params.balance_permutation is not None:
        return tuple(permute_matrix(m, params.balance_permutation,
                                    params.threshold) for m in mats)
    return mats


def maybe_unpermute(params, mat):
    if params.do_load_balancing and params.balance_permutation is not None:
        return undo_permute_matrix(mat, params.balance_permutation,
                                   params.threshold)
    return mat


def identity_like(mat) -> PM.PSMatrix:
    """Identity at capacity 1 (every op handles mixed slot counts)."""
    return PM.identity(mat.dim, bs=mat.bs, dtype=mat.dtype, grid=mat.grid)


def real_scalar(x) -> float:
    return float(x)
