"""Shared skeleton of the iterative solvers.

Counterpart of ``ntpoly_tpu/solvers/common.py``: resolve params ->
monitor -> verbose YAML header -> similarity transform into the
orthogonal basis -> optional load-balance permutation -> iterate with
the monitor -> undo the permutation -> transform back; and the chunked
driver (:func:`run_chunked`), which runs ``iters_per_sync`` iterations
of a solver's step per host read, for the nine loops the reference
chunks (PM, TRS2, TRS4, HPCP, Hotelling, CG, Newton-Schulz of order 2
and Taylor, sign).  Every other solver runs eagerly whatever
``iters_per_sync`` says, as in the reference.
"""
from __future__ import annotations

import contextlib
import gc
import warnings

import torch

from ..config import EMPTY
from ..core import bell
from ..parallel import algebra as alg
from ..parallel import pmatrix as PM
from ..utils import trace
from ..utils.errors import NTPolyError
from ..utils.logging import logger, sub_log
from ..utils.permutation import permute_matrix, undo_permute_matrix
from .parameters import SolverParameters, Monitor


def resolve(params: SolverParameters | None
            ) -> tuple[SolverParameters, Monitor]:
    params = params.copy() if params is not None else SolverParameters()
    return params, params.monitor()


class solver_log:
    """Verbose YAML block (header, method, citations, parameters), and
    the capacity policy of the solve: the pinned capacity
    params.k_out, 'grow' unless params.on_overflow is 'ignore'
    ('truncate') or 'warn' (checks deferred to one sync at the end).
    The whole block is one ``ntp.solve`` span (``utils/trace.py``),
    which starts a new solve id."""

    def __init__(self, params, header: str, method: str | None = None,
                 citations: tuple[str, ...] = (), extra: dict | None = None):
        self.params, self.header = params, header
        self.method, self.citations = method, citations
        self.extra = extra or {}
        self._policy = None
        self._span = None

    def __enter__(self):
        self._span = trace.span(trace.SOLVE)
        self._span.__enter__()
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
            method=self.params.matmul_method, defer=True,
            verbose=self.params.be_verbose)
        self._policy.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self._policy is not None:
                self._policy.__exit__(*exc)
                self._policy = None
            if self.params.be_verbose:
                logger.exit_sub_log()
        finally:
            self._span.__exit__(*exc)
            self._span = None
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
    """Log totals (and count them, ``solver.iterations``); with
    params.raise_on_nonconvergence, raise ConvergenceError when the
    monitor never fired."""
    trace.counts["solver.iterations"] += total_iterations
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
    v = trace.read(torch.stack([lo, hi, tr]))
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
    """A device scalar as a float (a counted host read,
    ``trace.read``); a number as it is."""
    if isinstance(x, torch.Tensor):
        return float(trace.read(x.reshape(())))
    return float(x)


# ----------------------------------------------------------------------------
# the chunked driver
# ----------------------------------------------------------------------------

def select_matrix(pred, a: PM.PSMatrix, b: PM.PSMatrix) -> PM.PSMatrix:
    """A where the device predicate ``pred`` holds, else B: a whole-matrix
    select with no host read (both of one shape, as under a pinned
    capacity)."""
    return a.with_data(torch.where(pred, a.col_ids, b.col_ids),
                       torch.where(pred, a.blocks, b.blocks))


def pad_capacity(m: PM.PSMatrix, k: int) -> PM.PSMatrix:
    """Widen (or keep) the slot capacity to exactly ``k``: m itself
    when it has k slots."""
    if m.k == k:
        return m
    if m.k > k:
        raise ValueError(f"pad_capacity cannot shrink {m.k} slots to {k}")
    return m.with_data(*bell.pad_slots(m.col_ids, m.blocks, k))


def pin_capacity(params, *mats, n_carry: int = 1):
    """The pinned capacity of a chunked solve, and the matrices: the
    user's ``k_out``, else 3x the structural fill of the first squaring
    (one host read), at least each carried matrix's capacity; only the
    first ``n_carry`` matrices (the carry, whose shapes a chunk keeps)
    are padded to it, every op taking mixed slot counts (reference
    ``density._pin_capacity``)."""
    x = mats[0]
    k_pin = params.k_out or min(x.panel_nb, 3 * alg.fill_bound(x, x))
    k_pin = max(k_pin, *(m.k for m in mats[:n_carry]))
    return k_pin, tuple(pad_capacity(m, k_pin) for m in mats[:n_carry]
                        ) + mats[n_carry:]


def _leaves(tree) -> list:
    """The tensors of a carry or its constants: PSMatrices (col ids,
    blocks), tensors, and tuples or lists of them, in order."""
    if isinstance(tree, PM.PSMatrix):
        return [tree.col_ids, tree.blocks]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    raise TypeError(f"a chunk's carry holds {type(tree).__name__}")


def _rebuild(like, leaves):
    """``like`` with its tensors taken in order from the iterator
    ``leaves`` (the inverse of :func:`_leaves`)."""
    if isinstance(like, PM.PSMatrix):
        return like.with_data(next(leaves), next(leaves))
    if isinstance(like, torch.Tensor):
        return next(leaves)
    return type(like)(_rebuild(t, leaves) for t in like)


def _signature(tree) -> tuple:
    """Shapes, dtypes and devices of the tensors, and each PSMatrix's
    dimension and block size: what a captured chunk is specialised to
    besides its step."""
    if isinstance(tree, PM.PSMatrix):
        return ("psmatrix", tree.dim, tree.bs, tree.k,
                tuple(tree.blocks.shape), str(tree.dtype), str(tree.device))
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype), str(tree.device))
    return tuple(_signature(t) for t in tree)


def chunk_steps(step_fn, params, k_pin: int, last_fn=None):
    """The chunk as device code: ``run(carry, consts, n)`` takes ``n``
    steps of ``step_fn`` (the last of them ``last_fn`` when given)
    under a collecting capacity policy at the pinned capacity ``k_pin``
    ('truncate'; every capacity-bounded op appends its exact structural
    fill, ``alg.capacity_policy``) -> (carry, the largest fill as a 0-d
    int32 tensor, the steps' scalars as a float64 tensor [n, scalars]).
    Nothing in it reads a device value to the host."""
    def run(carry, consts, n: int):
        fill = torch.zeros((), dtype=torch.int32,
                           device=_leaves(carry)[0].device)
        rows = []
        for i in range(n):
            coll: list = []
            fn = last_fn if last_fn is not None and i == n - 1 else step_fn
            with alg.capacity_policy(k_out=k_pin, on_overflow="truncate",
                                     precision=params.precision,
                                     method=params.matmul_method,
                                     collect=coll):
                carry, scal = fn(carry, *consts)
            for f in coll:
                fill = torch.maximum(fill, f.to(torch.int32))
            rows.append(torch.stack([v.to(torch.float64).reshape(())
                                     for v in scal]))
        return carry, fill, torch.stack(rows)
    return run


def _side_stream() -> torch.cuda.Stream:
    """The warm-ups' stream of the current device, one for the process
    (a library handle and its workspace are kept for every stream that
    uses one)."""
    dev = torch.cuda.current_device()
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream()
    return _SIDE[dev]


class _Graph:
    """A chunk captured once as a ``torch.cuda.CUDAGraph``.

    Its static inputs are copies of the carry's and the constants'
    tensors, made before the capture (a later solve with constants of
    the same shapes copies its own in, :meth:`load`).  One step is
    taken uncaptured on a side stream first (the warm-up
    ``torch.cuda.graphs`` asks for: kernel build, library handles; a
    chunk of one step, so the last step's form where the chunk's last
    differs), then the whole chunk is captured.  A capture launches
    nothing, so every counter of ``utils/trace.py`` bumped while
    capturing (kernel launches, multiplies, ...) is set back and its
    increment added on each replay instead.  Each call copies the carry
    into the static inputs, replays, and returns the graph's own
    outputs, which the next replay overwrites."""

    @trace.spanned("ntp.chunk.capture")
    def __init__(self, run, carry, consts, chunk: int, key):
        self.carry_in = [x.clone() for x in _leaves(carry)]
        self.const_in = [x.clone() for x in _leaves(consts)]
        c_in = _rebuild(carry, iter(self.carry_in))
        k_in = _rebuild(consts, iter(self.const_in))
        side = _side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(c_in, k_in, 1)
        torch.cuda.current_stream().wait_stream(side)
        before = trace.snapshot()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.out = run(c_in, k_in, chunk)
        except Exception as err:
            raise RuntimeError(f"capturing the chunk {key!r} failed: "
                               f"{err}") from err
        self.counted = trace.since(before)
        trace.restore(before)
        trace.counts["graph.captures"] += 1
        self.solve = None       # the solve whose constants it holds

    def load(self, consts) -> None:
        """Copy a solve's constants into the static inputs."""
        for dst, src in zip(self.const_in, _leaves(consts)):
            dst.copy_(src)

    @trace.spanned("ntp.chunk.replay")
    def __call__(self, carry):
        for dst, src in zip(self.carry_in, _leaves(carry)):
            if dst is not src:
                dst.copy_(src)
        self.graph.replay()
        trace.add(self.counted)
        trace.counts["graph.replays"] += 1
        return self.out


# the captured chunk, kept across solves under the key of what shapes its
# graph (one: each holds its private memory pool, about a chunk's peak
# of device memory, until another chunk is captured or release_graphs()
# is called)
_GRAPHS: dict = {}
_CAPTURE = [True]
_SIDE: dict = {}


def release_graphs() -> None:
    """Drop every captured chunk and return its memory to the card."""
    _GRAPHS.clear()
    if torch.cuda.is_initialized():
        gc.collect()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def uncaptured():
    """While open, chunks run uncaptured on every grid: the same device
    code that a graph replays (e.g. to hold a captured solve against
    it bit for bit)."""
    prev = _CAPTURE[0]
    _CAPTURE[0] = False
    try:
        yield
    finally:
        _CAPTURE[0] = prev


def captures(device: torch.device, ranks: int) -> bool:
    """Whether a chunk is captured as one CUDA graph: on a CUDA device
    with a grid of one rank.  A grid of several ranks runs the same
    chunk uncaptured: its collectives may stage card tensors through
    the host (gloo, ``dist.staged``)."""
    return _CAPTURE[0] and device.type == "cuda" and ranks == 1


def run_chunked(step_fn, carry0, consts, params, monitor, ilog, *,
                k_pin: int, aux_names=("Energy Value",), conv_index=0,
                conv_mode: str = "diff", cache_key=None,
                row_transform=None, last_step=None):
    """Drive ``step_fn`` ``params.iters_per_sync`` iterations per host
    read (reference ``run_chunked``, common.py:263-440).

    step_fn(carry, *consts) -> (carry_new, (scalar, ...)): device code
    with no host read, at static shapes (the carry's matrices padded to
    the pinned capacity ``k_pin``; the constants are not padded, every
    op takes mixed slot counts); ``last_step``, of the same form, takes
    its place as each chunk's last step, and must launch every kernel
    that ``step_fn`` launches (a capture's warm-up takes it alone).  A
    chunk (:func:`chunk_steps`) runs on the CPU, and on a grid of
    several ranks, as a plain loop; on a card with a grid of one rank
    (:func:`captures`) it is captured once per key as one CUDA graph and
    replayed (:class:`_Graph`), the key being ``cache_key`` (without
    one, the graph serves this solve only) with ``k_pin``, the chunk's
    length, the shapes and dtypes of the carry and the constants, the
    precision and the method.  A failed capture raises; nothing falls
    back.  The caller's carry is copied into the graph's inputs, never
    written.

    Once per chunk, one host read takes every step's scalars and the
    chunk's largest structural fill.  A fill of EMPTY (a violated band
    assumption under 'pallas_band') raises.  A fill over ``k_pin``:
    with ``on_overflow`` 'raise', raise; 'grow' below the panel width,
    re-pad the carry alone to the needed capacity and redo the chunk;
    'ignore', nothing; else warn ("exceeds pinned capacity").  Then the
    monitor replays the chunk's rows one at a time (``row_transform``
    maps each raw row first, e.g. to combine a compensated (hi, lo)
    energy), ``conv_mode`` 'diff' feeding it successive differences of
    row[conv_index] and 'value' the value itself, and stops at the
    first converged row; the carry returned is the one from the end of
    the chunk, up to iters_per_sync - 1 iterations past convergence,
    as in the reference.  -> (carry, history of the rows the monitor
    saw, their count)."""
    chunk = max(1, params.iters_per_sync)
    first = next(m for m in (carry0 if isinstance(carry0, (tuple, list))
                             else (carry0,)) if isinstance(m, PM.PSMatrix))
    cap = first.panel_nb
    mode = params.on_overflow
    captured = captures(first.grid.device, first.grid.n_devices)
    solve = object()            # marks the graphs this solve loaded

    def chunk_of(carry):
        run = chunk_steps(step_fn, params, k_pin, last_step)
        if not captured:
            return run(carry, consts, chunk)
        # without a cache_key, no later solve takes this graph
        key = (solve if cache_key is None else cache_key, k_pin, chunk,
               _signature(carry), _signature(consts), params.precision,
               params.matmul_method)
        graph = _GRAPHS.get(key)
        if graph is None:
            while _GRAPHS:
                _GRAPHS.popitem()
            graph = _Graph(run, carry, consts, chunk, key)
            _GRAPHS[key] = graph
        elif graph.solve is not solve:
            graph.load(consts)
        graph.solve = solve
        return graph(carry)

    def repad(tree, k_new):
        if isinstance(tree, PM.PSMatrix):
            return pad_capacity(tree, k_new)
        if isinstance(tree, (tuple, list)):
            return type(tree)(repad(t, k_new) for t in tree)
        return tree

    history = []
    prev = None
    total = 0
    while total < params.max_iterations:
        with trace.span("ntp.chunk"):
            new_carry, fill, scal = chunk_of(carry0)
            # the chunk's ONE host read: its rows and its largest fill
            vals = trace.read(torch.cat([scal.reshape(-1),
                                         fill.to(scal.dtype).reshape(1)]))
            need = int(vals[-1])
            rows = [vals[i * scal.shape[1]:(i + 1) * scal.shape[1]]
                    for i in range(chunk)]
            if need >= EMPTY:
                raise NTPolyError(
                    "chunked solve: matmul_method='pallas_band' operands "
                    "violate the band assumption; rerun without the method "
                    "override")
            if need > k_pin and mode != "ignore":
                msg = (f"chunked solve: structural fill {need} exceeds pinned "
                       f"capacity {k_pin} — results truncated this chunk")
                if mode == "raise":
                    raise NTPolyError(msg)
                if mode == "grow" and k_pin < cap:
                    # redo the chunk at the needed capacity; only the carry
                    # is padded
                    del new_carry, fill, scal
                    trace.counts["chunk.redos"] += 1
                    k_pin = min(alg._k_bucket(need, cap), cap)
                    carry0 = repad(carry0, k_pin)
                    if params.be_verbose:
                        logger.write_comment(
                            f"capacity regrown to {k_pin} (fill {need}); "
                            "chunk redone")
                    continue
                warnings.warn(msg)
                if ilog is not None and params.be_verbose:
                    logger.write_comment(msg)
            carry0 = new_carry
            converged = False
            for raw in rows:
                row = tuple(raw)
                if row_transform is not None:
                    row = row_transform(row)
                history.append(row)
                total += 1
                if conv_mode == "diff":
                    val = row[conv_index] if prev is None \
                        else row[conv_index] - prev
                    prev = row[conv_index]
                else:
                    val = row[conv_index]
                monitor.append(val)
                if ilog is not None:
                    ilog.step(**{name: row[i]
                                 for i, name in enumerate(aux_names)})
                if monitor.check_converged(params.be_verbose):
                    converged = True
                    break
            if converged:
                break
    if captured:
        # the graph's outputs are overwritten by its next replay
        carry0 = _rebuild(carry0, iter([x.clone()
                                        for x in _leaves(carry0)]))
    return carry0, history, total
