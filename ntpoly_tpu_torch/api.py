"""NTPoly-compatible object API.

Counterpart of ``ntpoly_tpu/api.py``: the reference's SWIG Python
module (``import NTPolySwig as nt``, reference Source/Swig/NTPolySwig.i
and the C++ classes in Source/CPlusPlus/), mirrored class for class and
method for method, with its output-argument conventions and the SWIG
``%apply double& OUTPUT`` pattern (out-doubles become return values):

    import ntpoly_tpu_torch as nt

Under it is the port's functional core: PSMatrix handles on the
one-device grid, on the CUDA card unless the grid was constructed on
another device (``ConstructGlobalProcessGrid(..., device="cpu")``).
Wrapper objects hold a handle (``._m``) and "mutate" by handle
replacement; the copy constructor shares the handle.

The port's kernels are real, so complex data is always held as its
2 x 2 real embedding E(A + iB) = [[A, -B], [B, A]] of twice the
dimension (``core/cplx.py``), as the JAX package holds it on the TPU.
``_embedded``/``_cdim`` track that state: accessors translate, density
solvers double the trace target and halve reported energies.  The
paths that do not commute with the embedding (eigen- and singular
value decompositions, the dimension reduction, Hadamard products, the
complex dot and norm) extract the complex matrix and compute on it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import native as _native
from .config import DEFAULT_BLOCK_SIZE, default_complex_dtype, \
    default_real_dtype
from .core import cplx as _cplx
from .core.lmatrix import LocalMatrix as _LocalMatrix
from .io import binary as _bin
from .io import matrix_market as _mm
from .parallel import algebra as _alg
from .parallel import dist as _dist
from .parallel import grid as _grid
from .parallel import pmatrix as _pm
from .solvers import (analysis as _analysis, chebyshev as _cheb,
                      density as _density, eigen as _eigen,
                      eigenbounds as _bounds, exponential as _exp,
                      fermi as _fermi, geometry as _geo, hermite as _herm,
                      inverse as _inv, linear as _linear,
                      polynomial as _poly, roots as _roots, sign as _sign,
                      squareroot as _sqrt, trigonometry as _trig)
from .solvers.parameters import SolverParameters as _Params
from .utils import maps as _maps
from .utils import permutation as _perm
from .utils import timer as _timer
from .utils.errors import ComplexSupportError
from .utils.logging import activate_logger as _activate, \
    deactivate_logger as _deactivate, logger as _logger


# ----------------------------------------------------------------------------
# Process grid (reference ProcessGridModule wrapper surface)
# ----------------------------------------------------------------------------

def ConstructGlobalProcessGrid(process_rows=None, process_columns=None,
                               process_slices=1, *args, device=None):
    """reference ConstructProcessGrid (ProcessGridModule.F90:84-97).

    The grid over the world's ranks (``parallel/dist.py``), rows x
    columns x slices with the reference's rules, auto-sized when rows
    or columns are not given; without a world it is 1 x 1 x 1.  Matrices
    live on ``device``: ``cuda:{LOCAL_RANK}`` in a world, the CUDA card
    without one, unless named.  Collective in a world.  A process
    started by ``torchrun`` (``WORLD_SIZE`` in its environment) joins
    its world here if it has not yet (``dist.initialize``)."""
    import os
    if "WORLD_SIZE" in os.environ and not torch.distributed.is_initialized():
        _dist.initialize()
    _grid.construct_global_grid(process_rows, process_columns,
                                process_slices, device=device)


def DestructGlobalProcessGrid():
    _grid.destruct_global_grid()


def GetGlobalIsRoot() -> bool:
    return _dist.process_index() == 0


def GetGlobalNumRows() -> int:
    return _grid.global_grid().rows


def GetGlobalNumColumns() -> int:
    return _grid.global_grid().cols


def GetGlobalNumSlices() -> int:
    return _grid.global_grid().slices


def GetGlobalMyRow() -> int:
    return _grid.global_grid().my_row


def GetGlobalMyColumn() -> int:
    return _grid.global_grid().my_col


def GetGlobalMySlice() -> int:
    return _grid.global_grid().my_slice


def _write_grid(g):
    _logger.write_header("Process Grid")
    _logger.enter_sub_log()
    _logger.write_element("Process Rows", g.rows)
    _logger.write_element("Process Columns", g.cols)
    _logger.write_element("Process Slices", g.slices)
    _logger.exit_sub_log()


def WriteGridInfo():
    """reference WriteGridInfo (Source/CPlusPlus/ProcessGrid.h:111)."""
    _write_grid(_grid.global_grid())


class ProcessGrid(_grid.ProcessGrid):
    """Custom (non-global) grid; reference
    Source/CPlusPlus/ProcessGrid.h.  My{Row,Column,Slice} are this
    rank's coordinates."""

    def GetMyRow(self) -> int:
        return self.my_row

    def GetMyColumn(self) -> int:
        return self.my_col

    def GetMySlice(self) -> int:
        return self.my_slice

    def GetNumRows(self) -> int:
        return self.rows

    def GetNumColumns(self) -> int:
        return self.cols

    def GetNumSlices(self) -> int:
        return self.slices

    def WriteInfo(self):
        _write_grid(self)


# ----------------------------------------------------------------------------
# Logging / timers
# ----------------------------------------------------------------------------

def ActivateLogger(file_name=None, append=False):
    if isinstance(file_name, bool):      # ActivateLogger(True) -> stdout
        _activate(None)
    else:
        _activate(file_name, append)


def DeactivateLogger():
    _deactivate()


def EnterSubLog():
    _logger.enter_sub_log()


def ExitSubLog():
    _logger.exit_sub_log()


def WriteHeader(key):
    _logger.write_header(key)


def WriteElement(key, value=None):
    _logger.write_element(key, value)


def WriteListElement(key, value=None):
    _logger.write_list_element(key, value)


RegisterTimer = _timer.register_timer
StartTimer = _timer.start_timer
StopTimer = _timer.stop_timer
PrintAllTimers = _timer.print_all_timers
PrintAllTimersDistributed = _timer.print_all_timers_distributed


# ----------------------------------------------------------------------------
# Triplets (reference TripletModule / TripletListModule)
# ----------------------------------------------------------------------------

class Triplet_r:
    def __init__(self, index_row=0, index_column=0, point_value=0.0):
        self.index_row = index_row
        self.index_column = index_column
        self.point_value = point_value


class Triplet_c(Triplet_r):
    pass


class TripletList_r:
    """Growable COO list (reference TripletListModule.F90:14-27), held
    as numpy arrays (1-based indices, as the reference's): ``Append``
    grows them by doubling, and the fills read them whole
    (``_arrays``/``_from_arrays``), with no Python object per
    triplet."""
    _complex = False

    def __init__(self, size: int = 0):
        self._n = size
        self._r = np.zeros(size, np.int64)
        self._c = np.zeros(size, np.int64)
        self._v = np.zeros(size, self._value_dtype())

    @classmethod
    def _value_dtype(cls):
        return np.complex128 if cls._complex else np.float64

    @property
    def rows(self) -> np.ndarray:
        return self._r[:self._n]

    @property
    def columns(self) -> np.ndarray:
        return self._c[:self._n]

    @property
    def values(self) -> np.ndarray:
        return self._v[:self._n]

    def _reserve(self, need: int):
        if need <= len(self._r):
            return
        cap = max(need, 2 * len(self._r), 16)
        for name in ("_r", "_c", "_v"):
            old = getattr(self, name)
            new = np.zeros(cap, old.dtype)
            new[:self._n] = old[:self._n]
            setattr(self, name, new)

    # -- reference API ---------------------------------------------------
    def Append(self, triplet):
        self._reserve(self._n + 1)
        n = self._n
        self._r[n] = triplet.index_row
        self._c[n] = triplet.index_column
        self._v[n] = triplet.point_value
        self._n = n + 1

    def GetSize(self) -> int:
        return self._n

    def GetTripletAt(self, index: int):
        t = Triplet_c() if self._complex else Triplet_r()
        t.index_row = int(self._r[index])
        t.index_column = int(self._c[index])
        v = self._v[index]
        t.point_value = complex(v) if self._complex else float(v)
        return t

    def SetTripletAt(self, index: int, triplet):
        self._r[index] = triplet.index_row
        self._c[index] = triplet.index_column
        self._v[index] = triplet.point_value

    def Resize(self, size: int):
        self._reserve(size)
        for arr in (self._r, self._c, self._v):
            arr[self._n:size] = 0
        self._n = size

    def SortTripletList(self, matrix_size: int | None = None):
        n = self._n
        order = np.lexsort((self._r[:n], self._c[:n]))
        for arr in (self._r, self._c, self._v):
            arr[:n] = arr[:n][order]

    # -- internal --------------------------------------------------------
    def _arrays(self):
        """(rows, cols, vals) 0-based, values in the default dtype."""
        dtype = default_complex_dtype() if self._complex \
            else default_real_dtype()
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        return self.rows - 1, self.columns - 1, self.values.astype(np_dtype)

    @classmethod
    def _from_arrays(cls, rows, cols, vals):
        out = cls(0)
        out._r = np.asarray(rows, np.int64) + 1
        out._c = np.asarray(cols, np.int64) + 1
        out._v = np.asarray(vals).astype(cls._value_dtype())
        out._n = len(out._r)
        return out

    def _take(self, other: "TripletList_r"):
        """Replace this list's contents with ``other``'s."""
        self._r, self._c, self._v, self._n = (other._r, other._c, other._v,
                                              other._n)


class TripletList_c(TripletList_r):
    _complex = True


# ----------------------------------------------------------------------------
# SolverParameters / Permutation
# ----------------------------------------------------------------------------

class Permutation(_perm.Permutation):
    """reference Source/CPlusPlus/Permutation.h -- stores the dimension
    at construction; Set*Permutation() then builds the lookup."""

    def __init__(self, matrix_dimension: int | None = None):
        super().__init__()
        self._dim = matrix_dimension

    def SetDefaultPermutation(self, dim=None):
        self.set_default_permutation(dim or self._dim)

    def SetReversePermutation(self, dim=None):
        self.set_reverse_permutation(dim or self._dim)

    def SetRandomPermutation(self, dim=None):
        self.set_random_permutation(dim or self._dim)

    def SetLimitedRandomPermutation(self, actual_dim=None, logical_dim=None):
        self.set_limited_random_permutation(actual_dim or self._dim,
                                            logical_dim or self._dim)


class SolverParameters:
    """reference Source/CPlusPlus/SolverParameters.h setters."""

    def __init__(self):
        self._p = _Params()

    def SetConvergeDiff(self, value):
        self._p.converge_diff = value

    def SetMaxIterations(self, value):
        self._p.max_iterations = int(value)

    def SetThreshold(self, value):
        self._p.threshold = value

    def SetVerbosity(self, value):
        self._p.be_verbose = bool(value)

    def SetLoadBalance(self, permutation):
        self._p.do_load_balancing = True
        self._p.balance_permutation = permutation

    def SetStepThreshold(self, value):
        self._p.step_thresh = value

    def SetItersPerSync(self, value):
        """Iterations between host convergence checks (1 = the
        reference's per-iteration semantics).  With more, the nine loops
        that the reference chunks run that many iterations per host read
        (``solvers/common.run_chunked``; one CUDA graph a chunk on a
        card with a grid of one rank), and may run up to that many
        less one past convergence."""
        self._p.iters_per_sync = int(value)

    def SetMonitorConvergence(self, value):
        self._p.monitor_convergence = bool(value)


def _params_of(sp: SolverParameters | None) -> _Params:
    return sp._p if sp is not None else _Params()


# ----------------------------------------------------------------------------
# Matrix_ps
# ----------------------------------------------------------------------------

def _auto_bs(dim: int) -> int:
    if dim >= 1024:
        return DEFAULT_BLOCK_SIZE
    if dim >= 256:
        return 32
    if dim >= 32:
        return 8
    return 4


def _require_same_embedding(*mats) -> None:
    """Mixed embedded/plain operands would fail deep in the stack on a
    dimension mismatch (the embedding doubles it); raise a typed,
    actionable error instead."""
    if len({m._embedded for m in mats}) > 1:
        raise ComplexSupportError(
            "operands mix an embedded complex matrix with a plain real "
            "one; build the real operand from the embedded container "
            "(e.g. M2 = Matrix_ps(M1); M2.FillIdentity()) so both share "
            "the embedding")


def _propagate(dst: "Matrix_ps", src: "Matrix_ps") -> None:
    """Copy the embedding state: f(E(C)) = E(f(C)) for every matrix
    function here, so outputs of embedded inputs are embedded."""
    dst._embedded, dst._cdim = src._embedded, src._cdim


def _no_complex_scalar(value, embedded: bool, what: str) -> None:
    if np.iscomplexobj(value) and embedded:
        raise TypeError(f"complex {what} requires native complex; real "
                        f"{what}s commute with the embedding")


class PMatrixMemoryPool:
    """Capacity is managed by the algebra; kept for signature parity
    (reference PMatrixMemoryPoolModule.F90:12-18)."""

    def __init__(self, matrix=None):
        self.matrix = matrix


class Matrix_ps:
    """reference Source/CPlusPlus/PSMatrix.h:20-200.

    Complex data is held as the 2 x 2 real embedding of twice the
    dimension (see the module's docstring); ``_embedded``/``_cdim``
    track that state.  The reference holds complex natively through
    every layer (PSMatrixModule.F90:1673-1703)."""

    _embedded = False                  # class-level defaults
    _cdim = None

    def __init__(self, arg, *extra):
        grid = None
        is_binary = False
        for e in extra:
            if isinstance(e, bool):
                is_binary = e
            elif isinstance(e, _grid.ProcessGrid):
                grid = e
        if isinstance(arg, Matrix_ps):                 # copy constructor
            self._m = arg._m
            self._embedded, self._cdim = arg._embedded, arg._cdim
        elif isinstance(arg, _pm.PSMatrix):
            self._m = arg
        elif isinstance(arg, str):
            reader = _bin if is_binary else _mm
            i, j, v, dim = reader.read_triplets(arg)
            self._fill_triplets(i, j, v, dim, grid=grid)
        else:
            dim = int(arg)
            self._m = _pm.empty(dim, bs=_auto_bs(dim),
                                dtype=default_real_dtype(), grid=grid)

    def _fill_triplets(self, i, j, v, dim, grid=None, bs=None, k=None):
        grid = grid or (self._m.grid if hasattr(self, "_m") else None)
        if np.iscomplexobj(v):
            i, j, v, dim2 = _cplx.embed_triplets(i, j, v, dim)
            m = _pm.empty(dim2, bs=bs or _auto_bs(dim2),
                          dtype=default_real_dtype(), grid=grid)
            self._m = _pm.fill_from_triplets(m, i, j, v)
            self._embedded, self._cdim = True, dim
            return
        m = _pm.empty(dim, bs=bs or _auto_bs(dim), k=k,
                      dtype=default_real_dtype(), grid=grid)
        self._m = _pm.fill_from_triplets(m, i, j, v)
        self._embedded, self._cdim = False, None

    def _triplets(self):
        """Stored triplets in the user's coordinates (complex when
        embedded)."""
        r, c, v = _pm.to_triplets(self._m)
        if self._embedded:
            return _cplx.extract_triplets(r, c, v, self._m.dim)[:3]
        return r, c, v

    # -- IO --------------------------------------------------------------
    def WriteToMatrixMarket(self, file_name: str):
        if self._embedded:
            r, c, v = self._triplets()
            if GetGlobalIsRoot():
                _mm.write_triplets(file_name, r, c, v, self._cdim)
            return
        _mm.write(self._m, file_name)

    def WriteToBinary(self, file_name: str):
        if self._embedded:
            r, c, v = self._triplets()
            if GetGlobalIsRoot():
                _bin.write_triplets(file_name, r, c, v, self._cdim)
            return
        _bin.write(self._m, file_name)

    # -- fills -----------------------------------------------------------
    def FillFromTripletList(self, triplet_list):
        i, j, v = triplet_list._arrays()
        dim = self._cdim if self._embedded else self._m.dim
        self._fill_triplets(i, j, v, dim, grid=self._m.grid,
                            bs=self._m.bs, k=self._m.k)

    def FillIdentity(self):
        self._m = _pm.identity(self._m.dim, bs=self._m.bs, k=self._m.k,
                               dtype=self._m.dtype, grid=self._m.grid)

    def FillDense(self):
        """Every entry 1, built on the device."""
        m = self._m
        self._m = _pm.banded(m.dim, m.dim, _ones_fn, bs=m.bs, grid=m.grid,
                             dtype=m.dtype)

    def FillDistributedPermutation(self, lb, permuterows=True):
        p_rows, p_cols = _perm.permutation_matrices(lb, self._m)
        self._m = p_rows if permuterows else p_cols

    # -- accessors -------------------------------------------------------
    def GetActualDimension(self) -> int:
        return self._cdim if self._embedded else self._m.dim

    def GetLogicalDimension(self) -> int:
        return self._m.logical_dim

    def GetSize(self) -> int:
        """Stored nonzero count (the embedded path extracts the complex
        triplets on the host)."""
        if self._embedded:
            return len(self._triplets()[2])
        return self._m.nnz

    def GetTripletList(self, triplet_list):
        r, c, v = self._triplets()
        order = np.lexsort((c, r))
        triplet_list._take(type(triplet_list)._from_arrays(
            r[order], c[order], v[order]))

    def GetMatrixBlock(self, triplet_list, start_row, end_row, start_column,
                       end_column):
        r, c, v = self._triplets()
        keep = ((r >= start_row) & (r < end_row)
                & (c >= start_column) & (c < end_column))
        triplet_list._take(type(triplet_list)._from_arrays(
            r[keep], c[keep], v[keep]))

    def GetMatrixSlice(self, submatrix, start_row, end_row, start_column,
                       end_column):
        if self._embedded:
            r, c, v = self._triplets()
            keep = ((r >= start_row) & (r <= end_row)
                    & (c >= start_column) & (c <= end_column))
            dim = max(end_row - start_row, end_column - start_column) + 1
            submatrix._fill_triplets(
                r[keep] - start_row, c[keep] - start_column, v[keep], dim,
                grid=self._m.grid, bs=self._m.bs)
            return
        submatrix._m = _pm.get_slice(self._m, start_row, end_row + 1,
                                     start_column, end_column + 1)

    def IsIdentity(self) -> bool:
        """reference PSMatrixModule.F90:1810-1852 (one pass on the
        device)."""
        return _alg.is_identity(self._m)

    # -- structure -------------------------------------------------------
    @staticmethod
    def _embed_sign(m, cdim):
        """P = diag(+I_cdim, -I): E(conj C) = P E(C) P (conjugation flips
        the imaginary blocks' signs).  The boundary is the complex
        dimension cdim, not logical_dim // 2, which drifts whenever the
        block geometry pads the embedded matrix."""
        d = torch.where(torch.arange(m.logical_dim, device=m.device) < cdim,
                        1.0, -1.0)
        return _alg.diagonal_scale(
            _alg.diagonal_scale(m, d, side="left"), d, side="right")

    def Transpose(self, matA: "Matrix_ps"):
        t = _alg.transpose(matA._m)
        # embedded: E(A)^T = E(A^H); the plain transpose needs the
        # conjugation fix-up P E(A)^T P = E(A^T)
        self._m = self._embed_sign(t, matA._cdim) if matA._embedded else t
        _propagate(self, matA)

    def Conjugate(self):
        if self._embedded:
            self._m = self._embed_sign(self._m, self._cdim)
        else:
            self._m = self._m.conjugate()

    def Resize(self, new_size: int):
        if self._embedded:
            r, c, v = self._triplets()
            keep = (r < new_size) & (c < new_size)
            self._fill_triplets(r[keep], c[keep], v[keep], new_size,
                                grid=self._m.grid, bs=self._m.bs)
            return
        self._m = _pm.resize(self._m, new_size)

    # -- algebra ---------------------------------------------------------
    def Dot(self, matB: "Matrix_ps"):
        _require_same_embedding(self, matB)
        result = complex(_alg.dot(self._m, matB._m))
        # <E(A), E(B)> = 2 Re<A, B>
        return result.real / 2.0 if self._embedded else result.real

    def Dot_c(self, matB: "Matrix_ps"):
        """Complex dot.  The embedding loses the imaginary part of the
        device dot, so the embedded path joins both operands' complex
        triplets on the host."""
        _require_same_embedding(self, matB)
        if self._embedded:
            ra, ca, va = self._triplets()
            rb, cb, vb = matB._triplets()
            dim = self._cdim
            ka, kb = ra * dim + ca, rb * dim + cb      # ka sorted
            pos = np.searchsorted(ka, kb)
            pos_c = np.minimum(pos, max(len(ka) - 1, 0))
            hit = (pos < len(ka)) & (len(ka) > 0)
            hit &= np.where(hit, ka[pos_c] == kb, False)
            return complex(np.sum(np.conj(va[pos_c[hit]]) * vb[hit]))
        return complex(_alg.dot(self._m, matB._m))

    def Increment(self, matB: "Matrix_ps", alpha=1.0, threshold=0.0):
        _require_same_embedding(self, matB)
        _no_complex_scalar(alpha, matB._embedded, "alpha")
        self._m = _alg.increment(self._m, matB._m, beta=alpha,
                                 alpha=1.0, threshold=threshold)
        _propagate(self, matB)

    def PairwiseMultiply(self, matA: "Matrix_ps", matB: "Matrix_ps"):
        """Hadamard product.  It does not commute with the embedding, so
        the embedded path joins both operands' complex triplets on the
        host and embeds the product."""
        _require_same_embedding(matA, matB)
        if matA._embedded:
            ra, ca, va = matA._triplets()
            rb, cb, vb = matB._triplets()
            dim = matA._cdim
            ka, kb = ra * dim + ca, rb * dim + cb      # both sorted
            pos = np.searchsorted(kb, ka)
            pos_c = np.minimum(pos, max(len(kb) - 1, 0))
            hit = (pos < len(kb)) & (len(kb) > 0)
            hit &= np.where(hit, kb[pos_c] == ka, False)
            vv = np.zeros(len(va), np.complex128)
            vv[hit] = va[hit] * vb[pos_c[hit]]
            self._fill_triplets(ra, ca, vv, matA._cdim, grid=matA._m.grid,
                                bs=matA._m.bs)
            return
        self._m = _alg.pairwise_multiply(matA._m, matB._m)
        _propagate(self, matA)

    def Gemm(self, matA: "Matrix_ps", matB: "Matrix_ps", memory_pool=None,
             alpha=1.0, beta=0.0, threshold=0.0):
        _require_same_embedding(matA, matB)
        if beta != 0.0:
            # self is an operand too (the accumulate target)
            _require_same_embedding(self, matA)
        _no_complex_scalar(alpha, matA._embedded, "alpha")
        self._m = _alg.matmul(matA._m, matB._m, alpha=alpha,
                              threshold=threshold, beta=beta,
                              c=self._m if beta != 0.0 else None)
        _propagate(self, matA)

    def Scale(self, constant):
        _no_complex_scalar(constant, self._embedded, "scale factor")
        self._m = _alg.scale(self._m, constant)

    def Norm(self):
        """Max column 1-norm.  The embedding's column sums see |Re| +
        |Im|, not |v|, so the embedded path sums the complex triplets'
        magnitudes on the host."""
        if self._embedded:
            r, c, v = self._triplets()
            sums = np.zeros(self._cdim)
            np.add.at(sums, c.astype(np.int64), np.abs(v))
            return float(sums.max()) if len(v) else 0.0
        return float(_alg.norm(self._m))

    def MeasureAsymmetry(self):
        return float(_alg.measure_asymmetry(self._m))

    def Trace(self):
        t = complex(_alg.trace(self._m)).real
        return t / 2.0 if self._embedded else t

    def Symmetrize(self):
        self._m = _alg.symmetrize(self._m)

    def DiagonalScale(self, tlist):
        i, j, v = tlist._arrays()
        d = np.zeros(self._m.dim, v.dtype)
        d[j] = v
        self._m = _alg.diagonal_scale(
            self._m.astype(torch.from_numpy(d).dtype), d, side="right")


def _ones_fn(i, j):
    return torch.ones_like(i)


# ----------------------------------------------------------------------------
# Solver namespaces (reference Source/CPlusPlus/*Solvers.h static classes)
# ----------------------------------------------------------------------------

def _purify(fn, Hamiltonian, InverseSquareRoot, nel, Density, sp,
            *args, mu=True):
    """A density solver on the stored matrices: the embedding doubles
    the trace target and the energy."""
    _require_same_embedding(Hamiltonian, InverseSquareRoot)
    emb = Hamiltonian._embedded
    out = fn(Hamiltonian._m, InverseSquareRoot._m, 2 * nel if emb else nel,
             *args, _params_of(sp))
    Density._m = out[0]
    _propagate(Density, Hamiltonian)
    e = out[1] / 2.0 if emb else out[1]
    return (e, out[2]) if mu else e


class DensityMatrixSolvers:
    @staticmethod
    def PM(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        return _purify(_density.pm, Hamiltonian, InverseSquareRoot, nel,
                       Density, sp)

    @staticmethod
    def TRS2(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        return _purify(_density.trs2, Hamiltonian, InverseSquareRoot, nel,
                       Density, sp)

    @staticmethod
    def TRS4(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        return _purify(_density.trs4, Hamiltonian, InverseSquareRoot, nel,
                       Density, sp)

    @staticmethod
    def HPCP(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        return _purify(_density.hpcp, Hamiltonian, InverseSquareRoot, nel,
                       Density, sp)

    @staticmethod
    def ScaleAndFold(Hamiltonian, InverseSquareRoot, nel, Density, homo,
                     lumo, sp=None):
        return _purify(_density.scale_and_fold, Hamiltonian,
                       InverseSquareRoot, nel, Density, sp, homo, lumo,
                       mu=False)

    @staticmethod
    def DenseDensity(Hamiltonian, InverseSquareRoot, nel, Density, sp=None):
        return _purify(_fermi.compute_dense_foe, Hamiltonian,
                       InverseSquareRoot, nel, Density, sp, None)

    @staticmethod
    def EnergyDensityMatrix(Hamiltonian, Density, EnergyDensity,
                            threshold=0.0):
        _require_same_embedding(Hamiltonian, Density)
        EnergyDensity._m = _density.energy_density_matrix(
            Hamiltonian._m, Density._m, threshold)
        _propagate(EnergyDensity, Hamiltonian)

    @staticmethod
    def McWeenyStep(D, *args):
        # McWeenyStep(D, DOut) or McWeenyStep(D, S, DOut)
        if len(args) == 1:
            args[0]._m = _density.mcweeny_step(D._m)
            _propagate(args[0], D)
        else:
            s, dout = args
            dout._m = _density.mcweeny_step(D._m, s._m)
            _propagate(dout, D)


class FermiOperator:
    @staticmethod
    def ComputeDenseFOE(Hamiltonian, InverseSquareRoot, nel, Density,
                        inv_temp=None, sp=None):
        if isinstance(inv_temp, SolverParameters):
            sp, inv_temp = inv_temp, None
        return _purify(_fermi.compute_dense_foe, Hamiltonian,
                       InverseSquareRoot, nel, Density, sp, inv_temp)

    @staticmethod
    def WOM_GC(Hamiltonian, InverseSquareRoot, Density, chemical_potential,
               inv_temp, sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e = _fermi.wom_gc(Hamiltonian._m, InverseSquareRoot._m,
                             chemical_potential, inv_temp, _params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return e / 2.0 if emb else e

    @staticmethod
    def WOM_C(Hamiltonian, InverseSquareRoot, Density, nel, inv_temp,
              sp=None):
        _require_same_embedding(Hamiltonian, InverseSquareRoot)
        emb = Hamiltonian._embedded
        k, e = _fermi.wom_c(Hamiltonian._m, InverseSquareRoot._m,
                            2 * nel if emb else nel, inv_temp,
                            _params_of(sp))
        Density._m = k
        _propagate(Density, Hamiltonian)
        return e / 2.0 if emb else e


def _apply(fn, InputMat, OutputMat, sp, *args):
    """OutputMat <- fn(InputMat, *args, params), embedding propagated."""
    OutputMat._m = fn(InputMat._m, *args, _params_of(sp))
    _propagate(OutputMat, InputMat)


class InverseSolvers:
    @staticmethod
    def Invert(InputMat, OutputMat, sp=None):
        _apply(_inv.invert, InputMat, OutputMat, sp)

    @staticmethod
    def PseudoInverse(InputMat, OutputMat, sp=None):
        _apply(_inv.pseudo_inverse, InputMat, OutputMat, sp)

    @staticmethod
    def DenseInvert(InputMat, OutputMat, sp=None):
        _apply(_inv.dense_invert, InputMat, OutputMat, sp)


class SquareRootSolvers:
    @staticmethod
    def SquareRoot(InputMat, OutputMat, sp=None, order=5):
        OutputMat._m = _sqrt.square_root(InputMat._m, _params_of(sp), order)
        _propagate(OutputMat, InputMat)

    @staticmethod
    def InverseSquareRoot(InputMat, OutputMat, sp=None, order=5):
        OutputMat._m = _sqrt.inverse_square_root(InputMat._m,
                                                 _params_of(sp), order)
        _propagate(OutputMat, InputMat)

    @staticmethod
    def DenseSquareRoot(InputMat, OutputMat, sp=None):
        _apply(_sqrt.dense_square_root, InputMat, OutputMat, sp)

    @staticmethod
    def DenseInverseSquareRoot(InputMat, OutputMat, sp=None):
        _apply(_sqrt.dense_inverse_square_root, InputMat, OutputMat, sp)


class SignSolvers:
    @staticmethod
    def ComputeSign(InputMat, OutputMat, sp=None):
        _apply(_sign.sign_function, InputMat, OutputMat, sp)

    @staticmethod
    def ComputeDenseSign(InputMat, OutputMat, sp=None):
        _apply(_sign.dense_sign_function, InputMat, OutputMat, sp)

    @staticmethod
    def ComputePolarDecomposition(InputMat, UMat, HMat, sp=None):
        u, h = _sign.polar_decomposition(InputMat._m, _params_of(sp))
        UMat._m, HMat._m = u, h


class RootSolvers:
    @staticmethod
    def ComputeRoot(InputMat, OutputMat, root, sp=None):
        _apply(_roots.compute_root, InputMat, OutputMat, sp, root)

    @staticmethod
    def ComputeInverseRoot(InputMat, OutputMat, root, sp=None):
        _apply(_roots.compute_inverse_root, InputMat, OutputMat, sp, root)


class ExponentialSolvers:
    @staticmethod
    def ComputeExponential(InputMat, OutputMat, sp=None):
        _apply(_exp.compute_exponential, InputMat, OutputMat, sp)

    @staticmethod
    def ComputeExponentialPade(InputMat, OutputMat, sp=None):
        _apply(_exp.compute_exponential_pade, InputMat, OutputMat, sp)

    @staticmethod
    def ComputeExponentialTaylor(InputMat, OutputMat, sp=None):
        _apply(_exp.compute_exponential_taylor, InputMat, OutputMat, sp)

    @staticmethod
    def ComputeDenseExponential(InputMat, OutputMat, sp=None):
        _apply(_exp.compute_dense_exponential, InputMat, OutputMat, sp)

    @staticmethod
    def ComputeLogarithm(InputMat, OutputMat, sp=None):
        _apply(_exp.compute_logarithm, InputMat, OutputMat, sp)

    @staticmethod
    def ComputeLogarithmTaylor(InputMat, OutputMat, sp=None):
        _apply(_exp.compute_logarithm_taylor, InputMat, OutputMat, sp)

    @staticmethod
    def ComputeDenseLogarithm(InputMat, OutputMat, sp=None):
        _apply(_exp.compute_dense_logarithm, InputMat, OutputMat, sp)


class TrigonometrySolvers:
    @staticmethod
    def Sine(InputMat, OutputMat, sp=None):
        _apply(_trig.sine, InputMat, OutputMat, sp)

    @staticmethod
    def Cosine(InputMat, OutputMat, sp=None):
        _apply(_trig.cosine, InputMat, OutputMat, sp)

    @staticmethod
    def DenseSine(InputMat, OutputMat, sp=None):
        _apply(_trig.dense_sine, InputMat, OutputMat, sp)

    @staticmethod
    def DenseCosine(InputMat, OutputMat, sp=None):
        _apply(_trig.dense_cosine, InputMat, OutputMat, sp)

    @staticmethod
    def ScaleSquareTrigonometryTaylor(InputMat, OutputMat, sp=None):
        _apply(_trig.scale_square_trigonometry_taylor, InputMat, OutputMat,
               sp)


class LinearSolvers:
    @staticmethod
    def CGSolver(AMat, XMat, BMat, sp=None):
        XMat._m = _linear.cg_solver(AMat._m, BMat._m, _params_of(sp))

    @staticmethod
    def CholeskyDecomposition(AMat, LMat, sp=None):
        LMat._m = _linear.cholesky_decomposition(AMat._m, _params_of(sp))


class EigenBounds:
    @staticmethod
    def GershgorinBounds(InputMat):
        return _bounds.gershgorin_bounds(InputMat._m)

    @staticmethod
    def PowerBounds(InputMat, sp=None):
        return _bounds.power_bounds(InputMat._m, _params_of(sp))


def _embedded_dense(InputMat) -> torch.Tensor:
    """An embedded matrix as its dense complex128 matrix on its device
    -- the gather-to-LAPACK role of the reference's EigenSerial
    fallback (eigenexa_includes/EigenSerial.f90)."""
    r, c, v = InputMat._triplets()
    n = InputMat._cdim
    dev = InputMat._m.device
    dense = torch.zeros((n, n), dtype=torch.complex128, device=dev)
    dense[torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)] = \
        torch.from_numpy(v.astype(np.complex128)).to(dev)
    return dense


def _fill_dense(mat, dense: torch.Tensor, like):
    """``mat`` <- the stored entries of a dense complex tensor, embedded
    on ``like``'s grid and block size."""
    ii, jj = torch.nonzero(dense.abs() > 0, as_tuple=True)
    vals = dense[ii, jj].to(torch.complex128)
    mat._fill_triplets(ii.cpu().numpy(), jj.cpu().numpy(),
                       vals.cpu().numpy(), dense.shape[0],
                       grid=like._m.grid, bs=like._m.bs)


def _fill_diagonal(mat, w: torch.Tensor, like):
    n = w.shape[0]
    i = np.arange(n)
    mat._fill_triplets(i, i, w.cpu().numpy().astype(np.complex128), n,
                       grid=like._m.grid, bs=like._m.bs)


def _pivoted_cholesky(a: torch.Tensor, rank: int) -> torch.Tensor:
    """Rank-``rank`` pivoted Cholesky L (n x rank) with A ~= L L^H, on
    A's device -- the complex leg of the embedded ReduceDimension (the
    max-diagonal pivot rule of solvers/analysis.py; reference
    AnalysisModule.F90:30-221, aquilante2006fast)."""
    n = a.shape[0]
    ell = a.new_zeros((n, rank))
    diag = torch.diagonal(a).real.to(torch.float64).clone()
    for jj in range(rank):
        p = int(torch.argmax(diag))
        val = float(diag[p])
        if val <= 0:
            break
        col = (a[:, p] - ell[:, :jj] @ ell[p, :jj].conj()) / val ** 0.5
        col[p] = val ** 0.5
        ell[:, jj] = col
        diag -= col.abs() ** 2
        diag[p] = 0.0
    return ell


class EigenSolvers:
    @staticmethod
    def EigenDecomposition(InputMat, EigenValues, nvals=None,
                           EigenVectors=None, sp=None):
        if InputMat._embedded:
            # the spectrum of E(C) is C's with doubled multiplicity, so
            # the complex matrix is decomposed (torch.linalg.eigh on its
            # device)
            w, v = torch.linalg.eigh(_embedded_dense(InputMat))
            n = InputMat._cdim
            if nvals is not None and nvals < n:
                keep = torch.arange(n, device=w.device) < nvals
                w = torch.where(keep, w, 0.0)
                v = v * keep[None, :]
            _fill_diagonal(EigenValues, w, InputMat)
            if EigenVectors is not None:
                _fill_dense(EigenVectors, v, InputMat)
            return
        vals, vecs = _eigen.eigen_decomposition(
            InputMat._m, nvals=nvals, params=_params_of(sp),
            compute_vectors=EigenVectors is not None)
        EigenValues._m = vals
        _propagate(EigenValues, InputMat)
        if EigenVectors is not None:
            EigenVectors._m = vecs
            _propagate(EigenVectors, InputMat)

    @staticmethod
    def EigenValues(InputMat, EigenValuesOut, nvals=None, sp=None):
        if InputMat._embedded:
            EigenSolvers.EigenDecomposition(InputMat, EigenValuesOut,
                                            nvals=nvals, sp=sp)
            return
        EigenValuesOut._m = _eigen.eigen_values(InputMat._m, nvals=nvals,
                                                params=_params_of(sp))
        _propagate(EigenValuesOut, InputMat)

    @staticmethod
    def IterativeEigenDecomposition(InputMat, nvals, sp=None):
        """The lowest ``nvals`` eigenpairs by matrix-free LOBPCG ->
        (eigenvalues ndarray [nvals], eigenvectors ndarray [dim,
        nvals])."""
        if InputMat._embedded:
            # the real LOBPCG on the stored embedding (its spectrum is
            # the complex matrix's, doubled) and the complex pairs
            # rebuilt from it
            w2, v2 = _eigen.eigen_decomposition_iterative(
                InputMat._m, 2 * nvals, params=_params_of(sp))
            return _eigen.dedup_embedded_pairs(
                w2.cpu().numpy(), v2.cpu().numpy(), InputMat._cdim, nvals)
        w, v = _eigen.eigen_decomposition_iterative(
            InputMat._m, nvals, params=_params_of(sp))
        return w.cpu().numpy(), v.cpu().numpy()

    @staticmethod
    def SingularValueDecomposition(InputMat, LeftVectors, RightVectors,
                                   SingularValues, sp=None):
        """reference SingularValueSolversModule.F90:18-70: A = L S R^H,
        singular values ascending.  SVD factors do not commute with the
        embedding, so the embedded path decomposes the complex matrix
        (torch.linalg.svd on its device)."""
        if InputMat._embedded:
            u, s, vh = torch.linalg.svd(_embedded_dense(InputMat))
            idx = torch.argsort(s)                    # ascending
            _fill_dense(LeftVectors, u[:, idx], InputMat)
            _fill_dense(RightVectors, vh.conj().T[:, idx], InputMat)
            _fill_diagonal(SingularValues, s[idx], InputMat)
            return
        left, right, vals = _eigen.singular_value_decomposition(
            InputMat._m, _params_of(sp))
        LeftVectors._m, RightVectors._m, SingularValues._m = left, right, \
            vals

    @staticmethod
    def EstimateGap(Hmat, Kmat, chemical_potential, sp=None):
        return _eigen.estimate_gap(Hmat._m, Kmat._m, chemical_potential,
                                   _params_of(sp))


class GeometryOptimization:
    @staticmethod
    def PurificationExtrapolate(PreviousDensity, Overlap, nel, NewDensity,
                                sp=None):
        NewDensity._m = _geo.purification_extrapolate(
            PreviousDensity._m, Overlap._m, nel, _params_of(sp))
        _propagate(NewDensity, PreviousDensity)

    @staticmethod
    def LowdinExtrapolate(PreviousDensity, OldOverlap, NewOverlap,
                          NewDensity, sp=None):
        NewDensity._m = _geo.lowdin_extrapolate(
            PreviousDensity._m, OldOverlap._m, NewOverlap._m,
            _params_of(sp))
        _propagate(NewDensity, PreviousDensity)


class Analysis:
    @staticmethod
    def PivotedCholeskyDecomposition(AMat, LMat, rank, sp=None):
        LMat._m = _analysis.pivoted_cholesky_decomposition(
            AMat._m, rank, _params_of(sp))

    @staticmethod
    def ReduceDimension(InputMat, dim, ReducedMat, sp=None):
        """reference AnalysisModule.F90:222-279.  The rank-dim subspace
        does not commute with the embedding, so the embedded path runs
        the reference's algorithm on the complex matrix, on its device:
        the projector onto the lowest ``dim`` eigenstates (the TRS4
        fixed point at trace dim), its rank-dim pivoted Cholesky,
        rotate, slice."""
        if InputMat._embedded:
            h = _embedded_dense(InputMat)
            _, v = torch.linalg.eigh(h)
            occ = v[:, :dim]
            ell = _pivoted_cholesky(occ @ occ.conj().T, dim)
            _fill_dense(ReducedMat, ell.conj().T @ h @ ell, InputMat)
            return
        ReducedMat._m = _analysis.reduce_dimension(InputMat._m, dim,
                                                   _params_of(sp))
        _propagate(ReducedMat, InputMat)


class MatrixConversion:
    @staticmethod
    def SnapMatrixToSparsityPattern(Mat, Pattern):
        Mat._m = _maps.snap_to_sparsity_pattern(Mat._m, Pattern._m)


class ComplexEmbedding:
    """Complex matrices as their real 2 x 2 embedding E(A + iB) = [[A,
    -B], [B, A]] (core/cplx.py): a ring homomorphism, so f(E(C)) =
    E(f(C)) for every solver here."""

    @staticmethod
    def Embed(InMat, OutMat):
        OutMat._m = _cplx.embed(InMat._m)

    @staticmethod
    def Extract(InMat, OutMat):
        OutMat._m = _cplx.extract(InMat._m)


# ----------------------------------------------------------------------------
# Polynomial objects (methods mirror the C++ member functions)
# ----------------------------------------------------------------------------

class Polynomial(_poly.Polynomial):
    def SetCoefficient(self, index, value):
        self.set_coefficient(index, value)

    def HornerCompute(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _poly.horner_compute(InputMat._m, self,
                                            _params_of(sp))

    def PatersonStockmeyerCompute(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _poly.paterson_stockmeyer_compute(
            InputMat._m, self, _params_of(sp))


class ChebyshevPolynomial(_cheb.ChebyshevPolynomial):
    def SetCoefficient(self, index, value):
        self.set_coefficient(index, value)

    def Compute(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _cheb.compute(InputMat._m, self, _params_of(sp))

    def ComputeFactorized(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _cheb.factorized_compute(InputMat._m, self,
                                                _params_of(sp))


class HermitePolynomial(_herm.HermitePolynomial):
    def SetCoefficient(self, index, value):
        self.set_coefficient(index, value)

    def Compute(self, InputMat, OutputMat, sp=None):
        OutputMat._m = _herm.compute(InputMat._m, self, _params_of(sp))


# ----------------------------------------------------------------------------
# Matrix maps (SWIG directors become plain Python callables)
# ----------------------------------------------------------------------------

RealOperation = _maps.RealOperation
ComplexOperation = _maps.ComplexOperation


class MatrixMapper:
    @staticmethod
    def Map(inmat, outmat, proc):
        outmat._m = _maps.map_matrix(inmat._m, proc)

    @staticmethod
    def MapVectorized(inmat, outmat, fn):
        """fn(rows, cols, vals) -> (rows, cols, vals) or (rows, cols,
        vals, keep_mask) over whole numpy triplet arrays, one call in
        place of a Python call per element (``maps.map_triplets``; for
        a map of the values alone on the device, ``maps.map_values``)."""
        outmat._m = _maps.map_triplets(inmat._m, fn)

    @staticmethod
    def GetSliceInfo(mat):
        """(num_slices, my_slice) of the matrix's grid (reference
        Source/CPlusPlus/MatrixMapper.h:73-74)."""
        return mat._m.grid.slices, mat._m.grid.my_slice


class LoadBalancer:
    """Permutation-based load balancing (reference
    Source/CPlusPlus/LoadBalancer.h, LoadBalancerModule.F90:16-92)."""

    @staticmethod
    def PermuteMatrix(mat_in, mat_out, permutation, memorypool=None):
        mat_out._m = _perm.permute_matrix(mat_in._m, permutation)

    @staticmethod
    def UndoPermuteMatrix(mat_in, mat_out, permutation, memorypool=None):
        mat_out._m = _perm.undo_permute_matrix(mat_in._m, permutation)


# ----------------------------------------------------------------------------
# Local matrices (reference Source/CPlusPlus/SMatrix.h)
# ----------------------------------------------------------------------------

class MatrixMemoryPool_r:
    """Scratch is managed by the algebra; signature parity only
    (reference MatrixMemoryPoolModule.F90:13-56)."""

    def __init__(self, columns=0, rows=0):
        self.columns, self.rows = columns, rows


class MatrixMemoryPool_c(MatrixMemoryPool_r):
    pass


class Matrix_lsr:
    """Local sparse matrix (reference Matrix_lsr, SMatrix.h:21-103) on
    the global grid's device."""
    _complex = False
    _TripletList = TripletList_r

    def __init__(self, arg, *extra):
        dtype = default_complex_dtype() if self._complex \
            else default_real_dtype()
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        dev = _grid.global_grid().device
        if isinstance(arg, str):
            i, j, v, shape = _mm.read_triplets_shape(arg)
            self._m = _LocalMatrix.from_triplets(
                i, j, v.astype(np_dtype), shape[0], shape[1], device=dev)
        elif isinstance(arg, TripletList_r):
            i, j, v = arg._arrays()
            rows, columns = extra
            self._m = _LocalMatrix.from_triplets(
                i, j, v.astype(np_dtype), rows, columns, device=dev)
        elif isinstance(arg, Matrix_lsr):
            self._m = arg._m
        else:
            columns, rows = int(arg), int(extra[0])
            self._m = _LocalMatrix(rows, columns, dtype=dtype, device=dev)

    def GetRows(self) -> int:
        return self._m.rows

    def GetColumns(self) -> int:
        return self._m.cols

    def Scale(self, constant):
        self._m.scale(constant)

    def Increment(self, matB, alpha=1.0, threshold=0.0):
        self._m.increment(matB._m, alpha, threshold)

    def Dot(self, matB):
        result = complex(self._m.dot(matB._m))
        return result if self._complex else result.real

    def PairwiseMultiply(self, matA, matB):
        self._m.pairwise(matA._m, matB._m)

    def Gemm(self, matA, matB, isATransposed, isBTransposed, alpha, beta,
             threshold, memory_pool=None):
        self._m.gemm(matA._m, matB._m, isATransposed, isBTransposed,
                     alpha, beta, threshold)

    def DiagonalScale(self, tlist):
        i, j, v = tlist._arrays()
        d = np.zeros(self._m.cols, v.dtype)
        d[j] = v
        self._m.diagonal_scale(d)

    def Transpose(self, matA):
        self._m.transpose(matA._m)

    def Conjugate(self):
        self._m.conjugate()

    def ExtractRow(self, row_number, row_out):
        row_out._m = self._m.extract_row(row_number)

    def ExtractColumn(self, column_number, column_out):
        column_out._m = self._m.extract_column(column_number)

    def Print(self):
        print(self._m.to_dense())

    def WriteToMatrixMarket(self, file_name):
        i, j, v = self._m.to_triplets()
        field = "complex" if np.iscomplexobj(v) else "real"
        with open(file_name, "wb") as f:
            f.write(f"%%MatrixMarket matrix coordinate {field} general\n"
                    .encode())
            f.write(f"{self._m.rows} {self._m.cols} {len(v)}\n".encode())
            f.write(_native.mm_format(i, j, v))

    def MatrixToTripletList(self, triplet_list):
        i, j, v = self._m.to_triplets()
        order = np.lexsort((i, j))
        triplet_list._take(type(triplet_list)._from_arrays(
            i[order], j[order], v[order]))


class Matrix_lsc(Matrix_lsr):
    _complex = True
    _TripletList = TripletList_c
