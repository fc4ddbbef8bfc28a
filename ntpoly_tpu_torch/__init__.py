"""ntpoly_tpu_torch — the PyTorch and CUDA port of ntpoly_tpu.

Block-sparse (block-ELL) matrices and the threshold-filtered SpGEMM that
every solver is built on, with hand-written CUDA kernels for NVIDIA
Hopper (``csrc/``).  The JAX package ``ntpoly_tpu`` is the reference:
storage, slot order, holes and capacities match it exactly, and the
tests hold each module of this package against its counterpart there.

Two surfaces, as the reference's:

* the functional core (``parallel``, ``solvers``, ``io``, ``utils``):
  the density-matrix purifications in an orthogonal or a
  non-orthogonal basis, the inverse square root and the other matrix
  functions, the analysis routines, Matrix Market and binary I/O
  byte-compatible with the JAX package's, and matrix maps;
* the NTPoly-compatible object API re-exported here (``import
  ntpoly_tpu_torch as nt``), mirroring the reference's SWIG module
  (reference Source/Swig/NTPolySwig.i), with complex data always held
  as its 2 x 2 real embedding.

Tensors on a CUDA device go through the kernels; tensors on the CPU go
through their plain PyTorch versions.  Importing the package builds
nothing: the kernels and the native Matrix Market code are compiled on
first use.
"""
from .api import *          # noqa: F401,F403
from . import config        # noqa: F401
from .utils.errors import (  # noqa: F401
    NTPolyError, GridError, IOFormatError, ConvergenceError)
from .api import (          # noqa: F401 — explicit for introspection
    ConstructGlobalProcessGrid, DestructGlobalProcessGrid, GetGlobalIsRoot,
    GetGlobalNumRows, GetGlobalNumColumns, GetGlobalNumSlices,
    GetGlobalMyRow, GetGlobalMyColumn, GetGlobalMySlice,
    ActivateLogger, DeactivateLogger, ProcessGrid,
    Triplet_r, Triplet_c, TripletList_r, TripletList_c,
    Matrix_ps, Matrix_lsr, Matrix_lsc,
    MatrixMemoryPool_r, MatrixMemoryPool_c, PMatrixMemoryPool,
    Permutation, SolverParameters,
    DensityMatrixSolvers, FermiOperator, InverseSolvers, SquareRootSolvers,
    SignSolvers, RootSolvers, ExponentialSolvers, TrigonometrySolvers,
    LinearSolvers, EigenBounds, EigenSolvers, GeometryOptimization,
    Analysis, MatrixConversion, Polynomial, ChebyshevPolynomial,
    HermitePolynomial, RealOperation, ComplexOperation, MatrixMapper,
)

__version__ = "0.2.0"
