"""ntpoly_tpu_torch — the PyTorch and CUDA port of ntpoly_tpu.

Block-sparse (block-ELL) matrices and the threshold-filtered SpGEMM that
every solver is built on, with hand-written CUDA kernels for NVIDIA
Hopper (``csrc/``).  The JAX package ``ntpoly_tpu`` is the reference:
storage, slot order, holes and capacities match it exactly, and the
tests hold each module of this package against its counterpart there.

The port covers, on one device, the density-matrix purifications
(PM, TRS2, TRS4, HPCP and scale-and-fold, ``solvers/density.py``) in
an orthogonal or a non-orthogonal basis, the latter through the
overlap's inverse square root (``solvers/squareroot.py``), with
optional load-balance permutations (``utils/permutation.py``); and the
matrix functions: spectral bounds (``eigenbounds``), the dense
eigendecomposition and every ``dense_*`` solver on
``eigen.dense_matrix_function`` (whose ``func`` maps a torch tensor of
eigenvalues), the dense and wave-operator Fermi solvers (``fermi``),
inverse and pseudo-inverse, sign and polar decomposition, p-th roots
and inverse roots, standard, Chebyshev and Hermite polynomials, the
exponential and logarithm, sine and cosine, and the CG linear solver.
Tensors on a CUDA device go through the kernels; tensors on the CPU go
through their plain PyTorch versions.
"""
from . import config  # noqa: F401
from .utils.errors import NTPolyError  # noqa: F401

__version__ = "0.1.0"
