"""ntpoly_tpu_torch — the PyTorch and CUDA port of ntpoly_tpu.

Block-sparse (block-ELL) matrices and the threshold-filtered SpGEMM that
every solver is built on, with hand-written CUDA kernels for NVIDIA
Hopper (``csrc/``).  The JAX package ``ntpoly_tpu`` is the reference:
storage, slot order, holes and capacities match it exactly, and the
tests hold each module of this package against its counterpart there.

This slice covers the TRS4 purification on one device (see
``solvers/density.py``).  Tensors on a CUDA device go through the
kernels; tensors on the CPU go through their plain PyTorch versions.
"""
from . import config  # noqa: F401
from .utils.errors import NTPolyError  # noqa: F401

__version__ = "0.1.0"
