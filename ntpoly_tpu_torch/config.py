"""Global configuration for ntpoly_tpu_torch.

Counterpart of ``ntpoly_tpu/config.py``.  The storage format is the
reference package's exactly: ``EMPTY`` marks an unused block slot and
sorts after every real block-column id.

Float32 matrix products on the card run in full float32: TF32 keeps
about three decimal digits, far below the 1e-6 tolerances of the
solvers, so it is switched off for cuBLAS (used only by the plain
versions and the one-hot contractions outside the kernels) and cuDNN.
"""
from __future__ import annotations

import torch

# Sentinel marking an empty block slot (dims < 2**30 blocks).
EMPTY = 2**30

# Default block size of the NTPoly-compatible surface for matrices of
# 1024 rows and more (``api._auto_bs`` picks smaller ones below).
DEFAULT_BLOCK_SIZE = 128

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_real_dtype() -> torch.dtype:
    return torch.get_default_dtype()


def default_complex_dtype() -> torch.dtype:
    """complex128 when the default real dtype is float64, else
    complex64."""
    return (torch.complex128 if default_real_dtype() == torch.float64
            else torch.complex64)


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a type name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
