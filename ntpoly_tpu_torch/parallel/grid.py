"""Process grid on one device.

Counterpart of ``ntpoly_tpu/parallel/grid.py``.  This slice of the port
runs on one device, so the grid is 1 x 1 x 1 and carries the
``torch.device`` every matrix on it lives on: the CUDA card unless the
caller names another device (``device="cpu"``).  The rows x cols x
slices mesh of the reference (``torch.distributed`` process groups) is
ROADMAP Queue A item 8.

The global grid (reference ``grid.py`` ``construct_global_grid``) is the
default of every constructor that is given no grid.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.errors import GridError


@dataclass(frozen=True)
class ProcessGrid:
    rows: int = 1
    cols: int = 1
    slices: int = 1
    device: torch.device = None

    def __post_init__(self):
        if (self.rows, self.cols, self.slices) != (1, 1, 1):
            raise GridError(
                f"grid {self.rows}x{self.cols}x{self.slices}: only the "
                "1x1x1 grid is ported; multi-device grids are ROADMAP "
                "Queue A item 8")
        object.__setattr__(self, "device",
                           torch.device(self.device or "cuda"))

    def __repr__(self):
        return f"ProcessGrid(1x1x1, device={self.device})"


# ----------------------------------------------------------------------------
# global default grid
# ----------------------------------------------------------------------------
_global_grid: ProcessGrid | None = None


def construct_global_grid(rows: int | None = None, cols: int | None = None,
                          slices: int | None = None, device=None
                          ) -> ProcessGrid:
    """The global grid: 1 x 1 x 1 on ``device`` (the CUDA card unless
    named); any other shape raises :class:`GridError`."""
    global _global_grid
    _global_grid = ProcessGrid(rows or 1, cols or 1, slices or 1,
                               device=device)
    return _global_grid


def destruct_global_grid() -> None:
    global _global_grid
    _global_grid = None


def global_grid() -> ProcessGrid:
    """The global grid, constructed on the CUDA card if none is."""
    global _global_grid
    if _global_grid is None:
        _global_grid = ProcessGrid()
    return _global_grid
