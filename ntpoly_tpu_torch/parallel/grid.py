"""Process grid on one device.

Counterpart of ``ntpoly_tpu/parallel/grid.py``.  This slice of the port
runs on one device, so the grid is 1 x 1 x 1 and carries the
``torch.device`` every matrix on it lives on: the CUDA card unless the
caller names another device (``device="cpu"``).  The rows x cols x
slices mesh of the reference (``torch.distributed`` process groups) is
ROADMAP Queue A item 8.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ProcessGrid:
    rows: int = 1
    cols: int = 1
    slices: int = 1
    device: torch.device = None

    def __post_init__(self):
        if (self.rows, self.cols, self.slices) != (1, 1, 1):
            raise ValueError(
                f"grid {self.rows}x{self.cols}x{self.slices}: only the "
                "1x1x1 grid is ported; multi-device grids are ROADMAP "
                "Queue A item 8")
        object.__setattr__(self, "device",
                           torch.device(self.device or "cuda"))

    def __repr__(self):
        return f"ProcessGrid(1x1x1, device={self.device})"
