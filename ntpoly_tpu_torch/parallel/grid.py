"""Process grid: rows x cols x slices ranks over ``torch.distributed``.

Counterpart of ``ntpoly_tpu/parallel/grid.py``, in NTPoly's own model:
one process (rank) per device, SPMD (reference
ProcessGridModule.F90:15-56,130-264).  The reference's mesh axes become
process groups:

    rows   -- block-row shards of the matrix (reference row_comm)
    cols   -- block-column panels (reference column_comm)
    slices -- split-k replicas of 2.5D multiplies (reference
              between_slice_comm); matrix data is replicated over slices

Rank ``(r * cols + c) * slices + s`` of the grid sits at (r, c, s), the
order of the reference's ``devs.reshape(rows, cols, slices)``, so its
owner tables and the slot order of gathered panels are the reference's.
Every group a grid needs is made when the grid is, in the same order on
every rank of the world (``new_group`` is collective), and kept for the
world's life; constructing a grid is therefore collective too.

Without a world the grid is 1 x 1 x 1 on ``device``: the CUDA card
unless the caller names another (``device="cpu"``); in a world the
device defaults to ``cuda:{LOCAL_RANK}``, and ranks that share one card
name it (``device="cuda:0"``).  Its groups are then of one rank, which
the collectives treat as the identity.

The global grid (reference ``construct_global_grid``) is the default of
every constructor that is given no grid.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.errors import GridError
from . import dist

def _near_square(n: int) -> tuple[int, int]:
    r = int(np.sqrt(n))
    while n % r != 0:
        r -= 1
    return max(r, 1), n // max(r, 1)


def grid_shape(rows, cols, slices: int, n: int) -> tuple[int, int, int]:
    """The reference's shape rules (ProcessGridModule.F90:162-176,
    576-638) for ``n`` ranks: rows and cols auto-sized near-square when
    either is missing; rows * cols * slices == n; with slices > 1,
    max(rows, cols) a multiple of min(rows, cols)."""
    if rows is None or cols is None:
        if n % slices != 0:
            raise GridError(
                f"slices={slices} does not divide rank count {n}")
        rows, cols = _near_square(n // slices)
    if rows * cols * slices != n:
        raise GridError(f"grid {rows}x{cols}x{slices} != rank count {n}")
    if slices > 1 and max(rows, cols) % min(rows, cols) != 0:
        raise GridError(
            "with slices > 1, max(rows, cols) must be a multiple of "
            f"min(rows, cols); got {rows}x{cols}")
    return rows, cols, slices


def _default_device() -> torch.device:
    if not torch.distributed.is_initialized():
        return torch.device("cuda")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = dist.process_index() % max(1, torch.cuda.device_count())
    return torch.device(f"cuda:{int(local)}")


class ProcessGrid:
    """A rows x cols x slices grid of world ranks.

    ``rows``/``cols`` default to a near-square split of the world's
    ranks (of ``ranks`` when given) over ``slices``; a grid smaller than
    the world takes its first ranks, as the reference takes its first
    devices.  Equality compares the shape, the ranks and the device."""

    def __init__(self, rows: int | None = None, cols: int | None = None,
                 slices: int = 1, device=None, ranks=None):
        slices = slices or 1
        if ranks is None:
            n = dist.process_count()
            if rows is not None and cols is not None:
                need = rows * cols * slices
                if need <= n:
                    n = need
            ranks = range(n)
        ranks = tuple(int(r) for r in ranks)
        rows, cols, slices = grid_shape(rows, cols, slices, len(ranks))
        self.rows, self.cols, self.slices = rows, cols, slices
        self.ranks = ranks
        self.device = torch.device(device or _default_device())
        self._groups()

    def _groups(self):
        """Every group of the grid, made in one order on every rank;
        this rank keeps its own (None where it is not a member)."""
        R, C, S = self.rows, self.cols, self.slices
        at = np.asarray(self.ranks).reshape(R, C, S)
        me = dist.process_index()
        spans = {
            "cols": [at[r, :, s] for r in range(R) for s in range(S)],
            "rows": [at[:, c, s] for c in range(C) for s in range(S)],
            "slices": [at[r, c, :] for r in range(R) for c in range(C)],
            "plane": [at[:, :, s].reshape(-1) for s in range(S)],
            "all": [at.reshape(-1)],
        }
        self._g = {}
        for name, lists in spans.items():
            for ranks in lists:
                g = dist.group(ranks.tolist())
                if me in g.ranks:
                    self._g[name] = g
        pos = self.ranks.index(me) if me in self.ranks else None
        self.member = pos is not None
        self.my_row = pos // (C * S) if self.member else None
        self.my_col = (pos // S) % C if self.member else None
        self.my_slice = pos % S if self.member else None

    def group(self, name: str) -> "dist.Group":
        """This rank's group along ``name``: 'rows', 'cols' or 'slices'
        (the ranks that differ only there), 'plane' (its slice's rows x
        cols ranks) or 'all'."""
        return self._g[name]

    def _sig(self):
        return (self.rows, self.cols, self.slices, self.ranks, self.device)

    def __eq__(self, other):
        return isinstance(other, ProcessGrid) and self._sig() == other._sig()

    def __hash__(self):
        return hash(self._sig())

    def __repr__(self):
        return (f"ProcessGrid({self.rows}x{self.cols}x{self.slices}, "
                f"device={self.device})")

    @property
    def n_devices(self) -> int:
        return self.rows * self.cols * self.slices

    def split(self) -> tuple["ProcessGrid", "ProcessGrid", bool]:
        """Halve the grid (reference SplitProcessGrid,
        ProcessGridModule.F90:430-515): slices first, then the longer of
        rows and cols.  -> (first_half, second_half, split_slice); a grid
        of one rank gives itself twice.  Collective: every rank of the
        world makes both halves."""
        at = np.asarray(self.ranks).reshape(self.rows, self.cols,
                                            self.slices)
        if self.n_devices == 1:
            return self, self, False
        if self.slices > 1:
            h = self.slices // 2
            a, b = at[:, :, :h], at[:, :, h:]
        elif self.cols >= self.rows:
            h = self.cols // 2
            a, b = at[:, :h], at[:, h:]
        else:
            h = self.rows // 2
            a, b = at[:h], at[h:]

        def mk(d):
            return type(self)(d.shape[0], d.shape[1], d.shape[2],
                              device=self.device, ranks=d.reshape(-1))
        return mk(a), mk(b), self.slices > 1


# ----------------------------------------------------------------------------
# global default grid
# ----------------------------------------------------------------------------
_global_grid: ProcessGrid | None = None


def construct_global_grid(rows: int | None = None, cols: int | None = None,
                          slices: int | None = None, device=None
                          ) -> ProcessGrid:
    """The global grid over the world's ranks (1 x 1 x 1 without a
    world) on ``device``; a shape the reference refuses raises
    :class:`GridError`."""
    global _global_grid
    _global_grid = ProcessGrid(rows, cols, slices or 1, device=device)
    return _global_grid


def destruct_global_grid() -> None:
    global _global_grid
    _global_grid = None


def global_grid() -> ProcessGrid:
    """The global grid, constructed over the world (on the CUDA card) if
    none is."""
    global _global_grid
    if _global_grid is None:
        _global_grid = ProcessGrid()
    return _global_grid
