"""Multi-process runtime: one rank per device over ``torch.distributed``.

Counterpart of ``ntpoly_tpu/parallel/dist.py``.  The reference drives
every device of a host from one controller and exchanges triplets over
the JAX coordination service; the port runs NTPoly's own model, one
process (rank) per device, SPMD, as MPI does:

  * :func:`initialize` starts the world (``init_process_group``).  When
    every rank can have a card of its own the backend is the
    device-aware pair ``cpu:gloo,cuda:nccl``: card tensors go through
    NCCL and the host tensors of the triplet exchanges and the
    collective writes through gloo.  On the CPU, and when several ranks
    share one card (NCCL refuses two ranks on one GPU), it is ``gloo``.
  * :class:`Group` wraps a process group with the collectives the
    matrix layer uses (gather, gather of ragged lengths, max, and the
    all-to-all of ragged buckets).  A group of one rank is the identity
    and calls no backend, so the 1 x 1 x 1 grid runs the same code as
    every other grid.  Under ``gloo`` a CUDA tensor is staged through
    host memory, decided by the backend (``staged`` lists each
    collective that was), never on a failure.  Each backend call of a
    group of several ranks runs inside a timed ``ntp.collective`` span
    (``utils/trace.py``) and is counted in the counter group
    ``collectives``: ``calls``, and ``bytes_in``, the bytes that arrive
    from the other members (its own part left out; host-staged gloo
    traffic included; an all-reduce counts every other member's
    operand).
  * :func:`allgather_triplets` and :func:`exchange_triplets`: the union
    of every rank's triplets, and the owner-routed exchange of the
    reference fill (counts first, then one ``all_to_all_single`` each
    of rows, cols and values).  The reference's key-value chunking
    exists for gRPC message limits, which the process group does not
    have.
"""
from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as tdist

from ..utils import trace as tr

__all__ = ["initialize", "shutdown", "process_count", "process_index",
           "allgather_triplets", "exchange_triplets", "Group", "group",
           "world", "staged"]

# collectives that went through host memory (gloo with CUDA tensors)
staged: set = set()
# the backend of a world whose ranks each have a card
PAIR = "cpu:gloo,cuda:nccl"
# backend calls of groups of several ranks, and the bytes they brought
counts = tr.counter_group("collectives", ("calls", "bytes_in"))
SPAN = "ntp.collective"


def _called(bytes_in: int) -> None:
    counts["calls"] += 1
    counts["bytes_in"] += int(bytes_in)


def initialize(backend: str | None = None, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               timeout: float | None = None) -> None:
    """Start the world.  ``rank`` and ``world_size`` default to the
    ``RANK`` and ``WORLD_SIZE`` environment (as ``torchrun`` sets them),
    ``init_method`` to ``env://``.  ``backend`` defaults to
    ``cpu:gloo,cuda:nccl`` when there are at least as many cards as
    ranks (each rank then works on ``cuda:{LOCAL_RANK}``, made its
    current device), else to ``gloo``; plain ``nccl`` is refused, since
    the matrix layer exchanges host tensors too.  ``timeout`` (s)
    bounds every collective, so that a hung rank fails the run."""
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if backend is None:
        own_card = (torch.cuda.is_available()
                    and world_size <= torch.cuda.device_count())
        backend = PAIR if own_card else "gloo"
    if backend == "nccl":
        raise ValueError(f"backend 'nccl' carries no host tensors; use "
                         f"{PAIR!r}")
    if "nccl" in backend:
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    tdist.init_process_group(backend, init_method=init_method or "env://",
                             rank=rank, world_size=world_size, **kw)
    _state["timeout"] = kw.get("timeout")


def shutdown() -> None:
    """Leave the world (every rank calls it); the groups are dropped."""
    _groups.clear()
    if tdist.is_initialized():
        tdist.destroy_process_group()


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


_state: dict = {"timeout": None}
_groups: dict = {}


class Group:
    """The ranks ``ranks`` (world ranks, in this order) as one process
    group, for the rank ``me`` of the world.  ``index`` is this rank's
    place in ``ranks`` (None when it is not a member)."""

    def __init__(self, ranks: tuple, pg=None):
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        me = process_index()
        self.index = self.ranks.index(me) if me in self.ranks else None
        self.pg = pg

    # -- helpers ---------------------------------------------------------
    def _stage(self, name: str, x: torch.Tensor) -> bool:
        if x.is_cuda and tdist.get_backend(self.pg) == "gloo":
            staged.add(name)
            return True
        return False

    # -- collectives -----------------------------------------------------
    def all_gather(self, x: torch.Tensor) -> list:
        """Every member's ``x`` (same shape everywhere), in rank order."""
        if self.size == 1:
            return [x]
        stage = self._stage("all_gather", x)
        with tr.span(SPAN, timed=True):
            src = x.contiguous().cpu() if stage else x.contiguous()
            out = [torch.empty_like(src) for _ in range(self.size)]
            tdist.all_gather(out, src, group=self.pg)
            _called((self.size - 1) * src.nbytes)
            return [o.to(x.device) for o in out] if stage else out

    def all_gather_v(self, x: torch.Tensor) -> list:
        """Every member's ``x``, whose leading lengths may differ."""
        if self.size == 1:
            return [x]
        n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        counts = [int(c) for c in torch.cat(self.all_gather(n)).tolist()]
        top = max(counts)
        pad = x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))
        parts = self.all_gather(torch.cat([x, pad]))
        return [p[:c] for p, c in zip(parts, counts)]

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the members (integers or floats)."""
        if self.size == 1:
            return x
        stage = self._stage("all_reduce_max", x)
        with tr.span(SPAN, timed=True):
            y = x.detach().clone().cpu() if stage else x.detach().clone()
            tdist.all_reduce(y, op=tdist.ReduceOp.MAX, group=self.pg)
            _called((self.size - 1) * y.nbytes)
            return y.to(x.device) if stage else y

    def sum_ordered(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the members, added in rank order from the
        gathered values, so that every member holds the same bits."""
        parts = self.all_gather(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_to_all_v(self, x: torch.Tensor, counts: list) -> torch.Tensor:
        """Send ``x[sum(counts[:d]) : sum(counts[:d + 1])]`` to member
        ``d``; -> what every member sent here, in member order."""
        if self.size == 1:
            return x
        stage = self._stage("all_to_all", x)
        # the counts travel on the payload's side of the backend
        cdev = "cpu" if stage else x.device
        with tr.span(SPAN, timed=True):
            cnt = torch.tensor(counts, dtype=torch.int64, device=cdev)
            got = torch.empty_like(cnt)
            tdist.all_to_all_single(got, cnt, group=self.pg)
            _called((self.size - 1) * cnt.element_size())
        recv = [int(c) for c in got.tolist()]
        with tr.span(SPAN, timed=True):
            src = x.contiguous().cpu() if stage else x.contiguous()
            out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
            tdist.all_to_all_single(out, src, output_split_sizes=recv,
                                    input_split_sizes=list(counts),
                                    group=self.pg)
            row = math.prod(out.shape[1:]) * out.element_size()
            _called((sum(recv) - recv[self.index]) * row)
            return out.to(x.device) if stage else out

    def barrier(self) -> None:
        if self.size > 1:
            with tr.span(SPAN, timed=True):
                tdist.barrier(group=self.pg)
                _called(0)


def group(ranks) -> Group:
    """The group of ``ranks``, made once per world.  ``new_group`` is
    collective over the whole world: every rank must ask for the same
    groups in the same order (the grids do, at construction)."""
    ranks = tuple(int(r) for r in ranks)
    if ranks not in _groups:
        pg = None
        if len(ranks) > 1:
            kw = {}
            if _state["timeout"] is not None:
                kw["timeout"] = _state["timeout"]
            pg = tdist.new_group(list(ranks), **kw)
        _groups[ranks] = Group(ranks, pg)
    return _groups[ranks]


def world() -> Group:
    return group(range(process_count()))


# ----------------------------------------------------------------------------
# triplets
# ----------------------------------------------------------------------------

def _np_to_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _values_real(vals: np.ndarray):
    """Values as a real tensor (complex as [..., 2]) for the backends,
    which carry no complex dtype everywhere."""
    if np.iscomplexobj(vals):
        return _np_to_tensor(np.stack([vals.real, vals.imag], axis=-1))
    return _np_to_tensor(vals)


def _values_back(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    a = t.numpy()
    if np.iscomplexobj(like):
        return (a[..., 0] + 1j * a[..., 1]).astype(like.dtype)
    return a.astype(like.dtype, copy=False)


def allgather_triplets(rows, cols, vals, grp: Group | None = None):
    """The union of every rank's (rows, cols, vals) numpy triplets, in
    rank order (O(total nnz) on every rank)."""
    grp = grp or world()
    if grp.size == 1:
        return rows, cols, vals
    vals = np.asarray(vals)
    idx = _np_to_tensor(np.stack([np.asarray(rows, np.int64),
                                  np.asarray(cols, np.int64)], axis=-1))
    gi = torch.cat(grp.all_gather_v(idx)).numpy()
    gv = torch.cat(grp.all_gather_v(_values_real(vals)))
    return gi[:, 0], gi[:, 1], _values_back(gv, vals)


def exchange_triplets(rows, cols, vals, dest, grp: Group | None = None):
    """Route each (i, j, v) numpy triplet to the rank ``dest`` (a world
    rank; each triplet goes once per listed destination) -> this rank's
    received (rows, cols, vals), in sender order and, within a sender,
    in the order sent."""
    grp = grp or world()
    vals = np.asarray(vals)
    if grp.size == 1:
        return (np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                vals)
    dest = np.asarray(dest, np.int64)
    lookup = np.full(max(grp.ranks) + 1, -1, np.int64)
    lookup[list(grp.ranks)] = np.arange(grp.size)
    pos = lookup[dest]
    order = np.argsort(pos, kind="stable")
    counts = np.bincount(pos, minlength=grp.size).tolist()
    idx = np.stack([np.asarray(rows, np.int64)[order],
                    np.asarray(cols, np.int64)[order]], axis=-1)
    gi = grp.all_to_all_v(_np_to_tensor(idx), counts).numpy()
    gv = grp.all_to_all_v(_values_real(vals[order]), counts)
    return gi[:, 0], gi[:, 1], _values_back(gv, vals)
