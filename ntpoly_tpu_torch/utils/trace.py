"""Program spans and counters: where a solve's time and host reads go.

**Spans.**  ``with span("ntp.matmul"): ...`` (or the decorator
:func:`spanned`) marks one stretch of the program.  A span records only
while a ``torch.profiler`` is recording (``torch.autograd.profiler.
_is_profiler_enabled``): there is no setting of its own, an operator
turns it on the way they already profile.  Then each span

  - opens ``torch.profiler.record_function(name)``, so that it lies on
    the profiler's clock beside the device's events;
  - records its name, its start and end (``time.perf_counter_ns``), its
    parent span and the solve it belongs to (every ``ntp.solve`` span
    starts a new solve id, the spans inside it share it);
  - if it was opened ``timed``, records a timing ``torch.cuda.Event``
    pair on the current stream, unless that stream is capturing a CUDA
    graph.  The pairs are resolved in one synchronisation when
    :func:`summary` is read, which gives the stream milliseconds between
    the span's start and end: the device's work inside the span and
    any idle stretch while the host was still launching it.  Only the
    spans whose stream time is read are timed (``ntp.matmul``,
    ``ntp.compact``, ``ntp.increment``, ``ntp.reduce``,
    ``ntp.collective``); an event pair
    costs host time that shows as idle where the device waits.

With the profiler off, a span is a flag check that returns a shared
no-op object: nothing is allocated and neither torch nor CUDA is
called.

The store holds what the last unbroken profiled stretch recorded: the
first span to run under a profiler after any span ran without one
clears it.  :func:`summary` returns per-name totals (count, host
seconds, host self seconds = duration less the child spans', device
seconds and device self seconds, the stream seconds of timed spans)
and the counters' increments over the stretch; :func:`records` the
raw spans (at most RECORDS of them); :func:`reset` clears the store.
The profiler's own ``export_chrome_trace`` is the timeline.

Spans of the program (``ntpoly_tpu_torch``), by name: ``ntp.solve``
(every solver, ``solvers/common.solver_log``), ``ntp.prologue``,
``ntp.epilogue`` and ``ntp.mu`` (the purification solvers), ``ntp.chunk``
(one chunk of a chunked solve), ``ntp.chunk.capture`` and
``ntp.chunk.replay`` (its CUDA graph), ``ntp.host_read`` (:func:`read`),
``ntp.matmul``, ``ntp.structure`` (the SpGEMM's structure pass),
``ntp.compact`` (the full-span band product's compact, the slices'
merge), ``ntp.increment``, ``ntp.reduce`` (the algebra's scalar
reductions) and ``ntp.collective`` (one backend call of a process group
of several ranks, ``parallel/dist.Group``: the wait for the slowest
member included).

**Counters.**  One registry of named groups of integer counters,
always on: ``ops.spgemm.launches`` (group ``launches``: kernel launches
per wrapper), ``ops.reduce.reductions`` (group ``reductions``: the slot
reductions' kernel launches per wrapper), ``parallel.algebra.multiplies``
(group ``multiplies``: ``matmul`` calls), ``parallel.dist.counts``
(group ``collectives``: ``calls``, the backend calls of groups of
several ranks, and ``bytes_in``, the bytes they brought from the other
members) and :data:`counts` (group
``program``: ``host_reads``,
``matmul.regrows``, ``chunk.redos``, ``graph.captures``,
``graph.replays``, ``solver.iterations``).  :func:`snapshot`,
:func:`restore`, :func:`since` and :func:`add` let a CUDA graph set
aside what its capture counted and add it on each replay
(``solvers/common._Graph``).  The program runs its spans on one host
thread.
"""
from __future__ import annotations

import functools
import time
from collections import namedtuple

import torch
import torch.autograd.profiler as _profiler

SOLVE = "ntp.solve"
HOST_READ = "ntp.host_read"
# raw span records kept per stretch; the totals count every span
RECORDS = 1 << 16
# unresolved event pairs kept before the completed ones are resolved
PENDING = 1 << 12

Record = namedtuple("Record", "id name parent solve start_ns end_ns")

# ----------------------------------------------------------------------------
# counters
# ----------------------------------------------------------------------------

_GROUPS: dict[str, dict[str, int]] = {}


def counter_group(name: str, keys) -> dict:
    """Register the group ``name`` of counters ``keys`` (all 0) and
    return its dict, which the program bumps in place."""
    if name in _GROUPS:
        raise ValueError(f"counter group {name!r} exists")
    _GROUPS[name] = dict.fromkeys(keys, 0)
    return _GROUPS[name]


def reset_counters(group: str | None = None) -> None:
    """Set every counter of ``group`` (of every group: None) to 0."""
    for g in ((group,) if group is not None else _GROUPS):
        d = _GROUPS[g]
        for key in d:
            d[key] = 0


def snapshot() -> dict:
    """Every counter's value: {group: {key: value}}."""
    return {g: dict(d) for g, d in _GROUPS.items()}


def restore(snap: dict) -> None:
    """Set the counters back to a :func:`snapshot`."""
    for g, d in snap.items():
        _GROUPS[g].update(d)


def since(snap: dict, until: dict | None = None) -> dict:
    """The increments from ``snap`` to ``until`` (now: None)."""
    now = until if until is not None else snapshot()
    return {g: {k: v - snap.get(g, {}).get(k, 0) for k, v in d.items()}
            for g, d in now.items()}


def add(delta: dict) -> None:
    """Add increments of :func:`since` to the counters."""
    for g, d in delta.items():
        group = _GROUPS[g]
        for k, v in d.items():
            group[k] += v


counts = counter_group("program", (
    "host_reads", "matmul.regrows", "chunk.redos", "graph.captures",
    "graph.replays", "solver.iterations"))


def read(x: torch.Tensor):
    """``x.tolist()``: one device-to-host read of the solve path,
    counted (``host_reads``) under an ``ntp.host_read`` span."""
    counts["host_reads"] += 1
    with span(HOST_READ):
        return x.tolist()


# ----------------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------------

class _Store:
    def __init__(self):
        self.totals: dict[str, list] = {}
        self.records: list = []
        self.dropped = 0
        self.pending: list = []     # (name, parent name, start, end)
        self.counts_at = snapshot()
        self.counts_end = None


_store = _Store()
_pool: list = []        # resolved timing events, recorded again by spans
_live = False           # the store is recording a profiled stretch
_stack: list = []       # open spans, innermost last
_solve = [0, 0]         # [current solve id, last id given]
_ids = [0]


def reset() -> None:
    """Clear the store: totals, records and the counters' baseline."""
    global _store
    _store = _Store()


def _total(name: str) -> list:
    # count, host ns, host self ns, device ms, device self ms, timed
    t = _store.totals.get(name)
    if t is None:
        t = _store.totals[name] = [0, 0, 0, 0.0, 0.0, 0]
    return t


def _resolve(pending: list) -> None:
    for name, parent, start, end in pending:
        ms = start.elapsed_time(end)
        _pool.extend((start, end))
        t = _total(name)
        t[3] += ms
        t[4] += ms
        t[5] += 1
        if parent is not None:
            _total(parent)[4] -= ms


def _resolve_done() -> None:
    """Fold the pairs whose end has completed into the totals (bounds
    the pending list of a long stretch without a synchronisation)."""
    done, waiting = [], []
    for p in _store.pending:
        (done if p[3].query() else waiting).append(p)
    _store.pending = waiting
    _resolve(done)


def _events() -> bool:
    return (torch.cuda.is_initialized()
            and not torch.cuda.is_current_stream_capturing())


def _record(stream) -> torch.cuda.Event:
    """A timing event recorded on ``stream`` (one of the pool's when it
    has one: a CUDA event is created once and recorded again)."""
    ev = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "timed", "id", "parent", "solve", "outer_solve",
                 "fn", "t0", "child", "ev", "stream")

    def __init__(self, name: str, timed: bool):
        self.name = name
        self.timed = timed

    def __enter__(self):
        global _live
        if not _live:
            reset()
            _live = True
        _ids[0] += 1
        self.id = _ids[0]
        self.parent = _stack[-1] if _stack else None
        self.outer_solve = _solve[0]
        if self.name == SOLVE:
            _solve[1] += 1
            _solve[0] = _solve[1]
        self.solve = _solve[0]
        self.child = 0
        self.fn = _profiler.record_function(self.name)
        self.fn.__enter__()
        # a span lies wholly inside or outside a capture, so its end is
        # recorded on the stream of its start
        self.ev = None
        if self.timed and _events():
            self.stream = torch.cuda.current_stream()
            self.ev = _record(self.stream)
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack.pop()
        parent = self.parent
        pname = parent.name if parent is not None else None
        if self.ev is not None:
            _store.pending.append((self.name, pname, self.ev,
                                   _record(self.stream)))
            self.stream = None
            if len(_store.pending) >= PENDING:
                _resolve_done()
        self.ev = None
        self.fn.__exit__(*exc)
        self.fn = None
        dur = t1 - self.t0
        t = _total(self.name)
        t[0] += 1
        t[1] += dur
        t[2] += dur - self.child
        if parent is not None:
            parent.child += dur
        if len(_store.records) < RECORDS:
            _store.records.append(Record(
                self.id, self.name, parent.id if parent is not None else None,
                self.solve, self.t0, t1))
        else:
            _store.dropped += 1
        _solve[0] = self.outer_solve
        self.parent = None
        return False


class _Off:
    """The shared span of an unprofiled stretch: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _break() -> None:
    """The first span without a profiler after a profiled stretch: the
    stretch is over, its counters' increments end here."""
    global _live
    _live = False
    _store.counts_end = snapshot()


def span(name: str, timed: bool = False):
    """A context manager marking one stretch of the program as ``name``
    (see the module docstring), its stream time recorded if ``timed``;
    with the profiler off, a shared no-op."""
    if not _profiler._is_profiler_enabled:
        if _live:
            _break()
        return _OFF
    return _Span(name, timed)


def spanned(name: str, timed: bool = False):
    """Decorator form of :func:`span`: each call of the function is one
    span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            # the flag check of span() inline: no with-block when off
            if not _profiler._is_profiler_enabled:
                if _live:
                    _break()
                return fn(*args, **kwargs)
            with _Span(name, timed):
                return fn(*args, **kwargs)
        return inner
    return wrap


def summary() -> dict:
    """The store's totals: {'spans': {name: {'count', 'host_s',
    'self_s', 'device_s', 'device_self_s'}}, 'counters': {group: {key:
    increment over the stretch}}, 'records', 'dropped'}.  The device
    seconds are the timed spans' stream seconds, idle inside included;
    None for a name none of whose spans recorded events (untimed, on
    the CPU, or inside a capture).  Reading it resolves the pending
    event pairs in one synchronisation."""
    if _store.pending:
        torch.cuda.synchronize()
        pending, _store.pending = _store.pending, []
        _resolve(pending)
    spans = {}
    for name, (n, host, own, dev, dev_own, timed) in _store.totals.items():
        spans[name] = {"count": n, "host_s": host * 1e-9,
                       "self_s": own * 1e-9,
                       "device_s": dev * 1e-3 if timed else None,
                       "device_self_s": dev_own * 1e-3 if timed else None}
    return {"spans": spans,
            "counters": since(_store.counts_at, _store.counts_end),
            "records": len(_store.records), "dropped": _store.dropped}


def records() -> list:
    """The store's raw spans (:data:`Record`: id, name, parent id, solve
    id, start and end in ``perf_counter_ns``), in the order they
    ended."""
    return list(_store.records)
