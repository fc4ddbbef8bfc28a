"""One run of one cell: set-up, the measured window or the traced span,
the check, and the result line.

Untraced (``trace`` false), the cell's entry (``entries/<entry>.py``)
is set up and warmed, then called back to back until ``seconds`` have
passed, each call waited for.  Traced, a bounded span of calls
(``workloads/<cell>.json``'s ``trace.calls``) runs under torch.profiler,
then one call per pool member with the solver's log on, then the
entry's roofline product.  Either way a sample of the outputs is kept
and compared with the reference once the program's state is freed:
untraced, the calls of ``check.calls`` indices drawn from the seed
before the window opens, out of its first ``check.within`` calls (fewer
than a window of the benchmark's length completes); traced, every
logged call.

An entry module gives ``CHECKS`` (the names of the numbers its check
compares) and a ``Session(cell, seed, device, control)`` with ``pool``,
``setup()``, ``call(n)``, ``keep(output)``, ``counters()``,
``logged_calls(first, count)``, ``roofline(output)``, ``release()`` and
``check(kept)``; ``entries/trs4.py`` says what each does.  ``control``
is None (the program) or an entry of the cell's ``controls``.

The readers of ``metrics/`` get one dict of records:

  setup_s        process start to the first measured call (both)
  window_s, calls, call_times   the window (untraced)
  peak_bytes     the allocator's peak over the window, less the bytes
                 of the kept sample held at the time (untraced): what
                 the program holds
  traced_calls, trace, counters   the profiled span: ``trace.reduce``'s
                 numbers and the program's counters' increments
  iterations     per call, from the solver's log
  roofline       the entry's {'bytes', 'flops', 'seconds'}
"""
from __future__ import annotations

import math
import random
import statistics
import sys
import time
import traceback

import torch

from benchmarks import cells
from benchmarks import trace as tr

# top-level module names that may not be loaded in a run's process
FOREIGN = ("jax", "jaxlib", "flax", "ntpoly_tpu")


def kept_calls(seed: int, size: int, within: int) -> frozenset:
    """The indices of the window's calls whose outputs are kept: a
    uniform draw of ``size`` of its first ``within``, from ``seed``."""
    return frozenset(random.Random(seed).sample(range(within),
                                                min(size, within)))


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FOREIGN."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FOREIGN})


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def _allocated(device) -> int:
    return torch.cuda.memory_allocated(device) \
        if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _window(session, seconds, keep, device) -> tuple[dict, list, int,
                                                       int]:
    """Calls back to back for ``seconds``; the outputs of the calls in
    ``keep`` are kept.  The allocator's peak is read call by call, and
    the kept outputs' bytes, constant during a call, are taken off the
    program's."""
    times, kept = [], []
    kept_bytes = peak = process_peak = 0
    failed = 0
    t0 = t1 = time.perf_counter()
    while t1 - t0 < seconds:
        start = time.perf_counter()
        _reset_peak(device)
        try:
            out = session.call(len(times))
            _sync(device)
        except Exception:
            traceback.print_exc()
            failed = 1
            break
        t1 = time.perf_counter()
        process_peak = max(process_peak, _peak(device))
        peak = max(peak, _peak(device) - kept_bytes)
        if len(times) in keep:
            before = _allocated(device)
            kept.append(session.keep(out))
            kept_bytes += _allocated(device) - before
        times.append(t1 - start)
        del out
    t1 = time.perf_counter()
    if times:
        print(f"# window: {len(times)} calls in {t1 - t0:.3f} s; first "
              f"{[round(t, 4) for t in times[:3]]}, median "
              f"{statistics.median(times):.4f}, max {max(times):.4f} s",
              file=sys.stderr)
    return ({"window_s": t1 - t0, "calls": len(times), "call_times": times,
             "peak_bytes": peak, "process_peak_bytes": process_peak},
            kept, len(times) + failed, failed)


def _traced(session, spec, device) -> tuple[dict, list, int]:
    from torch.profiler import ProfilerActivity, profile, record_function
    n = int(spec["trace"]["calls"])
    before = session.counters()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(tr.WINDOW):
            for c in range(n):
                last = session.call(c)
                _sync(device)
    after = session.counters()
    counters = {k: after[k] - before[k] for k in after}
    device_ev, host_ev = tr.events(prof)
    del prof
    reduced = tr.reduce(device_ev, host_ev, tr.kernel_symbols())
    launches = sum(v for k, v in counters.items() if k != "matmul")
    if reduced["kernel_count"] != launches:
        print(f"# trace: {reduced['kernel_count']} hand-written kernel "
              f"launches in the trace, {launches} counted by the program",
              file=sys.stderr)
    outs, iterations = session.logged_calls(n, session.pool)
    rec = {"traced_calls": n, "trace": reduced, "counters": counters,
           "iterations": iterations}
    if device.type == "cuda":
        rec["roofline"] = session.roofline(last)
    del last
    rec["process_peak_bytes"] = _peak(device)
    return rec, outs, n + len(outs)


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, *,
        device, started: float, control: str | None = None) -> dict:
    """One run (see the module docstring) -> the result line's dict.
    ``started`` is the process's start on ``time.perf_counter``'s
    clock; ``control`` names one of the cell's ``controls`` to run in
    the program's place."""
    device = torch.device(device)
    spec = cell.spec
    entry = cells.entry(cell)
    loaded = time.perf_counter()
    session = entry.Session(cell, seed, device, control=(
        spec["controls"][control] if control is not None else None))
    session.setup()
    _sync(device)
    setup_peak = _peak(device)
    rec = {"setup_s": time.perf_counter() - started}
    print(f"# setup: {rec['setup_s']:.3f} s, of it {loaded - started:.3f} "
          f"s to load the program", file=sys.stderr)
    _reset_peak(device)
    check = spec["check"]
    if trace:
        traced, kept, attempted = _traced(session, spec, device)
        rec.update(traced)
        failed = 0
    else:
        keep = kept_calls(seed, int(check["calls"]), int(check["within"]))
        window, kept, attempted, failed = _window(session, seconds, keep,
                                                  device)
        rec.update(window)
    peak = max(setup_peak, rec["process_peak_bytes"])
    session.release()
    readings = session.check(kept) if kept else {}
    limits = check["limits"]
    checks = {name: {"value": readings.get(name, math.inf),
                     "limit": limits[name]} for name in limits}
    correct = (failed == 0 and bool(kept)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(cell, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = checks
    return out
