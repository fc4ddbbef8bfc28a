"""Reduction of a torch.profiler trace to the numbers the per-layer
metrics read.

The traced span is one host range, ``bench.window``, opened by the
harness around a bounded number of calls after warm-up.  Inside it:

  busy_s     the union of the device operations' intervals (kernels,
             copies, fills), clipped to the window;
  window_s   the window's length on the host;
  kernel_s   the summed device time of the hand-written kernels, whose
             symbols ``kernels.json`` lists; ``kernel_count`` their
             launches, which the harness holds against the program's
             own launch counters;
  other_s    every other device operation's summed time: the plain
             torch glue, copies and fills;
  device_ops the operations that took most device time, by name;
  idle_gaps  the stretches with no device operation, summed by the
             innermost host operation that was running at their
             midpoint, the largest sums first.

Times in the profiler are microseconds on one clock for host and
device events.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
WINDOW = "bench.window"
SPAN_PREFIX = "bench."
# host operations looked back through for a gap's innermost one
SEARCH = 256
TOP = 10


def kernel_symbols() -> list[str]:
    """Substrings that name the program's hand-written kernels."""
    with open(HERE / "kernels.json") as f:
        return list(json.load(f)["symbols"])


def events(prof):
    """(device, host): lists of (name, start_us, end_us) from a
    finished torch.profiler.profile.  Ranges the benchmark opened
    (``bench.*``) that the profiler mirrors onto the device timeline
    are host spans, not device work, and are left out of ``device``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if (e.name.startswith(SPAN_PREFIX)
                    or getattr(e, "is_user_annotation", False)):
                continue
            device.append(item)
        else:
            host.append(item)
    return device, host


def _union(intervals):
    """Merged, sorted, disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(device, host, symbols) -> dict:
    """The numbers of the module docstring from ``events``' lists."""
    spans = [(a, b) for name, a, b in host if name == WINDOW]
    if not spans:
        raise ValueError(f"the trace has no {WINDOW!r} range")
    w0, w1 = min(a for a, _ in spans), max(b for _, b in spans)
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device
              if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in inside if b > a])
    busy_us = sum(b - a for a, b in busy)
    kernel_us = other_us = 0.0
    kernel_count = 0
    by_name: dict[str, float] = {}
    for name, a, b in inside:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if any(s in name for s in symbols):
            kernel_us += b - a
            kernel_count += 1
        else:
            other_us += b - a
    gaps = []
    edge = w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernel_s": kernel_us * 1e-6, "other_s": other_us * 1e-6,
            "kernel_count": kernel_count,
            "device_ops": _top(by_name),
            "idle_gaps": _top(_gap_labels(gaps, host))}


def _gap_labels(gaps, host) -> dict[str, float]:
    """Idle microseconds by the innermost host operation running at each
    gap's midpoint: of the host operations that contain it, the one that
    started last, a ``bench.*`` span only where no other does."""
    order = sorted(range(len(host)), key=lambda n: host[n][1])
    names = [host[n][0] for n in order]
    starts = np.array([host[n][1] for n in order], dtype=np.float64)
    ends = np.array([host[n][2] for n in order], dtype=np.float64)
    out: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label, span = "no host operation", None
        n = int(np.searchsorted(starts, mid, side="right")) - 1
        for m in range(n, max(-1, n - SEARCH), -1):
            if ends[m] < mid:
                continue
            if not names[m].startswith(SPAN_PREFIX):
                label = names[m]
                break
            span = span or names[m]
        else:
            label = span or label
        out[label] = out.get(label, 0.0) + (b - a)
    return out


def _top(times_us: dict) -> list:
    """The TOP largest as [[name, seconds], ...], largest first."""
    items = sorted(times_us.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, us * 1e-6] for name, us in items]
