"""Named wall-clock timers.

Counterpart of ``ntpoly_tpu/utils/timer.py``.  On one device every
timer is already global, so ``print_all_timers_distributed`` is an
alias.  The timers measure host wall time: a caller timing work on the
card synchronizes it (``torch.cuda.synchronize``) before stopping.
"""
from __future__ import annotations

import time

from .logging import logger, sub_log

_starts: dict[str, float] = {}
_totals: dict[str, float] = {}


def register_timer(name: str):
    _totals.setdefault(name, 0.0)


def start_timer(name: str):
    register_timer(name)
    _starts[name] = time.perf_counter()


def stop_timer(name: str):
    t0 = _starts.pop(name, None)
    if t0 is not None:
        _totals[name] = _totals.get(name, 0.0) + time.perf_counter() - t0


def get_timer(name: str) -> float:
    return _totals.get(name, 0.0)


def reset_timers():
    _starts.clear()
    _totals.clear()


def print_all_timers():
    with sub_log("Timers"):
        for name, total in _totals.items():
            logger.write_element(name, total)


print_all_timers_distributed = print_all_timers
