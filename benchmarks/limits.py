"""The readings that a cell's check limits are set from.

A run's pool is one fixed set of Hamiltonians (the traffic mix's
``set_seed``; the run's seed orders the calls), so here each seed
draws a set of its own in its place: one process sets up the cell's
entry on it as a run does, makes one call per pool member, frees the
program's state and compares every output with the reference; then
the same with each of the cell's controls in the program's place.  The
limit of each number lies between the largest program reading (the
lower) and the smallest reading of a control (the upper), with more
room above the lower.  On a machine with a CUDA card, from the repository root:

    python3 -m benchmarks.limits --workload <cell> --first-seed <n> \\
        [--seeds 12] [--controls 3]

prints one JSON line per seed and, last, the lower reading of each
number and the upper reading of each number under each control.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from benchmarks import cells


def readings(cell, seed: int, device, control: str | None) -> dict:
    """Every output of a pool drawn from ``seed``, compared -> the
    largest reading of each number."""
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  set_seed=seed))
    session = cells.entry(cell).Session(cell, seed, device, control=(
        cell.spec["controls"][control] if control else None))
    session.setup()
    outs = [session.keep(session.call(n)) for n in range(session.pool)]
    session.release()
    return session.check(outs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    device = torch.device("cuda")
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    lower, upper = {}, {}
    runs = [(None, args.first_seed + n) for n in range(args.seeds)]
    for c, control in enumerate(cell.spec["controls"]):
        runs += [(control, args.first_seed + args.seeds
                  + c * args.controls + n) for n in range(args.controls)]
    for control, seed in runs:
        try:
            got = readings(cell, seed, device, control)
        except Exception as err:            # a control that crashes fails
            if not control:
                raise
            print(json.dumps({"seed": seed, "control": True,
                              "error": repr(err)}), flush=True)
            continue
        print(json.dumps({"seed": seed, "control": control, **got}),
              flush=True)
        for name, v in got.items():
            if control:
                up = upper.setdefault(control, {})
                up[name] = min(up.get(name, float("inf")), v)
            else:
                lower[name] = max(lower.get(name, 0.0), v)
    print(json.dumps({"workload": cell.name, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
