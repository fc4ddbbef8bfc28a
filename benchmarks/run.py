"""Run one cell of the benchmark once on the CUDA card(s) of this machine.

From the root of a checkout:

    python3 -m benchmarks.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
untraced, its per-layer metrics traced), ``device``, ``breakdown``
(traced) and, last, ``checks``: each number compared with its limit,
also printed as the last lines of standard error.  The readings that
the limits were set from, the controls' with them, come from
``python3 -m benchmarks.limits``.

The run exits non-zero, printing no result, without enough CUDA cards,
or when the JAX package or JAX itself was loaded in this process.  Run
as a script, it holds itself to HOST_THREADS cores before anything
else starts a thread.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches of the libraries, at fixed paths inside the
# checkout (the port builds its kernels into ntpoly_tpu_torch/_build/)
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}
# host threads of torch's CPU pool: the host only drives the card
HOST_THREADS = 2


def _pin() -> None:
    """Hold this process, and every thread it starts later, to the last
    HOST_THREADS cores it may run on: the host's work between launches
    then keeps its caches and is not moved between cores."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-HOST_THREADS:])


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    import torch

    from benchmarks import cells, harness

    cell = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device=torch.device("cuda", 0), started=STARTED)
    foreign = harness.foreign_modules()
    if foreign:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(foreign), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    _pin()
    sys.exit(main())
