"""Run a function as every rank of a new world, one process per rank.

    run("package.module:function", world_size, args=(...),
        workdir=..., timeout=...)

spawns ``world_size`` Python processes, each running

    python -m ntpoly_tpu_torch.parallel.launch TARGET RANK SIZE ...

which joins the world through a ``FileStore`` under ``workdir`` (no
port to pick), calls ``function(*args)`` and leaves.  Every collective
of the world times out after ``timeout`` seconds, and the parent kills
every rank that is still running ``timeout`` + 30 s after the start, so
that a hung world fails within its limit.  A rank that fails, or a kill,
raises :class:`WorldError` with every rank's standard error.  Each rank
caps torch at ``threads`` intra-op threads.

``torchrun --nproc-per-node N`` is the other way to start a world: the
library joins it from the environment (``api.ConstructGlobalProcessGrid``
or ``dist.initialize()``).
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from ..utils.errors import NTPolyError

REPO = Path(__file__).resolve().parents[2]


class WorldError(NTPolyError, RuntimeError):
    """A rank of a spawned world failed or outlived its timeout."""


def run(target: str, world_size: int, *, args=(), workdir,
        timeout: float = 300.0, threads: int = 1,
        pythonpath=()) -> list:
    """Run ``target`` ("module:function") as each rank of a new world
    of ``world_size`` ranks -> every rank's standard output, in rank
    order.  ``args`` must be JSON values.  The backend is
    :func:`dist.initialize`'s default: with as many cards as ranks,
    each rank works on its own card."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / f"rendezvous-{os.getpid()}-{time.monotonic_ns()}"
    penv = dict(os.environ)
    penv["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), *map(str, pythonpath)]
        + ([penv["PYTHONPATH"]] if penv.get("PYTHONPATH") else []))
    penv["OMP_NUM_THREADS"] = str(threads)
    procs, logs = [], []
    for rank in range(world_size):
        out = open(workdir / f"rank{rank}.out", "w+")
        err = open(workdir / f"rank{rank}.err", "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ntpoly_tpu_torch.parallel.launch",
             target, str(rank), str(world_size), f"file://{store}",
             str(timeout), str(threads), json.dumps(list(args))],
            stdout=out, stderr=err, env={**penv, "LOCAL_RANK": str(rank)},
            cwd=str(REPO)))
    deadline = time.monotonic() + timeout + 30.0
    killed = False
    try:
        for p in procs:
            left = deadline - time.monotonic()
            try:
                p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                killed = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if killed or bad:
        why = (f"killed after {timeout + 30.0:.0f} s" if killed
               else f"ranks {bad} failed")
        detail = "\n".join(f"--- rank {r} (exit {p.returncode}) stderr:\n"
                           f"{texts[r][1][-4000:]}"
                           for r, p in enumerate(procs))
        raise WorldError(f"world of {world_size} running {target}: {why}\n"
                         + detail)
    return [t[0] for t in texts]


def _main(argv) -> None:
    target, rank, size, init, timeout, threads, args = argv
    import torch
    torch.set_num_threads(int(threads))
    from . import dist
    dist.initialize(init_method=init, rank=int(rank),
                    world_size=int(size), timeout=float(timeout))
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        fn(*json.loads(args))
        sys.stdout.flush()
    finally:
        dist.shutdown()


if __name__ == "__main__":
    _main(sys.argv[1:])
