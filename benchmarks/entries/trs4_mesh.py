"""TRS4 density solves on a process grid of one rank per card.

The caller is an SCF or MD driver that runs the library as an SPMD
program: every rank builds its tiles through the public constructors on
its own grid (``ProcessGrid(rows, cols, slices)``, ``PM.banded``,
``PM.identity``) and calls ``solvers.density.trs4`` on them, as a user's
program does after ``ConstructGlobalProcessGrid``.

The harness's process is rank 0, on the card it was given.  At set-up
it starts ranks 1 to rows * cols * slices - 1 as processes of their own
(``python3 -m benchmarks.entries.trs4_mesh``), each on card ``rank`` and
held to HOST_THREADS host cores of its own, disjoint from rank 0's and
from each other's where the machine has them.  The world joins through
a file store under a fresh temporary directory, over
``dist.initialize``'s backend (``cpu:gloo,cuda:nccl`` with a card a
rank, ``gloo`` on the CPU), with every collective bounded by
TIMEOUT_S.  Rank 0 then sends every step of the session (a call, a
kept output, the logged calls, the roofline product, the release, the
check) to each worker as one line on its standard input before doing
it itself, so that every rank runs the same collectives in the same
order.  A worker that is gone, a step that fails on rank 0, or a
collective that times out makes rank 0 raise (gloo at once, NCCL within
TIMEOUT_S); a worker dies with rank 0 (``PR_SET_PDEATHSIG``) and exits
when its standard input closes.

Each rank keeps its own tile of a kept output on its card (two tiles of
about 4 GiB beside the solve's 60 GiB at 2^22 rows), as ``entries/
trs4.py`` does: a copy to host memory inside the window would be timed
with the calls.  The check runs the
reference split over the same world (``reference/trs4_grid.py``): the
ranks of grid row r hold the block rows of row panel r, each rank holds
its tile (row panel r, column panel c) against its slab's blocks in
column panel c, and the squared differences, the norms and the worst
scalars are reduced over the world, so that every rank reads the same
numbers as ``entries/trs4.py``'s CHECKS:

  density_rel_fro, energy_err_per_electron, mu_outside_gap

A control is the program at another precision tier on every rank, or
the split reference in float32 on TF32-rounded operands.  Every rank
prints its peak ``max_memory_allocated`` over the calls to standard
error at the release; the harness reads rank 0's.

A test plants a fault on every rank by naming a function in the cell's
spec (``workloads/<cell>.json``'s object, ``"plant": "module:function"``):
each worker calls it once it has joined the world.  Rank 0 is the test's own
process, where the test plants the same fault itself.
"""
from __future__ import annotations

import atexit
import ctypes
import importlib
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as tdist

from benchmarks import roofline
from benchmarks.entries import trs4 as one
from benchmarks.reference import trs4_grid as G
from benchmarks.traffic import hamiltonians

from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.parallel import dist
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers.parameters import SolverParameters

# every collective of the world, and the world's start, are bounded so
TIMEOUT_S = 120.0
# host cores (and torch threads) of each worker, as run.py gives rank 0
HOST_THREADS = 2
ROOT = Path(__file__).resolve().parents[2]
CHECKS, Output = one.CHECKS, one.Output


class WorldError(RuntimeError):
    """A rank of the session's world failed or is gone."""


# ----------------------------------------------------------------------------
# one rank's work: the same on rank 0 and on every worker
# ----------------------------------------------------------------------------

class _Rank(one.Session):
    """``entries/trs4.py``'s session on this rank's tiles: an output
    holds this rank's tile (``cols`` int[nbr, k] of global col ids,
    ``blocks`` [nbr, k, bs, bs]).  The pool's values, the solver's
    parameters, the kept copies and the logged calls are the one-card
    session's."""

    def __init__(self, cell, seed: int, device, control,
                 reset_peaks: bool = False):
        super().__init__(cell, seed, device, control)
        self.shape = tuple(int(v) for v in cell.traffic["grid"])
        self.last = None
        self.kept: list[Output] = []
        # a worker reads its peak call by call, as the harness reads
        # rank 0's
        self.reset_peaks = reset_peaks
        self.peak = 0

    def _reference_control(self) -> bool:
        return bool(self.control) and self.control["kind"] == "reference"

    def setup(self) -> None:
        """Build the pool's tiles (under the reference control, its
        slabs) on this rank's card and warm up with one solve (it also
        opens every NCCL communicator the solves use)."""
        cfg = self.config
        dtype = getattr(torch, cfg["dtype"])
        self.grid = ProcessGrid(*self.shape, device=self.device)
        nb = PM.geometry(self.rows, self.bs, self.grid)[0]
        self.split = G.split(nb, self.shape[0],
                             self.shape[1] * self.shape[2])
        if self._reference_control():
            self.hams = [G.slab_from_values(
                self._values(i), self.rows, self.bs, self._band(),
                int(cfg["halfwidth"]), self.split, dtype, self.device)
                for i in range(self.pool)]
        else:
            with torch.profiler.record_function("bench.fill"):
                self.hams = [PM.banded(self.rows, int(cfg["halfwidth"]),
                                       self._values(i), bs=self.bs,
                                       grid=self.grid, dtype=dtype)
                             for i in range(self.pool)]
                self.isq = PM.identity(self.rows, bs=self.bs,
                                       grid=self.grid, dtype=dtype)
            solver = dict(self.cell.traffic["solver"])
            if self.control:
                solver["precision"] = self.control["precision"]
            self._params = SolverParameters(
                threshold=float(cfg["threshold"]), **solver)
        self.call(0)
        self.last = None

    def call(self, n: int) -> Output:
        """The n-th call, as the one-card session makes it; the split
        reference under the reference control."""
        self.last = None
        cuda = self.device.type == "cuda"
        if cuda and self.reset_peaks:
            torch.cuda.reset_peak_memory_stats(self.device)
        if self._reference_control():
            out = self._reference_call(n)
        else:
            out = super().call(n)
        if cuda:
            torch.cuda.synchronize(self.device)
            self.peak = max(self.peak,
                            torch.cuda.max_memory_allocated(self.device))
        self.last = out
        return out

    def _reference_call(self, n: int) -> Output:
        if n >= len(self.order):
            self.order = hamiltonians.order(self.seed, self.pool,
                                            2 * n + self.pool)
        i = self.order[n]
        with torch.profiler.record_function("bench.solve"):
            sol = G.trs4(self.hams[i], self.nel, self.split,
                         dtype=self.hams[i].dtype,
                         operands=one.OPERANDS[self.control["operands"]])
        c0 = self.grid.my_col * (self.split.nb // self.shape[1])
        cols, blocks = G.slab_to_ell(sol.density, self.split, c0,
                                     c0 + self.split.nb // self.shape[1])
        return Output(i, cols, blocks, sol.energy, sol.mu)

    def keep(self, out: Output) -> Output:
        """A copy of this rank's tile of ``out``, kept for the check."""
        kept = super().keep(out)
        self.kept.append(kept)
        return kept

    def logged_calls(self, first: int, count: int):
        """The one-card session's logged calls; the call that the
        roofline product reads stays the one before them."""
        last = self.last
        try:
            return super().logged_calls(first, count)
        finally:
            self.last = last

    def roofline(self, out: Output) -> dict:
        """One distributed ``matmul(K, K)`` of the density of ``out`` at
        the cell's tier, threshold and capacity, the L2 flushed on every
        rank before each launch, timed on this rank with CUDA events ->
        {'bytes', 'flops', 'seconds'} of this rank's share: the block
        products its tile of C needs from its gathered panels, those
        panels' blocks and its output tile's.  (The one-card session's
        product reads a whole matrix's structure, so it is not used.)"""
        k, p = out.matrix, self._params
        policy = dict(k_out=p.k_out, precision=p.precision,
                      method=p.matmul_method, defer=True,
                      on_overflow={"ignore": "truncate", "warn": "warn"}
                      .get(p.on_overflow, "grow"))
        flush = torch.empty(one.FLUSH_BYTES, dtype=torch.uint8,
                            device=self.device)
        g = self.grid
        # the panels the SUMMA gathers: A's row panel (its tiles over
        # 'cols', side by side), B's column panel (over 'rows', stacked)
        a_panel = torch.stack(g.group("cols").all_gather(k.col_ids[0]),
                              1).reshape(k.nbr, -1)
        b_panel = torch.cat(g.group("rows").all_gather(k.col_ids[0]))
        times = []
        with alg.capacity_policy(**policy):
            c = alg.matmul(k, k, threshold=p.threshold)
            work = roofline.product(a_panel, b_panel, c.col_ids[0], k.nb,
                                    k.bs, k.blocks.element_size(),
                                    same=False)
            del c, a_panel, b_panel
            for _ in range(one.ROOFLINE_REPS):
                flush.zero_()
                torch.cuda.synchronize(self.device)
                g.group("all").barrier()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                c = alg.matmul(k, k, threshold=p.threshold)
                end.record()
                torch.cuda.synchronize(self.device)
                times.append(start.elapsed_time(end) * 1e-3)
                del c
        return dict(work, seconds=statistics.median(times))

    def release(self) -> None:
        """Free the program's state; print this rank's peak."""
        self.last = None
        super().release()
        if self.device.type == "cuda":
            print(f"# rank {dist.process_index()} ({self.device}): peak "
                  f"max_memory_allocated over the calls "
                  f"{self.peak / 2 ** 30:.4f} GiB", file=sys.stderr,
                  flush=True)

    # -- the check -------------------------------------------------------
    def check(self) -> dict:
        """The largest reading of each of CHECKS over this rank's kept
        tiles, reduced over the world, against the float64 split
        reference of each pool member once."""
        worst = dict.fromkeys(CHECKS, 0.0)
        w, sp_ = self._band(), self.split
        pnb = sp_.nb // self.shape[1]
        c0 = self.grid.my_col * pnb
        with torch.profiler.record_function("bench.check"):
            for i in sorted({o.index for o in self.kept}):
                h = G.slab_from_values(self._values(i), self.rows, self.bs,
                                       w, int(self.config["halfwidth"]),
                                       sp_, torch.float64, self.device)
                ref = G.trs4(h, self.nel, sp_)
                homo, lumo = G.gap_edges(sp_, h, ref.density)
                del h
                if dist.process_index() == 0:
                    print(f"# check: pool member {i}: gap [{homo!r}, "
                          f"{lumo!r}], mu "
                          f"{[o.mu for o in self.kept if o.index == i]}",
                          file=sys.stderr)
                for o in (o for o in self.kept if o.index == i):
                    got, outside = G.slab_from_ell(o.cols, o.blocks, w,
                                                   sp_, self.device)
                    diff, norm = G.panel_difference(got, ref.density, sp_,
                                                    c0, c0 + pnb)
                    del got
                    diff, norm = G.world_sum(diff + outside, norm)
                    rel = diff ** 0.5 / norm ** 0.5
                    err = abs(o.energy - ref.energy) / self.nel
                    out = max(homo - o.mu, o.mu - lumo, 0.0)
                    for name, v in zip(CHECKS, (rel, err, out)):
                        # a reading that is not a number fails
                        v = v if math.isfinite(v) else math.inf
                        worst[name] = max(worst[name], v)
                del ref
        got = G.world_max(*worst.values())
        return dict(zip(CHECKS, got))


# ----------------------------------------------------------------------------
# rank 0: the harness's session
# ----------------------------------------------------------------------------

def _all_cores() -> list[int]:
    """The cores this machine lets its processes run on."""
    try:
        text = Path("/sys/fs/cgroup/cpuset.cpus.effective").read_text()
        cores = set()
        for part in text.strip().split(","):
            lo, _, hi = part.partition("-")
            cores.update(range(int(lo), int(hi or lo) + 1))
        if cores:
            return sorted(cores)
    except (OSError, ValueError):
        pass
    return list(range(os.cpu_count() or 1))


def worker_cores(size: int) -> list[list[int]]:
    """Each worker's HOST_THREADS cores (rank 1 first): the highest
    cores that rank 0 does not run on, two a worker; [] (no pin) for
    the workers that the machine has no free cores for."""
    mine = os.sched_getaffinity(0)
    free = [c for c in reversed(_all_cores()) if c not in mine]
    return [sorted(free[HOST_THREADS * r:HOST_THREADS * (r + 1)])
            if len(free) >= HOST_THREADS * (r + 1) else []
            for r in range(size - 1)]


class Session:
    """Rank 0 of one cell's world (see the module docstring)."""

    def __init__(self, cell, seed: int, device, control=None):
        self.me = _Rank(cell, seed, device, control)
        self.pool = self.me.pool
        self.size = math.prod(self.me.shape)
        self.workers: list[subprocess.Popen] = []
        self.broken = None

    # -- the world -------------------------------------------------------
    def _start(self) -> None:
        # a session that failed before its check left its world behind
        for old in list(_sessions):
            old.broken = old.broken or "superseded by a new session"
            old._stop()
        me = self.me
        if me.device.type == "cuda":
            from ntpoly_tpu_torch.ops import _cuda
            _cuda.build()            # once, before the workers load it
        self._tmp = tempfile.TemporaryDirectory(prefix="trs4_mesh_")
        store = f"file://{Path(self._tmp.name).resolve()}/store"
        spec = dict(cell=me.cell.name, config=me.config,
                    traffic=me.cell.traffic, spec=me.cell.spec,
                    seed=me.seed, control=me.control,
                    device=me.device.type, store=store, size=self.size)
        cores = worker_cores(self.size)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else []))
        env["OMP_NUM_THREADS"] = str(HOST_THREADS)
        for r in range(1, self.size):
            arg = json.dumps(dict(spec, rank=r, cores=cores[r - 1],
                                  parent=os.getpid()))
            self.workers.append(subprocess.Popen(
                [sys.executable, "-m", "benchmarks.entries.trs4_mesh", arg],
                stdin=subprocess.PIPE, stdout=2,
                cwd=str(ROOT), env={**env, "LOCAL_RANK": str(r)},
                text=True))
        _sessions.add(self)
        dist.initialize(init_method=store, rank=0, world_size=self.size,
                        timeout=TIMEOUT_S)

    def _send(self, *cmd) -> None:
        """Send one step to every worker, after checking that each is
        still there."""
        if self.broken:
            raise WorldError(f"the world failed earlier: {self.broken}")
        line = json.dumps(cmd) + "\n"
        for r, p in enumerate(self.workers, 1):
            if p.poll() is not None:
                self._fail(f"rank {r} exited with code {p.returncode}")
            try:
                p.stdin.write(line)
                p.stdin.flush()
            except (BrokenPipeError, OSError) as err:
                self._fail(f"rank {r} is gone ({err!r})")

    def _fail(self, why: str):
        self.broken = why
        raise WorldError(why)

    def _do(self, fn, *args):
        """``fn(*args)`` on rank 0; a failure breaks the world."""
        try:
            return fn(*args)
        except Exception as err:
            self.broken = self.broken or repr(err)
            raise

    def _stop(self) -> None:
        """Every rank leaves the world together (NCCL's teardown is
        collective); after a failure the workers are killed first and
        rank 0 aborts its communicators."""
        if not self.workers:
            return
        _sessions.discard(self)
        if self.broken:
            for p in self.workers:
                p.kill()
        else:
            try:
                self._send("stop")
            except WorldError:
                pass
        _leave(bool(self.broken))
        deadline = time.monotonic() + TIMEOUT_S
        for p in self.workers:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.workers = []
        self._tmp.cleanup()

    # -- the session's steps ---------------------------------------------
    def setup(self) -> None:
        """Start the world, then every rank builds its pool and warms
        up.  A warm-up that fails breaks the world: the window's first
        call then raises, and the run reports itself failed."""
        self._start()
        self._send("setup")
        try:
            self._do(self.me.setup)
        except Exception:
            traceback.print_exc()

    def call(self, n: int) -> Output:
        self._send("call", n)
        return self._do(self.me.call, n)

    def keep(self, out: Output) -> Output:
        self._send("keep")
        return self._do(self.me.keep, out)

    def counters(self) -> dict:
        return self.me.counters()

    def logged_calls(self, first: int, count: int):
        """``count`` calls from the ``first``-th with the solver's YAML
        log on -> (their outputs, kept; the iterations of each)."""
        self._send("logged", first, count)
        return self._do(self.me.logged_calls, first, count)

    def roofline(self, out: Output) -> dict:
        self._send("roofline")
        return self._do(self.me.roofline, out)

    def release(self) -> None:
        """Every rank frees its state; after a failed step rank 0 ends
        the world instead."""
        if self.broken:
            self._stop()
        else:
            self._send("release")
        self._do(self.me.release)

    def check(self, kept: list) -> dict:
        """Every rank compares its kept tiles (the same calls as
        ``kept``, rank 0's); then the world ends.  After a failed step
        nothing is compared, and every reading fails."""
        if self.broken:
            self._stop()
            return dict.fromkeys(CHECKS, math.inf)
        self._send("check")
        try:
            return self._do(self.me.check)
        finally:
            self._stop()


# sessions whose workers run: a session that failed before its check is
# ended by the next one, and any left are killed when rank 0 exits
_sessions: set = set()


@atexit.register
def _reap() -> None:
    for session in _sessions:
        for p in session.workers:
            if p.poll() is None:
                p.kill()


def _leave(broken: bool) -> None:
    """Rank 0 leaves the world, from a thread given at most TIMEOUT_S
    (a teardown that waits on a dead rank must not hang the run)."""
    def leave():
        abort = getattr(tdist.distributed_c10d, "_abort_process_group",
                        None)
        try:
            if (broken and abort is not None and tdist.is_initialized()
                    and "nccl" in str(tdist.get_backend())):
                abort()
            dist.shutdown()
        except Exception:
            traceback.print_exc()
    t = threading.Thread(target=leave, daemon=True)
    t.start()
    t.join(TIMEOUT_S)
    if t.is_alive():
        print("# trs4_mesh: rank 0 did not leave the world within "
              f"{TIMEOUT_S:.0f} s", file=sys.stderr, flush=True)


# ----------------------------------------------------------------------------
# ranks 1 ... size - 1
# ----------------------------------------------------------------------------

def _die_with(parent: int) -> None:
    """Be killed when rank 0 ends, however it ends."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)            # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def worker(spec: dict) -> None:
    """One worker: join the world, then run each step that rank 0 sends
    until it sends 'stop' or its standard input closes."""
    from benchmarks import cells
    cell = cells.Cell(name=spec["cell"], chips=spec["size"],
                      config=spec["config"], traffic=spec["traffic"],
                      spec=spec["spec"], end_to_end=[], per_layer=[],
                      base=ROOT / "benchmarks")
    rank = int(spec["rank"])
    device = (torch.device("cuda", rank) if spec["device"] == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.initialize(init_method=spec["store"], rank=rank,
                    world_size=int(spec["size"]), timeout=TIMEOUT_S)
    if spec["spec"].get("plant"):
        module, _, fn = spec["spec"]["plant"].partition(":")
        getattr(importlib.import_module(module), fn)()
    me = _Rank(cell, int(spec["seed"]), device, spec["control"],
               reset_peaks=True)
    for line in sys.stdin:
        cmd, *args = json.loads(line)
        if cmd == "stop":
            break
        if cmd == "setup":
            me.setup()
        elif cmd == "call":
            me.call(*args)
        elif cmd == "keep":
            me.keep(me.last)
        elif cmd == "logged":
            me.logged_calls(*args)
        elif cmd == "roofline":
            me.roofline(me.last)
        elif cmd == "release":
            me.release()
        elif cmd == "check":
            me.check()
        else:
            raise ValueError(f"unknown step {cmd!r}")
    else:
        os._exit(0)          # rank 0 is gone: leave without the world
    dist.shutdown()


if __name__ == "__main__":
    _spec = json.loads(sys.argv[1])
    _die_with(int(_spec["parent"]))
    if _spec["cores"]:
        os.sched_setaffinity(0, _spec["cores"])
    torch.set_num_threads(HOST_THREADS)
    worker(_spec)
