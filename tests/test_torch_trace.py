"""The port's spans and counters (``ntpoly_tpu_torch/utils/trace.py``)
on the CPU: spans nest and share the solve's id under torch.profiler,
the host-read counter equals the count of the solve path's read sites,
an unprofiled stretch ends what the store holds, a span with the
profiler off never enters ``record_function``, and a chunk's CUDA graph
adds on each replay what its capture counted (a stand-in graph on the
CPU that re-runs the captured chunk)."""
import contextlib
import math
import warnings

import pytest
import torch

from ntpoly_tpu_torch.ops import spgemm as sp
from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.solvers import common, density
from ntpoly_tpu_torch.solvers.parameters import SolverParameters
from ntpoly_tpu_torch.systems import gapped_fn
from ntpoly_tpu_torch.utils import trace

import _torch_port  # noqa: F401  (one torch thread)

ROWS, BS, NEL = 1024, 8, 512.0
# the solver settings of the benchmark's mixes (benchmarks/traffic/):
# the flagship, eager with a host read per iteration, and the chunked
FLAGSHIP = dict(converge_diff=1e-3, convergence_metric="idempotency",
                compensated_scalars=True, k_out=5,
                matmul_method="pallas_band", on_overflow="warn",
                iters_per_sync=1, precision="high", threshold=1e-7)
CHUNKED = dict(converge_diff=1e-6, k_out=8, iters_per_sync=8,
               on_overflow="grow", precision="high", threshold=1e-7)


@pytest.fixture(autouse=True)
def fresh_store():
    """Each test starts with an empty store: two profiled stretches
    with no unprofiled span between them share one."""
    trace.reset()


@pytest.fixture(scope="module")
def system():
    grid = ProcessGrid(device="cpu")
    h = PM.banded(ROWS, 16, gapped_fn, bs=BS, grid=grid,
                  dtype=torch.float32)
    isq = PM.identity(ROWS, bs=BS, grid=grid, dtype=torch.float32)
    return h, isq


def _solve(system, settings, **over):
    h, isq = system
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return density.trs4(h, isq, NEL,
                            SolverParameters(**dict(settings, **over)))


def _profiled(fn):
    with torch.profiler.profile() as prof:
        out = fn()
    return out, prof


def _ancestors(rec, by_id):
    names = []
    while rec.parent is not None:
        rec = by_id[rec.parent]
        names.append(rec.name)
    return names


def test_spans_nest_in_one_solve(system):
    _, prof = _profiled(lambda: _solve(system, FLAGSHIP))
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    names = {r.name for r in recs}
    assert {"ntp.solve", "ntp.prologue", "ntp.epilogue", "ntp.mu",
            "ntp.matmul", "ntp.structure", "ntp.compact",
            "ntp.increment", "ntp.reduce", "ntp.host_read"} <= names
    assert {r.solve for r in recs} == {recs[-1].solve}
    assert recs[-1].name == "ntp.solve" and recs[-1].parent is None
    structure = [r for r in recs if r.name == "ntp.structure"]
    assert structure
    for r in structure:
        up = _ancestors(r, by_id)
        assert up[0] == "ntp.matmul" and up[-1] == "ntp.solve"
    for r in recs:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    # the spans are the profiler's ranges too
    profiled = {e.name for e in prof.events()}
    assert {"ntp.solve", "ntp.matmul", "ntp.structure"} <= profiled
    s = trace.summary()["spans"]
    assert s["ntp.solve"]["count"] == 1
    assert s["ntp.matmul"]["count"] == \
        trace.summary()["counters"]["multiplies"]["matmul"]
    solve = s["ntp.solve"]
    assert 0 < solve["self_s"] < solve["host_s"]
    assert all(v["device_s"] is None for v in s.values())


class _Event:
    """A stand-in for a timing ``torch.cuda.Event``: every pair reads
    one millisecond."""

    def record(self, stream):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return 1.0


def test_only_the_read_spans_are_timed(system, monkeypatch):
    """Event pairs are recorded on the spans whose stream time is read
    (matmul, compact, increment, reduce) and on no other."""
    recorded = []

    def record(stream):
        recorded.append(_Event())
        return recorded[-1]
    monkeypatch.setattr(trace, "_events", lambda: True)
    monkeypatch.setattr(trace, "_record", record)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _profiled(lambda: _solve(system, FLAGSHIP, max_iterations=2))
    s = trace.summary()["spans"]
    timed = {"ntp.matmul", "ntp.compact", "ntp.increment", "ntp.reduce"}
    assert {n for n, v in s.items() if v["device_s"] is not None} == timed
    assert len(recorded) == 2 * sum(s[n]["count"] for n in timed)
    for n in timed:
        assert s[n]["device_s"] == pytest.approx(1e-3 * s[n]["count"])
    assert s["ntp.solve"]["device_s"] is None


def test_solve_ids_differ_between_solves(system):
    def two():
        _solve(system, FLAGSHIP, max_iterations=2)
        _solve(system, FLAGSHIP, max_iterations=2)
    _profiled(two)
    solves = [r for r in trace.records() if r.name == "ntp.solve"]
    assert len(solves) == 2 and solves[0].solve != solves[1].solve
    for s in solves:
        inside = [r for r in trace.records() if r.solve == s.solve]
        assert all(s.start_ns <= r.start_ns and r.end_ns <= s.end_ns
                   for r in inside)


@pytest.mark.parametrize("mix", ["flagship", "chunked"])
def test_host_reads_equal_the_read_sites(system, mix):
    """Eager flagship: prologue_scalars, per iteration the sigma
    scalars and the energy, the deferred checks' drain: 2 x iterations
    + 2.  Chunked: prologue_scalars, the first iterate's growing
    increment and one read per chunk (redone chunks included)."""
    if mix == "flagship":
        _profiled(lambda: _solve(system, FLAGSHIP))
        s = trace.summary()
        c = s["counters"]["program"]
        want = 2 * c["solver.iterations"] + 2
        assert s["spans"]["ntp.host_read"]["count"] == want
    else:
        # the counters count unprofiled too (the profiler slows the
        # CPU's many small ops about fourfold)
        before = trace.snapshot()
        _solve(system, CHUNKED)
        c = trace.since(before)["program"]
        want = 2 + math.ceil(c["solver.iterations"]
                             / CHUNKED["iters_per_sync"]) + c["chunk.redos"]
    assert c["solver.iterations"] > 1
    assert c["host_reads"] == want


def test_unprofiled_stretch_ends_the_store(system):
    h, _ = system
    _profiled(lambda: alg.matmul(h, h, threshold=1e-7))
    first = trace.summary()
    assert first["spans"]["ntp.matmul"]["count"] == 1
    reads = first["counters"]["program"]["host_reads"]
    assert reads >= 1
    # unprofiled: nothing recorded, the stretch's counts stay as they were
    _solve(system, FLAGSHIP, max_iterations=2)
    after = trace.summary()
    assert after["spans"] == first["spans"]
    assert after["counters"] == first["counters"]
    # the next profiled stretch starts afresh
    _profiled(lambda: alg.trace(h))
    fresh = trace.summary()
    assert set(fresh["spans"]) == {"ntp.reduce"}
    assert fresh["counters"]["program"]["host_reads"] == 0
    trace.reset()
    assert trace.summary()["spans"] == {} and trace.records() == []


def test_off_never_enters_record_function(system, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with the "
                             "profiler off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("ntp.matmul") is trace.span("ntp.solve")
    before = trace.snapshot()["program"]["host_reads"]
    _, energy, _ = _solve(system, FLAGSHIP, max_iterations=2)
    assert math.isfinite(energy)
    assert trace.snapshot()["program"]["host_reads"] == before + 6


def test_counter_registry():
    grp = trace.counter_group("test.registry", ("a", "b"))
    with pytest.raises(ValueError):
        trace.counter_group("launches", ("a",))
    before = trace.snapshot()
    grp["a"] += 3
    delta = trace.since(before)
    assert delta["test.registry"] == {"a": 3, "b": 0}
    trace.restore(before)
    assert grp["a"] == 0
    trace.add(delta)
    trace.add(delta)
    assert grp["a"] == 6
    trace.reset_counters("test.registry")
    assert grp == {"a": 0, "b": 0}
    # the old names reset through the registry
    sp.launches["split_bf16"] += 1
    alg.multiplies["matmul"] += 1
    sp.reset_launches()
    alg.reset_multiplies()
    assert not any(sp.launches.values()) and alg.multiplies["matmul"] == 0


class _Graphs:
    """A CPU stand-in for ``torch.cuda.CUDAGraph``: capturing runs the
    chunk (``chunk_steps``' run) as the real capture does on the host
    and remembers it; a replay runs it again with every counter set
    aside (a replay launches nothing on the host) and writes the
    results into the captured outputs, as the graph's replay writes
    its buffers."""

    def __init__(self, monkeypatch):
        self.capturing = None
        self.captures = self.replays = 0
        self.warmups = []
        outer = self
        real_steps = common.chunk_steps

        def chunk_steps(step_fn, params, k_pin, *rest):
            run = real_steps(step_fn, params, k_pin, *rest)

            def recorded(carry, consts, n):
                out = run(carry, consts, n)
                if outer.capturing is not None:
                    outer.capturing.chunk = (run, carry, consts, n, out)
                return out
            return recorded

        class Graph:
            chunk = None

            def replay(self):
                run, carry, consts, n, out = self.chunk
                before = trace.snapshot()
                new = run(carry, consts, n)
                trace.restore(before)
                for dst, src in zip(common._leaves(out),
                                    common._leaves(new)):
                    dst.copy_(src)
                outer.replays += 1

        @contextlib.contextmanager
        def graph(g):
            self.capturing = g
            try:
                yield
            finally:
                self.capturing = None
            self.captures += 1

        @contextlib.contextmanager
        def side_stream(_):
            before = trace.snapshot()
            yield
            self.warmups.append(trace.since(before))

        class Stream:
            def wait_stream(self, other):
                pass

        monkeypatch.setattr(common, "chunk_steps", chunk_steps)
        monkeypatch.setattr(common, "captures",
                            lambda device, ranks: common._CAPTURE[0])
        monkeypatch.setattr(common, "_side_stream", Stream)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda *a: Stream())
        monkeypatch.setattr(torch.cuda, "stream", side_stream)
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(torch.cuda, "graph", graph)


def _count_launches(monkeypatch):
    """Count the band and general wrappers' calls on the CPU as their
    launches are counted on a card."""
    for name in ("spgemm_band", "spgemm_general"):
        real = getattr(sp, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            pred = "_pred" if kwargs.get("run") is not None else ""
            sp.launches[_name + pred] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(sp, name, counted)


@pytest.mark.parametrize("ips", [2, 4, 8])
def test_replay_adds_what_the_capture_counted(system, monkeypatch, ips):
    """A captured solve counts what the same solve uncaptured counts,
    plus each capture's warm-up step (a grown pin captures anew); each
    replay adds its capture's increments, and the captures and replays
    are counted."""
    graphs = _Graphs(monkeypatch)
    _count_launches(monkeypatch)

    def counted(capture):
        common.release_graphs()
        before = trace.snapshot()
        with contextlib.nullcontext() if capture else common.uncaptured():
            k, energy, mu = _solve(system, CHUNKED, iters_per_sync=ips)
        return trace.since(before), (k.blocks.clone(), energy, mu)

    plain, out_plain = counted(False)
    captured, out_captured = counted(True)
    common.release_graphs()
    assert torch.equal(out_plain[0], out_captured[0])
    assert out_plain[1:] == out_captured[1:]
    assert graphs.captures == len(graphs.warmups) >= 1
    assert graphs.replays >= graphs.captures
    for warm in graphs.warmups:
        assert warm["multiplies"]["matmul"] == 2       # one TRS4 step
        assert sum(warm["launches"].values()) >= 2
    for g, keys in captured.items():
        for key, v in keys.items():
            want = plain[g][key] + sum(w[g][key] for w in graphs.warmups)
            if (g, key) == ("program", "graph.captures"):
                want += graphs.captures
            if (g, key) == ("program", "graph.replays"):
                want += graphs.replays
            assert v == want, (g, key)
