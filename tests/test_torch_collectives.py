"""The collectives' span and counters (``parallel/dist.py``): in a
2 x 2 x 1 world (gloo, CPU), one ``matmul`` and one ``trace`` make the
calls and bring the bytes that the tiles' shapes give, and a ragged
all-to-all counts what the other members sent; under a profiler
each call is one ``ntp.collective`` span, without one nothing is
recorded; the 1 x 1 x 1 grid calls no collective."""
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.parallel import dist
from ntpoly_tpu_torch.parallel import pmatrix as PM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.utils import trace

torch.set_num_threads(1)

DIM, BS, K_OUT = 96, 8, 6
SHAPE = (2, 2, 1)


def _matrix(grid):
    def fn(i, j):
        return 1.0 / (1.0 + (i - j).abs().to(torch.float64)) + 0.01 * i
    return PM.banded(DIM, 11, fn, bs=BS, grid=grid, dtype=torch.float64)


def _work(a):
    """One matmul (one SUMMA pass: capacity pinned, truncating) and one
    trace."""
    c = alg.matmul(a, a, k_out=K_OUT, on_overflow="truncate",
                   method="pallas")
    alg.trace(c)


def _expected(a, shape) -> dict:
    """Calls and bytes_in of :func:`_work` from the tile shapes: A's
    col ids and blocks gathered over 'cols', B's over 'rows', the grid's
    max of the two int32 stats over 'all', the trace's float64 partial
    gathered over 'plane'."""
    rows, cols, _ = shape
    ids = a.nbr * a.k * 4
    blocks = a.nbr * a.k * BS * BS * 8
    n = rows * cols
    calls = bytes_in = 0
    for size, nbytes in ((cols, ids), (cols, blocks), (rows, ids),
                         (rows, blocks), (n, 2 * 4), (n, 8)):
        if size > 1:
            calls += 1
            bytes_in += (size - 1) * nbytes
    return {"calls": calls, "bytes_in": bytes_in}


def _counted(fn) -> dict:
    before = dict(dist.counts)
    fn()
    return {k: dist.counts[k] - before[k] for k in before}


def counts_rank(workdir: str) -> None:
    """A rank of the world: the counters' increments of one matmul and
    one trace, unprofiled and profiled, and the spans each left."""
    grid = ProcessGrid(*SHAPE, device="cpu")
    a = _matrix(grid)
    out = {"expected": _expected(a, SHAPE)}
    trace.reset()
    out["plain"] = _counted(lambda: _work(a))
    out["plain_spans"] = sorted(trace.summary()["spans"])
    with profile(activities=[ProfilerActivity.CPU]):
        out["profiled"] = _counted(lambda: _work(a))
    s = trace.summary()
    out["profiled_spans"] = s["spans"]["ntp.collective"]["count"]
    out["stretch"] = s["counters"]["collectives"]
    # the ragged all-to-all: member d sends d + 1 rows of 3 float64 to
    # every member; the counts travel first, one int64 from each
    me, n = dist.process_index(), dist.process_count()
    rows = torch.zeros(n * (me + 1), 3, dtype=torch.float64)
    out["all_to_all"] = _counted(
        lambda: grid.group("all").all_to_all_v(rows, [me + 1] * n))
    out["all_to_all_expected"] = {
        "calls": 2, "bytes_in": (n - 1) * 8 + sum(
            (d + 1) * 3 * 8 for d in range(n) if d != me)}
    path = Path(workdir) / f"rank{dist.process_index()}.json"
    path.write_text(json.dumps(out))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ntpoly_tpu_torch.parallel import launch
    work = tmp_path_factory.mktemp("collectives")
    launch.run("test_torch_collectives:counts_rank", 4,
               args=(str(work),), workdir=work, timeout=120,
               pythonpath=[Path(__file__).resolve().parent])
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("rank", range(4))
def test_counts_from_the_tile_shapes(world, rank):
    r = world[rank]
    assert r["expected"]["calls"] == 6
    assert r["plain"] == r["expected"]
    assert r["profiled"] == r["expected"]
    # the profiled stretch's counter increments are the same
    assert r["stretch"] == r["expected"]


@pytest.mark.parametrize("rank", range(4))
def test_all_to_all_counts_what_others_sent(world, rank):
    r = world[rank]
    assert r["all_to_all"] == r["all_to_all_expected"]


@pytest.mark.parametrize("rank", range(4))
def test_spans_only_under_a_profiler(world, rank):
    r = world[rank]
    assert "ntp.collective" not in r["plain_spans"]
    assert r["profiled_spans"] == r["expected"]["calls"]


def test_one_rank_grid_calls_no_collective():
    a = _matrix(ProcessGrid(1, 1, 1, device="cpu"))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = _counted(lambda: _work(a))
    assert got == {"calls": 0, "bytes_in": 0}
    assert "ntp.collective" not in trace.summary()["spans"]
    assert _expected(a, (1, 1, 1)) == {"calls": 0, "bytes_in": 0}
