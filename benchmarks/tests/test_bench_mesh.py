"""The four-rank cell on the CPU (gloo): the split reference against the
one-process reference, a traced run's collective metrics, faults
planted on every rank, and a worker killed in the middle of a call.

The sound run, the controls and the faults of test_bench_control.py
run this cell too, but that file plants its faults in the harness's
process, which is rank 0 alone.  There a fault that changes what rank
0 sends (its products returning their first operand) breaks the
world's lockstep and fails only at the collective timeout.  Here each
fault is planted on every rank: the worker calls the function that the
cell's spec names under ``plant``.
"""
import dataclasses
import json
import math
import os
import signal
import threading
import time
from pathlib import Path

import pytest
import torch

from benchmarks import harness
from benchmarks.reference import band as B
from benchmarks.reference import trs4 as R
from benchmarks.reference import trs4_grid as G
from benchmarks.traffic import hamiltonians as T

from ntpoly_tpu_torch.config import EMPTY
from ntpoly_tpu_torch.parallel import algebra as alg

CELL = "trs4_chain_4m_mesh"
CONFIG = {"family": "gapped_chain", "onsite_stagger": 0.15,
          "hopping": 0.25}
N, BS, W, HALF = 4096, 32, 2, 16
# (parts, ranks a part) of a world of four ranks
LAYOUTS = ((2, 2), (4, 1))


def _fn():
    return T.value_function(CONFIG, T.onsite(2 ** 31 + 9, 1, N, 0.01,
                                             "cpu")[0])


def split_rank(workdir: str) -> None:
    """A rank of the world: the split solve and gap edges of each
    layout; the rank that counts its part saves the slab."""
    rank = torch.distributed.get_rank()
    for parts, per in LAYOUTS:
        sp = G.split(N // BS, parts, per)
        h = G.slab_from_values(_fn(), N, BS, W, HALF, sp)
        sol = G.trs4(h, N / 2, sp)
        homo, lumo = G.gap_edges(sp, h, sol.density)
        if sp.counted()[sp.part] == rank:
            torch.save(sol.density, Path(workdir) / f"k{parts}_{sp.part}.pt")
        if rank == 0:
            (Path(workdir) / f"s{parts}.json").write_text(json.dumps(
                dict(energy=sol.energy, mu=sol.mu, homo=homo, lumo=lumo,
                     iterations=sol.iterations)))


@pytest.fixture(scope="module")
def split_world(tmp_path_factory):
    from ntpoly_tpu_torch.parallel import launch
    work = tmp_path_factory.mktemp("split")
    launch.run("test_bench_mesh:split_rank", 4, args=(str(work),),
               workdir=work, timeout=240,
               pythonpath=[Path(__file__).resolve().parent])
    return work


# the one-process reference against itself on one thread and on eight,
# both stopped at the same step, reads up to 1.7e-11 here: the last
# steps' products turn rounding into the density's last digits
DENSITY_REL = 5e-11


def _one_process(iterations: int):
    """The one-process reference stopped at ``iterations`` steps: its
    plateau rule stops it a step earlier or later as the last digits
    of its sums round."""
    h = B.from_values(_fn(), N, BS, W, HALF)
    sol = R.trs4(h, N / 2, max_iterations=iterations)
    return sol, R.gap_edges(h, sol.density)


@pytest.mark.parametrize("parts", [p for p, _ in LAYOUTS])
def test_split_reference_is_the_reference(split_world, parts):
    s = json.loads((split_world / f"s{parts}.json").read_text())
    ref, (homo, lumo) = _one_process(s["iterations"])
    assert ref.iterations == s["iterations"]
    got = torch.cat([torch.load(split_world / f"k{parts}_{p}.pt")
                     for p in range(parts)], dim=1)
    assert got.shape == ref.density.shape
    rel = (got - ref.density).norm() / ref.density.norm()
    assert rel < DENSITY_REL
    assert abs(s["energy"] - ref.energy) <= 1e-10 * abs(ref.energy)
    assert abs(s["homo"] - homo) <= 1e-10
    assert abs(s["lumo"] - lumo) <= 1e-10
    # mu is anywhere in the gap: the bisection turns on the last
    # digits of the sigmas, which the slabs' sums round otherwise
    assert homo < s["mu"] < lumo


def test_split_reference_without_a_world():
    """One part, no world: the collectives are the identity."""
    n = 1024
    fn = T.value_function(CONFIG, T.onsite(3, 1, n, 0.01, "cpu")[0])
    h = B.from_values(fn, n, BS, W, HALF)
    sp = G.split(n // BS, 1)
    got = G.trs4(G.slab_from_values(fn, n, BS, W, HALF, sp), n / 2, sp)
    ref = R.trs4(h, n / 2)
    assert (got.density - ref.density).norm() <= 1e-12 * \
        ref.density.norm()


def test_tile_round_trip():
    """A slab written as block-ELL with global col ids and read back
    by panel gives the panel's part of the difference and the norm."""
    g = torch.Generator().manual_seed(6)
    sp = G.Split(8, (0, 0, 1, 1))
    band = torch.randn(5, 4, 3, 3, generator=g, dtype=torch.float64)
    cols, blocks = G.slab_to_ell(band, sp, 0, 8)
    back, outside = G.slab_from_ell(cols, blocks, 2, sp, "cpu")
    assert outside == 0.0
    # part 0 holds block rows 0..3: the blocks left of column 0 go
    inside = band.clone()
    for o in (-2, -1):
        inside[2 + o, :-o] = 0
    assert torch.equal(back, inside)
    diff, norm = G.panel_difference(back.clone(), inside, sp, 0, 8)
    assert diff == 0.0
    assert norm == pytest.approx(float(inside.pow(2).sum()))
    # one column panel of two: the other panel's blocks are not its own
    cols, blocks = G.slab_to_ell(band, sp, 0, 4)
    back, _ = G.slab_from_ell(cols, blocks, 2, sp, "cpu")
    diff, norm = G.panel_difference(back, inside, sp, 0, 4)
    assert diff == 0.0 and norm < float(inside.pow(2).sum())


def test_traced_run_reports_collectives(small_cell):
    out = harness.run(small_cell(CELL), 11, 0.0, True, device="cpu",
                      started=time.perf_counter())
    m = out["metrics"]
    assert out["correct"], out["checks"]
    assert m["collective_gib_per_call"]["value"] > 0
    # no span is timed on the CPU: no stream time to read
    assert "collective_ms_per_call" not in m
    assert "collective_link_share" not in m
    assert m["iterations"]["value"] > 0
    assert m["host_reads_per_call"]["value"] > 0


def test_killed_worker_fails_the_call(small_cell):
    from benchmarks import cells
    cell = small_cell(CELL)
    entry = cells.entry(cell)
    session = entry.Session(cell, 5, "cpu")
    session.setup()
    victim = session.workers[0]

    def kill():
        time.sleep(0.5)
        os.kill(victim.pid, signal.SIGKILL)
    threading.Thread(target=kill).start()
    t0 = time.monotonic()
    with pytest.raises(Exception):
        for n in range(1, 20):
            session.call(n)
    assert time.monotonic() - t0 < entry.TIMEOUT_S
    session.release()
    got = session.check([])
    assert all(math.isinf(v) for v in got.values())
    assert not session.workers


def test_failed_session_leaves_a_world_for_the_next(small_cell,
                                                    monkeypatch):
    """A warm-up that fails on rank 0 breaks its session's world; the
    next session (``benchmarks.limits`` runs one per seed and control
    in one process) starts a world of its own."""
    from benchmarks import cells
    from ntpoly_tpu_torch.solvers import density
    cell = small_cell(CELL)
    entry = cells.entry(cell)

    def fails(*args):
        raise MemoryError("a warm-up that fails on rank 0")
    with monkeypatch.context() as m:
        m.setattr(density, "trs4", fails)
        first = entry.Session(cell, 5, "cpu")
        first.setup()
        with pytest.raises(entry.WorldError):
            first.call(1)
    second = entry.Session(cell, 6, "cpu")
    second.setup()
    assert not first.workers
    kept = [second.keep(second.call(1))]
    second.release()
    got = second.check(kept)
    assert all(math.isfinite(v) for v in got.values()), got


def _local_panels(fn):
    """The SUMMA's panels with the other ranks' tiles left out: the
    gathers still run, so that every rank keeps in step, but only this
    rank's own tile of each panel is multiplied."""
    def panels(a, b, blocks=True):
        agc, agb, bgc, bgb = fn(a, b, blocks)
        g = a.grid
        agc = agc.reshape(a.nbr, g.cols, -1).clone()
        foreign = torch.arange(g.cols) != g.my_col
        agc[:, foreign] = EMPTY
        bgc = bgc.reshape(g.rows, -1, bgc.shape[-1]).clone()
        bgc[torch.arange(g.rows) != g.my_row] = EMPTY
        agc, bgc = agc.reshape(a.nbr, -1), bgc.reshape(-1, bgc.shape[-1])
        if blocks:      # an EMPTY slot's block is zero
            agb = agb * (agc < EMPTY)[..., None, None]
            bgb = bgb * (bgc < EMPTY)[..., None, None]
        return agc, agb, bgc, bgb
    return panels


PLANTS = {
    # every TRS4 step returns its state unchanged
    "state_unchanged": (alg, "matmul", lambda fn: (lambda a, b, *x, **y: a)),
    # the exchange between cards left out of every product
    "exchange_left_out": (alg, "_panels", _local_panels),
}


def _plant(fault, setattr=setattr):
    owner, attr, make = PLANTS[fault]
    setattr(owner, attr, make(getattr(owner, attr)))


# named by the cell's spec, and called by each worker
def plant_state_unchanged():
    _plant("state_unchanged")


def plant_exchange_left_out():
    _plant("exchange_left_out")


@pytest.mark.parametrize("fault", sorted(PLANTS))
def test_fault_on_every_rank_is_not_correct(fault, small_cell,
                                            monkeypatch):
    """Planted on all four ranks, the fault fails a limit through the
    comparison, well inside the collective timeout."""
    from benchmarks import cells
    _plant(fault, monkeypatch.setattr)
    cell = small_cell(CELL)
    cell = dataclasses.replace(cell, spec=dict(
        cell.spec, plant=f"benchmarks.tests.test_bench_mesh:plant_{fault}"))
    t0 = time.monotonic()
    r = harness.run(cell, 2 ** 31 + 77, 0.5, False, device="cpu",
                    started=time.perf_counter())
    assert time.monotonic() - t0 < cells.entry(cell).TIMEOUT_S
    assert r["failed"] == 0
    limits = cell.spec["check"]["limits"]
    assert not r["correct"], r["checks"]
    assert all(math.isfinite(c["value"]) for c in r["checks"].values())
    assert any(c["value"] > limits[n] for n, c in r["checks"].items())
