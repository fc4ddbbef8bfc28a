"""The check of each cell, run by the harness on the CPU at a small
size: sound runs come out correct; each of the cell's controls and each
fault planted in the timed path come out not correct.

The faults, each planted in the program under a run: every TRS4 step
returns its state unchanged (``matmul`` hands back its first operand);
the answer altered where it is produced (the density scaled by 1 +
1e-3, or the energy by the same, or the chemical potential moved by
0.25, the gap's width); half of the answer left out (the density's
second half of block rows zeroed).  The cells run on one
card, so no exchange between cards can be left out.
"""
import time

import pytest
import torch

from benchmarks import cells, harness
from ntpoly_tpu_torch.parallel import algebra as alg
from ntpoly_tpu_torch.solvers import density

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
SEED = 2 ** 31 + 77


def _run(cell, control=None):
    torch.manual_seed(0)
    return harness.run(cell, SEED, 0.5, False, device="cpu",
                       started=time.perf_counter(), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, small_cell):
    r = _run(small_cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"


CONTROLS = [(w, c) for w in CELLS for c in cells.load(w).spec["controls"]]


@pytest.mark.parametrize("name,control", CONTROLS)
def test_control_is_not_correct(name, control, small_cell):
    r = _run(small_cell(name), control=control)
    assert not r["correct"], r["checks"]


def _scaled_density(fn):
    def trs4(*args):
        k, energy, mu = fn(*args)
        return k.with_data(k.col_ids, k.blocks * (1 + 1e-3)), energy, mu
    return trs4


def _scaled_energy(fn):
    def trs4(*args):
        k, energy, mu = fn(*args)
        return k, energy * (1 + 1e-3), mu
    return trs4


def _moved_mu(fn):
    def trs4(*args):
        k, energy, mu = fn(*args)
        return k, energy, mu + 0.25
    return trs4


def _half_left_out(fn):
    def trs4(*args):
        k, energy, mu = fn(*args)
        blocks = k.blocks.clone()
        blocks[:, blocks.shape[1] // 2:] = 0
        return k.with_data(k.col_ids, blocks), energy, mu
    return trs4


FAULTS = {
    "state_unchanged": (alg, "matmul", lambda fn: (lambda a, b, *x, **y: a)),
    "density_altered": (density, "trs4", _scaled_density),
    "energy_altered": (density, "trs4", _scaled_energy),
    "half_left_out": (density, "trs4", _half_left_out),
    "mu_moved": (density, "trs4", _moved_mu),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, small_cell, monkeypatch):
    module, attr, plant = FAULTS[fault]
    monkeypatch.setattr(module, attr, plant(getattr(module, attr)))
    r = _run(small_cell(name))
    assert not r["correct"], r["checks"]
