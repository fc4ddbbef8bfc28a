"""Tests of the benchmark itself, on the CPU at small sizes:

    python3 -m pytest benchmarks/tests -q -p no:cacheprovider

Tests marked ``chip`` need a CUDA card and skip without one; on a
machine with a card, ``python3 -m pytest benchmarks/tests -m chip``.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the small size at which the CPU runs a cell: the program's plain
# kernel versions at 4096 rows in the cells' blocks of 128
SMALL = {"rows": 4096, "electrons": 2048}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skip unless this machine has a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def small_cell():
    """cell name -> that cell of BENCHMARK.json at the SMALL size."""
    from benchmarks import cells

    def make(name):
        cell = cells.load(name)
        # a short window: the check keeps calls 0 and 1 if made
        check = dict(cell.spec["check"], calls=2, within=2)
        return dataclasses.replace(cell, config=dict(cell.config, **SMALL),
                                   spec=dict(cell.spec, check=check))
    return make
