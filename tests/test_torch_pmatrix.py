"""Port parity of the constructors' capacity and threshold arguments:
``empty(k=)``, ``from_dense(k=, threshold=)``, ``fill_banded`` and
``banded(threshold=)`` and ``PSMatrix.conjugate`` in
ntpoly_tpu_torch.parallel.pmatrix against ntpoly_tpu.parallel.pmatrix on
a 1x1x1 grid, on the same numpy input at bs 8, slot for slot: capacity,
col ids and blocks exactly."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.systems import gapped_fn

from _torch_port import EMPTY, n

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402

BS = 8


@pytest.fixture
def grids():
    return RGrid(1, 1, 1), ProcessGrid(device="cpu")


def same_slots(rm, pm):
    """Capacity, col ids and blocks equal, slot for slot."""
    assert (rm.k, rm.dim, rm.bs) == (pm.k, pm.dim, pm.bs)
    assert np.array_equal(n(rm.col_ids), n(pm.col_ids))
    assert np.array_equal(n(rm.blocks), n(pm.blocks))
    assert n(pm.blocks).dtype == n(rm.blocks).dtype


def sparse_dense(dim, seed):
    """A dense matrix with about a third of its entries set, a spread of
    magnitudes (so that a threshold drops some) and one all-zero block
    row."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim)) * (rng.random((dim, dim)) < 0.35)
    a[BS:2 * BS] = 0.0
    return a * np.logspace(-3, 0, dim)[None, :]


@pytest.mark.parametrize("k", [None, 1, 3, 50])
def test_empty_capacity(grids, k):
    """k is the capacity, 1 by default and at most the panel's block
    columns (50 > 5 block columns here)."""
    rg, pg = grids
    rm = RPM.empty(37, bs=BS, k=k, grid=rg, dtype=np.float64)
    pm = PPM.empty(37, bs=BS, k=k, grid=pg, dtype=torch.float64)
    same_slots(rm, pm)
    assert pm.k == min(k or 1, pm.nb)
    assert (n(pm.col_ids) == EMPTY).all() and not n(pm.blocks).any()


@pytest.mark.parametrize("k", [None, 2, 5])
@pytest.mark.parametrize("threshold", [0.0, 0.05, 0.4])
def test_from_dense_threshold_and_capacity(grids, threshold, k):
    """Entries with |x| > threshold are kept (0.05 and 0.4 drop some,
    and whole blocks); k below the data's need grows to it, k above it
    (5, every block column) leaves EMPTY slots."""
    rg, pg = grids
    a = sparse_dense(37, 11)
    rm = RPM.from_dense(a, bs=BS, k=k, grid=rg, threshold=threshold)
    pm = PPM.from_dense(a, bs=BS, k=k, grid=pg, threshold=threshold)
    same_slots(rm, pm)
    want = np.where(np.abs(a) > threshold, a, 0.0)
    assert np.array_equal(n(PPM.to_dense(pm)), want)
    if threshold:
        assert np.count_nonzero(want) < np.count_nonzero(a)


@pytest.mark.parametrize("threshold", [0.0, 0.012])
def test_banded_threshold(grids, threshold):
    """The gapped chain's band, hopping 0.25 / (1 + |i - j|)^2: a
    threshold of 0.012 zeroes |i - j| >= 4 inside the band while the
    band's blocks keep their slots."""
    rg, pg = grids
    rm = RPM.banded(100, 16, bench._gapped_fn(), bs=BS, grid=rg,
                    dtype=np.float64, threshold=threshold)
    pm = PPM.banded(100, 16, gapped_fn, bs=BS, grid=pg,
                    dtype=torch.float64, threshold=threshold)
    same_slots(rm, pm)
    dense = n(PPM.to_dense(pm))
    i, j = np.indices(dense.shape)
    far = np.abs(i - j) >= 4
    assert (dense[far] == 0).all() == bool(threshold)


@pytest.mark.parametrize("k", [1, 4])
def test_fill_banded_threshold_ignores_capacity(grids, k):
    """fill_banded sizes its slots from the band, whatever the capacity
    of the matrix it fills."""
    rg, pg = grids
    rm = RPM.fill_banded(RPM.empty(64, bs=BS, k=k, grid=rg,
                                   dtype=np.float64),
                         5, bench._gapped_fn(), threshold=0.012)
    pm = PPM.fill_banded(PPM.empty(64, bs=BS, k=k, grid=pg,
                                   dtype=torch.float64),
                         5, gapped_fn, threshold=0.012)
    same_slots(rm, pm)


def test_conjugate_of_a_real_matrix(grids):
    """conjugate on a real matrix: the same slots and values, a new
    PSMatrix."""
    rg, pg = grids
    a = sparse_dense(29, 5)
    rm = RPM.from_dense(a, bs=BS, grid=rg).conjugate()
    pm = PPM.from_dense(a, bs=BS, grid=pg)
    pc = pm.conjugate()
    same_slots(rm, pc)
    assert pc is not pm and pc.dim == pm.dim
    assert np.array_equal(n(PPM.to_dense(pc)), a)
