"""Port parity: ntpoly_tpu_torch.parallel (pmatrix, algebra) against
ntpoly_tpu.parallel on a 1x1x1 grid, f64 on the CPU.  The reference
multiplies through its Pallas kernels in interpret mode (method
'pallas' / 'pallas_band'), so slots and capacities compare exactly."""
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from ntpoly_tpu.ops import spgemm_pallas as RSP
from ntpoly_tpu.parallel import algebra as RA
from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.utils.errors import NTPolyError as RError
from ntpoly_tpu_torch.ops import spgemm as PSP
from ntpoly_tpu_torch.parallel import algebra as PA
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.systems import gapped_fn
from ntpoly_tpu_torch.utils.errors import NTPolyError

from _torch_port import n

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402

TOL = 1e-12


@pytest.fixture
def grids():
    return RGrid(1, 1, 1), ProcessGrid(device="cpu")


@pytest.fixture
def fresh_jit():
    """The reference's jitted multiply is cached per shape; start and
    end each test here with empty caches."""
    RA._summa.clear_cache()
    RSP.spgemm_pallas.clear_cache()
    yield
    RA._summa.clear_cache()
    RSP.spgemm_pallas.clear_cache()


def same(rm, pm, tol=TOL):
    assert rm.k == pm.k and rm.dim == pm.dim and rm.bs == pm.bs
    assert np.array_equal(n(rm.col_ids), n(pm.col_ids))
    ref = n(rm.blocks)
    scale = max(np.abs(ref).max(initial=0.0), 1.0)
    assert np.abs(ref - n(pm.blocks)).max(initial=0.0) <= tol * scale


def chain(dim, bs, grids):
    i, jj, v = bench._gapped_chain(dim, bandwidth=12, dtype=np.float64)
    rg, pg = grids
    rm = RPM.fill_from_triplets(
        RPM.empty(dim, bs=bs, grid=rg, dtype=np.float64), i, jj, v)
    pm = PPM.fill_from_triplets(
        PPM.empty(dim, bs=bs, grid=pg, dtype=torch.float64), i, jj, v)
    return rm, pm


def test_fill_from_triplets(grids):
    rm, pm = chain(100, 8, grids)
    same(rm, pm, 0.0)
    back = PPM.from_reference_arrays(n(rm.col_ids), n(rm.blocks), rm.dim,
                                     rm.bs, pm.grid)
    same(rm, back, 0.0)
    cols, blocks = PPM.to_numpy(back)
    assert np.array_equal(cols, n(rm.col_ids))
    assert np.array_equal(blocks, n(rm.blocks))


@pytest.mark.parametrize("dim,bs", [(100, 8), (64, 16)])
def test_identity_and_banded(grids, dim, bs):
    rg, pg = grids
    ri = RPM.identity(dim, bs=bs, grid=rg, dtype=np.float64)
    pi = PPM.identity(dim, bs=bs, grid=pg, dtype=torch.float64)
    same(ri, pi, 0.0)
    assert getattr(pi, "_known_identity", False)
    rb = RPM.banded(dim, 16, bench._gapped_fn(), bs=bs, grid=rg,
                    dtype=np.float64)
    pb = PPM.banded(dim, 16, gapped_fn, bs=bs, grid=pg,
                    dtype=torch.float64)
    same(rb, pb, 0.0)


def test_dense_round_trip(grids, rng):
    rg, pg = grids
    a = rng.standard_normal((37, 37)) * (rng.random((37, 37)) < 0.3)
    rm = RPM.from_dense(a, bs=8, grid=rg)
    pm = PPM.from_dense(a, bs=8, grid=pg)
    same(rm, pm, 0.0)
    assert np.array_equal(n(PPM.to_dense(pm)), a)
    assert pm.nnz == rm.nnz


@pytest.mark.parametrize("k_out", [2, 4, 12])
def test_matmul_grow_and_trim(grids, fresh_jit, k_out):
    rm, pm = chain(96, 8, grids)
    r = RA.matmul(rm, rm, threshold=1e-9, k_out=k_out, method="pallas")
    p = PA.matmul(pm, pm, threshold=1e-9, k_out=k_out, method="pallas")
    same(r, p)


def test_matmul_warn_and_truncate(grids, fresh_jit):
    rm, pm = chain(96, 8, grids)
    for mode in ("truncate", "warn"):
        with warnings.catch_warnings(record=True) as rw:
            warnings.simplefilter("always")
            r = RA.matmul(rm, rm, k_out=3, method="pallas_band",
                          on_overflow=mode)
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            p = PA.matmul(pm, pm, k_out=3, method="pallas_band",
                          on_overflow=mode)
        same(r, p)
        rmsg = {str(w.message) for w in rw if "capacity" in str(w.message)}
        pmsg = {str(w.message) for w in pw if "capacity" in str(w.message)}
        assert rmsg == pmsg
        assert bool(pmsg) == (mode == "warn")


def test_deferred_band_violation_raises(grids, fresh_jit, monkeypatch):
    """A striped (non-band) operand under method='pallas_band': the
    poisoned fill surfaces when the deferring policy exits."""
    monkeypatch.setattr(RSP, "V3_MIN_ROWS", 1)
    monkeypatch.setattr(PSP, "V3_MIN_ROWS", 1)
    rg, pg = grids
    dim = 320
    i = np.arange(dim)
    rows = np.concatenate([i, i, i])
    cols = np.concatenate([i, (i + 16) % dim, (i + 40) % dim])
    vals = np.concatenate([np.full(dim, 2.0), np.ones(dim), np.ones(dim)])
    rm = RPM.fill_from_triplets(RPM.empty(dim, bs=8, grid=rg), rows, cols,
                                vals)
    pm = PPM.fill_from_triplets(
        PPM.empty(dim, bs=8, grid=pg, dtype=torch.float64), rows, cols,
        vals)
    assert not bool(PSP.band_plan(pm.col_ids[0], pm.col_ids[0], 8)[2])
    with pytest.raises(RError, match="band"):
        with RA.capacity_policy(on_overflow="warn", defer=True):
            RA.matmul(rm, rm, method="pallas_band", k_out=8)
    with pytest.raises(NTPolyError, match="band"):
        with PA.capacity_policy(on_overflow="warn", defer=True):
            PA.matmul(pm, pm, method="pallas_band", k_out=8)
    with pytest.raises(NTPolyError, match="band"):
        PA.matmul(pm, pm, method="pallas_band", k_out=8)


def test_matmul_refuses_unported_methods(grids):
    """The reference's XLA tiers, once refused, now run in plain torch:
    each equals the reference's tier slot for slot, and an unknown
    method is still refused."""
    rm, pm = chain(96, 8, grids)
    for method in ("acc", "cand", "dense"):
        same(RA.matmul(rm, rm, threshold=1e-6, method=method),
             PA.matmul(pm, pm, threshold=1e-6, method=method))
    with pytest.raises(ValueError, match="not in"):
        PA.matmul(pm, pm, method="summa")


@pytest.mark.parametrize("on_overflow", ["grow", "truncate"])
def test_increment_n(grids, on_overflow):
    rm, pm = chain(96, 8, grids)
    rg, pg = grids
    ri = RPM.identity(96, bs=8, grid=rg, dtype=np.float64)
    pi = PPM.identity(96, bs=8, grid=pg, dtype=torch.float64)
    coeffs = (0.75, -2.0, 1.5)
    r = RA.increment_n((rm, rm, ri), coeffs, threshold=1e-3, k_out=2,
                       on_overflow=on_overflow)
    p = PA.increment_n((pm, pm, pi), coeffs, threshold=1e-3, k_out=2,
                       on_overflow=on_overflow)
    same(r, p)
    same(RA.increment(rm, ri, -0.5, 3.0), PA.increment(pm, pi, -0.5, 3.0))


def test_reductions(grids):
    rm, pm = chain(100, 8, grids)
    rm2 = RA.scale(rm, 1.7)
    pm2 = PA.scale(pm, 1.7)
    same(rm2, pm2)
    for rv, pv in ((RA.trace(rm), PA.trace(pm)),
                   (RA.dot(rm, rm2), PA.dot(pm, pm2))):
        assert abs(float(rv) - float(pv)) <= TOL * max(abs(float(rv)), 1)
    for rv, pv in zip(RA.gershgorin_bounds(rm), PA.gershgorin_bounds(pm)):
        assert abs(float(rv) - float(pv)) <= TOL
    assert PA.is_identity(PPM.identity(100, bs=8, grid=grids[1],
                                       dtype=torch.float64))
    assert not PA.is_identity(pm)


def test_compensated_pairs(grids):
    """dot_pair and trace_pair of f32 data: hi + lo within the ~n eps^2
    bound of the float64 value."""
    rm, pm = chain(200, 8, grids)
    rm = rm.astype(np.float32)
    pm = pm.astype(torch.float32)
    b32 = n(pm.blocks)
    exact_dot = float(np.sum((b32 * b32).astype(np.float64)))
    exact_tr = float(np.trace(n(PPM.to_dense(pm)).astype(np.float64)))
    nel = pm.blocks.numel()
    eps2 = np.finfo(np.float32).eps ** 2
    for rp, pp, exact in ((RA.dot_pair(rm, rm), PA.dot_pair(pm, pm),
                           exact_dot),
                          (RA.trace_pair(rm), PA.trace_pair(pm), exact_tr)):
        bound = nel * eps2 * abs(exact) + 1e-12
        got, ref = PA.host_pair(pp), RA.host_pair(rp)
        assert abs(got - exact) <= bound
        # the reference on XLA:CPU resolves the sum less finely; the
        # port agrees with it to the reference's own error
        assert abs(got - ref) <= abs(ref - exact) + bound
