"""Port parity: matrix maps and sparsity-pattern conversion
(ntpoly_tpu_torch/utils/maps.py through nt.MatrixMapper and
nt.MatrixConversion) against the JAX package's, on the cases of
tests/test_psmatrix.py:181-227: the port's results within 1e-14 of the
JAX package's (f64) and both of the numpy result; map_values with a
torch callable against the reference's jnp callable."""
import numpy as np
import pytest
import torch
from scipy.io import mmwrite
from scipy.sparse import csr_matrix

import ntpoly_tpu as rnt
import ntpoly_tpu_torch as pnt
from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.utils import maps as RMAPS
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.parallel.grid import ProcessGrid
from ntpoly_tpu_torch.utils import maps as PMAPS

from _torch_port import n, port_matrix_ps

TOL = 1e-14


@pytest.fixture(autouse=True)
def grids():
    torch.set_default_dtype(torch.float64)
    rnt.ConstructGlobalProcessGrid(1, 1, 1)
    pnt.ConstructGlobalProcessGrid(1, 1, 1, device="cpu")
    yield
    pnt.DestructGlobalProcessGrid()
    rnt.DestructGlobalProcessGrid()
    torch.set_default_dtype(torch.float32)


def random_matrix(rng, dim=13, density=0.5):
    return rng.random((dim, dim)) * (rng.random((dim, dim)) < density)


def dense(m):
    """A Matrix_ps of either package as dense numpy."""
    r, c, v = m._triplets()
    out = np.zeros((m.GetActualDimension(),) * 2, np.asarray(v).dtype)
    out[r, c] = v
    return out


def both(tmp_path, m, name="in"):
    path = str(tmp_path / f"{name}.mtx")
    mmwrite(path, csr_matrix(m))
    return rnt.Matrix_ps(path), pnt.Matrix_ps(path)


def check(r, p, oracle):
    assert np.abs(dense(p) - dense(r)).max() <= TOL
    assert np.abs(dense(p) - oracle).max() <= TOL


class Below:
    """A RealOperation of each package: keep values below 0.5."""

    @staticmethod
    def of(nt):
        class Op(nt.RealOperation):
            def __call__(self):
                return self.data.point_value < 0.5
        return Op()


class Doubler:
    @staticmethod
    def of(nt):
        class Op(nt.RealOperation):
            def __call__(self):
                if self.data.index_row >= self.data.index_column:
                    self.data.point_value *= 2
                    return True
                return False
        return Op()


@pytest.mark.parametrize("op", [Below, Doubler], ids=["below", "lower"])
def test_map(tmp_path, rng, op):
    m = random_matrix(rng)
    ra, pa = both(tmp_path, m)
    rb, pb = rnt.Matrix_ps(13), pnt.Matrix_ps(13)
    rnt.MatrixMapper.Map(ra, rb, op.of(rnt))
    pnt.MatrixMapper.Map(pa, pb, op.of(pnt))
    oracle = (np.where(m < 0.5, m, 0) if op is Below
              else np.tril(2 * m))
    check(rb, pb, oracle)


def test_map_vectorized_moves_entries(tmp_path, rng):
    m = random_matrix(rng)
    ra, pa = both(tmp_path, m)

    def fn(i, j, v):
        return j, i, 2.0 * v, i >= j                 # transpose + drop
    rb, pb = rnt.Matrix_ps(13), pnt.Matrix_ps(13)
    rnt.MatrixMapper.MapVectorized(ra, rb, fn)
    pnt.MatrixMapper.MapVectorized(pa, pb, fn)
    check(rb, pb, np.tril(2 * m).T)


def test_snap_to_sparsity_pattern(tmp_path, rng):
    m = random_matrix(rng, density=0.8)
    pattern = random_matrix(rng, density=0.3)
    ra, pa = both(tmp_path, m, "m")
    rp, pp = both(tmp_path, pattern, "p")
    rnt.MatrixConversion.SnapMatrixToSparsityPattern(ra, rp)
    pnt.MatrixConversion.SnapMatrixToSparsityPattern(pa, pp)
    check(ra, pa, np.where(pattern != 0, m, 0))
    assert np.array_equal(np.asarray(ra._m.col_ids), n(pa._m.col_ids))


def test_slice_info(tmp_path, rng):
    ra, pa = both(tmp_path, random_matrix(rng))
    assert pnt.MatrixMapper.GetSliceInfo(pa) == \
        rnt.MatrixMapper.GetSliceInfo(ra) == (1, 0)


def _double_lower_jnp(r, c, v):
    return 2.0 * v, r >= c


def _double_lower_torch(r, c, v):
    return 2.0 * v, r >= c


def test_map_values_on_the_device(rng):
    """The device map: a torch callable on the stored blocks, against
    the reference's jnp callable; values change, slots stay."""
    m = random_matrix(rng, dim=17)
    rm = RPM.from_dense(m, bs=4, grid=RGrid(1, 1, 1))
    pm = PPM.from_dense(m, bs=4, grid=ProcessGrid(device="cpu"))
    ro = RMAPS.map_values(rm, _double_lower_jnp)
    po = PMAPS.map_values(pm, _double_lower_torch)
    assert np.array_equal(np.asarray(ro.col_ids), n(po.col_ids))
    assert np.abs(np.asarray(ro.blocks) - n(po.blocks)).max() <= TOL
    assert np.abs(n(PPM.to_dense(po)) - np.tril(2 * m)).max() <= TOL
    plain = PMAPS.map_values(pm, lambda r, c, v: torch.sin(v))
    assert np.abs(n(PPM.to_dense(plain)) - np.sin(m)).max() <= TOL


def test_carried_matrix_maps_alike(tmp_path, rng):
    """A matrix carried across (``port_matrix_ps``) maps as the JAX one."""
    m = random_matrix(rng)
    ra, _ = both(tmp_path, m)
    pa = port_matrix_ps(ra)
    rb, pb = rnt.Matrix_ps(13), pnt.Matrix_ps(13)
    rnt.MatrixMapper.Map(ra, rb, Doubler.of(rnt))
    pnt.MatrixMapper.Map(pa, pb, Doubler.of(pnt))
    assert np.array_equal(np.asarray(rb._m.col_ids), n(pb._m.col_ids))
    assert np.abs(np.asarray(rb._m.blocks) - n(pb._m.blocks)).max() <= TOL
