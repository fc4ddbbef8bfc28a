"""Port parity on the 2 x 2 x 2 grid: one world of 8 ranks (gloo,
CPU) runs every case of ``tests/_torch_mesh.py``, and each case is held
against the reference on the same grid of its 8-device CPU mesh, with
every rank's scalars equal bit for bit."""
import pytest

from _torch_port import n  # noqa: F401  (one torch thread)
import _torch_mesh as TM

SHAPE = (2, 2, 2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return TM.spawn(tmp_path_factory.mktemp("mesh222"), SHAPE)


@pytest.mark.parametrize("case", TM.CASES)
def test_case(world, tmp_path, case):
    TM.compare(case, world, SHAPE, tmp_path)
