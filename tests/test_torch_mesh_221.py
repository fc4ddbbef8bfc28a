"""Port parity on the 2 x 2 x 1 grid: one world of four ranks (gloo,
CPU) runs every case of ``tests/_torch_mesh.py``, and each case is held
against the reference on the same grid of its 8-device CPU mesh, with
every rank's scalars equal bit for bit.  The 1 x 1 x 1 grid inside an
initialised one-rank world is swept here too."""
import pytest

from _torch_port import n  # noqa: F401  (one torch thread)
import _torch_mesh as TM

SHAPE = (2, 2, 1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return TM.spawn(tmp_path_factory.mktemp("mesh221"), SHAPE)


@pytest.mark.parametrize("case", TM.CASES)
def test_case(world, tmp_path, case):
    TM.compare(case, world, SHAPE, tmp_path)


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    return TM.spawn(tmp_path_factory.mktemp("mesh111"), (1, 1, 1))


@pytest.mark.parametrize("case", TM.CASES)
def test_case_one_rank_world(world_one, tmp_path, case):
    TM.compare(case, world_one, (1, 1, 1), tmp_path)


@pytest.fixture
def f64_default():
    import torch
    yield
    torch.set_default_dtype(torch.float32)


@pytest.mark.parametrize("case", TM.CASES)
def test_case_without_world(tmp_path, f64_default, case):
    """The same case on the 1 x 1 x 1 grid with no world at all."""
    import numpy as np
    out = TM.run_case(case, TM.Pkg("port", (1, 1, 1)), tmp_path)
    np.savez(tmp_path / f"{case}.npz", **out)
    scalars = {case: {k: repr(v) for k, v in out.items()
                      if np.ndim(v) == 0}}
    import json
    (tmp_path / "scalars0.json").write_text(json.dumps(scalars))
    TM.compare(case, tmp_path, (1, 1, 1), tmp_path)


def test_algebra_interface_is_the_reference_s():
    """``__all__`` names the reference's interface, grand_sum and
    conjugate among it, and every name exists."""
    from ntpoly_tpu.parallel import algebra as ralg
    from ntpoly_tpu_torch.parallel import algebra as palg
    assert palg.__all__ == ralg.__all__
    assert all(callable(getattr(palg, name)) for name in palg.__all__)


def test_backend_rule(monkeypatch):
    """``dist.initialize`` refuses plain nccl (it carries no host
    tensors, which the triplet exchanges and collective writes pass)
    before it joins a world, and picks gloo without cards, the
    cpu:gloo,cuda:nccl pair with a card a rank."""
    import torch
    import torch.distributed as tdist
    from ntpoly_tpu_torch.parallel import dist
    with pytest.raises(ValueError, match="cpu:gloo,cuda:nccl"):
        dist.initialize("nccl", init_method="file:///nonexistent",
                        rank=0, world_size=1)
    assert not tdist.is_initialized()
    chosen = []
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda backend, **kw: chosen.append(backend))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    dist.initialize(rank=0, world_size=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    dist.initialize(rank=1, world_size=2)
    dist.initialize(rank=1, world_size=3)
    assert chosen == ["gloo", dist.PAIR, "gloo"]
