"""Port of tests/test_multihost.py: worlds of OS processes (gloo, CPU,
one rank each) on one grid.  Each world reads its byte ranges of a
Matrix Market file and fills ('distributed', routed to the owners) or
fills each rank's own tile ('prepartitioned'), runs TRS4 to the oracle
energy, and writes the density collectively as Matrix Market and as
binary, both read back here (the binary by the reference's reader).
Then the byte-range partitions, the structural ops on a 2 x 2 x 1 world
with no host triplets, and the reference's regrow stress at dim 1024 on
2 x 2 x 2: TRS4 chunked four iterations a host read
(``common.run_chunked``, uncaptured on a grid) with its capacity pinned
at 2 must regrow across a chunk and log it, and land on the oracle
energy."""
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import n  # noqa: F401  (one torch thread)
import _torch_mesh as TM
from conftest import rel_error
from ntpoly_tpu_torch.parallel import launch


def _make_system(workdir, rng, dim=64):
    h = rng.random((dim, dim))
    h = 0.5 * (h + h.T)
    w, v = np.linalg.eigh(h)
    w[dim // 2:] += (w[-1] - w[0])
    h = (v * w) @ v.T
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    mmwrite(str(workdir / "h.mtx"), csr_matrix(h))
    occ = v[:, :dim // 2]
    return w[:dim // 2].sum(), occ @ occ.T


def _run(tmp_path, shape, mode):
    outs = launch.run("_torch_mesh:multihost", int(np.prod(shape)),
                      args=(str(tmp_path), list(shape), mode),
                      workdir=tmp_path, timeout=240,
                      pythonpath=[Path(__file__).resolve().parent])
    energies = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MHENERGY"):
                _, pid, e, mu = line.split()
                energies[int(pid)] = e
    assert len(energies) == int(np.prod(shape)), outs
    # every rank's energy, bit for bit
    assert len(set(energies.values())) == 1, energies
    return float(energies[0])


@pytest.mark.parametrize("shape,mode", [
    ((2, 2, 2), "distributed"),
    ((2, 2, 2), "prepartitioned"),
    ((4, 2, 1), "distributed"),
], ids=["8rank-distributed", "8rank-prepartitioned", "8rank-asym-grid"])
def test_multi_process_mesh_trs4(tmp_path, rng, shape, mode):
    e_ref, rho_ref = _make_system(tmp_path, rng)
    energy = _run(tmp_path, shape, mode)
    assert abs(energy - e_ref) < 1e-6 * abs(e_ref)
    from scipy.io import mmread
    rho = np.asarray(mmread(str(tmp_path / "rho_mh.mtx")).todense())
    assert (np.linalg.norm(rho - rho_ref) / np.linalg.norm(rho_ref)) < 1e-6
    from ntpoly_tpu.io import binary
    i, j, v, dim = binary.read_triplets(str(tmp_path / "rho_mh.bin"))
    rho_b = np.zeros((dim, dim))
    np.add.at(rho_b, (i, j), v.real)
    assert np.abs(rho_b - rho).max() <= 1e-15 * np.abs(rho).max()
    assert len(i) == np.count_nonzero(rho)


def test_byte_range_read_partitions_exactly(tmp_path, rng):
    """The union of every rank's byte-range parse is the whole file,
    each line once."""
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    from ntpoly_tpu_torch.io import matrix_market as mm
    dim = 37
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < 0.3)
    mmwrite(str(tmp_path / "m.mtx"), csr_matrix(m))
    whole = mm.read_triplets(str(tmp_path / "m.mtx"))
    for n_ranks in (1, 2, 3, 5):
        parts = [mm.read_triplets_range(str(tmp_path / "m.mtx"), r, n_ranks)
                 for r in range(n_ranks)]
        got = sorted(zip(*(np.concatenate([p[k] for p in parts]).tolist()
                           for k in range(3))))
        ref = sorted(zip(*(w.tolist() for w in whole[:3])))
        assert got == ref


def test_binary_range_read_partitions_exactly(tmp_path, rng):
    from ntpoly_tpu_torch.io import binary
    from ntpoly_tpu_torch.parallel import pmatrix as PM
    from ntpoly_tpu_torch.parallel.grid import ProcessGrid
    dim = 29
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < 0.4)
    mat = PM.from_dense(m, bs=4, grid=ProcessGrid(device="cpu"))
    binary.write(mat, str(tmp_path / "m.bin"))
    whole = binary.read_triplets(str(tmp_path / "m.bin"))
    for n_ranks in (2, 4):
        parts = [binary.read_triplets_range(str(tmp_path / "m.bin"),
                                            r, n_ranks)
                 for r in range(n_ranks)]
        for k in range(3):
            assert (np.concatenate([p[k] for p in parts])
                    == whole[k]).all()


def test_prepartitioned_fill_single_process(rng):
    """mode='prepartitioned' with the whole set on one rank equals the
    replicated fill (the world's path shares this code)."""
    from ntpoly_tpu_torch.parallel import pmatrix as PM
    from ntpoly_tpu_torch.parallel.grid import ProcessGrid
    dim = 24
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < 0.4)
    i, j = np.nonzero(m)
    base = PM.empty(dim, bs=4, grid=ProcessGrid(device="cpu"), k=1,
                    dtype=torch.float64)
    a = PM.fill_from_triplets(base, i, j, m[i, j], mode="prepartitioned")
    b = PM.fill_from_triplets(base, i, j, m[i, j])
    assert rel_error(PM.to_dense(a).numpy(), PM.to_dense(b).numpy()) == 0


def test_multi_process_structural_ops(tmp_path):
    """resize, both slices, set_grid and comm_split route blocks on the
    device (no host triplets) in a world of four ranks."""
    outs = launch.run("_torch_mesh:structops", 4, args=(str(tmp_path),),
                      workdir=tmp_path, timeout=120,
                      pythonpath=[Path(__file__).resolve().parent])
    assert sum(o.count("STRUCTOPS_OK") for o in outs) == 4


def test_multi_process_stress_regrow(tmp_path):
    dim = 1024
    diag = np.where(np.arange(dim) % 2 == 0, -1.0, 1.0)
    from scipy.sparse import diags
    h = diags([np.full(dim - 1, 0.2), diag, np.full(dim - 1, 0.2)],
              [-1, 0, 1]).toarray()
    e_ref = np.linalg.eigvalsh(h)[:dim // 2].sum()
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix
    mmwrite(str(tmp_path / "h.mtx"), csr_matrix(h))
    energy = _run(tmp_path, (2, 2, 2), "stress")
    assert abs(energy - e_ref) < 1e-6 * abs(e_ref)
    log = (tmp_path / "stress_log.yaml").read_text()
    assert "capacity regrown" in log, \
        "regrow never fired: the stress case no longer stresses"
    import yaml
    yaml.safe_load(log)
