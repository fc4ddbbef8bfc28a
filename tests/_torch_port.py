"""Shared helpers of the port's parity tests: one input, built with
numpy from a seed, fed to both the JAX reference (``ntpoly_tpu``) and
the PyTorch port (``ntpoly_tpu_torch``).

Importing it caps torch at one intra-op thread: the suite runs in
several worker processes at once, and the port's small-op loops slowed
about a hundredfold when each worker also ran torch's default thread
pool on the same cores.  It imports JAX only where a helper needs it,
so that the tests of the card, which import its ``card`` fixture, run
where JAX is not installed."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EMPTY = 2**30


def rand_ell(rng, rows, k, nbc, bs, *, holes=0.0, dtype=np.float64,
             empty_row=None, ragged_row=None):
    """Random block-ELL (numpy): each row holds up to k ascending unique
    col ids in [0, nbc) packed first, then EMPTY; optional holes punched
    anywhere (EMPTY id, zero block), one empty row, one ragged row."""
    cols = np.full((rows, k), EMPTY, np.int32)
    for r in range(rows):
        n = int(rng.integers(1, k + 1))
        if r == empty_row:
            n = 0
        elif r == ragged_row:
            n = 1
        cols[r, :n] = np.sort(rng.choice(nbc, min(n, nbc), replace=False))
    if holes:
        cols = np.where(rng.random((rows, k)) < holes, EMPTY, cols)
    blocks = rng.standard_normal((rows, k, bs, bs)).astype(dtype)
    blocks[cols == EMPTY] = 0
    return cols.astype(np.int32), blocks


def band_ell(rng, rows, k, bs, *, holes=0.0, capacity=None,
             dtype=np.float64):
    """Banded block-ELL packed at rank: row r holds cols lo..lo+k-1
    (lo = max(0, r - k // 2), clipped to the matrix), capacity-padded
    with EMPTY, optional holes."""
    cap = capacity or k
    cols = np.full((rows, cap), EMPTY, np.int32)
    for r in range(rows):
        lo = max(0, r - k // 2)
        cc = [c for c in range(lo, lo + k) if c < rows]
        cols[r, :len(cc)] = cc
    if holes:
        cols = np.where(rng.random((rows, cap)) < holes, EMPTY, cols)
    blocks = rng.standard_normal((rows, cap, bs, bs)).astype(dtype)
    blocks[cols == EMPTY] = 0
    return cols.astype(np.int32), blocks


def j(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


@pytest.fixture
def card():
    """The CUDA device, for the tests marked ``card`` (the kernels of
    ``ntpoly_tpu_torch/csrc``); they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels of ntpoly_tpu_torch/csrc")
    return torch.device("cuda")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def n(x):
    """numpy from a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def overlap_triplets(dim, halfwidth=16):
    """(rows, cols, values) of the banded overlap of
    ``ntpoly_tpu_torch.systems.overlap_fn``: ones on the diagonal,
    0.3 / (1 + |i - j|)^2 within the half-width."""
    i = np.arange(dim)
    off = np.abs(i[:, None] - i[None, :])
    s = np.where(off == 0, 1.0, 0.3 / (1.0 + off) ** 2) * (off <= halfwidth)
    rows, cols = np.nonzero(s)
    return rows, cols, s[rows, cols]


def solve_logged(path, log, fn, *args):
    """fn(*args) with the package's YAML logger writing to ``path`` ->
    (result, the log's top-level block).  The iteration count is the
    block's 'Total Iterations', as bench.py reads it."""
    import warnings

    import yaml
    log.activate_logger(str(path))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = fn(*args)
    finally:
        log.deactivate_logger()
    doc = yaml.safe_load(path.read_text())
    return out, next(iter(doc.values()))


def to_reference(m):
    """The port's matrix as the reference's (1x1x1 grid), slot for
    slot."""
    from ntpoly_tpu.parallel import pmatrix as RPM
    from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
    from ntpoly_tpu_torch.parallel import pmatrix as PPM
    grid = RGrid(1, 1, 1)
    return RPM.PSMatrix(*RPM._shard(grid, *PPM.to_numpy(m)), m.dim, m.bs,
                        grid)


def port_matrix_ps(jax_matrix_ps, device="cpu"):
    """The JAX package's ``Matrix_ps`` carried across: its col_ids,
    blocks, dim and bs as numpy, through ``pmatrix.from_reference_arrays``,
    as a port ``Matrix_ps`` with the same embedding state."""
    import ntpoly_tpu_torch as pnt
    from ntpoly_tpu_torch.parallel import pmatrix as PPM
    from ntpoly_tpu_torch.parallel.grid import ProcessGrid
    m = jax_matrix_ps._m
    out = pnt.Matrix_ps(PPM.from_reference_arrays(
        np.asarray(m.col_ids), np.asarray(m.blocks), m.dim, m.bs,
        ProcessGrid(device=device)))
    out._embedded, out._cdim = jax_matrix_ps._embedded, jax_matrix_ps._cdim
    return out
