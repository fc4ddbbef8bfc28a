"""Port parity: ``ntpoly_tpu_torch/solvers/lobpcg.py`` against JAX's
``jax.experimental.sparse.linalg.lobpcg_standard`` driven with the same
start block and operator, and ``eigen.eigen_decomposition_iterative``
(real, and complex through the 2x2 real embedding) and
``dedup_embedded_pairs`` against the JAX package's, on the CPU in
float64.

Tolerances: LOBPCG's eigenvalues within 1e-10 (relative) of JAX's with
the same iteration count; its pieces (SVQB, the basis extension, the
projection) within 1e-12, compared through projectors where the
eigenvector signs of two LAPACKs may differ.  The entry points start
from different blocks (the port cannot draw JAX's PRNG), so they are
compared on matrices where LOBPCG converges: eigenvalues within 1e-8
and projectors V V^H within 1e-6.

``symbol_readings`` measures what 200 iterations reach on the analysis
path's overlap S, whose lowest eigenvalues crowd at the minimum of its
symbol: run as a script, it prints both packages' readings at the size
given (float32 and float64, from one start block):

    PYTHONPATH=. python3 tests/test_torch_lobpcg.py 65536
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ss
import torch
from jax.experimental.sparse import linalg as JL

from ntpoly_tpu.parallel import pmatrix as RPM
from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
from ntpoly_tpu.solvers import eigen as RE
from ntpoly_tpu.solvers import parameters as RP
from ntpoly_tpu_torch.parallel import pmatrix as PPM
from ntpoly_tpu_torch.profiling import analysis as AN
from ntpoly_tpu_torch.solvers import eigen as PE
from ntpoly_tpu_torch.solvers import lobpcg as PL
from ntpoly_tpu_torch.solvers import parameters as PP

from _torch_port import n

RG = RGrid(1, 1, 1)


def spaced(dim, k, seed):
    """A random symmetric matrix whose top k eigenvalues (20, 19, ...)
    stand well above the rest (uniform in [0, 5])."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    w = np.concatenate([20.0 - np.arange(k), 5.0 * rng.random(dim - k)])
    return (q * w) @ q.T


def flipped_overlap(dim):
    """b I - S for the analysis path's S (its lowest eigenvalues crowd
    at the symbol's minimum, so 200 iterations do not converge)."""
    rows, cols, vals = _overlap(dim)
    s = np.zeros((dim, dim))
    s[rows, cols] = vals
    return 2.4 * np.eye(dim) - s


def _overlap(dim, halfwidth=16):
    """(rows, cols, values) of the path's S, band by band (no dense
    dim x dim array)."""
    i = np.arange(dim)
    rows, cols = [], []
    for d in range(-halfwidth, halfwidth + 1):
        keep = (i + d >= 0) & (i + d < dim)
        rows.append(i[keep])
        cols.append(i[keep] + d)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    off = np.abs(rows - cols)
    return rows, cols, np.where(off == 0, 1.0, 0.3 / (1.0 + off) ** 2)


CASES = {"spaced": (lambda: spaced(300, 6, 1), 6, 100),
         "spaced_wide": (lambda: spaced(500, 12, 2), 12, 40),
         "overlap_unconverged": (lambda: flipped_overlap(1024), 8, 200)}


@pytest.mark.parametrize("case", list(CASES))
def test_lobpcg_standard(case):
    make, k, m = CASES[case]
    a = make()
    x0 = np.random.default_rng(3).standard_normal((a.shape[0], k))
    theta, v, it = JL.lobpcg_standard(jnp.asarray(a), jnp.asarray(x0), m=m)
    at = torch.from_numpy(a)
    pt, pv, pit = PL.lobpcg_standard(lambda x: at @ x, torch.from_numpy(x0),
                                     m=m)
    theta = np.asarray(theta)
    assert pit == int(it)
    assert np.abs(n(pt) - theta).max() <= 1e-10 * np.abs(theta).max()
    if case.startswith("spaced"):
        assert pit < m                    # converged by the eps rule
        v = np.asarray(v)
        assert np.abs(n(pv) @ n(pv).T - v @ v.T).max() <= 1e-8
        w = np.linalg.eigvalsh(a)[::-1][:k]
        assert np.abs(n(pt) - w).max() <= 1e-10


def test_lobpcg_pieces():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 6))
    x[:, 4] = x[:, 1] + 1e-20 * x[:, 2]          # a degenerate column
    for ref, got in ((JL._svqb(jnp.asarray(x)), PL._svqb(torch.from_numpy(x))),
                     (JL._orthonormalize(jnp.asarray(x)),
                      PL._orthonormalize(torch.from_numpy(x)))):
        ref, got = np.asarray(ref), n(got)
        assert np.abs(ref @ ref.T - got @ got.T).max() <= 1e-12
        assert (np.abs(ref).sum(0) > 0).sum() == (np.abs(got).sum(0) > 0).sum()
    q = np.linalg.qr(rng.standard_normal((64, 5)))[0]
    assert np.abs(np.asarray(JL._extend_basis(jnp.asarray(q), 5))
                  - n(PL._extend_basis(torch.from_numpy(q), 5))).max() <= 1e-12
    u = rng.standard_normal((64, 4))
    ref = np.asarray(JL._project_out(jnp.asarray(q), jnp.asarray(u)))
    got = n(PL._project_out(torch.from_numpy(q), torch.from_numpy(u)))
    assert np.abs(ref @ ref.T - got @ got.T).max() <= 1e-12


def test_column_norms_of_a_tall_float32_block():
    """LOBPCG normalizes [n, k] blocks column by column; torch's strided
    ``linalg.norm(x, dim=0)`` sums a tall float32 column in order on the
    CPU (2.4e-4 off at 2^20 rows, which cost the first transcription its
    orthonormality at 65,536 rows).  ``_norms`` stays at rounding."""
    x = np.random.default_rng(7).standard_normal((1 << 20, 4)).astype(
        np.float32) / 1024.0
    want = np.linalg.norm(x.astype(np.float64), axis=0)
    got = n(PL._norms(torch.from_numpy(x)))[0]
    assert np.abs(got - want).max() <= 1e-6


def test_lobpcg_input_checks():
    a = torch.eye(20, dtype=torch.float64)
    for k, match in ((0, "search dim > 0"), (4, "search dim \\* 5")):
        with pytest.raises(ValueError, match=match):
            PL.lobpcg_standard(lambda x: a @ x,
                               torch.ones((20, k), dtype=torch.float64))
        with pytest.raises(ValueError, match=match):
            JL.lobpcg_standard(jnp.eye(20), jnp.ones((20, k)))
    with pytest.raises(ValueError, match="same dtypes"):
        PL.lobpcg_standard(lambda x: (a @ x).float(),
                           torch.ones((20, 2), dtype=torch.float64))


def test_eps_rule_stops_early_in_float32():
    """In float32 the epsilon rule's bound tol * 10 * n * (|AX| + theta)
    grows with n: at 16,384 rows both packages stop after the same few
    iterations, far before m."""
    dim = 16384
    rows, cols, vals = _overlap(dim)
    s = ss.csr_matrix((vals, (rows, cols)), shape=(dim, dim))
    a = (2.4 * ss.eye(dim) - s).astype(np.float32)
    x0 = np.random.default_rng(5).standard_normal((dim, 8)).astype(
        np.float32)
    aj = jax.experimental.sparse.BCSR.from_scipy_sparse(a)
    _, _, it = JL.lobpcg_standard(lambda x: aj @ x, jnp.asarray(x0), m=200)
    at = torch.sparse_csr_tensor(torch.from_numpy(a.indptr.astype(np.int64)),
                                 torch.from_numpy(a.indices.astype(np.int64)),
                                 torch.from_numpy(a.data), size=(dim, dim))
    _, _, pit = PL.lobpcg_standard(lambda x: at @ x, torch.from_numpy(x0),
                                   m=200)
    assert pit == int(it) <= 5


def _pair(dense):
    return (RPM.from_dense(dense, bs=8, grid=RG),
            PPM.from_dense(dense, bs=8, grid=AN._grid("cpu")))


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_eigen_decomposition_iterative(complex_):
    """The defect matrix of the analysis path (eight deep levels) at 256
    rows: both packages converge, from different start blocks."""
    pm = AN.defect(256, 8, "cpu", complex_=complex_)
    d = n(PPM.to_dense(pm))
    rm = RPM.from_dense(d, bs=8, grid=RG)
    rw, rv = RE.eigen_decomposition_iterative(rm, 8, RP.SolverParameters())
    pw, pv = PE.eigen_decomposition_iterative(pm, 8, PP.SolverParameters())
    rw, rv = np.asarray(rw), np.asarray(rv)
    pw = pw if complex_ else n(pw)
    pv = pv if complex_ else n(pv)
    assert np.abs(pw - rw).max() <= 1e-8 * np.abs(rw).max()
    assert np.abs(pv @ pv.conj().T - rv @ rv.conj().T).max() <= 1e-6
    assert np.abs(pw - np.linalg.eigvalsh(d)[:8]).max() <= 1e-8
    assert pv.shape == (256, 8) and np.iscomplexobj(pv) == complex_


def test_eigen_decomposition_iterative_masks_padding():
    """dim 250 pads to 256 rows: the padded rows stay out of the
    search."""
    d = n(PPM.to_dense(AN.defect(250, 8, "cpu")))
    _, pm = _pair(d)
    w, v = PE.eigen_decomposition_iterative(pm, 8)
    assert v.shape == (250, 8)
    assert np.abs(n(w) - np.linalg.eigvalsh(d)[:8]).max() <= 1e-8


def test_dedup_embedded_pairs():
    rng = np.random.default_rng(6)
    cdim, nvals = 30, 4
    h = rng.standard_normal((cdim, cdim)) + 1j * rng.standard_normal(
        (cdim, cdim))
    h = h + h.conj().T
    e = np.block([[h.real, -h.imag], [h.imag, h.real]])
    w2, v2 = np.linalg.eigh(e)
    w2, v2 = w2[:2 * nvals], v2[:, :2 * nvals]
    ref = RE.dedup_embedded_pairs(w2, v2, cdim, nvals)
    got = PE.dedup_embedded_pairs(w2, v2, cdim, nvals)
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)
    assert np.abs(got[0] - np.linalg.eigvalsh(h)[:nvals]).max() <= 1e-12


def symbol_readings(dim: int, iters: int = 200) -> dict:
    """Both packages' LOBPCG on b I - S at ``dim`` rows from one start
    block (``torch.randn`` seeded 7): iterations at ``tol=None``, and
    after ``iters`` iterations (``tol=0``) the eigenvalues' distance
    from the symbol's minimum (min and max), max |V^T V - I| and the
    largest residual, per dtype."""
    rows, cols, vals = _overlap(dim)
    s = ss.csr_matrix((vals, (rows, cols)), shape=(dim, dim))
    f_min = AN.symbol_minimum()
    out = {}
    for dt in (np.float32, np.float64):
        b = dt(2.0 + 2 * sum(0.3 / (1 + d) ** 2 for d in range(1, 17)))
        a = (b * ss.eye(dim) - s).astype(dt)
        x0 = torch.randn((dim, 8), generator=torch.Generator().manual_seed(7),
                         dtype=torch.float64).numpy().astype(dt)
        aj = jax.experimental.sparse.BCSR.from_scipy_sparse(a)
        at = torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr.astype(np.int64)),
            torch.from_numpy(a.indices.astype(np.int64)),
            torch.from_numpy(a.data), size=(dim, dim))
        runs = {
            "jax": lambda tol: JL.lobpcg_standard(
                lambda x: aj @ x, jnp.asarray(x0), m=iters, tol=tol),
            "port": lambda tol: PL.lobpcg_standard(
                lambda x: at @ x, torch.from_numpy(x0), m=iters, tol=tol)}
        for name, run in runs.items():
            eps_iters = int(run(None)[2])
            theta, v, _ = run(0.0)
            w = float(b) - np.asarray(theta, np.float64)
            v = np.asarray(v, np.float64)
            res = np.linalg.norm(s @ v - v * w[None, :], axis=0)
            out[f"{name}_{np.dtype(dt).name}"] = {
                "iterations_tol_none": eps_iters,
                "min_w_minus_fmin": float(w.min() - f_min),
                "max_w_minus_fmin": float(w.max() - f_min),
                "orthogonality": float(np.abs(v.T @ v - np.eye(8)).max()),
                "max_residual": float(res.max())}
    return out


def test_symbol_readings_small():
    """At 2048 rows both packages sit within 1e-4 of the symbol's
    minimum after 200 iterations, none below it, and agree to 1e-10 in
    float64."""
    res = symbol_readings(2048)
    for key, r in res.items():
        assert 0.0 <= r["min_w_minus_fmin"] <= r["max_w_minus_fmin"] <= 1e-4
        assert r["orthogonality"] <= 1e-5
    j, p = res["jax_float64"], res["port_float64"]
    assert abs(j["max_w_minus_fmin"] - p["max_w_minus_fmin"]) <= 1e-10


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    print(json.dumps({"dim": size, **symbol_readings(size)}), flush=True)
