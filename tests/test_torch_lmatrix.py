"""Port parity: the local matrices (ntpoly_tpu_torch/core/lmatrix.py
through nt.Matrix_lsr / nt.Matrix_lsc) against the JAX package's, on
the cases of tests/test_matrix.py, real and complex: each operation run
by both packages on the same Matrix Market inputs, both results written
with WriteToMatrixMarket, the port's within 1e-12 of the JAX package's
(relative Frobenius, f64) and both within the reference's bar of the
numpy result."""
import numpy as np
import pytest
import torch
from scipy.io import mmread, mmwrite
from scipy.sparse import csr_matrix

import ntpoly_tpu as rnt
import ntpoly_tpu_torch as pnt
from ntpoly_tpu_torch.core.lmatrix import LocalMatrix

TOL = 1e-12


@pytest.fixture(autouse=True)
def grids():
    torch.set_default_dtype(torch.float64)
    pnt.ConstructGlobalProcessGrid(1, 1, 1, device="cpu")
    yield
    pnt.DestructGlobalProcessGrid()
    torch.set_default_dtype(torch.float32)


def make(rng, rows=8, cols=7, density=0.5, is_complex=False):
    m = rng.random((rows, cols)) * (rng.random((rows, cols)) < density)
    if is_complex:
        m = m + 1j * (rng.random((rows, cols)) * (m != 0))
    return m


def classes(nt, is_complex):
    return ((nt.Matrix_lsc, nt.TripletList_c, nt.Triplet_c,
             nt.MatrixMemoryPool_c) if is_complex else
            (nt.Matrix_lsr, nt.TripletList_r, nt.Triplet_r,
             nt.MatrixMemoryPool_r))


def rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def run_both(tmp_path, fn, oracle, oracle_tol=1e-13):
    """fn(nt, tag) -> a local matrix of that package; both written and
    compared."""
    out = {}
    for tag, nt in (("r", rnt), ("p", pnt)):
        path = str(tmp_path / f"out_{tag}.mtx")
        fn(nt, tag).WriteToMatrixMarket(path)
        out[tag] = np.asarray(mmread(path).todense())
    assert rel(out["p"], out["r"]) <= TOL
    assert rel(out["p"], oracle) <= oracle_tol
    assert rel(out["r"], oracle) <= oracle_tol
    return out


def write(tmp_path, m, name):
    path = str(tmp_path / f"{name}.mtx")
    mmwrite(path, csr_matrix(m))
    return path


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_read_write(tmp_path, rng, is_complex):
    m = make(rng, is_complex=is_complex)
    path = write(tmp_path, m, "in")

    def fn(nt, _):
        a = classes(nt, is_complex)[0](path)
        assert (a.GetRows(), a.GetColumns()) == m.shape
        return a
    run_both(tmp_path, fn, m)
    # the same matrix, the same bytes
    assert (tmp_path / "out_r.mtx").read_bytes() == \
        (tmp_path / "out_p.mtx").read_bytes()


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_from_triplets(tmp_path, rng, is_complex):
    m = make(rng, 6, 6, is_complex=is_complex)

    def fn(nt, _):
        SMatrix, TList, Triplet, _p = classes(nt, is_complex)
        tl = TList(0)
        for i, j in zip(*np.nonzero(m)):
            tl.Append(Triplet(int(i) + 1, int(j) + 1, m[i, j]))
        return SMatrix(tl, 6, 6)
    run_both(tmp_path, fn, m)


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_addition(tmp_path, rng, is_complex):
    a, b = (make(rng, 7, 7, is_complex=is_complex) for _ in range(2))
    pa, pb = write(tmp_path, a, "a"), write(tmp_path, b, "b")

    def fn(nt, _):
        SMatrix = classes(nt, is_complex)[0]
        ma, mb = SMatrix(pa), SMatrix(pb)
        mb.Increment(ma, 1.25, 0.0)
        return mb
    run_both(tmp_path, fn, b + 1.25 * a)


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_dot(tmp_path, rng, is_complex):
    a, b = (make(rng, 7, 7, is_complex=is_complex) for _ in range(2))
    pa, pb = write(tmp_path, a, "a"), write(tmp_path, b, "b")
    got = {}
    for tag, nt in (("r", rnt), ("p", pnt)):
        SMatrix = classes(nt, is_complex)[0]
        got[tag] = SMatrix(pb).Dot(SMatrix(pa))
    ref = np.sum(np.conj(b) * a)
    assert abs(got["p"] - got["r"]) <= TOL * abs(ref)
    assert abs(got["p"] - ref) <= 1e-12


@pytest.mark.parametrize("conjugate", [False, True], ids=["t", "h"])
@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_transpose(tmp_path, rng, is_complex, conjugate):
    m = make(rng, 8, 5, is_complex=is_complex)
    path = write(tmp_path, m, "a")

    def fn(nt, _):
        SMatrix = classes(nt, is_complex)[0]
        ma = SMatrix(path)
        mt = SMatrix(ma.GetRows(), ma.GetColumns())
        mt.Transpose(ma)
        if conjugate:
            mt.Conjugate()
        return mt
    run_both(tmp_path, fn, m.conj().T if conjugate else m.T)


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_pairwise(tmp_path, rng, is_complex):
    a, b = (make(rng, 7, 7, is_complex=is_complex) for _ in range(2))
    pa, pb = write(tmp_path, a, "a"), write(tmp_path, b, "b")

    def fn(nt, _):
        SMatrix = classes(nt, is_complex)[0]
        ma, mb = SMatrix(pa), SMatrix(pb)
        mc = SMatrix(ma.GetColumns(), ma.GetRows())
        mc.PairwiseMultiply(ma, mb)
        return mc
    run_both(tmp_path, fn, a * b)


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)],
                         ids=["nn", "nt", "tn", "tt"])
@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_multiply(tmp_path, rng, ta, tb, is_complex):
    a = make(rng, 6, 4, is_complex=is_complex)
    b = make(rng, 4, 7, is_complex=is_complex)
    c = make(rng, 6, 7, is_complex=is_complex)
    pa = write(tmp_path, a.T if ta else a, "a")
    pb = write(tmp_path, b.T if tb else b, "b")
    pc = write(tmp_path, c, "c")

    def fn(nt, _):
        SMatrix, _t, _tr, MPool = classes(nt, is_complex)
        ma, mb, mc = SMatrix(pa), SMatrix(pb), SMatrix(pc)
        mc.Gemm(ma, mb, ta, tb, 1.5, -0.5, 0.0, MPool(7, 6))
        return mc
    run_both(tmp_path, fn, 1.5 * a @ b - 0.5 * c)


def test_extract_row_column(tmp_path, rng):
    m = make(rng, 8, 5)
    path = write(tmp_path, m, "a")
    for what, idx, oracle in (("row", 3, m[3:4, :]), ("col", 2, m[:, 2:3])):
        def fn(nt, _):
            ma = nt.Matrix_lsr(path)
            if what == "row":
                out = nt.Matrix_lsr(ma.GetColumns(), 1)
                ma.ExtractRow(idx, out)
            else:
                out = nt.Matrix_lsr(1, ma.GetRows())
                ma.ExtractColumn(idx, out)
            return out
        run_both(tmp_path, fn, oracle)


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_diagonal_scale(tmp_path, rng, is_complex):
    m = make(rng, 6, 6, is_complex=is_complex)
    d = rng.random(6) + (1j * rng.random(6) if is_complex else 0)
    path = write(tmp_path, m, "a")

    def fn(nt, _):
        SMatrix, TList, Triplet, _p = classes(nt, is_complex)
        ma = SMatrix(path)
        tl = TList(0)
        for i, v in enumerate(d):
            tl.Append(Triplet(i + 1, i + 1, v))
        ma.DiagonalScale(tl)
        return ma
    run_both(tmp_path, fn, m * d[None, :])


def test_scale_and_triplet_roundtrip(tmp_path, rng):
    m = make(rng, 7, 7)
    path = write(tmp_path, m, "a")
    got = {}
    for tag, nt in (("r", rnt), ("p", pnt)):
        ma = nt.Matrix_lsr(path)
        ma.Scale(0.5)
        tl = nt.TripletList_r(0)
        ma.MatrixToTripletList(tl)
        d = np.zeros((7, 7))
        for k in range(tl.GetSize()):
            t = tl.GetTripletAt(k)
            d[t.index_row - 1, t.index_column - 1] = t.point_value
        got[tag] = d
    assert rel(got["p"], got["r"]) <= TOL
    assert rel(got["p"], 0.5 * m) <= 1e-14


def test_sparse_construction_never_densifies(rng, monkeypatch):
    """Triplets, extracted rows and columns come from the stored blocks:
    with to_dense patched to raise they still work."""
    m = make(rng, 19, 13, density=0.2)
    i, j = np.nonzero(m)
    lm = LocalMatrix.from_triplets(np.concatenate([i, i]),
                                   np.concatenate([j, j]),
                                   np.concatenate([m[i, j], m[i, j]]),
                                   19, 13, device="cpu")
    monkeypatch.setattr(LocalMatrix, "to_dense", None)
    r, c, v = lm.to_triplets()
    assert np.array_equal(r, i) and np.array_equal(c, j)
    assert np.abs(v - 2 * m[i, j]).max() <= 1e-15
    row = lm.extract_row(5)
    col = lm.extract_column(7)
    for got, want in ((row, 2 * m[5:6]), (col, 2 * m[:, 7:8])):
        rr, cc, vv = got.to_triplets()
        d = np.zeros(want.shape)
        d[rr, cc] = vv
        assert np.abs(d - want).max() <= 1e-15
