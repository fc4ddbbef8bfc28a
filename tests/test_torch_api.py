"""Port parity: the NTPoly-compatible surface (``import ntpoly_tpu_torch
as nt``) against the JAX package's (``import ntpoly_tpu as nt``) on the
cases of tests/test_psmatrix.py, test_psmatrixalgebra.py,
test_solvers.py and test_chemistry.py, at grid (1, 1, 1) on the CPU in
f64: each case runs through both surfaces on the same inputs.

Values agree within 1e-10 relative (Frobenius, ``VALUES``), and each
side lies within the reference's oracle bar (``conftest.THRESHOLD``,
1e-4).  The solver suite runs at DIM = 23 (bs 4: both packages take
the XLA tiers) and at 64 (bs 8: the port's kernels' plain versions
against the reference's XLA tiers).  The port always embeds complex
data; the JAX package embeds on the CPU only under
``set_complex_embedding("always")``, so complex cases run the JAX side
twice: embedded, for the same slots (col ids equal, blocks within
1e-12 of max |C|), and native, for the values.  Where a solver's stop
hangs on rounding (ROADMAP Queue C: the TRS4 sigma, the energy
monitor at the noise floor), the two may stop an iteration apart;
those cases hold each side to the oracle only (``parity=False``)."""
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg as sla
import torch
from scipy.io import mmwrite
from scipy.sparse import csr_matrix

import ntpoly_tpu as rnt
import ntpoly_tpu_torch as pnt
from ntpoly_tpu import config as rconfig

from _torch_port import port_matrix_ps

THRESHOLD = 1e-4
VALUES = 1e-10
SLOTS = 1e-12
DIM = 23


@pytest.fixture(autouse=True)
def grids():
    torch.set_default_dtype(torch.float64)
    rnt.ConstructGlobalProcessGrid(1, 1, 1)
    pnt.ConstructGlobalProcessGrid(1, 1, 1, device="cpu")
    yield
    pnt.DestructGlobalProcessGrid()
    rnt.DestructGlobalProcessGrid()
    rconfig.set_complex_embedding("auto")
    torch.set_default_dtype(torch.float32)


@pytest.fixture
def embed_always():
    """The JAX package embeds complex data as the port does."""
    rconfig.set_complex_embedding("always")
    yield
    rconfig.set_complex_embedding("auto")


def rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def dense(m) -> np.ndarray:
    r, c, v = m._triplets()
    n = m.GetActualDimension()
    out = np.zeros((n, n), np.asarray(v).dtype)
    np.add.at(out, (np.asarray(r), np.asarray(c)), v)
    return out


def read(tmp_path, m, name="in"):
    """The same file read by both surfaces -> (JAX, port)."""
    path = str(tmp_path / f"{name}.mtx")
    mmwrite(path, csr_matrix(m))
    return rnt.Matrix_ps(path), pnt.Matrix_ps(path)


def agree(r, p, oracle=None, parity=True, tol=THRESHOLD):
    """Values of the two surfaces' matrices (or dense arrays) against
    each other and the oracle."""
    rd = r if isinstance(r, np.ndarray) else dense(r)
    pd = p if isinstance(p, np.ndarray) else dense(p)
    if parity:
        assert rel(pd, rd) <= VALUES
    if oracle is not None:
        assert rel(pd, oracle) <= tol
        assert rel(rd, oracle) <= tol


def same_slots(r, p):
    assert r._embedded == p._embedded and r._cdim == p._cdim
    assert np.array_equal(np.asarray(r._m.col_ids), p._m.col_ids.numpy())
    rb = np.asarray(r._m.blocks)
    scale = max(np.abs(rb).max(initial=0.0), 1e-300)
    assert np.abs(rb - p._m.blocks.numpy()).max(initial=0.0) <= \
        SLOTS * scale


def random_matrix(rng, dim=13, density=0.5, is_complex=False):
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < density)
    if is_complex:
        m = m + 1j * rng.random((dim, dim)) * (m != 0)
    return m


# ----------------------------------------------------------------------------
# the surface: names, grid, parameters
# ----------------------------------------------------------------------------

def test_names_match_the_reference():
    import ntpoly_tpu.__init__ as rinit
    src = open(rinit.__file__).read()
    names = src[src.index("from .api import (") :]
    names = names[names.index("(") + 1: names.index(")")]
    want = {w.strip() for w in names.replace("\n", " ").split(",")
            if w.strip() and not w.strip().startswith("#")}
    want |= {"NTPolyError", "GridError", "IOFormatError",
             "ConvergenceError", "config"}
    assert all(hasattr(pnt, w) for w in want), \
        sorted(w for w in want if not hasattr(pnt, w))
    public = {n for n in dir(rnt.api) if not n.startswith("_")
              and n[0].isupper()}
    assert public <= set(dir(pnt.api))


def test_grid_shapes_and_getters(tmp_path):
    """Without a world there is one rank, so a 2 x 2 x 1 grid breaks the
    reference's rule rows * cols * slices == ranks; in a world of four
    ranks it is built, its shape getters are the reference's on its
    2 x 2 x 1 grid, rank 0's coordinates and root flag are the
    reference's controller's, and rank r sits at (r // 2, r % 2, 0)."""
    with pytest.raises(pnt.GridError, match="2x2x1 != rank count 1"):
        pnt.ConstructGlobalProcessGrid(2, 2, 1, device="cpu")
    import json
    import _torch_mesh
    from ntpoly_tpu_torch.parallel import launch
    outs = launch.run("_torch_mesh:api_getters", 4, args=(str(tmp_path),),
                      workdir=tmp_path, timeout=120,
                      pythonpath=[Path(_torch_mesh.__file__).parent])
    rnt.ConstructGlobalProcessGrid(2, 2, 1)
    ref = [getattr(rnt, f"GetGlobal{n}")() for n in
           ("IsRoot", "NumRows", "NumColumns", "NumSlices", "MyRow",
            "MyColumn", "MySlice")]
    rg = rnt.ProcessGrid(2, 2, 1)
    ref += [rg.GetNumRows(), rg.GetMyRow(), rg.GetMyColumn(),
            rg.GetMySlice()]
    rnt.ConstructGlobalProcessGrid(1, 1, 1)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert ranks[0] == ref == [True, 2, 2, 1, 0, 0, 0, 2, 0, 0, 0]
    for r, got in enumerate(ranks[1:], 1):
        rc = [r // 2, r % 2, 0]
        assert got == [False, 2, 2, 1, *rc, 2, *rc]
    pnt.ConstructGlobalProcessGrid(1, 1, 1, device="cpu")
    got = [getattr(pnt, f"GetGlobal{n}")() for n in
           ("IsRoot", "NumRows", "NumColumns", "NumSlices", "MyRow",
            "MyColumn", "MySlice")]
    want = [getattr(rnt, f"GetGlobal{n}")() for n in
            ("IsRoot", "NumRows", "NumColumns", "NumSlices", "MyRow",
             "MyColumn", "MySlice")]
    assert got == want == [True, 1, 1, 1, 0, 0, 0]
    g = pnt.ProcessGrid(1, 1, 1, device="cpu")
    assert (g.GetNumRows(), g.GetNumColumns(), g.GetNumSlices(),
            g.GetMyRow()) == (1, 1, 1, 0)
    assert pnt.Matrix_ps(9, g)._m.device == torch.device("cpu")


def test_iters_per_sync_refused(tmp_path, rng):
    """SetItersPerSync(2) runs the Hotelling loop chunked through the
    API, as the reference's does: its inverse, and the oracle's."""
    a = np.eye(DIM) * 2.0 + 0.1 * np.diag(np.ones(DIM - 1), 1) \
        + 0.1 * np.diag(np.ones(DIM - 1), -1)
    r, p = read(tmp_path, a)
    rs, ps = rnt.SolverParameters(), pnt.SolverParameters()
    rs.SetItersPerSync(2)
    ps.SetItersPerSync(2)
    ro, po = rnt.Matrix_ps(DIM), pnt.Matrix_ps(DIM)
    rnt.InverseSolvers.Invert(r, ro, rs)
    pnt.InverseSolvers.Invert(p, po, ps)
    agree(ro, po, np.linalg.inv(a))


def test_logger_and_timers(tmp_path):
    import yaml
    log = tmp_path / "log.yaml"
    pnt.ActivateLogger(str(log))
    pnt.WriteGridInfo()
    pnt.WriteHeader("Block")
    pnt.EnterSubLog()
    pnt.WriteElement("key", 3)
    pnt.ExitSubLog()
    pnt.WriteHeader("List")
    pnt.EnterSubLog()
    pnt.WriteListElement("item", 1.5)
    pnt.ExitSubLog()
    pnt.DeactivateLogger()
    doc = yaml.safe_load(log.read_text())
    assert doc["Process Grid"]["Process Rows"] == 1
    pnt.RegisterTimer("t")
    pnt.StartTimer("t")
    pnt.StopTimer("t")


def test_triplet_list_methods():
    for nt in (rnt, pnt):
        tl = nt.TripletList_r()
        for k in range(40):
            tl.Append(nt.Triplet_r(40 - k, k % 7 + 1, float(k)))
        tl.SetTripletAt(0, nt.Triplet_r(3, 3, -1.0))
        tl.SortTripletList()
        tl.Resize(45)
        t = tl.GetTripletAt(44)
        assert (tl.GetSize(), t.index_row, t.point_value) == (45, 0, 0.0)
        tl.Resize(30)
        got = [(tl.GetTripletAt(k).index_row,
                tl.GetTripletAt(k).index_column,
                tl.GetTripletAt(k).point_value) for k in range(30)]
        if nt is rnt:
            ref = got
    assert got == ref


# ----------------------------------------------------------------------------
# Matrix_ps: construction, I/O, structure (tests/test_psmatrix.py)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_read_write_binary(tmp_path, rng, is_complex):
    m = random_matrix(rng, is_complex=is_complex)
    r, p = read(tmp_path, m)
    for a, tag in ((r, "r"), (p, "p")):
        a.WriteToBinary(str(tmp_path / f"{tag}.ntx"))
    rb = rnt.Matrix_ps(str(tmp_path / "p.ntx"), True)
    pb = pnt.Matrix_ps(str(tmp_path / "r.ntx"), True)
    agree(rb, pb, m, tol=1e-14)
    assert p.GetSize() == r.GetSize() == np.count_nonzero(m)


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_fill_and_triplet_lists(tmp_path, rng, is_complex):
    dim = 11
    m = random_matrix(rng, dim, is_complex=is_complex)
    lists = {}
    for tag, nt in (("r", rnt), ("p", pnt)):
        TL = nt.TripletList_c if is_complex else nt.TripletList_r
        T = nt.Triplet_c if is_complex else nt.Triplet_r
        tl = TL(0)
        for i, j in zip(*np.nonzero(m)):
            tl.Append(T(int(i) + 1, int(j) + 1, m[i, j]))
        a = nt.Matrix_ps(dim)
        a.FillFromTripletList(tl)
        out = TL(0)
        a.GetTripletList(out)
        blk = TL(0)
        a.GetMatrixBlock(blk, 2, 9, 1, 7)
        lists[tag] = [(out.GetTripletAt(k).index_row,
                       out.GetTripletAt(k).index_column,
                       out.GetTripletAt(k).point_value)
                      for k in range(out.GetSize())]
        lists[tag + "b"] = blk.GetSize()
    assert lists["rb"] == lists["pb"]
    assert [x[:2] for x in lists["r"]] == [x[:2] for x in lists["p"]]
    assert np.allclose([x[2] for x in lists["r"]],
                       [x[2] for x in lists["p"]], rtol=0, atol=1e-15)


def test_identity_dense_permutation(tmp_path):
    for nt in (rnt, pnt):
        a = nt.Matrix_ps(9)
        a.FillIdentity()
        assert a.IsIdentity() and abs(a.Trace() - 9) < 1e-14
        d = nt.Matrix_ps(7)
        d.FillDense()
        assert d.GetSize() == 49 and abs(d.Norm() - 7.0) < 1e-14
        assert not d.IsIdentity()
        p = nt.Matrix_ps(10)
        perm = nt.Permutation(p.GetLogicalDimension())
        perm.SetReversePermutation()
        p.FillDistributedPermutation(perm, True)
        assert p.GetSize() == p.GetLogicalDimension()
    r, q = rnt.Matrix_ps(9), pnt.Matrix_ps(9)
    r.FillIdentity()
    q.FillIdentity()
    same_slots(r, q)


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_transpose_conjugate(tmp_path, rng, embed_always, is_complex):
    m = random_matrix(rng, is_complex=is_complex)
    r, p = read(tmp_path, m)
    out = {}
    for tag, nt, a in (("r", rnt, r), ("p", pnt, p)):
        b = nt.Matrix_ps(a.GetActualDimension())
        b.Transpose(a)
        b.Conjugate()
        out[tag] = b
    same_slots(out["r"], out["p"])
    agree(out["r"], out["p"], m.conj().T, tol=1e-14)


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
@pytest.mark.parametrize("new_dim", [7, 21])
def test_resize(tmp_path, rng, embed_always, is_complex, new_dim):
    m = random_matrix(rng, is_complex=is_complex)
    r, p = read(tmp_path, m)
    r2, p2 = rnt.Matrix_ps(r), pnt.Matrix_ps(p)
    r2.Resize(new_dim)
    p2.Resize(new_dim)
    ref = np.zeros((new_dim, new_dim), m.dtype)
    k = min(13, new_dim)
    ref[:k, :k] = m[:k, :k]
    same_slots(r2, p2)
    agree(r2, p2, ref, tol=1e-14)
    assert p._m is not p2._m and dense(p).shape == (13, 13)


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_get_matrix_slice(tmp_path, rng, embed_always, is_complex):
    m = random_matrix(rng, is_complex=is_complex)
    r, p = read(tmp_path, m)
    subs = {}
    for tag, nt, a in (("r", rnt, r), ("p", pnt, p)):
        sub = nt.Matrix_ps(13)
        a.GetMatrixSlice(sub, 2, 8, 1, 5)
        subs[tag] = sub
    ref = np.zeros((7, 7), m.dtype)
    ref[:, :5] = m[2:9, 1:6]
    same_slots(subs["r"], subs["p"])
    agree(subs["r"], subs["p"], ref, tol=1e-14)


def test_measure_asymmetry_and_symmetrize(tmp_path, rng):
    m = random_matrix(rng)
    r, p = read(tmp_path, m)
    assert abs(p.MeasureAsymmetry() - r.MeasureAsymmetry()) <= 1e-14
    assert abs(p.MeasureAsymmetry() - np.abs(m - m.T).sum(0).max()) <= 1e-12
    r.Symmetrize()
    p.Symmetrize()
    same_slots(r, p)
    agree(r, p, 0.5 * (m + m.T), tol=1e-14)


# ----------------------------------------------------------------------------
# algebra (tests/test_psmatrixalgebra.py)
# ----------------------------------------------------------------------------

CASES = [(False, False), (True, True)]


@pytest.mark.parametrize("ca,cb", CASES, ids=["rr", "cc"])
@pytest.mark.parametrize("op", ["increment", "gemm", "pairwise"])
def test_binary_ops(tmp_path, rng, ca, cb, op):
    """Each op under the JAX package's embedding (slot for slot) and
    native complex (values)."""
    a = random_matrix(rng, 15, is_complex=ca)
    b = random_matrix(rng, 15, is_complex=cb)
    oracle = {"increment": b + 1.5 * a, "gemm": a @ b,
              "pairwise": a * b}[op]
    outs = {}
    for mode in ("always", "auto"):
        rconfig.set_complex_embedding(mode)
        for tag, nt in (("r", rnt), ("p", pnt)):
            if tag == "p" and mode == "auto":
                continue
            ma, mb = read(tmp_path, a, "a")[tag == "p"], \
                read(tmp_path, b, "b")[tag == "p"]
            if op == "increment":
                mb.Increment(ma, 1.5)
                c = mb
            else:
                c = nt.Matrix_ps(ma.GetActualDimension())
                if op == "gemm":
                    c.Gemm(ma, mb, nt.PMatrixMemoryPool(ma))
                else:
                    c.PairwiseMultiply(ma, mb)
            outs[tag + mode] = c
    same_slots(outs["ralways"], outs["palways"])
    agree(outs["rauto"], outs["palways"], oracle, tol=1e-13)


def test_mixed_embedding_raises(tmp_path, rng, embed_always):
    a = random_matrix(rng, 15, is_complex=True)
    b = random_matrix(rng, 15)
    for k, nt in enumerate((rnt, pnt)):
        ma, mb = read(tmp_path, a, "a")[k], read(tmp_path, b, "b")[k]
        with pytest.raises(nt.api.ComplexSupportError
                           if nt is pnt else Exception):
            mb.Increment(ma, 1.5)


def test_gemm_alpha_beta_threshold(tmp_path, rng):
    a, b, c = (random_matrix(rng, 15) for _ in range(3))
    out = {}
    for k, tag in enumerate("rp"):
        ma, mb, mc = (read(tmp_path, x, nm)[k]
                      for x, nm in ((a, "a"), (b, "b"), (c, "c")))
        nt = (rnt, pnt)[k]
        mc.Gemm(ma, mb, nt.PMatrixMemoryPool(ma), alpha=2.0, beta=0.5)
        md = nt.Matrix_ps(15)
        md.Gemm(ma, ma, threshold=0.3)
        out[tag] = (mc, md)
    same_slots(out["r"][0], out["p"][0])
    agree(out["r"][0], out["p"][0], 2.0 * a @ b + 0.5 * c, tol=1e-13)
    same_slots(out["r"][1], out["p"][1])
    got = dense(out["p"][1])
    kept = got != 0
    assert np.all(np.abs((a @ a)[~kept]) <= 0.3 + 1e-12)


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_dot_scale_norm_trace(tmp_path, rng, is_complex):
    a, b = (random_matrix(rng, 15, is_complex=is_complex)
            for _ in range(2))
    vals = {}
    for k, tag in enumerate("rp"):
        ma, mb = read(tmp_path, a, "a")[k], read(tmp_path, b, "b")[k]
        dot = ma.Dot_c(mb) if is_complex else ma.Dot(mb)
        ma.Scale(3.0)
        vals[tag] = (dot, ma.Dot(mb), ma.Norm(), ma.Trace())
    want = (np.sum(np.conj(a) * b), 3.0 * np.sum(np.conj(a) * b).real,
            np.abs(3 * a).sum(0).max(), np.trace(3 * a).real)
    for g, r, w in zip(vals["p"], vals["r"], want):
        assert abs(g - r) <= VALUES * abs(w) and abs(g - w) <= 1e-12


def test_diagonal_scale(tmp_path, rng):
    a = random_matrix(rng, 11)
    d = rng.random(11)
    out = {}
    for k, nt in enumerate((rnt, pnt)):
        ma = read(tmp_path, a, "a")[k]
        tl = nt.TripletList_r(0)
        for i, v in enumerate(d):
            tl.Append(nt.Triplet_r(i + 1, i + 1, v))
        ma.DiagonalScale(tl)
        out[k] = ma
    same_slots(out[0], out[1])
    agree(out[0], out[1], a * d[None, :], tol=1e-14)


def test_load_balancer(tmp_path, rng):
    a = random_matrix(rng, 15)
    out = {}
    for k, nt in enumerate((rnt, pnt)):
        ma = read(tmp_path, a, "a")[k]
        perm = nt.Permutation(ma.GetLogicalDimension())
        perm.SetReversePermutation()
        mid, back = nt.Matrix_ps(15), nt.Matrix_ps(15)
        nt.LoadBalancer.PermuteMatrix(ma, mid, perm)
        nt.LoadBalancer.UndoPermuteMatrix(mid, back, perm)
        out[k] = (mid, back)
    agree(out[0][0], out[1][0])
    agree(out[0][1], out[1][1], a, tol=1e-14)


# ----------------------------------------------------------------------------
# solvers (tests/test_solvers.py, test_chemistry.py)
# ----------------------------------------------------------------------------

def create_matrix(rng, SPD=False, scaled=False, diag_dom=False, rank=None,
                  add_gap=False, dim=DIM):
    m = rng.random((dim, dim))
    m = m + m.T
    if SPD:
        m = m.T @ m
    if diag_dom:
        m = m + dim * np.eye(dim)
    if scaled:
        m = m / dim
    if rank:
        m = m[rank:].T @ m[rank:]
    if add_gap:
        w, v = np.linalg.eigh(m)
        w[dim // 2:] += (w[-1] - w[0]) / 2.0
        m = v @ np.diag(w) @ v.T
    return m


def params(nt):
    p = nt.SolverParameters()
    p.SetConvergeDiff(1e-8)
    p.SetMonitorConvergence(False)
    return p


def fpow(m, x):
    return np.real(sla.fractional_matrix_power(m, x))


# name -> (matrix, call(nt, A, Out, params), oracle, parity)
def _solvers():
    spd = dict(SPD=True, diag_dom=True)
    return {
        "invert": (spd, lambda nt, a, o, p: nt.InverseSolvers.Invert(
            a, o, p), np.linalg.inv, True),
        "dense_invert": (spd, lambda nt, a, o, p:
                         nt.InverseSolvers.DenseInvert(a, o, p),
                         np.linalg.inv, True),
        "sqrt": (spd, lambda nt, a, o, p: nt.SquareRootSolvers.SquareRoot(
            a, o, p, 2), lambda m: fpow(m, 0.5), True),
        "isqrt": (spd, lambda nt, a, o, p:
                  nt.SquareRootSolvers.InverseSquareRoot(a, o, p, 5),
                  lambda m: fpow(m, -0.5), True),
        "dense_isqrt": (spd, lambda nt, a, o, p:
                        nt.SquareRootSolvers.DenseInverseSquareRoot(
                            a, o, p), lambda m: fpow(m, -0.5), True),
        "root3": (dict(diag_dom=True), lambda nt, a, o, p:
                  nt.RootSolvers.ComputeRoot(a, o, 3, p),
                  lambda m: fpow(m, 1.0 / 3), True),
        "inverse_root2": (dict(diag_dom=True), lambda nt, a, o, p:
                          nt.RootSolvers.ComputeInverseRoot(a, o, 2, p),
                          lambda m: fpow(m, -0.5), True),
        "sign": ({}, lambda nt, a, o, p: nt.SignSolvers.ComputeSign(
            a, o, p), lambda m: np.real(sla.signm(m)), True),
        "dense_sign": ({}, lambda nt, a, o, p:
                       nt.SignSolvers.ComputeDenseSign(a, o, p),
                       lambda m: np.real(sla.signm(m)), True),
        "exp": (dict(scaled=True), lambda nt, a, o, p:
                nt.ExponentialSolvers.ComputeExponential(a, o, p),
                sla.expm, True),
        "exp_pade": (dict(scaled=True), lambda nt, a, o, p:
                     nt.ExponentialSolvers.ComputeExponentialPade(a, o, p),
                     sla.expm, True),
        "log": (dict(SPD=True, diag_dom=True, scaled=True),
                lambda nt, a, o, p: nt.ExponentialSolvers.ComputeLogarithm(
                    a, o, p), lambda m: np.real(sla.logm(m)), True),
        "sin": ({}, lambda nt, a, o, p: nt.TrigonometrySolvers.Sine(
            a, o, p), lambda m: np.real(sla.sinm(m)), True),
        "cos": ({}, lambda nt, a, o, p: nt.TrigonometrySolvers.Cosine(
            a, o, p), lambda m: np.real(sla.cosm(m)), True),
        "dense_sin": ({}, lambda nt, a, o, p:
                      nt.TrigonometrySolvers.DenseSine(a, o, p),
                      lambda m: np.real(sla.sinm(m)), True),
        "cholesky": (spd, lambda nt, a, o, p:
                     nt.LinearSolvers.CholeskyDecomposition(a, o, p),
                     np.linalg.cholesky, True),
        "eigenvalues": ({}, lambda nt, a, o, p: nt.EigenSolvers.EigenValues(
            a, o, a.GetActualDimension(), p),
            lambda m: np.diag(np.linalg.eigvalsh(m)), True),
    }


SOLVERS = _solvers()


def _solve(tmp_path, rng, name, dim):
    kind, call, oracle, parity = SOLVERS[name]
    m = create_matrix(rng, dim=dim, **kind)
    if name == "log":
        m = m + np.eye(dim)
    r, p = read(tmp_path, m)
    out = {}
    for k, nt, a in ((0, rnt, r), (1, pnt, p)):
        out[k] = nt.Matrix_ps(dim)
        call(nt, a, out[k], params(nt))
    agree(out[0], out[1], oracle(m), parity=parity)
    return out


@pytest.mark.parametrize("name", list(SOLVERS))
def test_solver_dim23(tmp_path, rng, name):
    """bs 4: both packages take the same XLA tiers, so the results are
    the same slot for slot."""
    out = _solve(tmp_path, rng, name, DIM)
    same_slots(out[0], out[1])


@pytest.mark.parametrize("name", ["invert", "isqrt", "sign", "exp",
                                  "root3"])
def test_solver_dim64_kernels(tmp_path, rng, name):
    """bs 8: the port's band and general kernels (plain versions here)
    against the reference's XLA tiers."""
    _solve(tmp_path, rng, name, 64)


# kind -> (class, method)
POLYNOMIALS = {"horner": ("Polynomial", "HornerCompute"),
               "paterson": ("Polynomial", "PatersonStockmeyerCompute"),
               "chebyshev": ("ChebyshevPolynomial", "Compute"),
               "factorized": ("ChebyshevPolynomial", "ComputeFactorized"),
               "hermite": ("HermitePolynomial", "Compute")}


@pytest.mark.parametrize("kind", list(POLYNOMIALS))
def test_polynomials(tmp_path, rng, kind):
    from numpy.polynomial import chebyshev, hermite, polynomial
    m = create_matrix(rng, scaled=True)
    if kind in ("chebyshev", "factorized"):
        m = m / np.abs(np.linalg.eigvalsh(m)).max() * 0.9
    coef = [1.0, -0.5, 0.25, -0.125, 0.0625, 0.03, 0.015, 0.0075]
    val = {"horner": polynomial.polyval, "paterson": polynomial.polyval,
           "chebyshev": chebyshev.chebval,
           "factorized": chebyshev.chebval,
           "hermite": hermite.hermval}[kind]
    w, v = np.linalg.eigh(m)
    oracle = v @ np.diag(val(w, coef)) @ v.T
    r, p = read(tmp_path, m)
    out = {}
    cls, method = POLYNOMIALS[kind]
    for k, nt, a in ((0, rnt, r), (1, pnt, p)):
        poly = getattr(nt, cls)(len(coef))
        for i, c in enumerate(coef):
            poly.SetCoefficient(i, c)
        out[k] = nt.Matrix_ps(DIM)
        getattr(poly, method)(a, out[k], params(nt))
    agree(out[0], out[1], oracle)


def test_cg_and_bounds(tmp_path, rng):
    amat = create_matrix(rng, SPD=True, diag_dom=True)
    bmat = create_matrix(rng)
    outs, bounds = {}, {}
    for k, nt in enumerate((rnt, pnt)):
        a, b = read(tmp_path, amat, "a")[k], read(tmp_path, bmat, "b")[k]
        outs[k] = nt.Matrix_ps(DIM)
        nt.LinearSolvers.CGSolver(a, outs[k], b, params(nt))
        bounds[k] = (nt.EigenBounds.PowerBounds(b, params(nt)),
                     nt.EigenBounds.GershgorinBounds(b))
    agree(outs[0], outs[1], np.linalg.solve(amat, bmat))
    w = np.linalg.eigvalsh(bmat)
    assert abs(bounds[1][0] - bounds[0][0]) <= VALUES * abs(w).max()
    assert abs(bounds[1][0] - np.abs(w).max()) <= THRESHOLD * abs(w).max()
    assert np.allclose(bounds[1][1], [float(x) for x in bounds[0][1]],
                       rtol=VALUES, atol=0)


def test_eigen_decomposition_svd(tmp_path, rng):
    m = create_matrix(rng)
    r, p = read(tmp_path, m)
    out = {}
    for k, nt, a in ((0, rnt, r), (1, pnt, p)):
        vals, vecs = nt.Matrix_ps(DIM), nt.Matrix_ps(DIM)
        nt.EigenSolvers.EigenDecomposition(a, vals, 5, vecs, params(nt))
        left, right, sv = (nt.Matrix_ps(DIM) for _ in range(3))
        nt.EigenSolvers.SingularValueDecomposition(a, left, right, sv,
                                                   params(nt))
        out[k] = (vals, vecs, left, right, sv)
    w = np.linalg.eigvalsh(m)
    ref = np.zeros((DIM, DIM))
    ref[:5, :5] = np.diag(w[:5])
    agree(out[0][0], out[1][0], ref)
    ld, rd, sd = (dense(x) for x in out[1][2:])
    assert rel(ld @ sd @ rd.T, m) <= THRESHOLD
    agree(out[0][4], out[1][4], np.diag(sorted(np.abs(w))))


def test_pivoted_cholesky_reduce_dimension(tmp_path, rng):
    m = create_matrix(rng, rank=DIM - 5)
    g = create_matrix(rng, add_gap=True)
    out = {}
    for k, nt in enumerate((rnt, pnt)):
        a, h = read(tmp_path, m, "m")[k], read(tmp_path, g, "g")[k]
        ell, red = nt.Matrix_ps(DIM), nt.Matrix_ps(DIM)
        nt.Analysis.PivotedCholeskyDecomposition(a, ell, 5, params(nt))
        nt.Analysis.ReduceDimension(h, DIM // 2, red, params(nt))
        out[k] = (ell, red)
    ld = dense(out[1][0])
    agree(out[0][0], out[1][0])
    assert rel(ld @ ld.T, m) <= THRESHOLD
    rd = dense(out[1][1])[:DIM // 2, :DIM // 2]
    assert rel(np.sort(np.linalg.eigvalsh(rd)),
               np.linalg.eigvalsh(g)[:DIM // 2]) <= 1e-2


class System:
    """A fake molecule (tests/test_chemistry.py): gapped Hermitian H and
    an SPD overlap S, with the scipy oracle."""

    def __init__(self, rng, is_complex=False, dim=16, nel=5):
        h = rng.random((dim, dim))
        if is_complex:
            h = h + 1j * rng.random((dim, dim))
        h = 0.5 * (h + h.conj().T)
        w, v = np.linalg.eigh(h)
        w[nel:] += (w[-1] - w[0])
        self.h = (v * w) @ v.conj().T
        s = rng.random((dim, dim))
        if is_complex:
            s = s + 1j * rng.random((dim, dim))
        self.s = 0.1 * (s @ s.conj().T) + np.eye(dim)
        self.isq = np.asarray(sla.funm(self.s, lambda x: 1 / np.sqrt(x)))
        ww, vv = np.linalg.eigh(self.isq @ self.h @ self.isq)
        occ = vv[:, :nel]
        self.density = self.isq @ (occ @ occ.conj().T) @ self.isq
        self.energy = float(ww[:nel].sum())
        self.homo, self.lumo = ww[nel - 1], ww[nel]
        self.nel = nel


def chem_params(nt):
    sp = nt.SolverParameters()
    sp.SetConvergeDiff(1e-10)
    return sp


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
@pytest.mark.parametrize("method", ["PM", "TRS2", "TRS4", "HPCP"])
def test_purification(tmp_path, rng, method, is_complex):
    """Values and energies against the JAX package (native complex on
    its side) and the oracle; mu inside the gap.  TRS4's last steps hang
    on rounding (ROADMAP Queue C), so its density is held to the oracle
    on each side."""
    sys_ = System(rng, is_complex)
    out = {}
    for k, nt in enumerate((rnt, pnt)):
        h, s = read(tmp_path, sys_.h, "h")[k], read(tmp_path, sys_.s, "s")[k]
        isq, d = nt.Matrix_ps(16), nt.Matrix_ps(16)
        nt.SquareRootSolvers.InverseSquareRoot(s, isq, chem_params(nt))
        e, mu = getattr(nt.DensityMatrixSolvers, method)(
            h, isq, sys_.nel, d, chem_params(nt))
        out[k] = (d, e, mu, isq)
    agree(out[0][3], out[1][3], sys_.isq)
    agree(out[0][0], out[1][0], sys_.density, parity=method != "TRS4")
    for k in (0, 1):
        assert abs(out[k][1] - sys_.energy) <= THRESHOLD
        assert sys_.homo < out[k][2] < sys_.lumo
    if method != "TRS4":
        assert abs(out[0][1] - out[1][1]) <= VALUES * abs(sys_.energy)


def test_chemistry_extras(tmp_path, rng):
    """Scale-and-fold, the dense density, McWeeny, the energy-density
    matrix and the two extrapolations."""
    sys_ = System(rng)
    out = {}
    for k, nt in enumerate((rnt, pnt)):
        h, s = read(tmp_path, sys_.h, "h")[k], read(tmp_path, sys_.s, "s")[k]
        isq = nt.Matrix_ps(16)
        nt.SquareRootSolvers.InverseSquareRoot(s, isq, chem_params(nt))
        d1, d2 = nt.Matrix_ps(16), nt.Matrix_ps(16)
        e1 = nt.DensityMatrixSolvers.ScaleAndFold(
            h, isq, sys_.nel, d1, sys_.homo, sys_.lumo, chem_params(nt))
        e2, _ = nt.DensityMatrixSolvers.DenseDensity(h, isq, sys_.nel, d2,
                                                     chem_params(nt))
        mc, edm = nt.Matrix_ps(16), nt.Matrix_ps(16)
        nt.DensityMatrixSolvers.McWeenyStep(d2, s, mc)
        nt.DensityMatrixSolvers.EnergyDensityMatrix(h, d2, edm)
        pe, le = nt.Matrix_ps(16), nt.Matrix_ps(16)
        nt.GeometryOptimization.PurificationExtrapolate(
            d2, s, sys_.nel, pe, chem_params(nt))
        nt.GeometryOptimization.LowdinExtrapolate(d2, s, s, le,
                                                  chem_params(nt))
        out[k] = (d1, d2, mc, edm, pe, le, e1, e2)
    dd = sys_.density
    oracles = (dd, dd, dd, dd @ sys_.h @ dd, dd, dd)
    for x, y, o in zip(out[0][:6], out[1][:6], oracles):
        agree(x, y, o)
    for k in (0, 1):
        assert abs(out[k][6] - sys_.energy) <= THRESHOLD
        assert abs(out[k][7] - sys_.energy) <= THRESHOLD


# ----------------------------------------------------------------------------
# complex solvers (tests/test_cplx.py)
# ----------------------------------------------------------------------------

def hermitian(rng, dim=16, spd=False):
    a = rng.random((dim, dim)) + 1j * rng.random((dim, dim))
    a = 0.5 * (a + a.conj().T)
    if spd:
        a = a @ a.conj().T + dim * np.eye(dim)
    return a


@pytest.mark.parametrize("what", ["isq", "sign", "exp"])
def test_complex_solvers(tmp_path, rng, what):
    m = hermitian(rng, spd=what == "isq")
    if what == "exp":
        m = m / 16
    oracle = {"isq": lambda x: sla.fractional_matrix_power(x, -0.5),
              "sign": sla.signm, "exp": sla.expm}[what](m)
    outs = {}
    for mode in ("always", "auto"):
        rconfig.set_complex_embedding(mode)
        for k, nt in enumerate((rnt, pnt)):
            if k == 1 and mode == "auto":
                continue
            a = read(tmp_path, m)[k]
            o = nt.Matrix_ps(16)
            call = {"isq": nt.SquareRootSolvers.InverseSquareRoot,
                    "sign": nt.SignSolvers.ComputeSign,
                    "exp": nt.ExponentialSolvers.ComputeExponential}[what]
            call(a, o, params(nt))
            outs[(k, mode)] = o
    same_slots(outs[(0, "always")], outs[(1, "always")])
    agree(outs[(0, "auto")], outs[(1, "always")], oracle)


def test_complex_eigen_svd_reduce(tmp_path, rng, embed_always):
    """The paths that do not commute with the embedding: the port
    decomposes the extracted complex matrix with torch, the JAX package
    with numpy."""
    m = hermitian(rng)
    r, p = read(tmp_path, m)
    out = {}
    for k, nt, a in ((0, rnt, r), (1, pnt, p)):
        w = nt.Matrix_ps(16)
        nt.EigenSolvers.EigenValues(a, w)
        left, right, sv = (nt.Matrix_ps(16) for _ in range(3))
        nt.EigenSolvers.SingularValueDecomposition(a, left, right, sv)
        red = nt.Matrix_ps(16)
        nt.Analysis.ReduceDimension(a, 6, red)
        out[k] = (w, sv, red)
    ev = np.linalg.eigvalsh(m)
    agree(out[0][0], out[1][0], np.diag(ev))
    agree(out[0][1], out[1][1], np.diag(np.sort(np.abs(ev))))
    rd = dense(out[1][2])[:6, :6]
    assert rel(np.linalg.eigvalsh(rd), ev[:6]) <= 1e-2
    agree(np.sort(np.linalg.eigvalsh(dense(out[0][2])[:6, :6])),
          np.sort(np.linalg.eigvalsh(rd)))


def test_complex_trs2_energy(tmp_path, rng, embed_always):
    sys_ = System(rng, is_complex=True)
    out = {}
    for k, nt in enumerate((rnt, pnt)):
        h, s = read(tmp_path, sys_.h, "h")[k], read(tmp_path, sys_.s, "s")[k]
        isq, d = nt.Matrix_ps(16), nt.Matrix_ps(16)
        nt.SquareRootSolvers.InverseSquareRoot(s, isq, chem_params(nt))
        e, _ = nt.DensityMatrixSolvers.TRS2(h, isq, sys_.nel, d,
                                            chem_params(nt))
        out[k] = (d, e)
    same_slots(out[0][0], out[1][0])
    assert abs(out[1][1] - out[0][1]) <= VALUES * abs(sys_.energy)
    assert abs(out[1][1] - sys_.energy) <= THRESHOLD


def test_carried_matrix(rng):
    """``port_matrix_ps`` carries a JAX Matrix_ps across slot for slot,
    embedding state included."""
    rconfig.set_complex_embedding("always")
    m = hermitian(rng, 9)
    i, j = np.nonzero(m)
    tl = rnt.TripletList_c._from_arrays(i, j, m[i, j])
    r = rnt.Matrix_ps(9)
    r.FillFromTripletList(tl)
    p = port_matrix_ps(r)
    same_slots(r, p)
    assert p._embedded and p.GetActualDimension() == 9
    assert abs(p.Trace() - np.trace(m).real) <= 1e-14
