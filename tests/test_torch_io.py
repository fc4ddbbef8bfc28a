"""Port parity: Matrix Market and binary I/O (ntpoly_tpu_torch/io,
ntpoly_tpu_torch/native) against the JAX package's (ntpoly_tpu/io).

Round trips through every header the reference reads (real, complex,
symmetric, Hermitian, skew-symmetric, pattern, 1-based, duplicates
summed); files written by either package read by the other; the two
packages' writes of the same matrix byte-identical; the native parser
and formatter against their numpy plain versions; byte ranges over 1-4
ranks covering the body once; malformed files raising IOFormatError; a
missing compiler making the native build raise."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import mmwrite
from scipy.sparse import coo_matrix

import ntpoly_tpu as rnt
import ntpoly_tpu_torch as pnt
from ntpoly_tpu import config as rconfig
from ntpoly_tpu.io import binary as RBIN
from ntpoly_tpu.io import matrix_market as RMM
from ntpoly_tpu_torch import native
from ntpoly_tpu_torch.io import binary as PBIN
from ntpoly_tpu_torch.io import matrix_market as PMM
from ntpoly_tpu_torch.utils.errors import IOFormatError

from _torch_port import port_matrix_ps

ROOT = Path(__file__).resolve().parent.parent


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


def random_matrix(rng, dim=13, density=0.4, is_complex=False):
    m = rng.random((dim, dim)) * (rng.random((dim, dim)) < density)
    if is_complex:
        m = m + 1j * rng.random((dim, dim)) * (m != 0)
    return m


def dense_of(i, j, v, shape):
    out = np.zeros(shape, np.asarray(v).dtype)
    np.add.at(out, (i, j), v)
    return out


# every (field, symmetry) header that scipy writes
HEADERS = [(f, s) for f in ("real", "complex", "pattern")
           for s in ("general", "symmetric", "hermitian", "skew-symmetric")
           if not (f == "pattern" and s in ("hermitian", "skew-symmetric")
                   or f == "real" and s == "hermitian")]


@pytest.mark.parametrize("field,symmetry", HEADERS,
                         ids=["-".join(h) for h in HEADERS])
def test_read_headers_match_reference(tmp_path, rng, field, symmetry):
    """Every header, read by both packages into the same triplets."""
    m = random_matrix(rng, is_complex=field == "complex")
    if symmetry == "symmetric":
        m = m + m.T
    elif symmetry == "hermitian":
        m = m + m.conj().T
    elif symmetry == "skew-symmetric":
        m = m - m.T
    if field == "pattern":
        m = (m != 0).astype(float)
    path = str(tmp_path / "m.mtx")
    mmwrite(path, coo_matrix(m), field=field, symmetry=symmetry)
    ref = RMM.read_triplets(path)
    got = PMM.read_triplets(path)
    assert ref[3] == got[3] == 13
    for a, b in zip(ref[:3], got[:3]):
        assert np.array_equal(a, b)
    # float64 through %.16g text and the scanner: a few ulp
    assert np.abs(dense_of(*got[:3], m.shape) - m).max() <= 1e-14
    a = pnt.Matrix_ps(path)
    assert a._embedded == (field == "complex")
    out = str(tmp_path / "out.mtx")
    a.WriteToMatrixMarket(out)
    i, j, v, _ = PMM.read_triplets(out)
    assert np.abs(dense_of(i, j, v, m.shape) - m).max() <= 1e-14


def test_duplicates_and_one_based(tmp_path):
    path = tmp_path / "dup.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    "% a comment\n3 3 4\n1 1 1.5\n3 2 -2\n1 1 0.25\n"
                    "2 3 4e-3\n")
    i, j, v, dim = PMM.read_triplets(str(path))
    assert dim == 3 and list(i) == [0, 2, 0, 1] and list(j) == [0, 1, 0, 2]
    m = pnt.Matrix_ps(str(path))
    d = pnt.parallel.pmatrix.to_dense(m._m).numpy()
    assert d[0, 0] == 1.75 and d[2, 1] == -2.0 and d[1, 2] == 4e-3


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
@pytest.mark.parametrize("binary", [False, True], ids=["mtx", "bin"])
def test_files_cross_and_byte_identical(tmp_path, rng, is_complex, binary):
    """The same matrix written by both packages gives the same bytes,
    and each package reads the other's file to the same triplets."""
    rconfig.set_complex_embedding("always")
    m = random_matrix(rng, dim=21, is_complex=is_complex)
    src = str(tmp_path / "in.mtx")
    mmwrite(src, coo_matrix(m))
    rm = rnt.Matrix_ps(src)
    pm = port_matrix_ps(rm)
    suffix = "ntx" if binary else "mtx"
    rpath, ppath = (str(tmp_path / f"{w}.{suffix}") for w in "rp")
    (rm.WriteToBinary if binary else rm.WriteToMatrixMarket)(rpath)
    (pm.WriteToBinary if binary else pm.WriteToMatrixMarket)(ppath)
    assert Path(rpath).read_bytes() == Path(ppath).read_bytes()
    pread = pnt.Matrix_ps(rpath, True) if binary else pnt.Matrix_ps(rpath)
    rread = rnt.Matrix_ps(ppath, True) if binary else rnt.Matrix_ps(ppath)
    for a, b in zip(rread._triplets(), pread._triplets()):
        assert np.array_equal(a, b)
    assert np.array_equal(np.asarray(rread._m.col_ids),
                          pread._m.col_ids.numpy())
    assert np.array_equal(np.asarray(rread._m.blocks),
                          pread._m.blocks.numpy())


def test_psmatrix_writers_byte_identical(tmp_path, rng):
    """The layer below the API: ``write(PSMatrix)`` of both packages."""
    from ntpoly_tpu.parallel import pmatrix as RPM
    from ntpoly_tpu.parallel.grid import ProcessGrid as RGrid
    from ntpoly_tpu_torch.parallel import pmatrix as PPM
    from ntpoly_tpu_torch.parallel.grid import ProcessGrid
    d = random_matrix(rng, dim=37)
    rm = RPM.from_dense(d, bs=8, grid=RGrid(1, 1, 1))
    pm = PPM.from_dense(d, bs=8, grid=ProcessGrid(device="cpu"))
    for mod_r, mod_p, name in ((RMM, PMM, "a.mtx"), (RBIN, PBIN, "a.ntx")):
        mod_r.write(rm, str(tmp_path / f"r{name}"))
        mod_p.write(pm, str(tmp_path / f"p{name}"))
        assert (tmp_path / f"r{name}").read_bytes() == \
            (tmp_path / f"p{name}").read_bytes()
        back = mod_p.read(str(tmp_path / f"r{name}"), bs=8,
                          grid=ProcessGrid(device="cpu"))
        assert torch.equal(back.col_ids, pm.col_ids)
        # binary records are exact; %.16g text keeps float64 to a few ulp
        tol = 0.0 if name.endswith("ntx") else 4e-16
        assert (back.blocks - pm.blocks).abs().max() <= tol


@pytest.mark.parametrize("is_complex", [False, True], ids=["r", "c"])
def test_native_equals_plain(rng, is_complex):
    """Format: the same bytes.  Parse: the same indices, values within
    2e-15 relative of the plain version's and of the values written:
    the native scanner sums decimal digits in float64 (6 ulp from the
    correctly rounded value in this sample), and %.16g keeps 16 digits
    of a float64 (4 ulp)."""
    nnz = 5000
    r = rng.integers(0, 10**6, nnz)
    c = rng.integers(0, 10**6, nnz)
    v = rng.standard_normal(nnz) * 10.0 ** rng.integers(-12, 12, nnz)
    if is_complex:
        v = v + 1j * rng.standard_normal(nnz)
    v[:3] = [0.0, -1.0, 1e-300] if not is_complex else v[:3]
    body = native.mm_format(r, c, v)
    assert body == PMM.format_lines_plain(r, c, v)
    field = "complex" if is_complex else "real"
    ri, ci, vi = native.mm_parse_range(body, PMM._field_code(field))
    rp, cp, vp = PMM.parse_lines_plain(body, field)
    assert np.array_equal(ri, r) and np.array_equal(ri, rp)
    assert np.array_equal(ci, c) and np.array_equal(ci, cp)
    for got, want in ((vi, vp), (vp, v)):
        for part in (np.real, np.imag):
            a, b = part(got), part(want)
            assert np.all(np.abs(a - b) <= 2e-15 * np.abs(b))
    pattern = b"3 1\n% c\n2 2\n"
    assert [list(x) for x in native.mm_parse_range(pattern, 2)] == \
        [list(x) for x in PMM.parse_lines_plain(pattern, "pattern")]


@pytest.mark.parametrize("symmetry", ["general", "symmetric"])
def test_ranges_cover_the_file_once(tmp_path, rng, symmetry):
    m = random_matrix(rng, dim=40, density=0.3)
    if symmetry == "symmetric":
        m = m + m.T
    path = str(tmp_path / "m.mtx")
    mmwrite(path, coo_matrix(m), symmetry=symmetry)
    whole = PMM.read_triplets(path)
    for n_ranks in (1, 2, 3, 4):
        parts = [PMM.read_triplets_range(path, k, n_ranks)
                 for k in range(n_ranks)]
        ref = [RMM.read_triplets_range(path, k, n_ranks)
               for k in range(n_ranks)]
        for p, q in zip(parts, ref):
            for a, b in zip(p[:3], q[:3]):
                assert np.array_equal(a, b)
        got = dense_of(np.concatenate([p[0] for p in parts]),
                       np.concatenate([p[1] for p in parts]),
                       np.concatenate([p[2] for p in parts]), m.shape)
        assert np.array_equal(got, dense_of(*whole[:3], m.shape))
    rm = rnt.Matrix_ps(path)
    bpath = str(tmp_path / "m.ntx")
    rm.WriteToBinary(bpath)
    for n_ranks in (1, 3):
        recs = [PBIN.read_triplets_range(bpath, k, n_ranks)
                for k in range(n_ranks)]
        assert sum(len(r[0]) for r in recs) == \
            len(PBIN.read_triplets(bpath)[0])


MALFORMED = {
    "banner": "%%MatrixMarkt matrix coordinate real general\n2 2 1\n1 1 1\n",
    "fields": "%%MatrixMarket matrix coordinate real\n2 2 1\n1 1 1\n",
    "array": "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    "no size": "%%MatrixMarket matrix coordinate real general\n% only\n",
    "size": "%%MatrixMarket matrix coordinate real general\n2 x 1\n",
    "count": "%%MatrixMarket matrix coordinate real general\n2 2 3\n"
             "1 1 1\n2 2 2\n",
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_matrix_market(tmp_path, name):
    path = tmp_path / "bad.mtx"
    path.write_text(MALFORMED[name])
    with pytest.raises(IOFormatError):
        pnt.Matrix_ps(str(path))


def test_malformed_binary(tmp_path, rng):
    path = tmp_path / "bad.ntx"
    path.write_bytes(b"NOPE" + bytes(40))
    with pytest.raises(IOFormatError):
        pnt.Matrix_ps(str(path), True)
    good = tmp_path / "good.ntx"
    rnt.Matrix_ps(pnt_write(tmp_path, rng)).WriteToBinary(str(good))
    data = good.read_bytes()
    (tmp_path / "cut.ntx").write_bytes(data[:-5])
    with pytest.raises(IOFormatError):
        pnt.Matrix_ps(str(tmp_path / "cut.ntx"), True)


def pnt_write(tmp_path, rng):
    path = str(tmp_path / "src.mtx")
    mmwrite(path, coo_matrix(random_matrix(rng)))
    return path


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """A failed native build raises and names the compiler."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libntp_mmio_x.so")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.mm_format(np.zeros(1, np.int64), np.zeros(1, np.int64),
                         np.ones(1))
    assert not (tmp_path / "libntp_mmio_x.so").exists()


def test_native_build_command_and_nothing_at_import():
    assert native.FLAGS == ("-O3", "-march=native", "-std=c++17",
                            "-shared", "-fPIC", "-pthread")
    assert native.library_path().parent == ROOT / "ntpoly_tpu_torch" / \
        "_build"
    head = (ROOT / "ntpoly_tpu_torch" / "native" / "mmio.cpp").read_text()
    assert "ntpoly_tpu/native/mmio.cpp" in head.split("#include")[0]
    code = ("import ntpoly_tpu_torch, ntpoly_tpu_torch.native as n\n"
            "assert n._lib is None\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
