"""Matrix Market I/O (reference Source/Fortran/MatrixMarketModule.F90 and
PSMatrixModule.F90:351-570).

Counterpart of ``ntpoly_tpu/io/matrix_market.py`` for one process: the
host parses the file with the native scanner (``native/mmio.cpp``, one
byte range per thread, the analogue of the reference's per-rank
ranges) and the matrix is built on its grid's device by
``fill_from_triplets``.  Symmetric, Hermitian and skew-symmetric
headers are expanded as the reference's SymmetrizeTripletList does
(TripletListModule.F90:509-590).  Files are written as the JAX package
writes them, byte for byte: the header ``%%MatrixMarket matrix
coordinate {real|complex} general``, the size line, then one 1-based
line per stored entry in ``to_triplets``' order with values as %.16g.

The numpy parser and formatter here are the plain versions of the
native ones; the package reads and writes through the native code.
On a grid of several ranks, reads and writes are collective, as the
reference's (PSMatrixModule.F90:351-570, WriteToMatrixMarket.f90): a
read parses rank r's byte range and routes the triplets to their
owners ('distributed' fill); a write formats each rank's owned entries
(slice 0), gathers the byte counts, and after rank 0 has written the
header and sized the file every rank writes its lines at its offset.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import native
from ..config import default_complex_dtype, default_real_dtype
from ..parallel import pmatrix as PM
from ..parallel.grid import global_grid
from ..utils.errors import IOFormatError

_FIELDS = {"pattern": native.FIELD_PATTERN, "complex": native.FIELD_COMPLEX}


def read_header(file_name: str):
    """(object, format, field, symmetry) of the banner line."""
    with open(file_name, "rb") as f:
        header = f.readline().decode(errors="replace")
    parts = header.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise IOFormatError(f"bad MatrixMarket header: {header!r}")
    _, obj, fmt, field, symmetry = (p.lower() for p in parts)
    if fmt != "coordinate":
        raise IOFormatError(
            "only coordinate MatrixMarket files are supported")
    return obj, fmt, field, symmetry


def _field_code(field: str) -> int:
    return _FIELDS.get(field, native.FIELD_REAL)


def _size_line(file_name: str, raw: bytes):
    """(rows, cols, entries) of the first line that is not a comment."""
    pos = 0
    while pos < len(raw):
        end = raw.find(b"\n", pos)
        end = len(raw) if end < 0 else end
        line = raw[pos:end].strip()
        pos = end + 1
        if line and not line.startswith(b"%"):
            try:
                rows, cols, nnz = (int(x) for x in line.split())
            except ValueError:
                raise IOFormatError(
                    f"{file_name}: bad size line {line!r}") from None
            return rows, cols, nnz
    raise IOFormatError(f"{file_name}: no size line")


def _lines(raw: bytes) -> list[bytes]:
    return [s for s in (ln.strip() for ln in raw.splitlines())
            if s and not s.startswith(b"%")]


def parse_lines_plain(body: bytes, field: str):
    """The plain version of the native parse: data lines (no size line)
    -> (rows, cols, vals) 0-based, values as float64 or complex128."""
    width = {"pattern": 2, "complex": 4}.get(field, 3)
    try:
        arr = np.array(b" ".join(_lines(body)).split(), np.float64)
        arr = arr.reshape(-1, width)
    except ValueError as exc:
        raise IOFormatError(f"malformed MatrixMarket data: {exc}") from None
    i = arr[:, 0].astype(np.int64) - 1
    j = arr[:, 1].astype(np.int64) - 1
    if field == "pattern":
        return i, j, np.ones(len(i))
    if field == "complex":
        return i, j, arr[:, 2] + 1j * arr[:, 3]
    return i, j, arr[:, 2]


def _expand(i, j, v, symmetry: str):
    """The stored triangle's mirror images appended (reference
    SymmetrizeTripletList)."""
    if symmetry not in ("symmetric", "hermitian", "skew-symmetric"):
        return i, j, v
    off = i != j
    io_, jo, vo = i[off], j[off], v[off]
    if symmetry == "hermitian":
        vo = np.conj(vo)
    elif symmetry == "skew-symmetric":
        vo = -vo
    return (np.concatenate([i, jo]), np.concatenate([j, io_]),
            np.concatenate([v, vo]))


def _read_body(file_name: str):
    """(rows, cols, vals, n_rows, n_cols) of a whole file, expanded."""
    _, _, field, symmetry = read_header(file_name)
    with open(file_name, "rb") as f:
        f.readline()                              # the banner
        raw = f.read()
    _, _, nnz = _size_line(file_name, raw)
    n_rows, n_cols, i, j, v = native.mm_parse_body(raw, _field_code(field))
    if len(v) != nnz:
        raise IOFormatError(f"{file_name}: {len(v)} entries, the size line "
                            f"says {nnz}")
    i, j, v = _expand(i, j, v, symmetry)
    return i, j, v, n_rows, n_cols


def read_triplets(file_name: str):
    """Parse a coordinate file -> (rows, cols, vals, dim), 0-based and
    symmetry-expanded; dim is the larger of the two sizes."""
    i, j, v, n_rows, n_cols = _read_body(file_name)
    return i, j, v, max(n_rows, n_cols)


def read_triplets_shape(file_name: str):
    """Like :func:`read_triplets` with the (rows, cols) shape in place
    of dim: local matrices may be rectangular."""
    i, j, v, n_rows, n_cols = _read_body(file_name)
    return i, j, v, (n_rows, n_cols)


def _body_offset_and_size(file_name: str):
    """Byte offset of the first data line, the (rows, cols) size, and
    the field and symmetry."""
    _, _, field, symmetry = read_header(file_name)
    with open(file_name, "rb") as f:
        f.readline()
        while True:
            line = f.readline()
            if not line:
                raise IOFormatError(f"{file_name}: no size line")
            s = line.strip()
            if s and not s.startswith(b"%"):
                parts = s.split()
                return (f.tell(), int(parts[0]), int(parts[1]), field,
                        symmetry)


def read_triplets_range(file_name: str, rank: int, n_ranks: int):
    """Parse only byte range ``rank`` of ``n_ranks`` of the body, each
    line by exactly one rank (the reference's MPI-IO read with its
    line-boundary fix-up, PSMatrixModule.F90:453-493) -> (rows, cols,
    vals, dim), symmetry-expanded locally."""
    body, n_rows, n_cols, field, symmetry = _body_offset_and_size(file_name)
    total = os.path.getsize(file_name)
    span = total - body
    start = body + (span * rank) // n_ranks
    end = body + (span * (rank + 1)) // n_ranks
    with open(file_name, "rb") as f:
        if start > body:
            # the partial line at the start belongs to the previous rank,
            # which reads past its end
            f.seek(start - 1)
            f.readline()
            start = f.tell()
        f.seek(start)
        raw = f.read(max(end - start, 0))
        if end < total and raw and not raw.endswith(b"\n"):
            raw += f.readline()
    body_bytes = b"\n".join(_lines(raw))
    if body_bytes:
        i, j, v = native.mm_parse_range(body_bytes, _field_code(field))
    else:
        i = j = np.zeros(0, np.int64)
        v = np.zeros(0)
    i, j, v = _expand(i, j, v, symmetry)
    return i, j, v, max(n_rows, n_cols)


def read(file_name: str, *, bs: int, grid=None, k: int | None = None,
         dtype=None) -> PM.PSMatrix:
    """A file -> PSMatrix on ``grid`` (the global grid unless given);
    on several ranks each parses its byte range (collective)."""
    grid = grid or global_grid()
    mode = "replicated"
    if grid.n_devices > 1:
        g = grid.group("all")
        i, j, v, dim = read_triplets_range(file_name, g.index, g.size)
        mode = "distributed"
    else:
        i, j, v, dim = read_triplets(file_name)
    if dtype is None:
        cplx = read_header(file_name)[2] == "complex"
        dtype = default_complex_dtype() if cplx else default_real_dtype()
    m = PM.empty(dim, bs=bs, k=k, dtype=dtype, grid=grid)
    return PM.fill_from_triplets(m, i, j, v, mode=mode)


def format_lines_plain(r, c, v) -> bytes:
    """The plain version of the native format: 1-based lines, %.16g."""
    out = []
    if np.iscomplexobj(v):
        for i, j, val in zip(r + 1, c + 1, v):
            out.append(f"{i} {j} {val.real:.16g} {val.imag:.16g}\n")
    else:
        for i, j, val in zip(r + 1, c + 1, v):
            out.append(f"{i} {j} {float(val):.16g}\n")
    return "".join(out).encode()


def write(mat: PM.PSMatrix, file_name: str):
    """Write coordinate-general Matrix Market (reference
    WriteMatrixToMatrixMarket; collective on several ranks)."""
    if mat.grid.n_devices == 1:
        r, c, v = PM.to_triplets(mat)
        write_triplets(file_name, r, c, v, mat.dim)
        return
    r, c, v = PM.to_triplets(mat, local=True)
    is_complex = mat.dtype.is_complex
    if is_complex and not np.iscomplexobj(v):
        v = v.astype(np.complex128)
    body = native.mm_format(r, c, v) if len(v) else b""
    grp = mat.grid.group("all")
    stats = torch.stack(grp.all_gather(torch.tensor([len(v), len(body)])))
    nnz, sizes = stats[:, 0].tolist(), stats[:, 1].tolist()
    field = "complex" if is_complex else "real"
    header = (f"%%MatrixMarket matrix coordinate {field} general\n"
              f"{mat.dim} {mat.dim} {sum(nnz)}\n").encode()
    me = grp.index
    if me == 0:
        with open(file_name, "wb") as f:
            f.write(header)
            # sized first, so that every rank writes inside the file
            f.truncate(len(header) + sum(sizes))
    grp.barrier()
    with open(file_name, "r+b") as f:
        f.seek(len(header) + sum(sizes[:me]))
        f.write(body)
    grp.barrier()


def write_triplets(file_name: str, r, c, v, dim: int):
    field = "complex" if np.iscomplexobj(v) else "real"
    with open(file_name, "wb") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n"
                .encode())
        f.write(f"{dim} {dim} {len(v)}\n".encode())
        f.write(native.mm_format(r, c, v))
