"""Binary checkpoint format (reference PSMatrixModule.F90:572-789:
"Faster than text, so this is good for check pointing").

Counterpart of ``ntpoly_tpu/io/binary.py`` for one process, with its
layout exactly, so that either package reads the other's files: a
header {magic ``NTPX``, complex flag, rows, cols, total nnz} followed by
packed little-endian (row <i4, col <i4, value <f8 | <c16) records, in
``to_triplets``' order.  On a grid of several ranks the write is
collective, as the reference's (WriteMatrixToBinary.f90): each rank
packs the entries its tiles own (slice 0), the counts are gathered and
exclusive-summed into record offsets, rank 0 writes the header and
sizes the file, and after a barrier every rank writes its records at
its offset (a shared file system, as MPI-IO needs).  A read on such a
grid takes rank r's byte range of the records and routes them to their
owners ('distributed' fill).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import default_complex_dtype, default_real_dtype
from ..parallel import pmatrix as PM
from ..parallel.grid import global_grid
from ..utils.errors import IOFormatError

MAGIC = 0x4E545058        # "NTPX"

_HEADER_DTYPE = np.dtype([
    ("magic", "<u4"), ("is_complex", "<u4"),
    ("rows", "<i8"), ("cols", "<i8"), ("nnz", "<i8")])


def _triplet_dtype(is_complex: bool):
    vt = "<c16" if is_complex else "<f8"
    return np.dtype([("row", "<i4"), ("col", "<i4"), ("val", vt)])


def write(mat: PM.PSMatrix, file_name: str):
    """Write the checkpoint (collective on a grid of several ranks)."""
    if mat.grid.n_devices == 1:
        r, c, v = PM.to_triplets(mat)
        write_triplets(file_name, r, c, v, mat.dim)
        return
    r, c, v = PM.to_triplets(mat, local=True)
    is_complex = mat.dtype.is_complex
    dt = _triplet_dtype(is_complex)
    grp = mat.grid.group("all")
    counts = torch.cat(grp.all_gather(torch.tensor([len(v)]))).tolist()
    me = grp.index
    if me == 0:
        header = np.zeros(1, _HEADER_DTYPE)
        header["magic"], header["is_complex"] = MAGIC, is_complex
        header["rows"] = header["cols"] = mat.dim
        header["nnz"] = sum(counts)
        with open(file_name, "wb") as f:
            header.tofile(f)
            # sized first, so that every rank writes inside the file
            f.truncate(_HEADER_DTYPE.itemsize + sum(counts) * dt.itemsize)
    grp.barrier()
    recs = np.empty(len(v), dt)
    recs["row"], recs["col"], recs["val"] = r, c, v
    with open(file_name, "r+b") as f:
        f.seek(_HEADER_DTYPE.itemsize + sum(counts[:me]) * dt.itemsize)
        f.write(recs.tobytes())
    grp.barrier()


def write_triplets(file_name: str, r, c, v, dim: int):
    is_complex = bool(np.iscomplexobj(v))
    header = np.zeros(1, _HEADER_DTYPE)
    header["magic"], header["is_complex"] = MAGIC, is_complex
    header["rows"] = header["cols"] = dim
    header["nnz"] = len(v)
    recs = np.empty(len(v), _triplet_dtype(is_complex))
    recs["row"], recs["col"], recs["val"] = r, c, v
    with open(file_name, "wb") as f:
        header.tofile(f)
        recs.tofile(f)


def _read_header(f, file_name):
    hdr = np.fromfile(f, _HEADER_DTYPE, count=1)
    if len(hdr) == 0 or hdr[0]["magic"] != MAGIC:
        raise IOFormatError(f"{file_name}: not an ntpoly binary file")
    return hdr[0]


def _records(f, file_name, header, count: int):
    recs = np.fromfile(f, _triplet_dtype(bool(header["is_complex"])),
                       count=count)
    if len(recs) != count:
        raise IOFormatError(f"{file_name}: {len(recs)} records, the "
                            f"header says {count}")
    return (recs["row"].astype(np.int64), recs["col"].astype(np.int64),
            recs["val"], int(header["rows"]))


def read_triplets(file_name: str):
    """-> (rows, cols, vals, dim), 0-based."""
    with open(file_name, "rb") as f:
        header = _read_header(f, file_name)
        return _records(f, file_name, header, int(header["nnz"]))


def read_triplets_range(file_name: str, rank: int, n_ranks: int):
    """Records [nnz rank / n_ranks, nnz (rank + 1) / n_ranks): fixed-size
    records make byte ranges exact (the reference's collective binary
    read, PSMatrixModule.F90:574-693)."""
    with open(file_name, "rb") as f:
        header = _read_header(f, file_name)
        dt = _triplet_dtype(bool(header["is_complex"]))
        nnz = int(header["nnz"])
        lo = (nnz * rank) // n_ranks
        hi = (nnz * (rank + 1)) // n_ranks
        f.seek(_HEADER_DTYPE.itemsize + lo * dt.itemsize)
        return _records(f, file_name, header, hi - lo)


def read(file_name: str, *, bs: int, grid=None, k: int | None = None,
         dtype=None) -> PM.PSMatrix:
    """A checkpoint -> PSMatrix on ``grid`` (the global grid unless
    given); on several ranks each reads its byte range (collective)."""
    grid = grid or global_grid()
    mode = "replicated"
    if grid.n_devices > 1:
        g = grid.group("all")
        i, j, v, dim = read_triplets_range(file_name, g.index, g.size)
        mode = "distributed"
    else:
        i, j, v, dim = read_triplets(file_name)
    if dtype is None:
        with open(file_name, "rb") as f:
            cplx = bool(_read_header(f, file_name)["is_complex"])
        dtype = default_complex_dtype() if cplx else default_real_dtype()
    m = PM.empty(dim, bs=bs, k=k, dtype=dtype, grid=grid)
    return PM.fill_from_triplets(m, i, j, v, mode=mode)
