"""Native Matrix Market parse and format (C++ through ctypes).

``mmio.cpp`` (a copy of the JAX package's) parses and formats the
coordinate lines of a Matrix Market body on every host thread.  It is
compiled with ``g++`` into ``ntpoly_tpu_torch/_build/``, named by a
hash of the source and the flags, on first use and never at import.
A failed build raises and names the compiler: the I/O path has no
silent fallback.  The numpy parser and formatter of
``io/matrix_market.py`` are its plain versions, which the tests hold
it against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "mmio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread")

# field codes -- must match mmio.cpp
FIELD_REAL, FIELD_COMPLEX, FIELD_PATTERN, FIELD_INTEGER = 0, 1, 2, 3

_lib = None


def compiler() -> str:
    """The C++ compiler: $CXX, else g++ on the PATH."""
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libntp_mmio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile mmio.cpp unless this source hash is built already."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = compiler()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        part = Path(tmp) / out.name
        cmd = [cxx, *FLAGS, str(SOURCE), "-o", str(part)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as exc:
            raise RuntimeError(f"the C++ compiler {cxx!r} could not run "
                               f"to build {SOURCE.name}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed building {SOURCE.name}:\n"
                               + proc.stdout + proc.stderr)
        os.replace(part, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.ntx_mm_count.restype = ctypes.c_int64
        lib.ntx_mm_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.ntx_mm_parse.restype = ctypes.c_int64
        lib.ntx_mm_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.ntx_mm_format.restype = ctypes.c_int64
        lib.ntx_mm_format.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _parse(body: bytes, field: int):
    lib = library()
    n = lib.ntx_mm_count(body, len(body))
    ri = np.empty(n, np.int64)
    ci = np.empty(n, np.int64)
    vre = np.empty(n, np.float64)
    vim = np.empty(n, np.float64) if field == FIELD_COMPLEX else None
    got = lib.ntx_mm_parse(body, len(body), field, _ptr(ri), _ptr(ci),
                           _ptr(vre), _ptr(vim) if vim is not None else None)
    if got != n:
        raise RuntimeError(f"mm parse mismatch: counted {n}, parsed {got}")
    return ri, ci, vre, vim


def mm_parse_body(body: bytes, field: int):
    """Parse a body whose first data line is the size line ->
    (n_rows, n_cols, rows, cols, vals), 0-based."""
    ri, ci, vre, vim = _parse(body, field)
    if len(ri) < 1:
        raise ValueError("MatrixMarket body missing size line")
    # entry 0 is the size line (parse_int applied -1; undo it)
    n_rows, n_cols = int(ri[0] + 1), int(ci[0] + 1)
    vals = vre[1:] + 1j * vim[1:] if field == FIELD_COMPLEX else vre[1:]
    return n_rows, n_cols, ri[1:], ci[1:], vals


def mm_parse_range(body: bytes, field: int):
    """Parse data lines only (no size line) -> (rows, cols, vals)."""
    ri, ci, vre, vim = _parse(body, field)
    if field == FIELD_PATTERN:
        return ri, ci, np.ones(len(ri))
    return ri, ci, (vre + 1j * vim if field == FIELD_COMPLEX else vre)


def mm_format(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> bytes:
    """0-based triplets -> 1-based coordinate lines, values as %.16g."""
    lib = library()
    n = len(rows)
    ri = np.ascontiguousarray(rows, np.int64)
    ci = np.ascontiguousarray(cols, np.int64)
    if np.iscomplexobj(vals):
        field = FIELD_COMPLEX
        vre = np.ascontiguousarray(vals.real, np.float64)
        vim = np.ascontiguousarray(vals.imag, np.float64)
        vim_p = _ptr(vim)
    else:
        field = FIELD_REAL
        vre = np.ascontiguousarray(vals, np.float64)
        vim_p = None
    size = lib.ntx_mm_format(_ptr(ri), _ptr(ci), _ptr(vre), vim_p, n, field,
                             None, 0)
    buf = ctypes.create_string_buffer(int(size))
    got = lib.ntx_mm_format(_ptr(ri), _ptr(ci), _ptr(vre), vim_p, n, field,
                            buf, size)
    if got != size:
        raise RuntimeError("mm format size mismatch")
    return buf.raw[:size]
