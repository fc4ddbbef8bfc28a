"""Build and load the CUDA kernels in ``csrc/``.

The kernels have a plain C interface and are loaded with ctypes.  The
build compiles every ``csrc/*.cu`` with its own ``nvcc`` process, all
started together, and links the objects into one shared library under
``ntpoly_tpu_torch/_build/``, named by a hash of the sources, so an
edited source rebuilds and an unchanged one is reused.  Nothing is
built at import: :func:`library` builds on first use, and a failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_REAL = ("_f32", "_f64")
# name -> (argtypes, dtype suffixes of its instances); every entry
# returns a cudaError_t as int
_SIGNATURES = {
    "ntp_spgemm_general": ((_P,) * 8 + (_I,) * 5 + (_D, _D, _P), _REAL),
    "ntp_spgemm_general_tc": ((_P,) * 10 + (_I,) * 6 + (_D, _D, _P),
                              ("",)),
    "ntp_spgemm_band": ((_P,) * 8 + (_I,) * 6 + (_D, _D, _P), _REAL),
    "ntp_spgemm_band_tc": ((_P,) * 10 + (_I,) * 7 + (_D, _D, _P), ("",)),
    "ntp_split_bf16": ((_P,) * 3 + (_L, _P), ("",)),
    "ntp_spgemm_stream": ((_P,) * 6 + (_I,) * 6 + (_D, _D, _P), _REAL),
    "ntp_spgemm_window": ((_P,) * 7 + (_I,) * 8 + (_D, _D, _P), _REAL),
    "ntp_spgemm_window_tc": ((_P,) * 9 + (_I,) * 8 + (_D, _D, _P), ("",)),
    "ntp_spgemm_uniform": ((_P,) * 6 + (_I,) * 10 + (_D, _D, _P),
                           ("_f32",)),
    "ntp_spgemm_uniform_tc": ((_P,) * 8 + (_I,) * 10 + (_D, _D, _P),
                              ("",)),
    "ntp_slot_dot": ((_P,) * 6 + (_L,) * 4 + (_I,) * 6 + (_P,), _REAL),
    "ntp_slot_trace": ((_P,) * 4 + (_L,) * 2 + (_I,) * 7 + (_P,), _REAL),
    "ntp_slot_compact": ((_P,) * 7 + (_L,) * 2 + (_I,) * 4 + (_D, _P),
                         _REAL),
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, PATH, or the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def nvcc_commands(output: Path, objdir: Path):
    """(one compile command per ``csrc/*.cu``, the link command)."""
    nvcc = nvcc_path()
    objs, compiles = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = objdir / f"{src.stem}.o"
        objs.append(str(obj))
        compiles.append([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                         "-o", str(obj), str(src)])
    return compiles, [nvcc, "-shared", "-o", str(output), *objs]


def library_path() -> Path:
    return BUILD_DIR / f"libntp_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels if this source hash is not built yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        part = Path(tmp) / out.name
        compiles, link = nvcc_commands(part, Path(tmp))
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        logs = [(cmd[-1], p.communicate()[0], p.returncode)
                for cmd, p in zip(compiles, procs)]
        failed = [f"{src}:\n{log}" for src, log, rc in logs if rc != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                failed.append("link:\n" + proc.stdout + proc.stderr)
        if failed:
            raise RuntimeError("nvcc failed building the CUDA kernels:\n"
                               + "\n".join(failed))
        os.replace(part, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, suffixes) in _SIGNATURES.items():
            for suffix in suffixes:
                fn = getattr(lib, name + suffix)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        lib.ntp_error_string.argtypes = [ctypes.c_int]
        lib.ntp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code:
        msg = library().ntp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
