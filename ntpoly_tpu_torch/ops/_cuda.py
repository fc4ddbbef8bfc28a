"""The one boundary to the CUDA kernels (``csrc/``): their build, what
they take, and their launch.

The kernels have a plain C interface and are loaded with ctypes.  The
build compiles every ``csrc/*.cu`` with its own ``nvcc`` process, all
started together, and links the objects into one shared library under
``ntpoly_tpu_torch/_build/``, named by a hash of the sources, so an
edited source rebuilds and an unchanged one is reused.  Nothing is
built at import: :func:`library` builds on first use, and a failed
build raises.  A wrapper checks its operands here (:func:`operands`,
or :func:`slot_operands` for the slot kernels) and launches through
:func:`launch`.

CPU tensors run the plain versions.  On the card the slot reductions,
the compact and the merge route by the kind of data (:func:`takes`):
their kernels where the dtype and block size are ones the kernels take,
their plain versions for complex data and other block sizes, as the two
compute the same function; an input at fault (ids not int32, operands
on two devices or of shapes that do not match) raises.  The SpGEMM
wrappers raise on every input the kernels do not take: for those shapes
the multiply's route is the algebra's method choice
(``parallel/algebra.py``'s ``_pick_method``, the plain torch tiers),
and a silent fallback to a plain version 5-150x slower would hide a
misrouted multiply.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# the real dtypes every kernel has an instance of, and the suffix of
# each instance's C entry
SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
REAL = tuple(SUFFIX)
_REAL = tuple(SUFFIX.values())
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
    "ntp_slot_add_n": ((_P,) * 15 + (_L,) * 8 + (_I,) * 8 + (_D,) * 5
                       + (_P,), _REAL),
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


def launch(entry: str, group: dict, key: str, pointers, ints,
           floats=()) -> None:
    """Launch C entry ``entry`` on the current stream with the pointers
    of the tensors ``pointers`` (None: a null pointer), then ``ints`` and
    ``floats``; raise on a CUDA error, else count one launch in
    ``group[key]``."""
    fn = getattr(library(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(*[None if x is None else x.data_ptr() for x in pointers],
              *ints, *map(float, floats), stream)
    check(code, key)
    group[key] += 1


# ----------------------------------------------------------------------------
# what the kernels take
# ----------------------------------------------------------------------------

def eligible(dtype, bs: int, dtypes=REAL) -> bool:
    """Can the kernels run this shape: a dtype of ``dtypes`` (real
    float32/float64) and bs a multiple of 8 up to 128."""
    return dtype in dtypes and bs % 8 == 0 and 0 < bs <= 128


def on_card(x: torch.Tensor) -> bool:
    """Is ``x`` where the kernels run: a CUDA tensor."""
    return x.device.type == "cuda"


def route(x: torch.Tensor, what: str) -> bool:
    """Launch the kernel ``what`` for ``x`` (True) or run its plain
    version (False: a CPU tensor); any other device raises."""
    if not on_card(x) and x.device.type != "cpu":
        raise ValueError(f"no {what} kernel for {x.device}")
    return on_card(x)


def takes(dtype, blocks: torch.Tensor) -> bool:
    """The route of the slot operations (``ops/reduce.py``,
    ``ops/compact.py``, ``ops/merge.py``): their kernels for CUDA
    ``blocks`` computed in a dtype and at a block size the kernels take
    (:func:`eligible`), their plain versions for every other input.  The
    route reads the kind of data alone; a kernel input at fault (ids not
    int32, operands on two devices, shapes that do not match) raises in
    :func:`slot_operands`."""
    return on_card(blocks) and eligible(dtype, blocks.shape[-1])


def on_vectors(*offsets: int) -> bool:
    """Do these byte offsets (a start's address, a row's step) all fall
    on 16 bytes: the kernels read blocks as 16-byte vectors."""
    return all(o % 16 == 0 for o in offsets)


def _refuse(ids: dict, blocks: dict, dtype, dtypes) -> None:
    """Raise unless the kernels take int32 ``ids`` and ``blocks`` (name ->
    tensor), all on one device, computed in ``dtype``."""
    first, x0 = next(iter(blocks.items()))
    for name, x in {**ids, **blocks}.items():
        if x.device != x0.device:
            raise ValueError(f"{name} on {x.device}, {first} on "
                             f"{x0.device}")
        if name in ids and x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if not eligible(dtype, x0.shape[-1], dtypes):
        raise TypeError(f"the kernels take matching {dtypes} operands "
                        f"with bs a multiple of 8 up to 128; got "
                        f"{[x.dtype for x in blocks.values()]}, bs "
                        f"{x0.shape[-1]}")


def operands(ids: dict, blocks: dict, dtypes=REAL) -> list:
    """What every kernel requires, or raise: ``ids`` (name -> tensor)
    int32, ``blocks`` of one dtype of ``dtypes`` with the first's bs
    :func:`eligible`, all on one device, the blocks starting on 16
    bytes.  -> the ids, then the blocks, contiguous."""
    dts = {x.dtype for x in blocks.values()}
    _refuse(ids, blocks, dts.pop() if len(dts) == 1 else None, dtypes)
    out = [x.contiguous() for x in blocks.values()]
    if not on_vectors(*(x.data_ptr() for x in out)):
        raise ValueError(f"{' and '.join(blocks)} must start on 16 bytes")
    return [x.contiguous() for x in ids.values()] + out


def slot_operands(dtype, *pairs) -> list:
    """(col ids [..., R, K], blocks [..., R, K, bs, bs]) ``pairs``
    computed in ``dtype``, checked (what :func:`operands` requires, and
    one shape of rows and one bs) and laid out by :func:`slot_rows`:
    -> [cols, blocks] of each pair in turn.  A pair at fault raises."""
    c0, b0 = pairs[0]
    bs = b0.shape[-1]
    _refuse({f"ids {i}": c for i, (c, _) in enumerate(pairs)},
            {f"blocks {i}": b for i, (_, b) in enumerate(pairs)},
            dtype, REAL)
    for c, b in pairs:
        if (tuple(b.shape) != tuple(c.shape) + (bs, bs)
                or c.shape[:-1] != c0.shape[:-1]):
            raise ValueError(f"slot operands: blocks {tuple(b.shape)} and "
                             f"col ids {tuple(c.shape)} do not match "
                             f"[..., {tuple(c0.shape[:-1])}, K, {bs}, "
                             f"{bs}]")
    return [x for c, b in pairs for x in slot_rows(c, b, dtype)]


def slot_rows(cols: torch.Tensor, blocks: torch.Tensor, dt: torch.dtype):
    """[..., R, K] slots as [rows, K] col ids and [rows, K, bs, bs] blocks
    of ``dt`` whose rows may lie any 16 bytes apart (a capacity trim's
    view): copied only where a row's slots or a block are not dense, or
    the blocks' start or row step is not :func:`on_vectors`.  The slot
    kernels read their operands so."""
    k, bs = cols.shape[-1], blocks.shape[-1]
    rows = math.prod(cols.shape[:-1])
    c = cols.reshape(rows, k)
    b = blocks.reshape(rows, k, bs, bs).to(dt)
    if k > 1 and c.stride(1) != 1:
        c = c.contiguous()
    if (b.stride(3) != 1 or b.stride(2) != bs
            or (k > 1 and b.stride(1) != bs * bs)):
        b = b.contiguous()
    step = b.stride(0) * b.element_size() if rows > 1 else 0
    if not on_vectors(b.data_ptr(), step):
        b = b.clone(memory_format=torch.contiguous_format)
    return c, b
