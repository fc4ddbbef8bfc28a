"""API reference generator of the port (standard library only).

Counterpart of the JAX package's ``docs/gen_api.py``: walk the public
surface of ``ntpoly_tpu_torch``, group it into the reference's page
layout (electronic solvers / generic solvers / parameters / basic
parallel / basic / maps / other -- reference
Documentation/source/*.rst), and emit markdown from the live docstrings
and signatures.  Run from the repository root:

    python -m ntpoly_tpu_torch.docs.gen_api [outdir]

(``outdir`` defaults to ``ntpoly_tpu_torch/docs/api``, where the pages
are committed).  A Sphinx scaffold with the same grouping lives in
``ntpoly_tpu_torch/docs/source/``.

Two departures from the JAX package's generator:

  * a name listed in ``PAGES`` that ``ntpoly_tpu_torch`` lacks is an
    error (``MissingNameError``), where the JAX generator leaves it out
    of its page silently;
  * an eighth page, ``kernels.md``, says what each CUDA source in
    ``csrc/`` is, from what the package itself says: the TPU kernel the
    source replaces, from the source's own header comment; the Python
    wrapper that launches it and the plain PyTorch version beside it in
    ``ops/spgemm.py``, with their docstrings; and the table of
    ``ops.spgemm.kernel_tier``.  It quotes no times.

The package imports ``torch`` and never ``jax``, so the generator runs
where JAX cannot be imported.
"""
from __future__ import annotations

import importlib
import inspect
import os
import re
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent

# the reference's page grouping (Documentation/source/*.rst), with the
# grid-size queries of the port's explicit import list in basic_parallel
PAGES = {
    "electronic_solvers": [
        "DensityMatrixSolvers", "FermiOperator", "GeometryOptimization",
    ],
    "generic_solvers": [
        "ChebyshevPolynomial", "HermitePolynomial", "Polynomial",
        "EigenSolvers", "ExponentialSolvers", "InverseSolvers",
        "LinearSolvers", "RootSolvers", "SignSolvers",
        "SquareRootSolvers", "TrigonometrySolvers", "Analysis",
    ],
    "parameters": ["SolverParameters", "Permutation", "LoadBalancer"],
    "basic_parallel": [
        "Matrix_ps", "PMatrixMemoryPool", "ProcessGrid",
        "ConstructGlobalProcessGrid", "DestructGlobalProcessGrid",
        "GetGlobalIsRoot", "GetGlobalMyRow", "GetGlobalMyColumn",
        "GetGlobalMySlice", "GetGlobalNumRows", "GetGlobalNumColumns",
        "GetGlobalNumSlices",
    ],
    "basic": [
        "Triplet_r", "Triplet_c", "TripletList_r", "TripletList_c",
        "Matrix_lsr", "Matrix_lsc", "MatrixMemoryPool_r",
        "MatrixMemoryPool_c",
    ],
    "maps": ["MatrixMapper", "RealOperation", "ComplexOperation"],
    "other": [
        "ActivateLogger", "DeactivateLogger", "EnterSubLog", "ExitSubLog",
        "WriteHeader", "WriteElement", "WriteListElement",
        "RegisterTimer", "StartTimer", "StopTimer", "PrintAllTimers",
        "PrintAllTimersDistributed", "EigenBounds", "MatrixConversion",
        "ComplexEmbedding", "NTPolyError", "GridError", "IOFormatError",
        "ConvergenceError",
    ],
}

TITLES = {
    "electronic_solvers": "Electronic Structure Solvers",
    "generic_solvers": "Generic Matrix-Function Solvers",
    "parameters": "Solver Parameters",
    "basic_parallel": "Distributed Matrices and Process Grids",
    "basic": "Local Matrices and Triplets",
    "maps": "Matrix Maps",
    "other": "Logging, Bounds, and Conversion",
}
KERNELS_TITLE = "CUDA Kernels"

# binding classes delegate to these modules; their module docstrings
# (algorithms, citations, reference file:line) are the substance the
# generated page should carry
IMPL_MODULES = {
    "DensityMatrixSolvers": "ntpoly_tpu_torch.solvers.density",
    "FermiOperator": "ntpoly_tpu_torch.solvers.fermi",
    "GeometryOptimization": "ntpoly_tpu_torch.solvers.geometry",
    "EigenSolvers": "ntpoly_tpu_torch.solvers.eigen",
    "ExponentialSolvers": "ntpoly_tpu_torch.solvers.exponential",
    "InverseSolvers": "ntpoly_tpu_torch.solvers.inverse",
    "LinearSolvers": "ntpoly_tpu_torch.solvers.linear",
    "RootSolvers": "ntpoly_tpu_torch.solvers.roots",
    "SignSolvers": "ntpoly_tpu_torch.solvers.sign",
    "SquareRootSolvers": "ntpoly_tpu_torch.solvers.squareroot",
    "TrigonometrySolvers": "ntpoly_tpu_torch.solvers.trigonometry",
    "Analysis": "ntpoly_tpu_torch.solvers.analysis",
    "ChebyshevPolynomial": "ntpoly_tpu_torch.solvers.chebyshev",
    "HermitePolynomial": "ntpoly_tpu_torch.solvers.hermite",
    "Polynomial": "ntpoly_tpu_torch.solvers.polynomial",
    "EigenBounds": "ntpoly_tpu_torch.solvers.eigenbounds",
    "MatrixMapper": "ntpoly_tpu_torch.utils.maps",
    "MatrixConversion": "ntpoly_tpu_torch.utils.maps",
    "SolverParameters": "ntpoly_tpu_torch.solvers.parameters",
    "Permutation": "ntpoly_tpu_torch.utils.permutation",
    "ProcessGrid": "ntpoly_tpu_torch.parallel.grid",
    "Matrix_ps": "ntpoly_tpu_torch.parallel.pmatrix",
    "ComplexEmbedding": "ntpoly_tpu_torch.core.cplx",
}

# a TPU kernel named in a CUDA source's header
_REPLACES = re.compile(
    r"(ntpoly_tpu/ops/spgemm_pallas\.py|profile_lowk_r5\.py):(_kernel\w*)")
# the plain version a wrapper's docstring names when it is not
# ``<wrapper>_plain``
_PLAIN_NAMED = re.compile(r"plain version\s+\(``(\w+)``\)")


class MissingNameError(LookupError):
    """A name listed in ``PAGES`` is not on ``ntpoly_tpu_torch``."""


def _doc(obj) -> str:
    return inspect.getdoc(obj) or ""


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def render_entry(name, obj) -> str:
    out = [f"## `{name}`\n"]
    doc = _doc(obj)
    if doc:
        out.append(doc + "\n")
    if name in IMPL_MODULES:
        mod = importlib.import_module(IMPL_MODULES[name])
        mdoc = _doc(mod)
        if mdoc:
            out.append(f"*Implementation: `{IMPL_MODULES[name]}`*\n")
            out.append(mdoc + "\n")
    if inspect.isclass(obj):
        members = [(n, m) for n, m in inspect.getmembers(obj)
                   if not n.startswith("_")
                   and (inspect.isfunction(m) or inspect.ismethod(m)
                        or isinstance(m, staticmethod))]
        for n, m in members:
            fn = m.__func__ if isinstance(m, staticmethod) else m
            out.append(f"### `{name}.{n}{_sig(fn)}`\n")
            d = _doc(fn)
            if d:
                out.append(d + "\n")
    elif callable(obj):
        out[0] = f"## `{name}{_sig(obj)}`\n"
    return "\n".join(out)


def _header(path: Path) -> list[str]:
    """The paragraphs of a CUDA source's header comment (the comment
    before its first ``#include``), each one string."""
    text = path.read_text().split("#include")[0]
    paras, cur = [], []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("//"):
            continue
        body = line[2:].strip()
        if body:
            cur.append(body)
        elif cur:
            paras.append(" ".join(cur))
            cur = []
    if cur:
        paras.append(" ".join(cur))
    return paras


def _wrappers(sp, source: str) -> list[tuple]:
    """(wrapper, plain version) pairs of ``ops/spgemm.py`` whose
    wrapper's docstring names ``csrc/<source>``."""
    pairs = []
    for name, fn in inspect.getmembers(sp, inspect.isfunction):
        if name.startswith("_") or fn.__module__ != sp.__name__:
            continue
        if f"``csrc/{source}``" not in _doc(fn):
            continue
        plain = getattr(sp, name + "_plain", None)
        if plain is None:
            named = _PLAIN_NAMED.search(_doc(fn))
            plain = getattr(sp, named.group(1)) if named else None
        if plain is None:
            raise MissingNameError(f"no plain version of {name}")
        pairs.append((name, fn, plain))
    return pairs


def render_kernels() -> str:
    """The eighth page: each CUDA source, what it replaces, its wrappers
    and plain versions, and the tier table."""
    import torch
    from ntpoly_tpu_torch.ops import spgemm as sp
    csrc = PACKAGE / "csrc"
    out = [f"# {KERNELS_TITLE}\n",
           "Every function of the JAX package that reaches "
           "`pl.pallas_call` has a hand-written counterpart for NVIDIA "
           "Hopper (`sm_90a`) in `ntpoly_tpu_torch/csrc/`, built by "
           "`ntpoly_tpu_torch.ops._cuda` with `nvcc` at first use (never "
           "at import).  Each is launched by a wrapper in "
           "`ntpoly_tpu_torch.ops.spgemm`, which launches it for CUDA "
           "tensors and runs its plain PyTorch version for CPU tensors; "
           "each launch adds one to `ops.spgemm.launches` under the "
           "wrapper's name.  Rendered from the sources' header comments "
           "and the wrappers' docstrings.\n"]
    for path in sorted(csrc.glob("*.cu")):
        paras = _header(path)
        replaced = list(dict.fromkeys(
            f"{f}:{k}" for f, k in _REPLACES.findall(" ".join(paras))))
        if not replaced:
            raise MissingNameError(f"{path.name} names no TPU kernel")
        out.append(f"## `csrc/{path.name}`\n")
        out.append(paras[0] + "\n")
        out.append("Replaces: " + ", ".join(f"`{r}`" for r in replaced)
                   + "\n")
        out.extend(p + "\n" for p in paras[1:] if "Replaces" in p)
        pairs = _wrappers(sp, path.name)
        if not pairs:
            raise MissingNameError(f"no wrapper launches {path.name}")
        for name, fn, plain in pairs:
            out.append(f"### `ops.spgemm.{name}{_sig(fn)}`\n")
            out.append(_doc(fn) + "\n")
            out.append(f"Plain version: `ops.spgemm.{plain.__name__}"
                       f"{_sig(plain)}`\n")
            out.append(_doc(plain) + "\n")
    for path in sorted(csrc.glob("*.cuh")):
        out.append(f"## `csrc/{path.name}` (shared)\n")
        out.append(_header(path)[0] + "\n")
    out.append("## Tiers: `ops.spgemm.kernel_tier(dtype, precision)`\n")
    out.append(_doc(sp.kernel_tier) + "\n")
    out.append("| precision | float32 | float64 |")
    out.append("|---|---|---|")
    for prec in sp.PRECISIONS:
        out.append(f"| `'{prec}'` | "
                   + " | ".join(f"`'{sp.kernel_tier(dt, prec)}'`"
                                for dt in (torch.float32, torch.float64))
                   + " |")
    out.append("")
    out.append("Launch counters (`ops.spgemm.launches`, reset with "
               "`ops.spgemm.reset_launches()`): "
               + ", ".join(f"`{k}`" for k in sp.launches) + ".\n")
    return "\n".join(out)


def generate(outdir: str) -> dict:
    """Write the seven reference pages, ``kernels.md`` and ``index.md``
    into ``outdir`` -> page -> the names it documents."""
    sys.path.insert(0, str(PACKAGE.parent))
    import ntpoly_tpu_torch as nt

    missing = [n for names in PAGES.values() for n in names
               if not hasattr(nt, n)]
    if missing:
        raise MissingNameError(f"not on ntpoly_tpu_torch: {missing}")
    os.makedirs(outdir, exist_ok=True)
    written = {}
    index = ["# ntpoly_tpu_torch API Reference\n",
             "Generated from live docstrings by "
             "`python -m ntpoly_tpu_torch.docs.gen_api` (the role of the "
             "reference's Ford/Doxygen/Sphinx pipeline, "
             "Documentation/Makefile).\n"]
    for page, names in PAGES.items():
        parts = [f"# {TITLES[page]}\n"]
        for name in names:
            parts.append(render_entry(name, getattr(nt, name)))
        with open(os.path.join(outdir, f"{page}.md"), "w") as f:
            f.write("\n".join(parts))
        written[page] = list(names)
        index.append(f"- [{TITLES[page]}]({page}.md) — "
                     + ", ".join(f"`{n}`" for n in names))
    with open(os.path.join(outdir, "kernels.md"), "w") as f:
        f.write(render_kernels())
    written["kernels"] = sorted(p.name for p in
                                (PACKAGE / "csrc").glob("*.cu"))
    index.append(f"- [{KERNELS_TITLE}](kernels.md) — "
                 + ", ".join(f"`csrc/{n}`" for n in written["kernels"]))
    with open(os.path.join(outdir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    return written


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else str(Path(__file__).resolve().parent / "api")
    pages = generate(out)
    total = sum(len(v) for v in pages.values())
    print(f"wrote {len(pages)} pages, {total} entries -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
