"""The port's documentation (ntpoly_tpu_torch/docs/), on the CPU.

Mirrors tests/test_docs.py for the port's generator
(``python -m ntpoly_tpu_torch.docs.gen_api``): it runs, documents the
namespaces the JAX package's test requires, carries the solvers'
implementation docstrings, and the tree is complete.  Then the port's
own checks: every name the generator lists is on the package and every
name of the package's explicit import list is on a page; the generator
runs with JAX unimportable; the committed pages are what it writes now;
every module path, file:line and test the pages cite resolves; the
default tier the guide states is ``SolverParameters().precision``; the
pages state no time, rate or size away from the card's name; every
``python`` block of the guide runs on the CPU at a small size; and the
guide's quick start, in float64, gives the energy, chemical potential
and written density of the JAX package running the same calls on the
same files, within 1e-8 relative (as tests/test_torch_examples.py holds
the PremadeMatrix example)."""
import ast
import importlib
import re
import subprocess
import sys
import traceback
import warnings
from pathlib import Path

import _torch_port  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import ntpoly_tpu as rnt
import ntpoly_tpu_torch as pnt
from ntpoly_tpu_torch import docs
from ntpoly_tpu_torch.docs import gen_api
from ntpoly_tpu_torch.profiling import api as papi
from ntpoly_tpu_torch.solvers.parameters import SolverParameters

ROOT = Path(__file__).resolve().parent.parent
DOCS = ROOT / "ntpoly_tpu_torch" / "docs"
# the solver namespaces tests/test_docs.py requires of the JAX docs
NAMESPACES = ("DensityMatrixSolvers", "FermiOperator", "EigenSolvers",
              "ExponentialSolvers", "InverseSolvers", "LinearSolvers",
              "SignSolvers", "SquareRootSolvers", "TrigonometrySolvers",
              "RootSolvers", "Analysis", "GeometryOptimization",
              "Matrix_ps", "SolverParameters", "ProcessGrid",
              "TripletList_r", "MatrixMapper")
PAGE_FILES = [f"{page}.md" for page in gen_api.PAGES] + ["kernels.md",
                                                         "index.md"]
TREE = ("architecture.md", "guide.md", "gen_api.py",
        "source/conf.py", "source/index.rst")
TEXTS = sorted([DOCS / "guide.md", DOCS / "architecture.md"]
               + [DOCS / "api" / p for p in PAGE_FILES])
# the eight TPU kernels (every function that reaches pl.pallas_call)
TPU_KERNELS = ("ntpoly_tpu/ops/spgemm_pallas.py:_kernel`",
               "ntpoly_tpu/ops/spgemm_pallas.py:_kernel_v2`",
               "ntpoly_tpu/ops/spgemm_pallas.py:_kernel_v3`",
               "ntpoly_tpu/ops/spgemm_pallas.py:_kernel_v4`",
               "profile_lowk_r5.py:_kernel_v6`",
               "profile_lowk_r5.py:_kernel_v7`",
               "profile_lowk_r5.py:_kernel_v9`",
               "profile_lowk_r5.py:_kernel_v10`")
# the guide on the CPU: 32 block rows of 64
SMALL = {"DEVICE": "cpu", "ROWS": 2048, "BS": 64}
TOL = 1e-8
# made at the first build, not in a checkout
BUILT = "ntpoly_tpu_torch/_build"


def explicit_imports() -> list:
    """The names of ``ntpoly_tpu_torch/__init__.py``'s explicit imports
    (every ``from .x import (...)`` but the star import), modules left
    out."""
    tree = ast.parse((ROOT / "ntpoly_tpu_torch" / "__init__.py")
                     .read_text())
    return [a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module
            for a in node.names if a.name != "*"]


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = tmp_path_factory.mktemp("api")
    proc = subprocess.run(
        [sys.executable, "-m", "ntpoly_tpu_torch.docs.gen_api", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    return proc, out


def test_gen_api_writes_every_page(generated):
    proc, out = generated
    assert proc.returncode == 0, proc.stderr
    assert (out / "index.md").exists()
    assert sorted(p.name for p in out.iterdir()) == sorted(PAGE_FILES)


@pytest.mark.parametrize("name", NAMESPACES)
def test_index_names_namespace(generated, name):
    assert f"`{name}`" in (generated[1] / "index.md").read_text(), \
        f"{name} missing from the API docs"


def test_solver_pages_carry_implementation_docstrings(generated):
    es = (generated[1] / "electronic_solvers.md").read_text()
    assert "purification" in es.lower()
    assert "DensityMatrixSolversModule" in es   # reference citation


@pytest.mark.parametrize("path", TREE)
def test_docs_tree_complete(path):
    assert (DOCS / path).exists(), path


@pytest.mark.parametrize("name", [n for names in gen_api.PAGES.values()
                                  for n in names])
def test_page_name_is_on_the_package(name):
    assert hasattr(pnt, name)


@pytest.mark.parametrize("name", explicit_imports())
def test_explicit_import_is_on_a_page(name):
    assert any(name in names for names in gen_api.PAGES.values())


def test_missing_name_is_an_error(tmp_path, monkeypatch):
    """Where the JAX generator skips a name the package lacks, the
    port's raises."""
    pages = {k: list(v) for k, v in gen_api.PAGES.items()}
    pages["other"].append("NoSuchName")
    monkeypatch.setattr(gen_api, "PAGES", pages)
    with pytest.raises(gen_api.MissingNameError, match="NoSuchName"):
        gen_api.generate(str(tmp_path))


def test_gen_api_runs_without_jax(tmp_path):
    """With ``jax`` and ``ntpoly_tpu`` unimportable the generator exits 0
    and writes every page, and neither was imported."""
    code = ("import sys\n"
            "for name in ('jax', 'ntpoly_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from ntpoly_tpu_torch.docs import gen_api\n"
            f"assert gen_api.main([{str(tmp_path)!r}]) == 0\n"
            "bad = [m for m in sys.modules if m.startswith(('jax.',\n"
            "       'ntpoly_tpu.')) or sys.modules[m] is not None\n"
            "       and m in ('jax', 'ntpoly_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(PAGE_FILES)


@pytest.mark.parametrize("page", PAGE_FILES)
def test_committed_page_is_fresh(generated, page):
    """Regenerate with ``python -m ntpoly_tpu_torch.docs.gen_api
    ntpoly_tpu_torch/docs/api`` after a docstring changes."""
    assert (DOCS / "api" / page).read_text() == \
        (generated[1] / page).read_text()


def test_kernels_page(generated):
    """Each CUDA source has its section, and the eight TPU kernels the
    sources replace are named, from the sources' own headers."""
    page = (generated[1] / "kernels.md").read_text()
    for src in sorted((ROOT / "ntpoly_tpu_torch" / "csrc").glob("*.cu")):
        assert f"## `csrc/{src.name}`" in page
    for kernel in TPU_KERNELS:
        assert f"`{kernel}" in page, kernel
    for name in ("spgemm_band", "spgemm_general", "spgemm_stream",
                 "spgemm_window", "spgemm_uniform", "split_bf16"):
        assert f"### `ops.spgemm.{name}(" in page
    assert "| `'high'` | `'high'` | `'highest'` |" in page


def _resolves(dotted: str) -> bool:
    """A dotted path under ntpoly_tpu_torch: its longest importable
    module prefix, then attributes."""
    parts = dotted.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ImportError:
            continue
        for attr in parts[cut:]:
            if not hasattr(obj, attr):
                return False
            obj = getattr(obj, attr)
        return True
    return False


@pytest.mark.parametrize("path", TEXTS, ids=lambda p: p.name)
def test_citations_resolve(path):
    """Every ``ntpoly_tpu_torch.<module>`` path, ``ntpoly_tpu_torch/...``
    file (with its ``:line``) and ``tests/...::test`` cited resolves."""
    text = path.read_text()
    bad = []
    for dotted in set(re.findall(r"\bntpoly_tpu_torch(?:\.\w+)+", text)):
        if not _resolves(dotted.rstrip(".")):
            bad.append(dotted)
    for rel, line in set(re.findall(
            r"\b(ntpoly_tpu_torch/[\w/.*]+\w)(?::(\d+))?", text)):
        if rel.startswith(BUILT):
            continue
        files = list(ROOT.glob(rel))
        if not files or (line and len(files[0].read_text().splitlines())
                         < int(line)):
            bad.append(f"{rel}:{line}")
    for rel, test in set(re.findall(r"(tests/\w+\.py)::(\w+)", text)):
        src = ROOT / rel
        if not src.exists() or f"def {test}(" not in src.read_text():
            bad.append(f"{rel}::{test}")
    assert not bad, bad


def test_guide_states_the_default_tier():
    text = (DOCS / "guide.md").read_text()
    stated = re.findall(r"The default tier is `'(\w+)'`", text)
    assert stated == [SolverParameters().precision]
    assert f"| `'{stated[0]}'` (default) |" in text


# a time, rate or memory size: a number with its unit
_MEASURE = re.compile(r"(?<![\w.])\d+(?:\.\d+)?\s?(?:ms|µs|us|s|TB/s|GB/s|"
                      r"GiB|GB|MB|TFLOP/s|W)(?![\w/])")


@pytest.mark.parametrize("path", TEXTS, ids=lambda p: p.name)
def test_measurements_stand_beside_the_card(path):
    """A paragraph that states a time, rate or memory size names the
    card it was measured on; the generated pages and the architecture
    map state none."""
    for para in re.split(r"\n\s*\n", path.read_text()):
        found = _MEASURE.findall(para.replace("H100 80GB", "H100"))
        if found:
            assert path.name == "guide.md", (path.name, found)
            assert "NVIDIA H100 80GB HBM3" in para and "700 W" in para, \
                para


def test_row_chunk_is_ignored():
    """``SolverParameters.row_chunk`` is accepted and read by nothing:
    no module of the port reads or passes it, and a solve gives the same
    bits with it set."""
    readers = [p for p in (ROOT / "ntpoly_tpu_torch").rglob("*.py")
               if re.search(r"\.row_chunk\b|row_chunk=", p.read_text())]
    assert not readers
    from ntpoly_tpu_torch.parallel import pmatrix as PM
    from ntpoly_tpu_torch.parallel.grid import ProcessGrid
    from ntpoly_tpu_torch.solvers import density
    from ntpoly_tpu_torch.systems import gapped_fn
    grid = ProcessGrid(device="cpu")
    h = PM.banded(256, 4, gapped_fn, bs=8, grid=grid, dtype=torch.float64)
    eye = PM.identity(256, bs=8, grid=grid, dtype=torch.float64)
    runs = [density.trs4(h, eye, 128, SolverParameters(
        threshold=1e-10, row_chunk=chunk)) for chunk in (None, 8)]
    assert runs[0][1:] == runs[1][1:]
    assert torch.equal(runs[0][0].blocks, runs[1][0].blocks)


# ----------------------------------------------------------------------------
# the guide's code
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def guide_run():
    """Every block of the guide at SMALL on the CPU, as written ->
    (namespace or None, the guide's line where it failed or None)."""
    ns, failed = None, None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ns = docs.run_guide(SMALL)
    except Exception as exc:           # reported by the blocks' tests
        lines = [f.lineno for f in traceback.extract_tb(exc.__traceback__)
                 if f.filename == str(docs.GUIDE)]
        failed = (lines[-1] if lines else 0, repr(exc))
    finally:
        torch.set_default_dtype(torch.float32)
        pnt.DestructGlobalProcessGrid()
    return ns, failed


def test_run_guide_refuses_unknown_overrides():
    with pytest.raises(KeyError, match="NOT_A_SIZE"):
        docs.run_guide({"NOT_A_SIZE": 1})


@pytest.mark.parametrize("block", docs.fenced_blocks(),
                         ids=lambda block: f"line{block[0]}")
def test_guide_block_runs(guide_run, block):
    failed = guide_run[1]
    assert failed is None or failed[0] > block[0] + \
        block[1].count("\n"), f"the guide failed at line {failed}"


def test_guide_tier_readings(guide_run):
    """X @ X in float32 against the float64 product: 'high' (bf16x3)
    within 2e-5 of max |C| and far nearer than 'bf16', 'default' the
    same as 'bf16', 'highest' within float32 rounding."""
    te = guide_run[0]["tier_error"]
    assert te["high"] <= 2e-5 and 100 * te["high"] < te["bf16"]
    assert te["default"] == te["bf16"]
    assert te["highest"] <= 1e-6


def test_guide_complex_exponential(guide_run):
    assert guide_run[0]["complex_error"] <= 1e-4


def test_guide_solves_agree(guide_run):
    """The energies of the guide's TRS4 solves of the gapped chain (the
    default tier, 'highest', the flagship's settings, chunked) within
    1e-4 of one another, relative."""
    ns = guide_run[0]
    energies = [ns["solved"]["high"][1], ns["solved"]["highest"][1],
                ns["e_flag"], ns["e4"]]
    assert max(energies) - min(energies) <= 1e-4 * abs(energies[1])


@pytest.fixture(scope="module")
def quick_start_pair(tmp_path_factory):
    """The guide up to its quick start in float64 at SMALL; then the
    quick start's own block run by the JAX package on the files the
    guide wrote.  Both densities are written as Matrix Market."""
    blocks = docs.fenced_blocks()
    quick = next(i for i, (_, code) in enumerate(blocks)
                 if "DensityMatrixSolvers.TRS4(hamiltonian" in code)
    out = tmp_path_factory.mktemp("quick_start")
    try:
        port = docs.run_blocks(blocks[:quick + 1],
                               {**SMALL, "DTYPE": torch.float64})
        port["kmat"].WriteToMatrixMarket(str(out / "port.mtx"))
        pnt.DestructGlobalProcessGrid()
    finally:
        torch.set_default_dtype(torch.float32)
    rnt.ConstructGlobalProcessGrid(1, 1, 1)
    try:
        ref = {"nt": rnt, "H_FILE": port["H_FILE"],
               "S_FILE": port["S_FILE"], "NEL": port["NEL"]}
        exec(blocks[quick][1], ref)
        ref["kmat"].WriteToMatrixMarket(str(out / "ref.mtx"))
    finally:
        rnt.DestructGlobalProcessGrid()
    return port, ref, out


@pytest.mark.parametrize("what", ("energy", "mu", "density"))
def test_quick_start_matches_jax(quick_start_pair, what):
    port, ref, out = quick_start_pair
    if what == "density":
        got, want = papi._read(str(out / "port.mtx")), \
            papi._read(str(out / "ref.mtx"))
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
    else:
        err = abs(port[what] - ref[what]) / abs(ref[what])
    assert err <= TOL, (what, err)
