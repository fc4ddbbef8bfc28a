"""Nothing a run loads is JAX or the JAX package, and the reference
loads nothing of the measured program either: top-level module names
compared whole (the port's name begins with the JAX package's)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmarks import harness

ROOT = Path(__file__).resolve().parents[2]
BASE = ROOT / "benchmarks"
FOREIGN = {"jax", "jaxlib", "flax", "ntpoly_tpu"}

LOAD_A_RUN = """
import json, sys
import benchmarks.run, benchmarks.harness, benchmarks.limits
from benchmarks import cells
for w in cells.benchmark()["workloads"]:
    cell = cells.load(w["name"])
    cells.entry(cell)
    for m in cell.end_to_end + cell.per_layer:
        cells.reader(cell, m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_THE_REFERENCE = """
import json, sys
import benchmarks.reference.band, benchmarks.reference.trs4
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _top_level_names(LOAD_A_RUN)
    assert "ntpoly_tpu_torch" in names
    assert not names & FOREIGN


def test_the_reference_loads_nothing_of_either_package():
    names = _top_level_names(LOAD_THE_REFERENCE)
    assert not names & (FOREIGN | {"ntpoly_tpu_torch"})


def test_no_reference_source_imports_them():
    banned = FOREIGN | {"ntpoly_tpu_torch"}
    for path in sorted((BASE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{path}: {n}"


def test_the_harness_names_a_foreign_module(monkeypatch):
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "ntpoly_tpu_torchx", sys)
    assert harness.foreign_modules() == ["jax.numpy"]
