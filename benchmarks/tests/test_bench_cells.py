"""BENCHMARK.json against the contract's shape, and finding a cell's
parts by name, including parts added later as new files."""
import json
import re
import shutil

import pytest

from benchmarks import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_shape():
    b = cells.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmarks"]
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in
                                            b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_each_cell_resolves(name):
    cell = cells.load(name)
    assert cell.chips in (1, 4)
    assert cell.config["reduced"] == []
    assert hasattr(cells.entry(cell), "Session")
    assert set(cell.spec["check"]["limits"]) == set(
        cells.entry(cell).CHECKS)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(cell, m["name"]))
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.load("no_such_cell")


NEW_METRIC = '''
def read(rec):
    return 2.0 * rec["calls"]
'''

NEW_ENTRY = '''
CHECKS = ("answer_err",)


class Session:
    pool = 1
'''


def test_new_parts_are_files_only(tmp_path):
    """A configuration, mix, cell, entry and metric added as new files
    and new BENCHMARK.json entries are found without editing a file."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.ROOT / "benchmarks", root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = cells.benchmark()
    base = root / "benchmarks"
    (base / "configs" / "tiny.json").write_text(json.dumps(
        {"rows": 8, "reduced": []}))
    (base / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"entry": "tiny_entry", "pool": 1}))
    (base / "workloads" / "tiny_cell.json").write_text(json.dumps(
        {"check": {"calls": 1, "limits": {"answer_err": 0}}}))
    (base / "entries" / "tiny_entry.py").write_text(NEW_ENTRY)
    (base / "metrics" / "calls_twice.py").write_text(NEW_METRIC)
    b["configs"].append({"name": "tiny", "source": "a paper",
                         "file": "benchmarks/configs/tiny.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny_cell", "config": "tiny",
                           "traffic": "tiny_mix", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "calls_twice", "unit": "count",
                           "better": "lower", "source": "program_counter",
                           "layer": "a test", "moves": "call_s",
                           "workloads": ["tiny_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = cells.load("tiny_cell", root)
    assert cell.config["rows"] == 8 and cell.traffic["pool"] == 1
    assert cells.entry(cell).CHECKS == ("answer_err",)
    assert [m["name"] for m in cell.per_layer] == ["calls_twice"]
    assert cells.reader(cell, "calls_twice")({"calls": 3}) == 6.0
    # a quantity split between groups of cells reads by its base name
    assert cells.reader(cell, "calls_twice.other")({"calls": 1}) == 2.0
    # the cells already there see none of it
    old = cells.load("trs4_chain_10k", root)
    assert "calls_twice" not in [m["name"] for m in old.per_layer]
