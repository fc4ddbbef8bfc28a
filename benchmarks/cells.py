"""Finding a cell's parts by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix.
Everything else is a file found by name under ``benchmarks/``:

  configs           the file that ``BENCHMARK.json``'s configuration
                    entry gives
  traffic/<t>.json  the mix: ``entry`` (the driver in
                    ``entries/<entry>.py``), its settings, the pool
  workloads/<c>.json  the cell's own: the check's sample, limits and
                    controls, the traced span
  metrics/<m>.py    one reader per metric, ``read(records)`` -> a
                    number or None (nothing to read); a metric named
                    ``<m>.<group>`` (one quantity split between groups
                    of cells that report different end-to-end metrics)
                    is read by ``metrics/<m>.py`` unless it has a file
                    of its own

so a later cell, mix, entry or metric is added as files and entries,
never by editing one.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # configs/<config>.json, with its 'name'
    traffic: dict          # traffic/<traffic>.json, with its 'name'
    spec: dict             # workloads/<cell>.json
    end_to_end: list       # BENCHMARK.json metrics that this cell reports
    per_layer: list
    base: Path             # the benchmark's folder


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json; KeyError if it
    has none of that name."""
    root = Path(root)
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    base = root / "benchmarks"
    config = dict(_json(root / conf["file"]), name=w["config"])
    traffic = dict(_json(base / "traffic" / f"{w['traffic']}.json"),
                   name=w["traffic"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                spec=_json(base / "workloads" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                base=base)


def _module(path: Path, label: str):
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{label}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def entry(cell: Cell):
    """The module ``entries/<entry>.py`` of the cell's traffic mix."""
    return _module(cell.base / "entries" / f"{cell.traffic['entry']}.py",
                   "entry")


def reader(cell: Cell, metric: str):
    """``read`` of ``metrics/<metric>.py``, else of the file of the
    name before its first '.'."""
    path = cell.base / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = path.with_name(f"{metric.split('.', 1)[0]}.py")
    return _module(path, "metric").read
