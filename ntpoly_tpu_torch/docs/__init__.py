"""The port's documentation.

  * ``guide.md``: the user guide for the card, whose ``python`` blocks
    run in order in one namespace (:func:`run_guide`);
  * ``architecture.md``: the reference component map, reference module
    to port module to design shift on Hopper;
  * ``gen_api.py``: the API-reference generator, ``python -m
    ntpoly_tpu_torch.docs.gen_api [outdir]``, and ``api/``, its output
    as committed;
  * ``source/``: a Sphinx scaffold with the API reference's grouping.

``run_guide`` runs the guide's blocks as written, with the constants of
the first block (the device, the rows, the block size, the dtype)
replaced by the caller's after that block ran: the tests run the guide
on the CPU at a small size, and ``chip_smoke.py`` (phase ``guide``) on
the card at the guide's own sizes.
"""
from __future__ import annotations

import re
from pathlib import Path

GUIDE = Path(__file__).resolve().parent / "guide.md"
_FENCE = re.compile(r"^```(\w*)\n(.*?)^```$", re.M | re.S)


def fenced_blocks() -> list[tuple[int, str]]:
    """The guide's ``python`` blocks, in order, each as (the line of its
    first code line, its code)."""
    text = GUIDE.read_text()
    return [(text.count("\n", 0, m.start(2)) + 1, m.group(2))
            for m in _FENCE.finditer(text) if m.group(1) == "python"]


def run_blocks(blocks, overrides: dict | None = None) -> dict:
    """Run ``blocks`` (``fenced_blocks`` pairs) in order in one
    namespace, the names in ``overrides`` replaced after the first
    block, which must have set each of them -> the namespace.  A
    traceback names the guide's own lines."""
    ns = {"__name__": "__guide__"}
    for i, (line, code) in enumerate(blocks):
        exec(compile("\n" * (line - 1) + code, str(GUIDE), "exec"), ns)
        if i == 0 and overrides:
            unknown = sorted(set(overrides) - set(ns))
            if unknown:
                raise KeyError(f"the guide's first block sets no {unknown}")
            ns.update(overrides)
    return ns


def run_guide(overrides: dict | None = None) -> dict:
    """Every ``python`` block of the guide (:func:`run_blocks`)."""
    return run_blocks(fenced_blocks(), overrides)
