"""Hierarchical YAML logger.

Mirrors NTPoly's LoggingModule (reference Source/Fortran/LoggingModule.F90:
14-27,43-120): solvers emit a YAML document (method, citations, parameters,
per-iteration convergence, totals) that tests re-parse; malformed output is a
test failure.  Single-process JAX drives the whole mesh, so the reference's
root-only activation pattern degenerates to a module-level singleton.
"""
from __future__ import annotations

import sys
from typing import IO, Optional

_UNSET = object()


class _Logger:
    def __init__(self):
        self.file: Optional[IO] = None
        self.indent = 0
        self._owns_file = False

    # -- lifecycle -------------------------------------------------------
    def activate(self, file_name: str | None = None, append: bool = False):
        self.deactivate()
        if file_name is None:
            self.file = sys.stdout
            self._owns_file = False
        else:
            self.file = open(file_name, "a" if append else "w")
            self._owns_file = True
        self.indent = 0

    def deactivate(self):
        if self.file is not None and self._owns_file:
            self.file.close()
        self.file = None
        self.indent = 0

    @property
    def active(self) -> bool:
        return self.file is not None

    # -- emission --------------------------------------------------------
    def _emit(self, text: str):
        if self.file is not None:
            self.file.write("  " * self.indent + text + "\n")
            self.file.flush()

    @staticmethod
    def _fmt(value) -> str:
        if isinstance(value, bool):
            return "True" if value else "False"
        if isinstance(value, float):
            return repr(float(value))
        if isinstance(value, int):
            return repr(int(value))
        s = str(value)
        return '"' + s.replace('"', r'\"') + '"'

    def enter_sub_log(self):
        self.indent += 1

    def exit_sub_log(self):
        self.indent = max(0, self.indent - 1)

    def write_header(self, key: str):
        self._emit(f"{key}:")

    def write_element(self, key: str, value=_UNSET):
        if value is _UNSET:
            self._emit(f"{key}:")
        else:
            self._emit(f"{key}: {self._fmt(value)}")

    def write_list_element(self, key: str | None = None, value=_UNSET):
        if value is _UNSET:
            self._emit(f"- {key}")
        else:
            self._emit(f"- {key}: {self._fmt(value)}")

    def write_comment(self, text: str):
        self._emit(f"# {text}")


logger = _Logger()


# Functional aliases mirroring the reference public names.
def activate_logger(file_name: str | None = None, append: bool = False):
    logger.activate(file_name, append)


def deactivate_logger():
    logger.deactivate()


class sub_log:
    """Context manager for an indented block (EnterSubLog/ExitSubLog)."""

    def __init__(self, header: str | None = None):
        self.header = header

    def __enter__(self):
        if self.header is not None:
            logger.write_header(self.header)
        logger.enter_sub_log()
        return logger

    def __exit__(self, *exc):
        logger.exit_sub_log()
        return False
