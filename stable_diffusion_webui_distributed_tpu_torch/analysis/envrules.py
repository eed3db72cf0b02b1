"""EV001: raw environment reads outside runtime/config.py.

Scattered ``os.environ.get(...)`` sites each grow their own parse/fallback
logic (three warn-and-default copies existed before this analyzer landed).
All env knobs go through the ``env_*`` helpers in runtime/config.py: one
warn-and-default policy, one grep-able inventory of every SDTPU_* knob, and
one place the recompile rules treat as an env taint source.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, ModuleInfo

#: The only module allowed to touch os.environ.
SANCTIONED = ("runtime/config.py",)


def _enclosing_symbol(mod: ModuleInfo, line: int) -> str:
    best = "<module>"
    best_span = None
    for qual, info in mod.funcs.items():
        node = info.node
        start = getattr(node, "lineno", 0)
        end = getattr(node, "end_lineno", start)
        if start <= line <= end:
            span = end - start
            if best_span is None or span < best_span:
                best, best_span = qual, span
    return best


def check(modules: List[ModuleInfo]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        if mod.path.endswith(SANCTIONED):
            continue
        for node in ast.walk(mod.tree):
            hit = None
            if isinstance(node, ast.Attribute):
                got = mod.dotted(node)
                if got is not None and got[1] and got[0] == "os.environ":
                    hit = "os.environ"
            elif isinstance(node, ast.Call):
                name, resolved = mod.call_name(node)
                if resolved and name == "os.getenv":
                    hit = "os.getenv"
            if hit is not None:
                line = node.lineno
                findings.append(Finding(
                    "EV001", mod.path, line, _enclosing_symbol(mod, line),
                    f"raw {hit} read; use the env_* helpers in "
                    f"runtime/config.py (warn-and-default policy lives "
                    f"there)"))
    return findings
