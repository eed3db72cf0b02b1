"""OB002: ad-hoc Prometheus metric names outside the central registry.

``obs/prometheus.py`` owns the exposition format AND the metric registry:
every family name passes through ``register_metric``, which validates the
``sdtpu_*`` naming convention and catches two call sites registering the
same name with different types (the classic silently-corrupt-scrape bug).
That guarantee only holds if no other module mints a metric-name string
and renders it directly — so this rule flags any ``sdtpu_*`` string
literal in package code outside ``obs/prometheus.py``, unless it is being
handed straight to the registry helper (``register_metric(...)``), which
is the supported way to reserve a name from another module.

Non-metric identifiers that happen to share the prefix (e.g. the obs
contextvar name) opt out with ``# sdtpu-lint: metric`` on the line or the
standalone comment line above, same marker discipline as OB001/EV001.
"""

from __future__ import annotations

import ast
import re
from typing import List

from .core import Finding, ModuleInfo
from .envrules import _enclosing_symbol

#: Matches the registry's metric naming convention (obs/prometheus.py
#: _NAME_RE) — a literal shaped like this outside the registry module is
#: presumed to be a metric family name.
_NAME_RE = re.compile(r"^sdtpu_[a-z0-9_]+$")

#: The registry entry point: a matching literal passed directly to one of
#: these calls (any dotted spelling) is the sanctioned path.
ALLOWED_CALLS = ("register_metric",)

MARKER_PREFIX = "sdtpu-lint:"
MARKER = "metric"

#: The module that owns metric names; everything inside it is exempt.
REGISTRY_MODULE = "obs/prometheus.py"


def _exempt(mod: ModuleInfo, line: int) -> bool:
    payload = mod.marker(line, MARKER_PREFIX)
    return payload is not None and MARKER in payload.split()


def _allowed_arg_ids(mod: ModuleInfo) -> set:
    """ids of argument nodes passed directly to a registry helper call."""
    allowed: set = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name, _resolved = mod.call_name(node)
        if not name or name.rsplit(".", 1)[-1] not in ALLOWED_CALLS:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            allowed.add(id(arg))
    return allowed


def check(modules: List[ModuleInfo]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        if mod.path.endswith(REGISTRY_MODULE):
            continue
        allowed = _allowed_arg_ids(mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            if not _NAME_RE.match(node.value):
                continue
            if id(node) in allowed:
                continue
            line = node.lineno
            if _exempt(mod, line):
                continue
            findings.append(Finding(
                "OB002", mod.path, line, _enclosing_symbol(mod, line),
                f"metric-name literal {node.value!r} outside "
                "obs/prometheus.py; register it through "
                "register_metric() (or mark a non-metric identifier "
                "with '# sdtpu-lint: metric')"))
    return findings
