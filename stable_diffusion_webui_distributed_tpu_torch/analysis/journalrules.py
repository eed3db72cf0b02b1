"""OB003: journal event-type literals outside the registered event set.

``obs/journal.py`` owns the lifecycle event vocabulary: ``emit`` rejects
any event name not in its ``EVENTS`` frozenset, so a misspelled literal
("complete" for "completed") raises at runtime — but only on the first
request that reaches that call site with the journal enabled, which is
exactly when an operator is debugging and least wants a new crash. This
rule moves the check to lint time: every ``*.emit(<literal>, ...)``
journal call in package code must pass an event name that appears in the
registry module's ``EVENTS`` assignment.

The registered set is parsed from ``obs/journal.py``'s AST (same
no-import discipline as every other rule). When the registry module is
not among the analyzed modules — e.g. a fixture-only run — the set is
empty and every journal-emit literal is flagged, which is what the
fixture tests rely on. Call sites that compute the event name
dynamically are not flagged (the runtime check still covers them); a
deliberate out-of-band literal opts out with ``# sdtpu-lint: journal``.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .core import Finding, ModuleInfo
from .envrules import _enclosing_symbol

MARKER_PREFIX = "sdtpu-lint:"
MARKER = "journal"

#: The module that owns the event vocabulary; its own emits (and the
#: EVENTS assignment itself) are exempt.
REGISTRY_MODULE = "obs/journal.py"


def _exempt(mod: ModuleInfo, line: int) -> bool:
    payload = mod.marker(line, MARKER_PREFIX)
    return payload is not None and MARKER in payload.split()


def _registered_events(modules: List[ModuleInfo]) -> Set[str]:
    """String constants assigned to ``EVENTS`` in the registry module."""
    events: Set[str] = set()
    for mod in modules:
        if not mod.path.endswith(REGISTRY_MODULE):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not any(isinstance(t, ast.Name) and t.id == "EVENTS"
                       for t in node.targets):
                continue
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    events.add(sub.value)
    return events


def _event_arg(node: ast.Call):
    """The event-name argument node of a journal emit call, if literal."""
    arg = None
    if node.args:
        arg = node.args[0]
    for kw in node.keywords:
        if kw.arg == "event":
            arg = kw.value
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg
    return None


def check(modules: List[ModuleInfo]) -> List[Finding]:
    registered = _registered_events(modules)
    findings: List[Finding] = []
    for mod in modules:
        if mod.path.endswith(REGISTRY_MODULE):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name, _resolved = mod.call_name(node)
            if not name:
                continue
            dotted = name.lower()
            # any spelling that resolves to the journal's emit: the
            # module-level helper (journal.emit / obs_journal.emit) or
            # the singleton method (JOURNAL.emit / self._journal.emit)
            if not (dotted.endswith("journal.emit")
                    or dotted.endswith("_journal.emit")
                    or dotted == "emit" and "journal" in
                    (_resolved or "").lower()):
                continue
            arg = _event_arg(node)
            if arg is None:
                continue  # dynamic event name: runtime check covers it
            if arg.value in registered:
                continue
            line = arg.lineno
            if _exempt(mod, line):
                continue
            findings.append(Finding(
                "OB003", mod.path, line, _enclosing_symbol(mod, line),
                f"journal event literal {arg.value!r} is not in "
                "obs/journal.py EVENTS; register it there (or mark a "
                "deliberate out-of-band name with "
                "'# sdtpu-lint: journal')"))
    return findings
