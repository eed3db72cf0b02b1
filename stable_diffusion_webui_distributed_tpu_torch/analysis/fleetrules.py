"""Fleet concurrency rule (FL001).

The fleet tier (``fleet/`` package) is the one place where many HTTP
handler threads, the coalesce leader, and preempted batch threads all
touch the same queue/registry structures, so its lock discipline is held
to a stricter bar than the rest of the package: in any ``fleet/`` class
that owns a threading lock, EVERY mutable container attribute
(list/dict/set/deque display or constructor) must carry a
``# guarded-by: <lockname>`` annotation — the declaration LK001/LK002
then enforce. An unannotated container in a lock-bearing fleet class is
exactly the shape of bug the gate's condition-variable dance makes
likely, and it is invisible to LK001 (which only checks attributes that
were declared).

Scope: path-scoped to ``fleet/`` modules only — elsewhere the annotation
is a convention, here it is mandatory. Classes with no lock attribute
are exempt (immutable-after-init policy tables, frozen dataclasses);
annotating a single-threaded structure would be noise.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .core import PACKAGE, Finding, ModuleInfo
from .locks import LOCK_TYPES

FLEET_PREFIX = f"{PACKAGE}/fleet/"

#: constructor names whose result is a mutable container
CONTAINER_CALLS = {"list", "dict", "set", "deque", "defaultdict",
                   "OrderedDict", "Counter"}
CONTAINER_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                   ast.SetComp)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _is_container(value: ast.AST, mod: ModuleInfo) -> bool:
    if isinstance(value, CONTAINER_NODES):
        return True
    if isinstance(value, ast.Call):
        name, _res = mod.call_name(value)
        return name.split(".")[-1] in CONTAINER_CALLS
    return False


def check(modules: List[ModuleInfo]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        if not mod.path.startswith(FLEET_PREFIX):
            continue
        for qual, cls in mod.classes.items():
            locks, guarded, containers = set(), set(), []
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and \
                        node.value is not None:
                    targets, value = [node.target], node.value
                else:
                    continue
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if isinstance(value, ast.Call):
                        name, _res = mod.call_name(value)
                        if name.split(".")[-1] in LOCK_TYPES:
                            locks.add(attr)
                            continue
                    if mod.marker(node.lineno, "guarded-by:"):
                        guarded.add(attr)
                    elif _is_container(value, mod):
                        containers.append((attr, node.lineno))
            if not locks:
                continue  # immutable-after-init class: nothing to guard
            seen = set()
            for attr, line in containers:
                if attr in guarded or attr in seen:
                    continue
                seen.add(attr)
                findings.append(Finding(
                    "FL001", mod.path, line, f"{cls.name}.{attr}",
                    f"mutable container '{attr}' in lock-bearing fleet "
                    f"class {cls.name} has no guarded-by annotation"))
    return findings
