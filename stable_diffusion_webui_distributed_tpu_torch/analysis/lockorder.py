"""LK005: whole-program lock-order / deadlock analysis rooted at thread
entry points.

LK003 (analysis/locks.py) reports any cycle in the package's lock-
acquisition digraph. This pass is the stronger, evidence-carrying form
the concurrency tier gates on: it walks the call graph from every
**thread entry point** — functions handed to ``threading.Thread(target=
...)`` (including nested closures and ``self.method`` references),
``run`` methods of ``threading.Thread`` subclasses, tick/fire callables
handed to ``runtime/daemon.py``'s StoppableDaemon, and HTTP handler
methods (``do_GET``/``do_POST``/...; each request runs on its own
server thread) — and reports a cycle only when every conflicting
acquisition is actually reachable from some entry, **with the
acquisition path for each direction in the finding**: which entry, by
which call chain, takes lock B while holding lock A, and which entry
does the reverse. That is the evidence a reviewer needs to judge a
deadlock report without re-deriving the graph by hand.

Two findings families:

- ``potential deadlock`` — a cycle in the entry-rooted acquisition
  graph, with both (all) acquisition paths spelled out.
- ``stale lockorder annotation`` — a ``# sdtpu-lint: lockorder a<b``
  that suppresses no contradicted edge. Annotations are the escape
  hatch for static-name collapse (two instances of one class ordered by
  identity at runtime); a stale one is rot and gets flagged, the same
  anti-rot discipline as AL002.

Honest limits: entry detection resolves ``target=``/``tick=``/``fire=``
references through the same conservative machinery as the rest of the
analyzer — an entry it cannot resolve contributes nothing, so the pass
under-reports rather than guessing. Cycles among locks touched only
from unresolved entries are still caught by LK003 (unrooted, no path
evidence).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import callgraph, locks
from .core import Finding, FuncInfo, ModuleInfo

#: HTTP-handler method names: each runs on its own server thread
_HANDLER_NAMES = {"do_GET", "do_POST", "do_PUT", "do_DELETE", "do_PATCH",
                  "do_HEAD"}


def _name_target(mod: ModuleInfo, info: FuncInfo, name: str
                 ) -> Optional[str]:
    """Resolve a bare-name thread target (nested def / sibling /
    module-level function) to its in-module qualname."""
    scope = info.qualname
    while True:
        cand = f"{scope}.{name}" if scope else name
        if cand in mod.funcs:
            return cand
        if "." not in scope:
            break
        scope = scope.rsplit(".", 1)[0]
    return name if name in mod.funcs else None


def _attr_target(mod: ModuleInfo, info: FuncInfo, prog: callgraph.Program,
                 node: ast.Attribute,
                 local: Dict[str, str]) -> Optional[str]:
    """Resolve an ``obj.method`` thread target to an in-module qualname
    via the object's inferred class."""
    base_t = prog.expr_type(mod, info, node.value, local)
    if base_t is None:
        return None
    for qual, fi in mod.funcs.items():
        if fi.cls == base_t and qual.split(".")[-1] == node.attr:
            return qual
    return None


def _callable_arg(call: ast.Call, kw: str, pos: int) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    if len(call.args) > pos:
        return call.args[pos]
    return None


def entry_points(modules: List[ModuleInfo], prog: callgraph.Program
                 ) -> Dict[str, str]:
    """Dotted qualname -> human label for every thread entry point."""
    entries: Dict[str, str] = {}

    def add(mod: ModuleInfo, qual: Optional[str], label: str) -> None:
        if qual is not None and qual in mod.funcs:
            entries.setdefault(
                f"{callgraph.module_name(mod.path)}.{qual}", label)

    for mod in modules:
        # threading.Thread subclasses: run() is the entry
        for clsqual, cls in mod.classes.items():
            for base in cls.bases:
                got = mod.dotted(base)
                if got is not None and got[0].endswith("threading.Thread"):
                    add(mod, f"{clsqual}.run", f"{cls.name}.run (Thread "
                                               f"subclass)")
            for qual, fi in mod.funcs.items():
                if fi.cls == cls.name and \
                        qual.split(".")[-1] in _HANDLER_NAMES:
                    add(mod, qual, f"{qual} (HTTP handler thread)")
        for qual, info in mod.funcs.items():
            if not isinstance(info.node,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            local = prog.local_types(mod, info)
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call):
                    continue
                name, _res = mod.call_name(node)
                tail = name.split(".")[-1]
                target: Optional[ast.AST] = None
                label = ""
                if name.endswith("threading.Thread") or name == "Thread":
                    target = _callable_arg(node, "target", -1)
                    label = "Thread target"
                elif tail == "StoppableDaemon":
                    target = _callable_arg(node, "tick", 1)
                    label = "StoppableDaemon tick"
                elif tail == "one_shot":
                    target = _callable_arg(node, "fire", 2)
                    label = "StoppableDaemon one-shot"
                if target is None:
                    continue
                if isinstance(target, ast.Name):
                    add(mod, _name_target(mod, info, target.id),
                        f"{label} from {qual}")
                elif isinstance(target, ast.Attribute):
                    add(mod, _attr_target(mod, info, prog, target, local),
                        f"{label} from {qual}")
    return entries


def _reach(entries: Dict[str, str], prog: callgraph.Program
           ) -> Dict[str, Tuple[str, Optional[str]]]:
    """BFS the call graph from every entry: qualname -> (entry, parent)."""
    reach: Dict[str, Tuple[str, Optional[str]]] = {}
    frontier: List[str] = []
    for e in sorted(entries):
        if e not in reach:
            reach[e] = (e, None)
            frontier.append(e)
    while frontier:
        cur = frontier.pop(0)
        entry = reach[cur][0]
        for tgt in sorted(prog.callees(cur)):
            if tgt not in reach:
                reach[tgt] = (entry, cur)
                frontier.append(tgt)
    return reach


def _chain(reach: Dict[str, Tuple[str, Optional[str]]], qual: str
           ) -> str:
    parts = [qual]
    seen = {qual}
    while True:
        parent = reach[parts[0]][1]
        if parent is None or parent in seen:
            break
        parts.insert(0, parent)
        seen.add(parent)
    return " -> ".join(parts)


def check(modules: List[ModuleInfo],
          prog: Optional[callgraph.Program] = None,
          base: Optional[locks.LockAnalysis] = None) -> List[Finding]:
    if prog is None:
        prog = callgraph.build(modules)
    if base is None:
        base = locks.analyze(modules, prog)
    findings: List[Finding] = []

    # stale annotations: declared orders that suppressed nothing
    for a, b, path, line in base.declared:
        if (a, b) not in base.suppressed:
            findings.append(Finding(
                "LK005", path, line, "<module>",
                f"lockorder annotation '{a}<{b}' contradicts no derived "
                f"edge — stale; remove it (annotations may only suppress "
                f"a real static inversion that a test exercises)"))

    entries = entry_points(modules, prog)
    if not entries:
        return findings
    reach = _reach(entries, prog)

    # cycles where every conflicting acquisition is entry-reachable
    edges = base.edges
    seen_cycles: Set[frozenset] = set()

    def path_of(a: str, b: str) -> Optional[str]:
        src = base.edge_src.get((a, b))
        if src is None:
            return None
        path, line, _sym, qual = src
        if qual not in reach:
            return None
        entry = reach[qual][0]
        return (f"[{entries[entry]}] {_chain(reach, qual)} acquires "
                f"{b} while holding {a} at {path}:{line}")

    def report(cyc: List[str]) -> None:
        pairs = list(zip(cyc, cyc[1:]))
        paths = [path_of(a, b) for a, b in pairs]
        if any(p is None for p in paths):
            return  # some direction unreachable from entries: LK003 only
        src = base.edge_src[pairs[-1]]
        evidence = "; ".join(f"path {i + 1}: {p}"
                             for i, p in enumerate(paths))
        findings.append(Finding(
            "LK005", src[0], src[1], src[2],
            "potential deadlock: " + " -> ".join(cyc) + "; " + evidence +
            " — acquire in one global order (or, only for an order a "
            "test exercises, annotate '# sdtpu-lint: lockorder a<b')"))

    def dfs(node: str, stack: List[str], on_stack: Set[str],
            visited: Set[str]) -> None:
        visited.add(node)
        on_stack.add(node)
        stack.append(node)
        for nxt in sorted(edges.get(node, ())):
            if nxt in on_stack:
                cyc = stack[stack.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    report(cyc)
            elif nxt not in visited:
                dfs(nxt, stack, on_stack, visited)
        stack.pop()
        on_stack.discard(node)

    visited: Set[str] = set()
    for node in sorted(edges):
        if node not in visited:
            dfs(node, [], set(), visited)
    return findings
