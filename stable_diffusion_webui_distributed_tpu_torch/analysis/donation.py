"""Use-after-replay rule (DN001), retargeted at CUDA graphs.

The JAX rule guards donated buffers: after ``jax.jit(fn,
donate_argnums=...)`` returns, the donated array is deleted. The port's
counterpart is the output of a graph-cache replay: ``GraphCache.run``
returns its entry's output, which lives in the graphs' memory pool, and
the next replay on the same cache may write over it ("consume it before
the next call", ``runtime/graphs.py``). On the CPU every call runs
eagerly and returns a fresh tensor, which is exactly why a static rule is
needed: tier-1 cannot catch it dynamically.

The pass is a forward scan per function, same discipline as the JAX one:

- a call of a function whose capture spec returns a pool output
  (``analysis/capture.py``: ``GraphCache.run`` by its marker, and every
  wrapper that returns what such a call returned) is a *replay*; a simple
  name bound straight to its result (or to a live one: ``prev = out``)
  holds a live pool output of that cache;
- a later replay on the same cache (the same receiver expression, or any
  bare wrapper call of the function: the engine's wrappers close over one
  cache) makes the earlier outputs **dead**; the replay's own arguments
  are read before it runs, so passing the earlier output into it is fine;
- rebinding a dead name revives it;
- any later load of a dead name is DN001;
- loop bodies are scanned twice, so a replay at the bottom and a use at
  the top of a loop are caught on the second sweep.

Only simple ``Name`` bindings are tracked; an output stored into a
container or attribute is out of scope (documented under-reporting), and
an output the caller transforms (``out.float()``) is a new tensor.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from . import callgraph as callgraph_mod
from . import capture as capture_mod
from .core import Finding, FuncInfo, ModuleInfo


def _eager_nodes(node: ast.AST):
    """``node`` and its sub-nodes, not descending into a lambda or a def:
    their names are their own, and they run later, if ever."""
    stack = [node]
    while stack:
        sub = stack.pop()
        if isinstance(sub, (ast.Lambda, ast.FunctionDef,
                            ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield sub
        stack.extend(ast.iter_child_nodes(sub))


class _ReplayScan:
    def __init__(self, mod: ModuleInfo, info: FuncInfo,
                 captures: capture_mod.Captures):
        self.mod = mod
        self.info = info
        self.captures = captures
        self.live: Dict[str, str] = {}  # name -> cache identity
        self.dead: Dict[str, str] = {}  # name -> what overwrote it
        self.findings: Dict[Tuple[int, str], Finding] = {}

    def run(self) -> List[Finding]:
        self._visit(self.info.node.body)  # type: ignore[attr-defined]
        return list(self.findings.values())

    def _replay(self, call: ast.AST) -> Optional[Tuple[str, str]]:
        """``(cache identity, callee)`` of a replay call, else None."""
        if not isinstance(call, ast.Call):
            return None
        got = self.captures.spec_of_call(self.mod, self.info, call)
        if got is None or not got[1].pool:
            return None
        ident = ast.unparse(call.func.value) \
            if isinstance(call.func, ast.Attribute) else "<closure>"
        return ident, got[0].rsplit(".", 1)[-1]

    # -- statement walk ------------------------------------------------------

    def _visit(self, stmts: List[ast.stmt]) -> None:
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # separate scope
        if isinstance(st, (ast.Assign, ast.AnnAssign)):
            value = st.value
            targets = st.targets if isinstance(st, ast.Assign) \
                else [st.target]
            if value is None:
                return
            self._scan_expr(value)
            for t in targets:
                self._store(t)
            # a replay's output, or an alias of a live one
            replay = self._replay(value)
            owner = replay[0] if replay is not None \
                else self.live.get(value.id) \
                if isinstance(value, ast.Name) else None
            if owner is not None and len(targets) == 1 and \
                    isinstance(targets[0], ast.Name):
                self.live[targets[0].id] = owner
            return
        if isinstance(st, ast.AugAssign):
            self._scan_expr(st.value)
            if isinstance(st.target, ast.Name):
                self._use(st.target)  # augmented assign reads the target
                self._store(st.target)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._scan_expr(st.iter)
            self._store(st.target)
            self._visit(st.body)
            self._visit(st.body)  # second sweep: catch cross-iteration use
            self._visit(st.orelse)
            return
        if isinstance(st, ast.While):
            self._scan_expr(st.test)
            self._visit(st.body)
            self._scan_expr(st.test)
            self._visit(st.body)
            self._visit(st.orelse)
            return
        if isinstance(st, ast.If):
            self._scan_expr(st.test)
            self._visit(st.body)
            self._visit(st.orelse)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._scan_expr(item.context_expr)
                if item.optional_vars is not None:
                    self._store(item.optional_vars)
            self._visit(st.body)
            return
        if isinstance(st, ast.Try):
            self._visit(st.body)
            for h in st.handlers:
                self._visit(h.body)
            self._visit(st.orelse)
            self._visit(st.finalbody)
            return
        self._scan_expr(st)

    # -- expression scan -----------------------------------------------------

    def _scan_expr(self, node: ast.AST) -> None:
        replays: List[Tuple[str, str]] = []
        for sub in _eager_nodes(node):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                self._use(sub)
            replay = self._replay(sub)
            if replay is not None:
                replays.append(replay)
        # a replay overwrites the pool after its arguments were read
        for ident, callee in replays:
            for name, owner in list(self.live.items()):
                if owner == ident:
                    del self.live[name]
                    self.dead[name] = f"{ident}.{callee}" \
                        if ident != "<closure>" else callee

    def _use(self, node: ast.Name) -> None:
        why = self.dead.get(node.id)
        if why is None:
            return
        key = (node.lineno, node.id)
        if key in self.findings:
            return
        self.findings[key] = Finding(
            "DN001", self.mod.path, node.lineno, self.info.qualname,
            f"'{node.id}' is a graph replay's output in the graphs' pool, "
            f"and a later replay ({why}) may have overwritten it (CPU runs "
            f"won't catch it) — consume or clone it before the next call")

    def _store(self, target: ast.AST) -> None:
        for sub in ast.walk(target):
            if isinstance(sub, ast.Name):
                self.dead.pop(sub.id, None)
                self.live.pop(sub.id, None)


def check(modules: List[ModuleInfo], prog=None) -> List[Finding]:
    prog = prog if prog is not None else callgraph_mod.build(modules)
    captures = capture_mod.of(prog)
    findings: List[Finding] = []
    for mod in modules:
        for info in mod.funcs.values():
            if not isinstance(info.node,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            findings.extend(_ReplayScan(mod, info, captures).run())
    return findings
