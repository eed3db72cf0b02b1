"""Lock-discipline rules (LK001/LK002/LK003/LK004).

Convention: a ``# guarded-by: <lockname>`` comment on a ``self.<attr> = ...``
line in ``__init__`` (or the line directly above it) declares that attribute
protected by ``self.<lockname>``. The analyzer then verifies that every
access to the attribute happens while the declaring class's lock is held
(LK001), that the named lock is a real ``threading`` lock attribute of the
class (LK002), that no two locks are ever acquired in opposite orders
anywhere in the package (LK003 — the deadlock precondition), and that no
blocking device/network/sleep call runs while any known lock is held
(LK004 — a latency cliff, and with two locks a deadlock precondition).

Unlike the original per-class lexical pass, this version reasons through
the whole-program index (``analysis/callgraph.py``):

- LK001 is **cross-object**: ``self.state.progress`` from a class whose
  ``state`` attribute is inferred to be a ``GenerationState`` is checked
  against ``GenerationState``'s guard declarations, as is ``p.progress``
  through an annotated param or typed local. Locks are named
  ``Class.attr`` program-wide; ``with self.worker._lock:`` on the right
  object satisfies the guard.
- LK003 builds its acquisition graph from the real call graph: a method
  called while a lock is held contributes every lock the callee may
  transitively acquire — across classes and modules, with attribute types
  inferred instead of hand-hinted (the old ``CLASS_HINTS`` table is gone).
- LK004 flags blocking calls (``time.sleep``, ``block_until_ready``,
  HTTP verbs on a requests session, ``urlopen``, zero-arg ``.result()``,
  thread ``.join()``) made while holding a lock — directly, or through a
  call chain whose leaf blocks. ``cond.wait()`` on the *only* lock held is
  exempt (wait releases it); waiting while holding a second lock is not.

``__init__`` of the declaring class is exempt (construction is
single-threaded), and nested ``def``s are scanned with an empty held-lock
set — they run later on other threads. Unknown types produce no finding
and no edge: the pass under-reports, never guesses.

An explicit ``# sdtpu-lint: lockorder a<b`` comment declares the true
global order between two locks the static model gets backwards (the
classic cause: two instances of one class hand off to each other, and
the runtime orders them by identity while the static names collapse to
one ``Class.attr``). The annotation removes the contradicted reverse
edge ``b -> a`` from the graph — and the runtime sanitizer enforces the
honesty of that claim both ways: an annotation whose order no test
exercises fails the LOCKSAN_ORDER session check, and a runtime
acquisition in the annotated-away direction is a divergence.

The static edge set is exported via :func:`lock_order_graph` so the
runtime lockset sanitizer (``runtime/locksan.py``) can diff observed
acquisition order against this model at test teardown; the richer
:func:`analyze` result (scans, edge provenance, declared orders) feeds
the entry-point-rooted LK005 pass (analysis/lockorder.py).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import callgraph
from .core import Finding, FuncInfo, ModuleInfo

LOCK_TYPES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

#: payload of ``# sdtpu-lint: lockorder A.x<B.y``
_ORDER_RE = re.compile(r"^\s*([\w.]+)\s*<\s*([\w.]+)\s*$")


def declared_orders(modules: List[ModuleInfo]
                    ) -> List[Tuple[str, str, str, int]]:
    """Every ``lockorder a<b`` annotation as ``(a, b, path, line)``."""
    out: List[Tuple[str, str, str, int]] = []
    for mod in modules:
        for line in sorted(mod.comments):
            text = mod.comments[line]
            if "sdtpu-lint:" not in text:
                continue
            payload = text.split("sdtpu-lint:", 1)[1].strip()
            if not payload.startswith("lockorder"):
                continue
            m = _ORDER_RE.match(payload[len("lockorder"):])
            if m is not None:
                out.append((m.group(1), m.group(2), mod.path, line))
    return out

#: HTTP verbs that block on the network when called on requests / a Session
_HTTP_VERBS = {"get", "post", "put", "delete", "head", "patch", "request"}
#: a tensor's value read back to the host: a wait for the card
_HOST_READS = {"item", "tolist", "cpu"}


class ClassLocks:
    def __init__(self, name: str, mod: ModuleInfo, node: ast.ClassDef):
        self.name = name
        self.mod = mod
        self.node = node
        self.locks: Set[str] = set()  # attr names holding threading locks
        self.guarded: Dict[str, Tuple[str, int]] = {}  # attr -> (lock, line)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _collect_classes(modules: List[ModuleInfo]) -> Dict[str, ClassLocks]:
    out: Dict[str, ClassLocks] = {}
    for mod in modules:
        for qual, cls in mod.classes.items():
            info = ClassLocks(cls.name, mod, cls)
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets = [node.target]
                else:
                    continue
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if isinstance(node.value, ast.Call):
                        name, _res = mod.call_name(node.value)
                        if name.split(".")[-1] in LOCK_TYPES:
                            info.locks.add(attr)
                    g = mod.marker(node.lineno, "guarded-by:")
                    if g:
                        info.guarded[attr] = (g.split()[0], node.lineno)
            if info.locks or info.guarded:
                # first definition wins on duplicate class names; the
                # package has none, and fixtures are analyzed in isolation
                out.setdefault(info.name, info)
    return out


# -- per-function traversal --------------------------------------------------

class _FuncScan:
    """One pass over a function body: cross-object LK001 checks, lock
    acquisitions (qualified ``Class.attr`` names), LK004 blocking sites,
    and the call facts the transitive passes need."""

    def __init__(self, mod: ModuleInfo, info: FuncInfo, qual: str,
                 prog: callgraph.Program,
                 classes: Dict[str, ClassLocks]):
        self.mod = mod
        self.info = info
        self.qual = qual  # dotted program-wide qualname
        self.prog = prog
        self.classes = classes
        self.local_types = prog.local_types(mod, info)
        self.lock_aliases: Dict[str, str] = {}  # var -> qualified lock
        self.findings: List[Finding] = []
        self.acquired: Set[str] = set()  # qualified locks this fn may take
        self.edges: Set[Tuple[str, str]] = set()
        self.all_calls: Set[str] = set()  # resolvable callees (any context)
        #: (held-locks, callee qualname, call line)
        self.calls_under: List[Tuple[frozenset, str, int]] = []
        #: (held-locks, reason, line) for direct blocking calls under a lock
        self.blocking_sites: List[Tuple[frozenset, str, int]] = []
        #: first directly-blocking call reason, from the caller's point of
        #: view (cond.wait always counts: it blocks whoever calls us)
        self.may_block: Optional[str] = None
        # depth > 0 while inside a nested def: LK001 held-tracking still
        # applies (closures read self), but acquisitions/calls/blocking
        # belong to the thread that eventually runs the closure, not to
        # this function's callers
        self._nested = 0

    # -- type/lock resolution ------------------------------------------------

    def _expr_class(self, expr: ast.AST) -> Optional[str]:
        return self.prog.expr_type(self.mod, self.info, expr,
                                   self.local_types)

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        """Qualified ``Class.attr`` lock name an expression denotes."""
        if isinstance(expr, ast.Name):
            return self.lock_aliases.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base_t = self._expr_class(expr.value)
            if base_t is not None:
                cl = self.classes.get(base_t)
                if cl is not None and expr.attr in cl.locks:
                    return f"{base_t}.{expr.attr}"
        return None

    # -- traversal -----------------------------------------------------------

    def run(self) -> None:
        self._body(getattr(self.info.node, "body", []), frozenset())

    def _body(self, stmts: List[ast.stmt], held: frozenset) -> None:
        for st in stmts:
            self._stmt(st, held)

    def _stmt(self, st: ast.stmt, held: frozenset) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later (thread target / callback): no locks
            # are held when it starts
            self._nested += 1
            self._body(st.body, frozenset())
            self._nested -= 1
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            newly = []
            for item in st.items:
                self._expr(item.context_expr, held)
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    newly.append(lock)
                    if not self._nested:
                        self.acquired.add(lock)
                    for h in held:
                        self.edges.add((h, lock))
            self._body(st.body, held | frozenset(newly))
            return
        if isinstance(st, ast.Try):
            self._body(st.body, held)
            for h in st.handlers:
                self._body(h.body, held)
            self._body(st.orelse, held)
            self._body(st.finalbody, held)
            return
        if isinstance(st, (ast.If, ast.While)):
            self._expr(st.test, held)
            self._body(st.body, held)
            self._body(st.orelse, held)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter, held)
            self._body(st.body, held)
            self._body(st.orelse, held)
            return
        # track `lk = self._lock` / `gate = self.fleet` style aliases
        if isinstance(st, ast.Assign) and len(st.targets) == 1 and \
                isinstance(st.targets[0], ast.Name):
            lock = self._lock_of(st.value)
            if lock is not None:
                self.lock_aliases[st.targets[0].id] = lock
        self._expr(st, held)

    def _expr(self, node: ast.AST, held: frozenset) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            if isinstance(sub, ast.Attribute):
                self._check_guarded(sub, held)
            if isinstance(sub, ast.Call):
                self._call(sub, held)

    def _check_guarded(self, node: ast.Attribute, held: frozenset) -> None:
        owner = self._expr_class(node.value)
        if owner is None:
            return
        cl = self.classes.get(owner)
        if cl is None or node.attr not in cl.guarded:
            return
        # construction is single-threaded: the declaring class's own
        # __init__ writes its guarded attributes without the lock
        if self.info.cls == owner and \
                self.info.node.name == "__init__":  # type: ignore[attr-defined]
            return
        lock, _ln = cl.guarded[node.attr]
        if f"{owner}.{lock}" in held:
            return
        if isinstance(node.value, ast.Name) and node.value.id == "self" \
                and self.info.cls == owner:
            msg = (f"access to '{node.attr}' (guarded-by {lock}) without "
                   f"holding self.{lock}")
        else:
            msg = (f"cross-object access to {owner}.{node.attr} "
                   f"(guarded-by {lock}) without holding {owner}.{lock} — "
                   f"use the owning class's locked accessor or take the "
                   f"lock")
        self.findings.append(Finding(
            "LK001", self.mod.path, node.lineno, self._symbol(), msg))

    def _symbol(self) -> str:
        if self.info.cls:
            return f"{self.info.cls}.{self.info.node.name}"  # type: ignore[attr-defined]
        return self.info.qualname

    def _call(self, call: ast.Call, held: frozenset) -> None:
        tgt = self.prog.resolve_call(self.mod, self.info, call,
                                     self.local_types)
        if self._nested:
            return  # runs on another thread; not attributable to callers
        if tgt is not None:
            self.all_calls.add(tgt)
            if held:
                self.calls_under.append((held, tgt, call.lineno))
        if held:
            why = self._blocking_reason(call, held)
            if why is not None:
                self.blocking_sites.append((held, why, call.lineno))
        if self.may_block is None:
            why = self._blocking_reason(call, frozenset({"<caller>"}))
            if why is not None:
                self.may_block = why

    def _blocking_reason(self, call: ast.Call,
                         held: frozenset) -> Optional[str]:
        got = self.prog.canonical(self.mod, call.func)
        name, resolved = got if got is not None else ("", False)
        tail = name.split(".")[-1] if name else ""
        if name == "time.sleep" and resolved:
            return "time.sleep()"
        if tail == "block_until_ready":
            return ".block_until_ready()"
        if tail == "synchronize":
            # the card's waits: the device, a CUDA event or a stream
            return "torch.cuda.synchronize()" \
                if name == "torch.cuda.synchronize" and resolved \
                else ".synchronize()"
        if tail in _HOST_READS and isinstance(call.func, ast.Attribute) \
                and not call.args and not call.keywords:
            return f".{tail}()"
        if tail == "urlopen":
            return "urlopen()"
        if tail in _HTTP_VERBS:
            if (resolved and name.startswith("requests.")) or \
                    ".session." in f".{name}":
                return f"HTTP .{tail}()"
            return None
        if tail == "result" and not call.args and not call.keywords:
            return ".result()"
        if tail == "join":
            if resolved and name.startswith("os.path"):
                return None
            base = call.func.value if isinstance(call.func, ast.Attribute) \
                else None
            if isinstance(base, ast.Constant):
                return None  # ", ".join(...)
            if not call.args or (len(call.args) == 1 and isinstance(
                    call.args[0], ast.Constant) and isinstance(
                    call.args[0].value, (int, float))):
                return ".join() on a thread"
            return None
        if tail == "wait":
            base = call.func.value if isinstance(call.func, ast.Attribute) \
                else None
            lock = self._lock_of(base) if base is not None else None
            if lock is not None and held == frozenset({lock}):
                return None  # cond.wait() releases the only lock held
            return ".wait()"
        return None


# -- whole-package analysis --------------------------------------------------

def _scan_all(modules: List[ModuleInfo], prog: callgraph.Program,
              classes: Dict[str, ClassLocks]) -> Dict[str, _FuncScan]:
    scans: Dict[str, _FuncScan] = {}
    for mod in modules:
        dotted = callgraph.module_name(mod.path)
        for qual, info in mod.funcs.items():
            if not isinstance(info.node,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if info.parent_qual and info.parent_qual in mod.funcs:
                continue  # nested def: scanned by its parent (no locks held)
            scan = _FuncScan(mod, info, f"{dotted}.{qual}", prog, classes)
            scan.run()
            scans[scan.qual] = scan
    return scans


def _transitive_acquired(scans: Dict[str, _FuncScan]
                         ) -> Dict[str, Set[str]]:
    acquired = {q: set(s.acquired) for q, s in scans.items()}
    changed = True
    while changed:
        changed = False
        for q, scan in scans.items():
            for tgt in scan.all_calls:
                extra = acquired.get(tgt)
                if extra and not extra <= acquired[q]:
                    acquired[q] |= extra
                    changed = True
    return acquired


def _transitive_blocking(scans: Dict[str, _FuncScan],
                         prog: callgraph.Program) -> Dict[str, str]:
    """qualname -> reason, for functions that may block anywhere in their
    call tree (direct reasons computed ignoring the held-set exemption:
    a Condition.wait blocks its *callers* even though it releases its own
    lock)."""
    blocking: Dict[str, str] = {
        q: scan.may_block for q, scan in scans.items()
        if scan.may_block is not None}
    changed = True
    while changed:
        changed = False
        for q, scan in scans.items():
            if q in blocking:
                continue
            for tgt in scan.all_calls:
                if tgt in blocking:
                    leaf = blocking[tgt].split(" [via ")[0]
                    blocking[q] = f"{leaf} [via {tgt}]"
                    changed = True
                    break
    return blocking


def _edge_line(scan: _FuncScan) -> int:
    """Fixture tests pin LK003 to the owning class's line; module-level
    functions use their own def line."""
    if scan.info.cls:
        for qual, cls in scan.mod.classes.items():
            if cls.name == scan.info.cls:
                return cls.lineno
    return getattr(scan.info.node, "lineno", 0)


@dataclass
class LockAnalysis:
    """Everything the lock passes derive in one scan — LK005
    (analysis/lockorder.py) and the conftest divergence graph reuse it
    instead of re-walking the package."""
    findings: List[Finding] = field(default_factory=list)
    #: annotation-filtered acquisition digraph (lock -> locks taken under)
    edges: Dict[str, Set[str]] = field(default_factory=dict)
    #: (a, b) -> (path, line, symbol, contributing function qualname)
    edge_src: Dict[Tuple[str, str], Tuple[str, int, str, str]] = \
        field(default_factory=dict)
    scans: Dict[str, "_FuncScan"] = field(default_factory=dict)
    classes: Dict[str, ClassLocks] = field(default_factory=dict)
    acquired: Dict[str, Set[str]] = field(default_factory=dict)
    #: every ``lockorder a<b`` annotation (a, b, path, line)
    declared: List[Tuple[str, str, str, int]] = field(default_factory=list)
    #: declared pairs whose reverse edge actually existed (not stale)
    suppressed: Set[Tuple[str, str]] = field(default_factory=set)


def _analyze(modules: List[ModuleInfo], prog: Optional[callgraph.Program]
             ) -> LockAnalysis:
    if prog is None:
        prog = callgraph.build(modules)
    findings: List[Finding] = []
    classes = _collect_classes(modules)

    # LK002: guarded-by names an attribute that is not a lock of the class
    for cls in classes.values():
        for attr, (lock, line) in cls.guarded.items():
            if lock not in cls.locks:
                findings.append(Finding(
                    "LK002", cls.mod.path, line, f"{cls.name}.{attr}",
                    f"guarded-by names '{lock}', which is not a "
                    f"threading lock attribute of {cls.name}"))

    scans = _scan_all(modules, prog, classes)
    for scan in scans.values():
        if not (scan.info.cls and
                scan.info.node.name == "__init__"):  # type: ignore[attr-defined]
            findings.extend(scan.findings)

    acquired = _transitive_acquired(scans)
    blocking = _transitive_blocking(scans, prog)

    # LK004: blocking call while holding a lock — direct sites, then calls
    # whose resolved callee may transitively block
    for scan in scans.values():
        reported: Set[int] = set()
        for held, why, line in scan.blocking_sites:
            if line in reported:
                continue
            reported.add(line)
            findings.append(Finding(
                "LK004", scan.mod.path, line, scan._symbol(),
                f"blocking call {why} while holding "
                f"{', '.join(sorted(held))} — release the lock before "
                f"blocking on device/network/time, or the lock becomes a "
                f"convoy (and a deadlock precondition)"))
        for held, tgt, line in scan.calls_under:
            why = blocking.get(tgt)
            if why is None or line in reported:
                continue
            reported.add(line)
            findings.append(Finding(
                "LK004", scan.mod.path, line, scan._symbol(),
                f"call to {tgt}() may block ({why}) while holding "
                f"{', '.join(sorted(held))} — release the lock before "
                f"blocking on device/network/time"))

    # lock-order edges: nested withs + calls made while holding a lock
    edges: Dict[str, Set[str]] = {}
    edge_src: Dict[Tuple[str, str], Tuple[str, int, str, str]] = {}

    def add_edge(a: str, b: str, mod: ModuleInfo, line: int, sym: str,
                 qual: str):
        if a == b:
            return
        edges.setdefault(a, set()).add(b)
        edge_src.setdefault((a, b), (mod.path, line, sym, qual))

    for scan in scans.values():
        line = _edge_line(scan)
        for (a, b) in scan.edges:
            add_edge(a, b, scan.mod, line, scan._symbol(), scan.qual)
        for held, tgt, _callline in scan.calls_under:
            for lk in acquired.get(tgt, set()):
                for h in held:
                    add_edge(h, lk, scan.mod, line,
                             f"{scan._symbol()} -> {tgt}", scan.qual)

    # lockorder annotations: the declared order wins — drop the
    # contradicted reverse edge (LK005 reports a stale annotation, and
    # the runtime sanitizer enforces that the declared order is actually
    # exercised and never inverted)
    declared = declared_orders(modules)
    suppressed: Set[Tuple[str, str]] = set()
    for a, b, _path, _line in declared:
        if a in edges.get(b, set()):
            edges[b].discard(a)
            edge_src.pop((b, a), None)
            suppressed.add((a, b))

    # LK003: cycles in the lock digraph
    seen_cycles: Set[frozenset] = set()

    def dfs(node: str, stack: List[str], on_stack: Set[str],
            visited: Set[str]) -> None:
        visited.add(node)
        on_stack.add(node)
        stack.append(node)
        for nxt in sorted(edges.get(node, ())):
            if nxt in on_stack:
                cyc = stack[stack.index(nxt):] + [nxt]
                cyc_key = frozenset(cyc)
                if cyc_key not in seen_cycles:
                    seen_cycles.add(cyc_key)
                    path, line, sym, _qual = edge_src.get(
                        (node, nxt), ("<unknown>", 0, "<unknown>", ""))
                    findings.append(Finding(
                        "LK003", path, line, sym,
                        "lock-order inversion: " + " -> ".join(cyc) +
                        " (acquire these locks in one global order)"))
            elif nxt not in visited:
                dfs(nxt, stack, on_stack, visited)
        stack.pop()
        on_stack.discard(node)

    visited: Set[str] = set()
    for node in sorted(edges):
        if node not in visited:
            dfs(node, [], set(), visited)

    return LockAnalysis(findings=findings, edges=edges, edge_src=edge_src,
                        scans=scans, classes=classes, acquired=acquired,
                        declared=declared, suppressed=suppressed)


def analyze(modules: List[ModuleInfo],
            prog: Optional[callgraph.Program] = None) -> LockAnalysis:
    """The full lock-analysis result (LK005 and the divergence graph
    build on it)."""
    return _analyze(modules, prog)


def check(modules: List[ModuleInfo],
          prog: Optional[callgraph.Program] = None) -> List[Finding]:
    return _analyze(modules, prog).findings


def lock_order_graph(modules: List[ModuleInfo],
                     prog: Optional[callgraph.Program] = None
                     ) -> Dict[str, Set[str]]:
    """The static lock-acquisition digraph (``Class.attr`` -> set of
    ``Class.attr`` acquired while held), with annotated-away reverse
    edges removed. runtime/locksan.py diffs the observed runtime order
    graph against this model."""
    return _analyze(modules, prog).edges
