"""AT001: interprocedural check-then-act atomicity-violation detection.

The lock rules (LK001-LK005) verify that guarded state is only touched
with the right lock held. That is necessary but not sufficient: the
quota-refund and preempt-latch bugs were both *atomicity* violations —
every individual access held the lock, but a value read under one
critical section leaked into a decision or a write made under a
**re-acquired** critical section, and the world had moved in between::

    with self._lock:
        bal = self._balance[t]     # read under session 1
    if bal < cost:                 # decision on the (now stale) read
        return False
    with self._lock:
        self._balance[t] = bal - cost   # write under session 2: races

This pass tracks, per function, which locals carry a guarded-field read
and from which lock *session* (each ``with lock:`` block is a distinct
session). A write to a guarded field under a later session of the same
lock fires when

- the written value is computed from a read taken under an earlier
  session of that lock on the same object (stale-value write), or
- a branch dominating the write tested such a stale read and the write
  touches the *same* field (check-then-act via control flow).

It is interprocedural through locked accessors: a method that returns a
guarded field under its own lock taints its call result, and a method
that writes a guarded field from a parameter under its own lock is a
guarded write — so ``x = obj.used(); ...; obj.set_used(x + n)`` fires
just like the inline form.

Suppression (the sanctioned fix shape): re-validating the field inside
the second critical section — reading it fresh in a dominating test
under the *current* session, or computing the new value from a fresh
read — silences the finding.

Honest limits: sessions are numbered per ``with`` statement, so a loop
re-entering one ``with`` twice is a single session (a stale carry
across iterations of the same block is missed); container mutations via
method calls (``.append``/``.pop``) are not writes; coupled-field
evidence requires the written value to carry the stale read (branch-
only coupling across *different* fields is not reported, by design —
it drowned real findings in false positives on the quota paths).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from . import callgraph
from .core import Finding, FuncInfo, ModuleInfo
from .locks import ClassLocks, _collect_classes

__all__ = ["check"]


@dataclass(frozen=True)
class _Taint:
    obj: str        # dotted base expression ("self", "acct", "self.quota")
    field: str      # guarded attribute name
    lock: str       # qualified "Class.attr" lock
    session: int    # acquisition session the read happened under
    line: int       # read site


def _dotted_str(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


# -- locked accessor summaries ------------------------------------------------

def _accessor_summaries(modules: List[ModuleInfo], prog: callgraph.Program,
                        classes: Dict[str, ClassLocks]
                        ) -> Tuple[Dict[Tuple[str, str], Tuple[str, str]],
                                   Dict[Tuple[str, str], Tuple[str, str]]]:
    """(reads, writes): ``(Class, method) -> (lock, field)`` for methods
    that return / assign a guarded field under their own lock."""
    reads: Dict[Tuple[str, str], Tuple[str, str]] = {}
    writes: Dict[Tuple[str, str], Tuple[str, str]] = {}
    for mod in modules:
        for qual, info in mod.funcs.items():
            cls = classes.get(info.cls or "")
            if cls is None or not isinstance(info.node, ast.FunctionDef):
                continue
            name = info.node.name
            if name == "__init__":
                continue
            params = {a.arg for a in info.node.args.args[1:]}
            for node in ast.walk(info.node):
                if not isinstance(node, ast.With):
                    continue
                lock = None
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Attribute) and \
                            isinstance(ctx.value, ast.Name) and \
                            ctx.value.id == "self" and \
                            ctx.attr in cls.locks:
                        lock = f"{info.cls}.{ctx.attr}"
                if lock is None:
                    continue
                for st in ast.walk(node):
                    if isinstance(st, ast.Return) and st.value is not None:
                        for sub in ast.walk(st.value):
                            if isinstance(sub, ast.Attribute) and \
                                    isinstance(sub.value, ast.Name) and \
                                    sub.value.id == "self" and \
                                    sub.attr in cls.guarded and \
                                    cls.guarded[sub.attr][0] == \
                                    lock.split(".")[1]:
                                reads.setdefault((info.cls, name),
                                                 (lock, sub.attr))
                    if isinstance(st, ast.Assign):
                        tgt = st.targets[0] if len(st.targets) == 1 else None
                        attr = _written_attr(tgt)
                        if attr is None:
                            continue
                        base, fieldname = attr
                        if base != "self" or fieldname not in cls.guarded \
                                or cls.guarded[fieldname][0] != \
                                lock.split(".")[1]:
                            continue
                        names = {n.id for n in ast.walk(st.value)
                                 if isinstance(n, ast.Name)}
                        if names & params:
                            writes.setdefault((info.cls, name),
                                              (lock, fieldname))
    return reads, writes


def _written_attr(target: Optional[ast.AST]
                  ) -> Optional[Tuple[str, str]]:
    """(base-dotted, field) for an attribute or container-slot write
    target (``self.f = ...`` / ``self.f[k] = ...``)."""
    if isinstance(target, ast.Subscript):
        target = target.value
    if isinstance(target, ast.Attribute):
        base = _dotted_str(target.value)
        if base is not None:
            return base, target.attr
    return None


# -- per-function traversal ---------------------------------------------------

class _AtomScan:
    def __init__(self, mod: ModuleInfo, info: FuncInfo, qual: str,
                 prog: callgraph.Program, classes: Dict[str, ClassLocks],
                 reads: Dict[Tuple[str, str], Tuple[str, str]],
                 writes: Dict[Tuple[str, str], Tuple[str, str]]):
        self.mod = mod
        self.info = info
        self.qual = qual
        self.prog = prog
        self.classes = classes
        self.acc_reads = reads
        self.acc_writes = writes
        self.local_types = prog.local_types(mod, info)
        self.findings: List[Finding] = []
        self.taints: Dict[str, _Taint] = {}
        self._session = 0
        #: (lock, session) -> fields read fresh in a dominating test
        self._validated: Dict[Tuple[str, int], Set[str]] = {}
        self._reported: Set[int] = set()

    # -- resolution ----------------------------------------------------------

    def _guard_of(self, node: ast.Attribute
                  ) -> Optional[Tuple[str, str, str]]:
        """(obj, field, lock) when ``node`` reads/writes a guarded
        attribute of a known class."""
        owner = self.prog.expr_type(self.mod, self.info, node.value,
                                    self.local_types)
        if owner is None:
            return None
        cl = self.classes.get(owner)
        if cl is None or node.attr not in cl.guarded:
            return None
        base = _dotted_str(node.value)
        if base is None:
            return None
        lockname, _line = cl.guarded[node.attr]
        return base, node.attr, f"{owner}.{lockname}"

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute):
            owner = self.prog.expr_type(self.mod, self.info, expr.value,
                                        self.local_types)
            if owner is not None:
                cl = self.classes.get(owner)
                if cl is not None and expr.attr in cl.locks:
                    return f"{owner}.{expr.attr}"
        return None

    def _guarded_reads(self, expr: ast.AST, held: Dict[str, int]
                       ) -> List[_Taint]:
        out = []
        for sub in ast.walk(expr):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            if isinstance(sub, ast.Attribute) and \
                    isinstance(sub.ctx, ast.Load):
                got = self._guard_of(sub)
                if got is not None and got[2] in held:
                    out.append(_Taint(got[0], got[1], got[2],
                                      held[got[2]], sub.lineno))
        return out

    def _stale_refs(self, expr: ast.AST, held: Dict[str, int]
                    ) -> List[_Taint]:
        """Taints referenced by ``expr`` that came from a lock session
        other than the current one (or from a locked accessor call)."""
        out = []
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                t = self.taints.get(sub.id)
                if t is not None and held.get(t.lock) != t.session:
                    out.append(t)
        return out

    # -- traversal -----------------------------------------------------------

    def run(self) -> None:
        self._body(getattr(self.info.node, "body", []), {}, ())

    def _body(self, stmts: List[ast.stmt], held: Dict[str, int],
              btaints: Tuple[_Taint, ...]) -> None:
        for st in stmts:
            self._stmt(st, held, btaints)

    def _stmt(self, st: ast.stmt, held: Dict[str, int],
              btaints: Tuple[_Taint, ...]) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # separate thread/scope: sessions don't carry over
        if isinstance(st, (ast.With, ast.AsyncWith)):
            newly = dict(held)
            for item in st.items:
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    self._session += 1
                    newly[lock] = self._session
            self._body(st.body, newly, btaints)
            return
        if isinstance(st, ast.Try):
            self._body(st.body, held, btaints)
            for h in st.handlers:
                self._body(h.body, held, btaints)
            self._body(st.orelse, held, btaints)
            self._body(st.finalbody, held, btaints)
            return
        if isinstance(st, (ast.If, ast.While)):
            # fresh reads in the test re-validate for the current session
            for t in self._guarded_reads(st.test, held):
                self._validated.setdefault(
                    (t.lock, t.session), set()).add(t.field)
            extra = tuple(self._stale_refs(st.test, held))
            self._check_calls(st.test, held, btaints)
            self._body(st.body, held, btaints + extra)
            self._body(st.orelse, held, btaints + extra)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._body(st.body, held, btaints)
            self._body(st.orelse, held, btaints)
            return
        if isinstance(st, ast.Assign):
            self._assign(st, held, btaints)
            return
        if isinstance(st, ast.AugAssign):
            # the in-place read happens at write time under the current
            # session — fresh by construction, never check-then-act
            return
        for node in ast.walk(st):
            if isinstance(node, ast.Call):
                self._setter_call(node, held)

    def _check_calls(self, expr: ast.AST, held: Dict[str, int],
                     btaints: Tuple[_Taint, ...]) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._setter_call(node, held)

    def _assign(self, st: ast.Assign, held: Dict[str, int],
                btaints: Tuple[_Taint, ...]) -> None:
        # 1) guarded-field writes under a (re-)acquired lock
        for target in st.targets:
            self._check_write(target, st.value, held, btaints, st.lineno)
        for node in ast.walk(st.value):
            if isinstance(node, ast.Call):
                self._setter_call(node, held)
        # 2) taint bookkeeping for name targets
        if len(st.targets) == 1 and isinstance(st.targets[0], ast.Name):
            name = st.targets[0].id
            reads = self._guarded_reads(st.value, held)
            if reads:
                self.taints[name] = reads[0]
                return
            acc = self._accessor_read(st.value)
            if acc is not None:
                self.taints[name] = acc
                return
            carried = self._stale_refs(st.value, held)
            fresh = [self.taints[n.id] for n in ast.walk(st.value)
                     if isinstance(n, ast.Name) and n.id in self.taints]
            if fresh:
                self.taints[name] = fresh[0]
            else:
                self.taints.pop(name, None)
            del carried

    def _accessor_read(self, expr: ast.AST) -> Optional[_Taint]:
        """``x = obj.used()`` through a locked read accessor taints x
        with a fresh pseudo-session (always distinct from any with-
        session in this function)."""
        if not (isinstance(expr, ast.Call)
                and isinstance(expr.func, ast.Attribute)):
            return None
        owner = self.prog.expr_type(self.mod, self.info, expr.func.value,
                                    self.local_types)
        if owner is None:
            return None
        summary = self.acc_reads.get((owner, expr.func.attr))
        if summary is None:
            return None
        base = _dotted_str(expr.func.value)
        if base is None:
            return None
        lock, fieldname = summary
        self._session += 1
        return _Taint(base, fieldname, lock, self._session, expr.lineno)

    def _check_write(self, target: ast.AST, value: ast.AST,
                     held: Dict[str, int], btaints: Tuple[_Taint, ...],
                     line: int) -> None:
        got = _written_attr(target)
        if got is None:
            return
        base, fieldname = got
        if isinstance(target, ast.Subscript):
            attr_node = target.value
        else:
            attr_node = target
        guard = self._guard_of(attr_node) if \
            isinstance(attr_node, ast.Attribute) else None
        if guard is None:
            return
        _obj, _field, lock = guard
        session = held.get(lock)
        if session is None:
            return  # unlocked write is LK001's finding, not ours
        if fieldname in self._validated.get((lock, session), set()):
            return  # re-validated inside this critical section
        fresh_fields = {t.field for t in self._guarded_reads(value, held)
                        if t.lock == lock and t.session == session
                        and t.obj == base}
        if fieldname in fresh_fields:
            return  # value recomputed from a fresh read
        stale = [t for t in self._stale_refs(value, held)
                 if t.lock == lock and t.obj == base]
        for t in stale:
            self._report(line, t, fieldname, lock, via="value")
            return
        for t in btaints:
            if t.lock == lock and t.obj == base and t.field == fieldname \
                    and t.session != session:
                self._report(line, t, fieldname, lock, via="branch")
                return

    def _setter_call(self, call: ast.Call, held: Dict[str, int]) -> None:
        if not isinstance(call.func, ast.Attribute):
            return
        owner = self.prog.expr_type(self.mod, self.info, call.func.value,
                                    self.local_types)
        if owner is None:
            return
        summary = self.acc_writes.get((owner, call.func.attr))
        if summary is None:
            return
        base = _dotted_str(call.func.value)
        if base is None:
            return
        lock, fieldname = summary
        for arg in list(call.args) + [k.value for k in call.keywords]:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Name) and sub.id in self.taints:
                    t = self.taints[sub.id]
                    if t.lock == lock and t.obj == base:
                        self._report(call.lineno, t, fieldname, lock,
                                     via="accessor")
                        return

    def _symbol(self) -> str:
        if self.info.cls:
            return f"{self.info.cls}.{self.info.node.name}"  # type: ignore[attr-defined]
        return self.info.qualname

    def _report(self, line: int, taint: _Taint, fieldname: str,
                lock: str, via: str) -> None:
        if line in self._reported:
            return
        self._reported.add(line)
        what = {"value": "is written back",
                "branch": "gates this write",
                "accessor": "flows into a locked write accessor"}[via]
        same = taint.field == fieldname
        coupled = "" if same else \
            f" (coupled field '{fieldname}' under the same lock)"
        self.findings.append(Finding(
            "AT001", self.mod.path, line, self._symbol(),
            f"check-then-act: '{taint.obj}.{taint.field}' read under "
            f"{lock} at line {taint.line} {what} under a re-acquired "
            f"{lock}{coupled} — the value may be stale; do the read, "
            f"check, and write in one critical section (or re-validate "
            f"the field inside this one)"))


def check(modules: List[ModuleInfo],
          prog: Optional[callgraph.Program] = None) -> List[Finding]:
    if prog is None:
        prog = callgraph.build(modules)
    classes = _collect_classes(modules)
    reads, writes = _accessor_summaries(modules, prog, classes)
    findings: List[Finding] = []
    for mod in modules:
        dotted = callgraph.module_name(mod.path)
        for qual, info in mod.funcs.items():
            if not isinstance(info.node,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if info.parent_qual and info.parent_qual in mod.funcs:
                continue  # nested defs run on their own thread/time
            if info.cls and info.node.name == "__init__":
                continue  # construction is single-threaded
            scan = _AtomScan(mod, info, f"{dotted}.{qual}", prog,
                             classes, reads, writes)
            scan.run()
            findings.extend(scan.findings)
    return findings
