"""Per-function taint summaries, propagated to a fixed point.

The intra-procedural recompile pass (``recompile.py``) sees taint born and
consumed inside one function. This module gives it eyes across calls: for
every function in the package it computes a small transfer summary —

- ``param_to_return``: which positional params flow into the return value
  (``def raw_steps(payload): return payload.steps`` -> {0});
- ``returns_taint``: the return value is request/env-derived regardless of
  what the caller passes (the body reads ``os.environ`` or an attribute
  off its own payload-named param);
- ``sanitizes``: every return passes through the bucketer ladder or a
  constant clamp, so call results are clean whatever went in;
- ``param_to_sink``: which params reach a **capture key** inside the body
  (the ``key=`` parameter of a capture spec, ``analysis/capture.py``:
  ``GraphCache.run``'s ``tag``), directly or through further calls — the
  caller-side half of an interprocedural RC001.

Summaries are computed per function from the AST, then iterated to a fixed
point over the program call graph so taint laundered through helper chains
(``a -> b -> c``, across modules) still resolves. ``recompile.py`` consults
the table at call sites: a call to a function whose summary returns taint
makes the result tainted; a tainted argument in a ``param_to_sink``
position is an RC001 at the call site.

Everything is positional-param based (keywords map by name); *args/**kwargs,
the positional arguments after a ``*starred`` one (their parameters are
unknown) and container flows are out of scope — documented
under-reporting, same bias as the rest of the analyzer. A nested def's
calls count for its enclosing function too: a closure forwards the
enclosing scope's values (the engine's ``_make_denoise_fn`` reaches the
capture key through its closures).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import capture as capture_mod
from .callgraph import Program
from .core import FuncInfo, ModuleInfo

#: origin markers: ("param", i) | ("env",) | ("payload", "<p.attr>")
Origin = Tuple


@dataclass
class FuncSummary:
    qualname: str
    params: List[str] = field(default_factory=list)
    param_to_return: Set[int] = field(default_factory=set)
    returns_taint: Optional[str] = None
    sanitizes: bool = False
    param_to_sink: Dict[int, str] = field(default_factory=dict)

    def key(self) -> Tuple:
        return (frozenset(self.param_to_return), self.returns_taint,
                self.sanitizes, frozenset(self.param_to_sink.items()))

    def to_dict(self) -> Dict:
        return {"params": self.params,
                "param_to_return": sorted(self.param_to_return),
                "returns_taint": self.returns_taint,
                "sanitizes": self.sanitizes,
                "param_to_sink": {str(k): v
                                  for k, v in self.param_to_sink.items()}}

    @classmethod
    def from_dict(cls, qualname: str, d: Dict) -> "FuncSummary":
        return cls(qualname, list(d.get("params", [])),
                   set(d.get("param_to_return", [])),
                   d.get("returns_taint"),
                   bool(d.get("sanitizes", False)),
                   {int(k): v
                    for k, v in d.get("param_to_sink", {}).items()})


def positional(args: List[ast.expr]) -> List[Tuple[int, ast.expr]]:
    """``(index, arg)`` of a call's positional arguments up to the first
    ``*starred`` one, past which no argument's parameter is known."""
    out = []
    for j, arg in enumerate(args):
        if isinstance(arg, ast.Starred):
            break
        out.append((j, arg))
    return out


def shallow(st: ast.stmt):
    """The nodes of a statement without its nested statement lists
    (``body``, ``orelse``, ``finalbody``, the handlers'), which a
    statement walk visits on their own."""
    skip = set()
    for name in ("body", "orelse", "finalbody"):
        sub = getattr(st, name, None)
        if isinstance(sub, list):
            skip.update(id(x) for x in sub if isinstance(x, ast.stmt))
    for h in getattr(st, "handlers", []) or []:
        skip.update(id(x) for x in h.body)
    stack = [st]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node)
                     if id(c) not in skip)


def _abs_why(origins: Set[Origin]) -> Optional[str]:
    """Caller-independent taint reason carried by an origin set."""
    for o in origins:
        if o[0] == "env":
            return "environment read"
        if o[0] == "payload":
            return o[1]
        if o[0] == "abs":
            return o[1]
    return None


def _param_indices(origins: Set[Origin]) -> Set[int]:
    return {o[1] for o in origins if o[0] == "param"}


class Summaries:
    """The summary table plus call-site resolution helpers."""

    def __init__(self, prog: Program,
                 seed: Optional[Dict[str, Dict]] = None,
                 dirty_paths: Optional[Set[str]] = None):
        """``seed`` (qualname -> serialized FuncSummary) + ``dirty_paths``
        enable incremental recomputation: functions in clean modules keep
        their seeded summaries; only functions in dirty modules iterate.
        Callers must include import-dependents of every changed module in
        ``dirty_paths`` or clean summaries could go stale."""
        self.prog = prog
        self.table: Dict[str, FuncSummary] = {}
        self._local_types: Dict[str, Dict[str, str]] = {}
        self._compute(seed or {}, dirty_paths)

    # -- call-site API (used by recompile.py) --------------------------------

    def callee(self, mod: ModuleInfo, info: FuncInfo, call: ast.Call
               ) -> Optional[Tuple[FuncSummary, int]]:
        """(summary, arg offset) for a resolvable call, else None. The
        offset is 1 for ``obj.method(...)`` calls whose target's first
        param is self/cls — caller arg ``i`` maps to callee param
        ``i + offset``."""
        qual = f"{callgraph_module(mod)}.{info.qualname}"
        cached = self._local_types.get(qual)
        tgt = capture_mod.resolve_call(self.prog, mod, info, call, cached)
        if tgt is None:
            return None
        summ = self.table.get(tgt)
        if summ is None:
            return None
        offset = 0
        if isinstance(call.func, ast.Attribute) and \
                summ.params[:1] and summ.params[0] in ("self", "cls"):
            offset = 1
        return summ, offset

    # -- computation ---------------------------------------------------------

    def _compute(self, seed: Dict[str, Dict],
                 dirty_paths: Optional[Set[str]]) -> None:
        entries = []
        for qual, (mod, info) in self.prog.funcs.items():
            if not isinstance(info.node,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in (info.node.args.posonlyargs
                                      + info.node.args.args)]
            clean = dirty_paths is not None and mod.path not in dirty_paths
            if clean and qual in seed:
                self.table[qual] = FuncSummary.from_dict(qual, seed[qual])
            else:
                self.table[qual] = FuncSummary(qual, params)
                clean = False
            self._local_types[qual] = capture_mod.scope_types(
                self.prog, mod, info)
            if not clean:
                entries.append((qual, mod, info))
        for _round in range(10):
            changed = False
            for qual, mod, info in entries:
                new = self._summarize(qual, mod, info)
                if new.key() != self.table[qual].key():
                    self.table[qual] = new
                    changed = True
            if not changed:
                break

    def _summarize(self, qual: str, mod: ModuleInfo, info: FuncInfo
                   ) -> FuncSummary:
        from .recompile import PAYLOAD_PARAMS, _is_env_read, _sanitized

        fn = info.node
        params = [a.arg for a in (fn.args.posonlyargs + fn.args.args)]
        summ = FuncSummary(qual, params)
        payload_params = {p for p in params if p in PAYLOAD_PARAMS}
        origins: Dict[str, Set[Origin]] = {
            p: {("param", i)} for i, p in enumerate(params)}
        return_origins: Set[Origin] = set()
        returns_seen = 0
        returns_sanitized = 0

        def call_summary(call: ast.Call) -> Optional[Tuple[FuncSummary, int]]:
            tgt = capture_mod.resolve_call(self.prog, mod, info, call,
                                           self._local_types.get(qual))
            if tgt is None or tgt == qual:
                return None
            got = self.table.get(tgt)
            if got is None:
                return None
            offset = 0
            if isinstance(call.func, ast.Attribute) and \
                    got.params[:1] and got.params[0] in ("self", "cls"):
                offset = 1
            return got, offset

        def eval_origins(expr: ast.AST) -> Set[Origin]:
            if isinstance(expr, ast.Call):
                if _sanitized(mod, expr):
                    return set()
                got = call_summary(expr)
                if got is not None:
                    csumm, offset = got
                    if csumm.sanitizes:
                        return set()
                    out: Set[Origin] = set()
                    if csumm.returns_taint:
                        out.add(("abs", csumm.returns_taint))
                    for j, arg in positional(expr.args):
                        if j + offset in csumm.param_to_return:
                            out |= eval_origins(arg)
                    for kw in expr.keywords:
                        if kw.arg in csumm.params and \
                                csumm.params.index(kw.arg) in \
                                csumm.param_to_return:
                            out |= eval_origins(kw.value)
                    return out
            if _is_env_read(mod, expr):
                return {("env",)}
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name):
                base = expr.value.id
                if base in payload_params:
                    return {("payload", f"{base}.{expr.attr}"),
                            ("param", params.index(base))}
            if isinstance(expr, ast.Name) and isinstance(expr.ctx, ast.Load):
                return set(origins.get(expr.id, set()))
            out = set()
            for child in ast.iter_child_nodes(expr):
                out |= eval_origins(child)
            return out

        def check_sinks(call: ast.Call) -> None:
            # callee forwards a param to its own sink
            got = call_summary(call)
            if got is None:
                return
            csumm, sink_offset = got
            for j, arg in positional(call.args):
                why = csumm.param_to_sink.get(j + sink_offset)
                if why is None:
                    continue
                for pi in _param_indices(eval_origins(arg)):
                    summ.param_to_sink.setdefault(
                        pi, f"via {csumm.qualname}")

        def note_assign(target: ast.AST, value: ast.AST) -> None:
            if not isinstance(target, ast.Name):
                return
            got = eval_origins(value)
            if got:
                origins[target.id] = got
            else:
                origins.pop(target.id, None)

        def visit(stmts: List[ast.stmt]) -> None:
            nonlocal return_origins, returns_seen, returns_sanitized
            from .recompile import _sanitized as _san
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # a closure: the sinks it reaches with the enclosing
                    # scope's values are this function's too
                    for node in ast.walk(st):
                        if isinstance(node, ast.Call):
                            check_sinks(node)
                    continue
                if isinstance(st, ast.Assign):
                    for t in st.targets:
                        note_assign(t, st.value)
                elif isinstance(st, ast.AnnAssign) and st.value is not None:
                    note_assign(st.target, st.value)
                elif isinstance(st, ast.AugAssign) and \
                        isinstance(st.target, ast.Name):
                    got = eval_origins(st.value)
                    if got:
                        origins.setdefault(st.target.id, set()).update(got)
                elif isinstance(st, ast.Return) and st.value is not None:
                    returns_seen += 1
                    sanitized = any(
                        isinstance(n, ast.Call) and _san(mod, n)
                        for n in ast.walk(st.value))
                    got = call_summary(st.value) \
                        if isinstance(st.value, ast.Call) else None
                    if got is not None and got[0].sanitizes:
                        sanitized = True
                    if sanitized:
                        returns_sanitized += 1
                    else:
                        return_origins |= eval_origins(st.value)
                for node in shallow(st):
                    if isinstance(node, ast.Call):
                        check_sinks(node)
                for block in ("body", "orelse", "finalbody"):
                    sub = getattr(st, block, None)
                    if isinstance(sub, list) and sub and \
                            isinstance(sub[0], ast.stmt):
                        visit(sub)
                for h in getattr(st, "handlers", []) or []:
                    visit(h.body)

        visit(fn.body)
        # the capture key itself: the sink every other one reaches
        spec = capture_mod.of(self.prog).specs.get(qual)
        if spec is not None and spec.key in params:
            summ.param_to_sink.setdefault(params.index(spec.key),
                                          "capture key")
        summ.param_to_return = {
            i for i in _param_indices(return_origins) if i < len(params)}
        summ.returns_taint = _abs_why(return_origins)
        summ.sanitizes = returns_seen > 0 and \
            returns_sanitized == returns_seen
        return summ


def callgraph_module(mod: ModuleInfo) -> str:
    from .callgraph import module_name
    return module_name(mod.path)


def compute(prog: Program,
            seed: Optional[Dict[str, Dict]] = None,
            dirty_paths: Optional[Set[str]] = None) -> Summaries:
    return Summaries(prog, seed=seed, dirty_paths=dirty_paths)


def by_path(summ: Summaries) -> Dict[str, Dict[str, Dict]]:
    """Serialized summaries grouped by module path, for the cache."""
    out: Dict[str, Dict[str, Dict]] = {}
    for qual, s in summ.table.items():
        entry = summ.prog.funcs.get(qual)
        if entry is None:
            continue
        out.setdefault(entry[0].path, {})[qual] = s.to_dict()
    return out
