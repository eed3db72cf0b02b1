"""Recapture-hazard rules (RC001/RC002/RC003), retargeted at CUDA graphs.

The port's counterpart of XLA's compile cache is the engine's graph cache
(``runtime/graphs.py``): ``GraphCache.run(tag, kind, fn, ...)`` captures
``fn`` once per ``(tag, input signatures)`` and replays it after that.
Every distinct tag value is a new capture, with its own static input
buffers (kept up to ``STATIC_BUDGET``, then the least recently used are
dropped and recaptured). When tag values derive from request payloads,
the key space is attacker-sized: one request per unique value captures a
graph (hundreds of milliseconds on the card) instead of replaying one,
and evicts the warm graphs. The serving layer bounds this with the
ShapeBucketer ladder: request-derived values may only enter a key AFTER
quantization onto the ladder (``bucket_shape`` / ``bucket_batch`` /
``bucket_payload``) or an explicit constant clamp (``min``/``max`` against
a literal), both of which bound the key space by construction.

Taint sources (per function, forward single pass; a nested def inherits
its enclosing scope's taint):

- attribute reads off a parameter named ``payload`` / ``request`` / ``req``
- ``os.environ`` / ``os.getenv`` reads and the sanctioned ``env_*`` helpers
  from runtime/config.py (env values are per-process constants, but a knob
  that silently multiplies captured graphs still deserves a ladder)

Sinks (the capture specs of ``analysis/capture.py``):

- RC001: a tainted argument that reaches a capture key: ``GraphCache.run``'s
  ``tag`` (marked ``# sdtpu-lint: captures(fn, key=tag, pool)``) or a
  parameter of a wrapper that passes it on, found through the per-function
  summaries (``analysis/summaries.py``) across calls and modules.
- RC002: a captured body, at a call that gives it a key, that closes over a
  tainted name (or has one bound through ``functools.partial``) which the
  key does not name: the replay reuses the value the capture saw. A value
  counts as named when the key expression, or a local it is assigned
  from, mentions it or one of its attributes (the engine's tag carries
  ``prec.flags`` for the ``prec`` its closures read).
- RC003: a raw serving-precision read outside the sanctioned resolution
  modules — ``SDTPU_UNET_INT8[_CONV]`` env reads, ``.get("precision")``
  on an override dict, or ``payload.precision`` attribute reads. The
  precision name is a STATIC compile-key and serving-group-key axis
  (pipeline/engine.py / serving/dispatcher.py), so every consumer must go
  through ``pipeline/precision.py``'s ``resolve``/``bucket_precision``
  (which bounds the value domain to the 3-rung ladder); a raw read is
  either an unbounded key or a group-key bypass that would coalesce
  int8 and bf16 requests into one executable.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import capture as capture_mod
from .core import Finding, FuncInfo, ModuleInfo, func_locals
from .summaries import positional, shallow

PAYLOAD_PARAMS = {"payload", "request", "req"}
ENV_HELPERS = {"read_env", "env_str", "env_flag", "env_int", "env_float",
               "env_parsed"}


def _is_env_read(mod: ModuleInfo, node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        name, _res = mod.call_name(node)
        if name in ("os.getenv",) or name.split(".")[-1] in ENV_HELPERS:
            return True
        # os.environ.get(...)
        if name.startswith("os.environ"):
            return True
    if isinstance(node, (ast.Attribute, ast.Subscript)):
        got = mod.dotted(node if isinstance(node, ast.Attribute)
                         else node.value)
        if got is not None and got[0].startswith("os.environ") and got[1]:
            return True
    return False


def _sanitized(mod: ModuleInfo, node: ast.Call) -> bool:
    """Bucketer quantization or a constant clamp bounds the value domain."""
    name, _res = mod.call_name(node)
    tail = name.split(".")[-1]
    if "bucket" in tail or tail == "crop":
        return True
    if tail in ("min", "max"):
        return any(isinstance(a, ast.Constant) for a in node.args)
    return False


class _Inter:
    """Interprocedural adapter: resolves call sites against the summary
    table (analysis/summaries.py) so ``_taint_of`` can follow taint
    through helpers in other modules. ``None`` everywhere degrades to the
    old intra-procedural behavior (which the cross-module fixture test
    exercises both ways)."""

    def __init__(self, summaries, mod: ModuleInfo):
        self.summaries = summaries
        self.mod = mod

    def resolve(self, info: FuncInfo, call: ast.Call):
        return self.summaries.callee(self.mod, info, call)

    def sanitizing(self, info: FuncInfo, call: ast.Call) -> bool:
        got = self.resolve(info, call)
        return got is not None and got[0].sanitizes

    def call_taint(self, info: FuncInfo, call: ast.Call, tainted: Set[str],
                   payload_params: Set[str]) -> Optional[str]:
        """Why a summarized call's return value is tainted, or None."""
        got = self.resolve(info, call)
        if got is None:
            return None
        summ, offset = got
        if summ.sanitizes:
            return None
        if summ.returns_taint:
            return f"{summ.qualname}() [{summ.returns_taint}]"
        forwarded = positional(call.args) + [
            (summ.params.index(kw.arg) - offset, kw.value)
            for kw in call.keywords if kw.arg in summ.params]
        for j, arg in forwarded:
            if j + offset not in summ.param_to_return:
                continue
            why = _arg_taint(self.mod, arg, tainted, payload_params,
                             self, info)
            if why is not None:
                return f"{summ.qualname}({why})"
        return None


def _arg_taint(mod: ModuleInfo, arg: ast.AST, tainted: Set[str],
               payload_params: Set[str], inter: Optional["_Inter"],
               info: Optional[FuncInfo]) -> Optional[str]:
    """Taint of a call argument: the usual expression taint, plus the
    whole-request-object case (``helper(payload)`` — a bare payload param
    is itself request-derived even though only attribute reads off it are
    taint *sources* intra-procedurally)."""
    why = _taint_of(mod, arg, tainted, payload_params, inter, info)
    if why is None and isinstance(arg, ast.Name) and \
            arg.id in payload_params:
        why = f"'{arg.id}' (request object)"
    return why


def _taint_of(mod: ModuleInfo, expr: ast.AST, tainted: Set[str],
              payload_params: Set[str], inter: Optional[_Inter] = None,
              info: Optional[FuncInfo] = None) -> Optional[str]:
    """Why ``expr`` is tainted (a description), or None if clean."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and _sanitized(mod, node):
            return None  # quantized somewhere in the expression
        if inter is not None and info is not None and \
                isinstance(node, ast.Call) and inter.sanitizing(info, node):
            return None  # callee's summary says it bucket/clamps
    for node in ast.walk(expr):
        if _is_env_read(mod, node):
            return "environment read"
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in payload_params:
            return f"{node.value.id}.{node.attr}"
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in tainted:
            return f"'{node.id}'"
        if inter is not None and info is not None and \
                isinstance(node, ast.Call):
            why = inter.call_taint(info, node, tainted, payload_params)
            if why is not None:
                return why
    return None


#: per scope: (tainted names, request/env-derived names). ``tainted`` is
#: what RC001 reads: bucketing or a clamp clears it. ``derived`` is what
#: RC002 reads: any value computed from the request or the environment,
#: bucketed or not (a bucketed value the closure reads must still be in
#: the key, or every member of the bucket replays the first one's).
Scope = Tuple[Set[str], Set[str]]


def _derived(mod: ModuleInfo, expr: ast.AST, derived: Set[str],
             payload_params: Set[str]) -> bool:
    """Whether ``expr`` is computed from the request or the environment
    (no sanitizer clears it)."""
    for node in ast.walk(expr):
        if _is_env_read(mod, node):
            return True
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and (node.id in derived or node.id in payload_params):
            return True
    return False


def _scope_seed(mod: ModuleInfo, info: FuncInfo, memo: Dict[str, Scope],
                inter: Optional[_Inter] = None) -> Scope:
    """The names a nested def inherits by closure.

    A closure reads the enclosing scope's variables, so ``skip`` assigned
    from ``payload.clip_skip`` in the enclosing method is just as tainted
    inside the nested helper that finally calls the graph cache. The seed
    is the enclosing function's *final* forward-pass state — an
    over-approximation of what is live at the nested def, biased toward
    reporting (names cleanly reassigned later in the parent are rare).
    """
    parent = mod.funcs.get(info.parent_qual)
    if parent is None or not isinstance(
            parent.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set(), set()
    if parent.qualname not in memo:
        memo[parent.qualname] = _forward_pass(
            mod, parent, _scope_seed(mod, parent, memo, inter),
            findings=None, inter=inter)
    # names the child rebinds locally are its own, not the closure's
    shadowed = func_locals(info.node)
    tainted, derived = memo[parent.qualname]
    return ({t for t in tainted if t not in shadowed},
            {t for t in derived if t not in shadowed})


def _forward_pass(mod: ModuleInfo, info: FuncInfo, seed: Scope,
                  findings: Optional[List[Finding]],
                  inter: Optional[_Inter] = None) -> Scope:
    fn = info.node
    params = [a.arg for a in (fn.args.posonlyargs + fn.args.args)]
    payload_params = {p for p in params if p in PAYLOAD_PARAMS}
    tainted: Set[str] = set(seed[0])
    derived: Set[str] = set(seed[1])

    def note_assign(target: ast.AST, value: ast.AST) -> None:
        if not isinstance(target, ast.Name):
            return
        why = _taint_of(mod, value, tainted, payload_params, inter, info)
        if why is not None:
            tainted.add(target.id)
        else:
            tainted.discard(target.id)  # clean reassignment clears taint
        if why is not None or \
                _derived(mod, value, derived, payload_params):
            derived.add(target.id)
        else:
            derived.discard(target.id)

    def visit(stmts: List[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # separate scope; RC002 handles closures
            if isinstance(st, ast.Assign):
                for t in st.targets:
                    note_assign(t, st.value)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                note_assign(st.target, st.value)
            elif isinstance(st, ast.AugAssign) and \
                    isinstance(st.target, ast.Name):
                why = _taint_of(mod, st.value, tainted, payload_params,
                                inter, info)
                if why is not None:
                    tainted.add(st.target.id)
                if why is not None or \
                        _derived(mod, st.value, derived, payload_params):
                    derived.add(st.target.id)
            # RC001: the callee's summary says one of its params reaches a
            # capture key inside it (GraphCache.run's tag included)
            if inter is not None and findings is not None:
                for node in shallow(st):
                    if isinstance(node, ast.Call):
                        _check_summary_sink(mod, info, node, tainted,
                                            payload_params, inter, findings)
            # recurse into compound statements, same scope
            for block in ("body", "orelse", "finalbody"):
                sub = getattr(st, block, None)
                if isinstance(sub, list) and sub and \
                        isinstance(sub[0], ast.stmt):
                    visit(sub)
            for h in getattr(st, "handlers", []) or []:
                visit(h.body)

    visit(fn.body)
    return tainted, derived | payload_params


def _check_summary_sink(mod: ModuleInfo, info: FuncInfo, call: ast.Call,
                        tainted: Set[str], payload_params: Set[str],
                        inter: _Inter, findings: List[Finding]) -> None:
    """RC001 at a call whose callee (per its summary) forwards the given
    argument position into a capture key."""
    got = inter.resolve(info, call)
    if got is None:
        return
    summ, offset = got
    if not summ.param_to_sink:
        return
    forwarded = positional(call.args) + [
        (summ.params.index(kw.arg) - offset, kw.value)
        for kw in call.keywords if kw.arg in summ.params]
    for j, arg in forwarded:
        sink = summ.param_to_sink.get(j + offset)
        if sink is None:
            continue
        why = _arg_taint(mod, arg, tainted, payload_params, inter, info)
        if why is not None:
            findings.append(Finding(
                "RC001", mod.path, call.lineno, info.qualname,
                f"argument {j} of {summ.qualname}() reaches a CUDA-graph "
                f"capture key ({sink}) and derives from {why}: every "
                f"distinct value captures a new graph and keeps its static "
                f"buffers (up to STATIC_BUDGET) — quantize through the "
                f"ShapeBucketer ladder or clamp to a constant range first"))


def _free_value_uses(node: ast.AST, out: Set[str]) -> None:
    """Names a body reads by value (a use that is only ever
    .shape/.ndim/.dtype/.size introspection is a host fact of the key)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.attr in ("shape", "ndim", "dtype", "size"):
        return
    if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
        out.add(node.id)
    for child in ast.iter_child_nodes(node):
        _free_value_uses(child, out)


def _closure(mod: ModuleInfo, node: ast.AST, scope: str) -> Set[str]:
    """Free names a captured body reads, with those of the nested defs of
    its enclosing scopes it calls by name (``evaluate`` reading
    ``unet_eval``'s ``prec``)."""
    free: Set[str] = set()
    seen: Set[int] = set()
    stack = [node]
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        uses: Set[str] = set()
        _free_value_uses(fn, uses)
        uses -= func_locals(fn)
        free |= uses
        for name in uses:
            s = scope
            while True:
                cand = f"{s}.{name}" if s else name
                if cand in mod.funcs:
                    if mod.funcs[cand].parent_qual:  # nested defs only
                        stack.append(mod.funcs[cand].node)
                    break
                if not s:
                    break
                s = s.rsplit(".", 1)[0] if "." in s else ""
    return free


def _local_defs(fn: ast.AST) -> Dict[str, List[ast.AST]]:
    """Local name -> the expressions assigned to it in ``fn``'s body."""
    out: Dict[str, List[ast.AST]] = {}
    for node in capture_mod.own_nodes(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(node.value)
    return out


def _named(mod: ModuleInfo, expr: ast.AST,
           defs: Dict[str, List[ast.AST]]) -> Set[str]:
    """Names a capture key names, through the local assignments of its
    names (``tag = (kind, prec.flags)`` names ``prec``). A name only under
    a bucket or clamp is not named: the key holds its bucket, not it."""
    out: Set[str] = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call) and _sanitized(mod, node):
            continue
        if isinstance(node, ast.Name) and node.id not in out:
            out.add(node.id)
            stack.extend(defs.get(node.id, ()))
        stack.extend(ast.iter_child_nodes(node))
    return out


def _check_closures(mod: ModuleInfo, info: FuncInfo, scope: Scope,
                    memo: Dict[str, Scope], inter: Optional[_Inter],
                    captures) -> List[Finding]:
    """RC002: a body captured with a key that closes over (or has bound
    through ``functools.partial``) a request/env-derived value the key
    does not name."""
    findings: List[Finding] = []
    defs = None
    for node in capture_mod.own_nodes(info.node):
        if not isinstance(node, ast.Call):
            continue
        got = captures.spec_of_call(mod, info, node)
        if got is None or got[1].key is None:
            continue
        callee, spec, offset = got
        key = captures.argument(node, callee, spec.key, offset)
        for p in spec.fns:
            arg = captures.argument(node, callee, p, offset)
            if arg is None:
                continue
            inner, _bound, _kws = capture_mod.unwrap(mod, arg)
            baked: Set[str] = set()
            part = arg  # a partial's bound arguments are baked too
            while isinstance(part, ast.Call) and part is not inner:
                for a in part.args[1:] + [k.value for k in part.keywords]:
                    _free_value_uses(a, baked)
                part = part.args[0]
            hot_names = scope[0] | scope[1]
            if isinstance(inner, ast.Lambda):
                line, name = inner.lineno, "<lambda>"
                baked |= _closure(mod, inner, info.qualname)
            else:
                tgt = captures.resolve_fn(mod, info, inner)
                if tgt is None:
                    continue
                tmod, tinfo = captures.prog.funcs[tgt]
                if tmod is not mod or not tinfo.parent_qual or \
                        tinfo.parent_qual not in mod.funcs:
                    continue  # only closures close over request values
                seed = _scope_seed(mod, tinfo, memo, inter)
                hot_names = hot_names | seed[0] | seed[1]
                line, name = tinfo.node.lineno, tinfo.node.name
                baked |= _closure(mod, tinfo.node, tinfo.parent_qual)
            if defs is None:
                defs = _local_defs(info.node)
            covered = _named(mod, key, defs) if key is not None else set()
            hot = sorted((baked & hot_names) - covered)
            if hot:
                findings.append(Finding(
                    "RC002", mod.path, line, info.qualname,
                    f"function '{name}' captured by "
                    f"{capture_mod.short(callee)} closes over "
                    f"request/env-derived {hot}, which its capture key does "
                    f"not name: every replay reuses the value of the "
                    f"capture — put it (or its bucket, and read the bucket) "
                    f"in the key, or pass it as an input"))
    return findings


def _check_function(mod: ModuleInfo, info: FuncInfo,
                    memo: Dict[str, Scope],
                    inter: Optional[_Inter] = None,
                    captures=None) -> List[Finding]:
    fn = info.node
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    findings: List[Finding] = []
    scope = _forward_pass(mod, info, _scope_seed(mod, info, memo, inter),
                          findings=findings, inter=inter)
    if captures is not None:
        findings.extend(_check_closures(mod, info, scope, memo, inter,
                                        captures))
    return findings


#: Modules allowed to read the raw precision knobs/fields — the policy
#: env defaults (runtime/dtypes.py) and the resolution ladder itself
#: (pipeline/precision.py). Everyone else goes through resolve().
RC003_SANCTIONED = ("runtime/dtypes.py", "pipeline/precision.py")

#: env knobs whose raw value is a precision static
RC003_ENV_PREFIX = "SDTPU_UNET_INT8"


def _rc003_offense(mod: ModuleInfo, node: ast.AST) -> Optional[str]:
    """Why ``node`` is a raw precision read, or None."""
    if isinstance(node, ast.Call):
        if _is_env_read(mod, node) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                node.args[0].value.startswith(RC003_ENV_PREFIX):
            return f"raw {node.args[0].value} env read"
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                node.args[0].value == "precision":
            return 'raw .get("precision") override read'
    if isinstance(node, ast.Attribute) and node.attr == "precision" and \
            isinstance(node.value, ast.Name) and \
            node.value.id in (PAYLOAD_PARAMS | {"run"}):
        return f"raw {node.value.id}.precision attribute read"
    return None


def _check_precision_reads(mod: ModuleInfo) -> List[Finding]:
    """RC003: module-wide scan (module level included); a read nested
    inside a bucket*/clamp call is sanitized like RC001 taint."""
    from .envrules import _enclosing_symbol

    if mod.path.endswith(RC003_SANCTIONED):
        return []
    findings: List[Finding] = []

    def walk(node: ast.AST, sanitized: bool) -> None:
        if isinstance(node, ast.Call) and _sanitized(mod, node):
            sanitized = True
        if not sanitized:
            why = _rc003_offense(mod, node)
            if why is not None:
                findings.append(Finding(
                    "RC003", mod.path, node.lineno,
                    _enclosing_symbol(mod, node.lineno),
                    f"{why}: the serving precision is a static compile-key "
                    f"and group-key axis — resolve it through "
                    f"pipeline/precision.py (resolve/bucket_precision) so "
                    f"the value domain stays on the 3-rung ladder and "
                    f"dispatch grouping sees the same name the engine "
                    f"compiles"))
                return  # one finding per offending expression
        for child in ast.iter_child_nodes(node):
            walk(child, sanitized)

    walk(mod.tree, False)
    return findings


def check(modules: List[ModuleInfo], summaries=None) -> List[Finding]:
    """``summaries`` (analysis/summaries.Summaries) turns RC001/RC002 on:
    both need the whole program (the capture specs and the call graph);
    None runs RC003 alone."""
    findings: List[Finding] = []
    captures = capture_mod.of(summaries.prog) \
        if summaries is not None else None
    for mod in modules:
        inter = _Inter(summaries, mod) if summaries is not None else None
        memo: Dict[str, Scope] = {}
        for info in mod.funcs.values():
            findings.extend(_check_function(mod, info, memo, inter,
                                            captures))
        findings.extend(_check_precision_reads(mod))
    return findings
