"""Which code a CUDA graph captures: the subject of the trace rules.

The JAX package's trace rules (TP001-TP004, RC001, RC002, DN001) look for
functions under ``jax.jit`` and ``lax.scan``. The port has none: its
counterpart of a trace is a CUDA-graph capture (``runtime/graphs.py``).
A capture runs a Python body once (after one eager call) and replays the
recorded kernels after that, so it has the hazards of a trace: host state
read in the body is baked into every replay, a host read of a device value
synchronises inside the capture, and a tensor the body allocates lives in
the graphs' memory pool, which the next replay overwrites.

This module finds, over the whole program:

- **capture specs**, what a function does with its parameters: which of
  them it captures (``fns``, with the number of leading positional
  parameters bound before the capture calls it), which one is the capture
  key (``key``), and whether it returns a replay's output, which lies in
  the graphs' pool (``pool``). A spec comes from
  - a capture region in the body: a parameter called inside a
    ``with torch.cuda.graph(...)`` block or between ``.capture_begin()``
    and ``.capture_end()``;
  - the marker ``# sdtpu-lint: captures(fn, key=tag, pool)`` on the
    ``def``, for an entry point whose capture goes through a call the
    resolver cannot follow (``GraphCache.run`` reaches its backend's
    ``capture`` through an untyped attribute);
  - propagation to a fixed point: a parameter passed on (bare, through
    ``functools.partial`` or a lambda that calls it) into a captured
    position of a resolvable callee is captured too, and so is a key;
    a function that returns such a callee's pool output returns one.
- **captured functions**: the function-valued argument at a captured
  position of a call (a name, ``functools.partial(f, ...)`` or a lambda),
  the body of a capture region, and every method of an ``nn.Module``
  (their forwards run under the engine's captures), closed over the calls
  they make within their own module, as the JAX package's reach is. A
  callee in another module is checked where it is a root itself (the
  UNet's blocks, reached from the engine's closures through a module
  call); the kernel wrappers' one-time library loads (``ops/nvcc.py``),
  which the eager call before every capture runs, stay out of reach. For
  an argument the spec says how its parameters map, so the parameters
  left after the bound ones are known tensors (``tensor_params``); for
  the others the mapping is unknown (``None``).

A nested ``def`` that uses its enclosing method's ``self`` resolves
``self.<attr>`` calls against that method's class here (the engine's
closures reach the graph cache as ``self._graphs``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import Program, module_name
from .core import FuncInfo, ModuleInfo, declared_nonlocal, func_locals

#: context managers whose body is captured
CAPTURE_CTX = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
PARTIALS = {"functools.partial", "partial"}


@dataclass
class CaptureSpec:
    #: captured parameter -> leading positional parameters bound before
    #: the capture calls it
    fns: Dict[str, int] = field(default_factory=dict)
    key: Optional[str] = None
    pool: bool = False

    def state(self) -> Tuple:
        return (tuple(sorted(self.fns.items())), self.key, self.pool)


class CapturedFn:
    """A body that runs under a capture: a function, a lambda, or a
    capture region of a function (``node`` is what the rules walk)."""

    def __init__(self, mod: ModuleInfo, info: FuncInfo, node: ast.AST,
                 tensor_params: Optional[Set[str]], why: str):
        self.mod = mod
        self.info = info  # the enclosing function of a lambda or region
        self.node = node
        self.tensor_params = tensor_params
        self.why = why
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.locals = func_locals(node)
            self.declared = declared_nonlocal(node)
        elif isinstance(node, ast.Lambda):
            self.locals, self.declared = func_locals(node), set()
        else:  # a region: the enclosing function's scope
            self.locals = func_locals(info.node)
            self.declared = declared_nonlocal(info.node)

    @property
    def symbol(self) -> str:
        return self.info.qualname


def _params(fn: ast.AST) -> List[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return []
    return [a.arg for a in (args.posonlyargs + args.args)]


def is_module_class(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = base.attr if isinstance(base, ast.Attribute) else \
            base.id if isinstance(base, ast.Name) else ""
        if name.endswith("Module"):
            return True
    return False


def own_nodes(fn: ast.AST):
    """Every node of a function body, not descending into nested defs or
    classes (their scopes are separate functions of the program)."""
    scopes = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    stack = [c for c in ast.iter_child_nodes(fn) if not isinstance(c, scopes)]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node)
                     if not isinstance(c, scopes))


def effective_info(mod: ModuleInfo, info: FuncInfo) -> FuncInfo:
    """``info`` with the class of its enclosing method, for a nested def
    that reads that method's ``self`` (it does not bind its own)."""
    if info.cls is not None or "self" in _params(info.node):
        return info
    parent = mod.funcs.get(info.parent_qual)
    while parent is not None:
        if parent.cls is not None:
            return FuncInfo(info.node, info.qualname, parent.cls,
                            info.parent_qual)
        if "self" in _params(parent.node):
            return info
        parent = mod.funcs.get(parent.parent_qual)
    return info


def scope_types(prog: Program, mod: ModuleInfo, info: FuncInfo
                ) -> Dict[str, str]:
    """A function's local types (``Program.local_types`` under its
    :func:`effective_info`) with those of the enclosing functions for the
    names it reads by closure (``cache`` typed by the enclosing def's
    annotation), computed once per program."""
    memo = prog.derived.setdefault("scope_types", {})
    got = memo.get(id(info.node))
    if got is None:
        got = prog.local_types(mod, effective_info(mod, info)) \
            if isinstance(info.node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) else {}
        parent = mod.funcs.get(info.parent_qual)
        if parent is not None and isinstance(info.node, (
                ast.FunctionDef, ast.AsyncFunctionDef)):
            own = func_locals(info.node)
            inherited = scope_types(prog, mod, parent)
            got = {**{k: v for k, v in inherited.items() if k not in own},
                   **got}
        memo[id(info.node)] = got
    return got


def resolve_call(prog: Program, mod: ModuleInfo, info: FuncInfo,
                 call: ast.Call, local: Optional[Dict[str, str]] = None
                 ) -> Optional[str]:
    """``Program.resolve_call`` with two extensions the trace rules need:
    a nested def's ``self`` is its enclosing method's
    (:func:`effective_info`), and a bare name that no enclosing scope
    defines is the module's own top-level def of that name."""
    got = prog.resolve_call(mod, effective_info(mod, info), call, local)
    if got is None and isinstance(call.func, ast.Name) and \
            call.func.id in mod.funcs:
        got = f"{module_name(mod.path)}.{call.func.id}"
    return got


def _marker_spec(mod: ModuleInfo, info: FuncInfo) -> Optional[CaptureSpec]:
    """``# sdtpu-lint: captures(fn, key=tag, pool)`` on a def."""
    payload = mod.marker(getattr(info.node, "lineno", 0), "sdtpu-lint:")
    if not payload or not payload.startswith("captures"):
        return None
    inside = payload[payload.find("(") + 1:payload.rfind(")")]
    spec = CaptureSpec()
    for part in (p.strip() for p in inside.split(",")):
        if part.startswith("key="):
            spec.key = part[4:].strip()
        elif part == "pool":
            spec.pool = True
        elif part:
            spec.fns[part] = 0
    return spec


def _regions(mod: ModuleInfo, fn: ast.AST) -> List[List[ast.stmt]]:
    """The captured statement lists of a function body: ``with
    torch.cuda.graph(...)`` bodies and the statements between a
    ``.capture_begin()`` and the next ``.capture_end()`` of one block."""
    out: List[List[ast.stmt]] = []

    def is_call_stmt(st: ast.stmt, attr: str) -> bool:
        return isinstance(st, ast.Expr) and isinstance(st.value, ast.Call) \
            and isinstance(st.value.func, ast.Attribute) \
            and st.value.func.attr == attr

    def block(stmts: List[ast.stmt]) -> None:
        i = 0
        while i < len(stmts):
            st = stmts[i]
            if is_call_stmt(st, "capture_begin"):
                j = i + 1
                while j < len(stmts) and \
                        not is_call_stmt(stmts[j], "capture_end"):
                    j += 1
                out.append(stmts[i + 1:j])
            if isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Call) and \
                            mod.call_name(ctx)[0] in CAPTURE_CTX:
                        out.append(st.body)
                        break
            if not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                for name in ("body", "orelse", "finalbody"):
                    sub = getattr(st, name, None)
                    if isinstance(sub, list) and sub and \
                            isinstance(sub[0], ast.stmt):
                        block(sub)
                for h in getattr(st, "handlers", []) or []:
                    block(h.body)
            i += 1

    block(getattr(fn, "body", []) or [])
    return out


def unwrap(mod: ModuleInfo, expr: ast.AST) -> Tuple[ast.AST, int, Set[str]]:
    """``(callable, positional params bound, keyword params bound)`` of a
    function-valued expression: ``functools.partial(f, a, k=b)`` binds one
    positional and ``k``."""
    bound, kws = 0, set()
    while isinstance(expr, ast.Call) and expr.args and \
            mod.call_name(expr)[0] in PARTIALS:
        bound += len(expr.args) - 1
        kws |= {kw.arg for kw in expr.keywords if kw.arg}
        expr = expr.args[0]
    return expr, bound, kws


class Captures:
    """The capture specs and captured functions of a program."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.specs: Dict[str, CaptureSpec] = {}
        self.fns: Dict[Tuple[str, int, str], CapturedFn] = {}
        self._resolved: Dict[Tuple[int, int], Optional[str]] = {}
        self._nodes: Dict[int, List[ast.AST]] = {}
        self._calls: Dict[int, List[ast.Call]] = {}
        self._seed()
        self._propagate()
        self._roots()
        self._reach()

    # -- resolution ----------------------------------------------------------

    def resolve(self, mod: ModuleInfo, info: FuncInfo, call: ast.Call
                ) -> Optional[str]:
        """Dotted qualname of the package function ``call`` targets."""
        key = (id(call), id(info.node))
        if key not in self._resolved:
            self._resolved[key] = resolve_call(
                self.prog, mod, info, call,
                scope_types(self.prog, mod, info))
        return self._resolved[key]

    def resolve_fn(self, mod: ModuleInfo, info: FuncInfo, expr: ast.AST
                   ) -> Optional[str]:
        """Dotted qualname of a function-valued expression."""
        return resolve_call(self.prog, mod, info,
                            ast.Call(func=expr, args=[], keywords=[]),
                            scope_types(self.prog, mod, info))

    def nodes(self, info: FuncInfo) -> List[ast.AST]:
        """:func:`own_nodes` of a function, computed once."""
        got = self._nodes.get(id(info.node))
        if got is None:
            got = self._nodes[id(info.node)] = list(own_nodes(info.node))
        return got

    def _resolved_calls(self, mod: ModuleInfo, info: FuncInfo
                        ) -> List[ast.Call]:
        """The calls of a function's own body that resolve to a package
        function."""
        got = self._calls.get(id(info.node))
        if got is None:
            got = self._calls[id(info.node)] = [
                n for n in self.nodes(info) if isinstance(n, ast.Call)
                and self.resolve(mod, info, n) is not None]
        return got

    def spec_of_call(self, mod: ModuleInfo, info: FuncInfo, call: ast.Call
                     ) -> Optional[Tuple[str, CaptureSpec, int]]:
        """``(callee, its spec, arg offset)`` for a call of a function
        with a capture spec; the offset is 1 for a method called through
        an attribute."""
        tgt = self.resolve(mod, info, call)
        if tgt is None or tgt not in self.specs:
            return None
        params = _params(self.prog.funcs[tgt][1].node)
        offset = 1 if isinstance(call.func, ast.Attribute) and \
            params[:1] and params[0] in ("self", "cls") else 0
        return tgt, self.specs[tgt], offset

    def argument(self, call: ast.Call, callee: str, param: str,
                 offset: int) -> Optional[ast.AST]:
        """The expression a call passes for ``callee``'s ``param``."""
        for kw in call.keywords:
            if kw.arg == param:
                return kw.value
        params = _params(self.prog.funcs[callee][1].node)
        if param not in params:
            return None
        i = params.index(param) - offset
        if 0 <= i < len(call.args) and \
                not any(isinstance(a, ast.Starred) for a in call.args[:i + 1]):
            return call.args[i]
        return None

    # -- specs ---------------------------------------------------------------

    def _functions(self):
        for qual, (mod, info) in self.prog.funcs.items():
            if isinstance(info.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield qual, mod, info

    def _seed(self) -> None:
        for qual, mod, info in self._functions():
            spec = _marker_spec(mod, info) or CaptureSpec()
            params = set(_params(info.node))
            for region in _regions(mod, info.node):
                for st in region:
                    for node in ast.walk(st):
                        if isinstance(node, ast.Call) and \
                                isinstance(node.func, ast.Name) and \
                                node.func.id in params:
                            spec.fns.setdefault(node.func.id, 0)
            if spec.state() != CaptureSpec().state():
                self.specs[qual] = spec

    def _propagate(self) -> None:
        for _round in range(10):
            changed = False
            for qual, mod, info in self._functions():
                before = self.specs.get(qual)
                spec = CaptureSpec(dict(before.fns), before.key,
                                   before.pool) if before else CaptureSpec()
                self._propagate_one(mod, info, spec)
                if spec.state() != (before or CaptureSpec()).state():
                    self.specs[qual] = spec
                    changed = True
            if not changed:
                break

    def _propagate_one(self, mod: ModuleInfo, info: FuncInfo,
                       spec: CaptureSpec) -> None:
        params = _params(info.node)
        pooled: Set[str] = set()
        for node in self._resolved_calls(mod, info):
            got = self.spec_of_call(mod, info, node)
            if got is None:
                continue
            callee, cspec, offset = got
            for p, bound in cspec.fns.items():
                arg = self.argument(node, callee, p, offset)
                if arg is None:
                    continue
                inner, extra, _kws = unwrap(mod, arg)
                if isinstance(inner, ast.Lambda):
                    body = inner.body
                    if isinstance(body, ast.Call) and \
                            isinstance(body.func, ast.Name) and \
                            body.func.id in params:
                        spec.fns.setdefault(body.func.id, 0)
                elif isinstance(inner, ast.Name) and inner.id in params:
                    n = bound + extra
                    if spec.fns.get(inner.id, n) >= n:
                        spec.fns[inner.id] = n
            if cspec.key is not None and spec.key is None:
                arg = self.argument(node, callee, cspec.key, offset)
                for n in ast.walk(arg) if arg is not None else ():
                    if isinstance(n, ast.Name) and n.id in params:
                        spec.key = n.id
                        break
        if spec.pool:
            return
        for node in self.nodes(info):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    self._pools(mod, info, node.value):
                pooled |= {t.id for t in node.targets
                           if isinstance(t, ast.Name)}
        for node in self.nodes(info):
            if isinstance(node, ast.Return) and node.value is not None:
                v = node.value
                if (isinstance(v, ast.Call) and self._pools(mod, info, v)) \
                        or (isinstance(v, ast.Name) and v.id in pooled):
                    spec.pool = True
                    return

    def _pools(self, mod: ModuleInfo, info: FuncInfo, call: ast.Call
               ) -> bool:
        got = self.spec_of_call(mod, info, call)
        return got is not None and got[1].pool

    # -- captured functions --------------------------------------------------

    def _add(self, cf: CapturedFn) -> bool:
        key = (cf.mod.path, getattr(cf.node, "lineno", 0),
               cf.info.qualname if not isinstance(
                   cf.node, (ast.FunctionDef, ast.AsyncFunctionDef))
               else cf.node.name)
        prev = self.fns.get(key)
        if prev is not None and (prev.tensor_params is not None
                                 or cf.tensor_params is None):
            return False
        self.fns[key] = cf
        return True

    def _roots(self) -> None:
        for qual, mod, info in self._functions():
            params = set(_params(info.node))
            for region in _regions(mod, info.node):
                if region:
                    node = ast.Module(body=region, type_ignores=[])
                    node.lineno = region[0].lineno
                    self._add(CapturedFn(mod, info, node, None,
                                         "capture region"))
            for node in self.nodes(info):
                if not isinstance(node, ast.Call):
                    continue
                got = self.spec_of_call(mod, info, node)
                if got is None:
                    continue
                callee, cspec, offset = got
                for p, bound in cspec.fns.items():
                    arg = self.argument(node, callee, p, offset)
                    if arg is not None:
                        self._root(mod, info, arg, bound, params,
                                   f"captured by {short(callee)}")
        for mod in self.prog.modules:
            for cls_qual, cls in mod.classes.items():
                if not is_module_class(cls):
                    continue
                for info in mod.funcs.values():
                    if info.cls == cls.name and \
                            info.parent_qual == cls_qual and \
                            not info.node.name.startswith("__init"):
                        self._add(CapturedFn(mod, info, info.node, None,
                                             "nn.Module method"))

    def _root(self, mod: ModuleInfo, info: FuncInfo, arg: ast.AST,
              bound: int, params: Set[str], why: str) -> None:
        inner, extra, kws = unwrap(mod, arg)
        n = bound + extra
        if isinstance(inner, ast.Lambda):
            names = _params(inner)
            self._add(CapturedFn(mod, info, inner,
                                 set(names[n:]) - kws, why))
            return
        if isinstance(inner, ast.Name) and inner.id in params:
            return  # the caller's parameter: its callers pass the body
        tgt = self.resolve_fn(mod, info, inner)
        if tgt is None:
            return
        tmod, tinfo = self.prog.funcs[tgt]
        names = _params(tinfo.node)
        if names[:1] in (["self"], ["cls"]) and tinfo.cls is not None:
            names = names[1:]
        self._add(CapturedFn(tmod, tinfo, tinfo.node,
                             set(names[n:]) - kws, why))

    def _reach(self) -> None:
        frontier = list(self.fns.values())
        while frontier:
            cf = frontier.pop()
            for node in ast.walk(cf.node):
                if not isinstance(node, ast.Call):
                    continue
                tgt = self.resolve(cf.mod, cf.info, node)
                if tgt is None:
                    continue
                tmod, tinfo = self.prog.funcs[tgt]
                if tmod is not cf.mod or not isinstance(
                        tinfo.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                new = CapturedFn(tmod, tinfo, tinfo.node, None,
                                 f"called from captured "
                                 f"{short(module_name(cf.mod.path))}"
                                 f".{cf.info.qualname}")
                if self._add(new):
                    frontier.append(new)

    def captured(self) -> List[CapturedFn]:
        return list(self.fns.values())


def short(dotted: str) -> str:
    """A dotted name without the package prefix."""
    return dotted.split(".", 1)[1] if "." in dotted else dotted


def of(prog: Program) -> Captures:
    """The program's captures, computed once per program."""
    got = prog.derived.get("captures")
    if got is None:
        got = prog.derived["captures"] = Captures(prog)
    return got
