"""Whole-program index: modules, classes, functions, and inferred types.

This is the layer that turned sdtpu-lint from a per-module linter into a
whole-program analyzer. It builds, from nothing but the ASTs that
``core.walk_package`` already loads:

- a **canonical name space**: every module gets its dotted name
  (``stable_diffusion_webui_distributed_tpu_torch.serving.dispatcher``), every
  import — absolute or relative — is resolved against it, and every
  function/class gets a package-unique dotted qualname;
- a **class-attribute type map**: ``self.engine = Engine(...)`` in
  ``__init__``, ``self.fleet: Optional[FleetGate] = None`` annotations,
  ``self.quotas = QuotaLedger.from_env()`` classmethod factories, and
  annotated ctor params (``def __init__(self, engine: Engine)`` followed by
  ``self.engine = engine``) all record "attribute X of class C holds a C2".
  This retires the hand-maintained ``CLASS_HINTS`` table the lock rules
  used to rely on;
- **module-level singleton types**: ``METRICS = DispatchMetrics()`` makes
  ``METRICS`` (and any import of it) a ``DispatchMetrics``;
- a **call graph**: for each function, the set of package functions it may
  call, resolving ``self.method()``, ``self.attr.method()``,
  ``local.method()`` (through per-function local type inference),
  ``module.func()`` and imported names across module boundaries;
- the **import graph** (module -> modules it imports), which the
  ``--changed`` CLI mode uses to re-check dependents of edited files.

Everything stays pure AST. Inference is deliberately conservative: an
attribute assigned two different class types, or anything the resolver
cannot see (dict lookups, factory registries, ``getattr``), yields *no*
type — downstream rules under-report rather than guess.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import FuncInfo, ModuleInfo

#: names that unwrap to their first type argument in annotations
_WRAPPER_TYPES = {"Optional", "Final", "ClassVar", "Annotated"}


def module_name(path: str) -> str:
    """Dotted module name for a repo-relative posix path.

    Fixture files analyzed under spoofed package-relative paths get the
    same treatment as real modules, so cross-module fixtures resolve.
    """
    p = path[:-3] if path.endswith(".py") else path
    parts = [x for x in p.split("/") if x]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclass
class ClassInfo:
    name: str  # bare class name
    qualname: str  # dotted module-level qualname (module.Class)
    mod: ModuleInfo
    node: ast.ClassDef
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> class key
    lock_attrs: Set[str] = field(default_factory=set)


class Program:
    """Package-wide resolution index over a list of ``ModuleInfo``."""

    def __init__(self, modules: List[ModuleInfo]):
        self.modules = modules
        self.by_dotted: Dict[str, ModuleInfo] = {}
        #: module dotted name -> {binding -> canonical dotted origin};
        #: extends ``ModuleInfo.aliases`` with relative imports resolved.
        self.aliases: Dict[str, Dict[str, str]] = {}
        #: bare class name -> ClassInfo (package class names are unique;
        #: a collision keeps the first and drops type info for the rest)
        self.classes: Dict[str, ClassInfo] = {}
        self.class_by_qual: Dict[str, ClassInfo] = {}
        #: dotted function qualname -> (ModuleInfo, FuncInfo)
        self.funcs: Dict[str, Tuple[ModuleInfo, FuncInfo]] = {}
        #: module-level singleton: dotted global name -> bare class name
        self.globals: Dict[str, str] = {}
        #: module dotted name -> set of module dotted names it imports
        self.imports: Dict[str, Set[str]] = {}
        self._callee_cache: Dict[str, Set[str]] = {}
        self._local_cache: Dict[Tuple[int, Optional[str]],
                                Dict[str, str]] = {}
        #: indexes the rule passes derive from this program, computed once
        #: (the capture specs of ``capture.py``)
        self.derived: Dict[str, object] = {}

        for mod in modules:
            dotted = module_name(mod.path)
            self.by_dotted[dotted] = mod
            self.aliases[dotted] = self._module_aliases(mod, dotted)
        self._index_defs()
        self._infer_singletons()
        self._infer_attr_types()
        self._build_import_graph()

    # -- construction --------------------------------------------------------

    def _module_aliases(self, mod: ModuleInfo, dotted: str) -> Dict[str, str]:
        out = dict(mod.aliases)
        pkg_parts = dotted.split(".")[:-1]
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                base = pkg_parts[:len(pkg_parts) - (node.level - 1)] \
                    if node.level > 1 else pkg_parts
                if len(pkg_parts) - (node.level - 1) < 0:
                    continue
                target = ".".join(base + ([node.module] if node.module
                                          else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    out[a.asname or a.name] = f"{target}.{a.name}"
        return out

    def _index_defs(self) -> None:
        for mod in self.modules:
            dotted = module_name(mod.path)
            for qual, info in mod.funcs.items():
                self.funcs[f"{dotted}.{qual}"] = (mod, info)
            for qual, cls in mod.classes.items():
                if "." in qual:
                    continue  # nested class: out of scope
                ci = ClassInfo(cls.name, f"{dotted}.{qual}", mod, cls)
                self.class_by_qual[ci.qualname] = ci
                self.classes.setdefault(cls.name, ci)

    def _infer_singletons(self) -> None:
        for mod in self.modules:
            dotted = module_name(mod.path)
            for st in mod.tree.body:
                if isinstance(st, ast.Assign):
                    targets, value = st.targets, st.value
                elif isinstance(st, ast.AnnAssign) and st.value is not None:
                    targets, value = [st.target], st.value
                else:
                    continue
                key = self._ctor_class(mod, value)
                if key is None:
                    continue
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.globals[f"{dotted}.{t.id}"] = key

    def _ctor_class(self, mod: ModuleInfo, value: ast.AST) -> Optional[str]:
        """Bare class name constructed by ``value``: ``Engine(...)``,
        ``fleet_policy.FleetGate(...)``, or a ``Cls.factory(...)``
        classmethod-style call on a known class."""
        if not isinstance(value, ast.Call):
            return None
        name, _res = mod.call_name(value)
        if not name:
            return None
        tail = name.split(".")[-1]
        if tail in self.classes:
            return tail
        # Cls.from_env() style: second-to-last component is a known class
        parts = name.split(".")
        if len(parts) >= 2 and parts[-2] in self.classes:
            return parts[-2]
        return None

    def _ann_class(self, mod: ModuleInfo, ann: ast.AST) -> Optional[str]:
        """Bare class name an annotation resolves to, unwrapping
        Optional[...]/string forward references."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript):
            head = ann.value
            head_name = head.attr if isinstance(head, ast.Attribute) \
                else head.id if isinstance(head, ast.Name) else ""
            if head_name in _WRAPPER_TYPES:
                inner = ann.slice
                if isinstance(inner, ast.Tuple) and inner.elts:
                    inner = inner.elts[0]
                return self._ann_class(mod, inner)
            return None  # List[...] etc: container, not the class itself
        got = mod.dotted(ann)
        if got is None:
            return None
        tail = got[0].split(".")[-1]
        return tail if tail in self.classes else None

    def _infer_attr_types(self) -> None:
        for ci in self.class_by_qual.values():
            mod = ci.mod
            ambiguous: Set[str] = set()

            def note(attr: str, key: Optional[str]) -> None:
                if key is None or attr in ambiguous:
                    return
                prev = ci.attr_types.get(attr)
                if prev is not None and prev != key:
                    ambiguous.add(attr)
                    del ci.attr_types[attr]
                    return
                ci.attr_types[attr] = key

            # annotated ctor params, so `self.engine = engine` picks up
            # `def __init__(self, engine: Engine)`
            param_ann: Dict[str, str] = {}
            init = self._method_node(ci, "__init__")
            if init is not None:
                for a in (init.args.posonlyargs + init.args.args
                          + init.args.kwonlyargs):
                    if a.annotation is not None:
                        key = self._ann_class(mod, a.annotation)
                        if key:
                            param_ann[a.arg] = key
            for node in ast.walk(ci.node):
                if isinstance(node, ast.AnnAssign):
                    attr = _self_attr(node.target)
                    if attr is not None:
                        note(attr, self._ann_class(mod, node.annotation))
                    continue
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    note(attr, self._value_class(mod, node.value, param_ann))

    def _value_class(self, mod: ModuleInfo, value: ast.AST,
                     param_ann: Dict[str, str]) -> Optional[str]:
        """Class constructed/referenced by an ``__init__`` assignment
        value: a ctor call, an annotated param, a module singleton, or a
        ``a or b or DEFAULT`` chain whose resolvable operands agree."""
        if isinstance(value, ast.BoolOp) and isinstance(value.op, ast.Or):
            keys = {k for v in value.values
                    for k in (self._value_class(mod, v, param_ann),)
                    if k is not None}
            return keys.pop() if len(keys) == 1 else None
        key = self._ctor_class(mod, value)
        if key is not None:
            return key
        if isinstance(value, ast.Name):
            return param_ann.get(value.id) or \
                self.resolve_global(mod, value.id)
        if isinstance(value, ast.Attribute):
            got = self.canonical(mod, value)
            if got is not None and got[1]:
                return self.globals.get(got[0])
        return None

    def _build_import_graph(self) -> None:
        known = set(self.by_dotted)
        for dotted, aliases in self.aliases.items():
            deps: Set[str] = set()
            for origin in aliases.values():
                # origin may be module.symbol; find the longest known
                # module prefix
                parts = origin.split(".")
                for i in range(len(parts), 0, -1):
                    cand = ".".join(parts[:i])
                    if cand in known:
                        deps.add(cand)
                        break
            deps.discard(dotted)
            self.imports[dotted] = deps

    # -- queries -------------------------------------------------------------

    def _method_node(self, ci: ClassInfo, name: str) -> Optional[ast.AST]:
        for item in ci.node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and item.name == name:
                return item
        return None

    def attr_type(self, class_name: str, attr: str) -> Optional[str]:
        ci = self.classes.get(class_name)
        return ci.attr_types.get(attr) if ci else None

    def resolve_global(self, mod: ModuleInfo, name: str) -> Optional[str]:
        """Type of a module-level singleton referenced as ``name`` from
        ``mod`` (local assignment or imported binding)."""
        dotted = module_name(mod.path)
        direct = self.globals.get(f"{dotted}.{name}")
        if direct:
            return direct
        origin = self.aliases.get(dotted, {}).get(name)
        if origin:
            return self.globals.get(origin)
        return None

    def canonical(self, mod: ModuleInfo, node: ast.AST
                  ) -> Optional[Tuple[str, bool]]:
        """Like ``ModuleInfo.dotted`` but with relative imports resolved."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        aliases = self.aliases.get(module_name(mod.path), mod.aliases)
        head = parts[0]
        if head in aliases:
            return ".".join([aliases[head]] + parts[1:]), True
        return ".".join(parts), False

    def local_types(self, mod: ModuleInfo, info: FuncInfo) -> Dict[str, str]:
        """Per-function variable -> bare class name: annotated params,
        ``x = self.attr`` pulls from attr_types, ``x = Cls(...)`` ctor
        calls, and annotated assignments. Reassignment to an unknown type
        clears the binding (conservative). Computed once per function
        and class; callers get a copy."""
        memo_key = (id(info.node), info.cls)
        got = self._local_cache.get(memo_key)
        if got is None:
            got = self._local_cache[memo_key] = self._local_types(mod, info)
        return dict(got)

    def _local_types(self, mod: ModuleInfo, info: FuncInfo
                     ) -> Dict[str, str]:
        fn = info.node
        out: Dict[str, str] = {}
        args = getattr(fn, "args", None)
        if args is not None:
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if a.annotation is not None:
                    key = self._ann_class(mod, a.annotation)
                    if key:
                        out[a.arg] = key

        def visit(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                    continue
                if isinstance(child, ast.Assign) and len(child.targets) == 1 \
                        and isinstance(child.targets[0], ast.Name):
                    tgt = child.targets[0].id
                    key = self.expr_type(mod, info, child.value, out)
                    if key:
                        out[tgt] = key
                    else:
                        out.pop(tgt, None)
                elif isinstance(child, ast.AnnAssign) and \
                        isinstance(child.target, ast.Name):
                    key = self._ann_class(mod, child.annotation)
                    if key:
                        out[child.target.id] = key
                visit(child)

        visit(fn)
        return out

    def expr_type(self, mod: ModuleInfo, info: FuncInfo, expr: ast.AST,
                  local: Optional[Dict[str, str]] = None) -> Optional[str]:
        """Bare class name of ``expr``, or None. Handles ``self``,
        ``self.attr`` (inferred attribute types), local vars/params with
        known types, module singletons, and direct constructor calls."""
        local = local or {}
        if isinstance(expr, ast.Name):
            if expr.id == "self" and info.cls:
                return info.cls
            if expr.id in local:
                return local[expr.id]
            return self.resolve_global(mod, expr.id)
        if isinstance(expr, ast.Attribute):
            base_t = self.expr_type(mod, info, expr.value, local)
            if base_t is not None:
                return self.attr_type(base_t, expr.attr)
            return None
        if isinstance(expr, ast.Call):
            return self._ctor_class(mod, expr)
        return None

    def resolve_call(self, mod: ModuleInfo, info: FuncInfo, call: ast.Call,
                     local: Optional[Dict[str, str]] = None
                     ) -> Optional[str]:
        """Dotted qualname of the package function a call targets, or
        None when the callee is outside the package / not resolvable."""
        fn = call.func
        dotted = module_name(mod.path)
        if isinstance(fn, ast.Name):
            # nested def / sibling in enclosing scope, then module scope
            scope = info.qualname
            while True:
                cand = f"{scope}.{fn.id}" if scope else fn.id
                if cand in mod.funcs:
                    return f"{dotted}.{cand}"
                if "." not in scope:
                    break
                scope = scope.rsplit(".", 1)[0]
            origin = self.aliases.get(dotted, {}).get(fn.id)
            if origin and origin in self.funcs:
                return origin
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        # method call through a typed expression
        base_t = self.expr_type(mod, info, fn.value, local)
        if base_t is not None:
            ci = self.classes.get(base_t)
            if ci is not None:
                tgt = f"{module_name(ci.mod.path)}.{ci.name}.{fn.attr}"
                if tgt in self.funcs:
                    return tgt
            return None
        # module.func() through an imported module binding
        got = self.canonical(mod, fn)
        if got is not None and got[1] and got[0] in self.funcs:
            return got[0]
        return None

    def callees(self, qualname: str) -> Set[str]:
        """Resolvable package callees of one function (cached)."""
        got = self._callee_cache.get(qualname)
        if got is not None:
            return got
        out: Set[str] = set()
        entry = self.funcs.get(qualname)
        if entry is not None:
            mod, info = entry
            local = self.local_types(mod, info)
            for node in ast.walk(info.node):
                if isinstance(node, ast.Call):
                    tgt = self.resolve_call(mod, info, node, local)
                    if tgt is not None and tgt != qualname:
                        out.add(tgt)
        self._callee_cache[qualname] = out
        return out

    def dependents(self, changed_paths: Set[str]) -> Set[str]:
        """Transitive closure of modules importing any changed module;
        returns repo-relative paths (changed paths included)."""
        changed_mods = {module_name(p) for p in changed_paths}
        rev: Dict[str, Set[str]] = {}
        for src, deps in self.imports.items():
            for d in deps:
                rev.setdefault(d, set()).add(src)
        frontier = [m for m in changed_mods if m in self.by_dotted]
        hit = set(frontier)
        while frontier:
            m = frontier.pop()
            for user in rev.get(m, ()):
                if user not in hit:
                    hit.add(user)
                    frontier.append(user)
        return {self.by_dotted[m].path for m in hit} | set(changed_paths)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def build(modules: List[ModuleInfo]) -> Program:
    return Program(modules)
