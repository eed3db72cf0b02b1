"""sdtpu-lint core: file walking, AST indexing, and shared resolution helpers.

Everything here is pure-AST (``ast`` + ``tokenize`` only): the analyzer must
run inside tier-1 on a CPU-only box with no GPU, without torch, and with no
imports of the code under analysis. Rule modules (purity / recompile /
envrules / locks) consume the ``ModuleInfo`` index built here and emit
``Finding`` records.

Conventions recognized in source comments (ANALYSIS.md for the carried
rules; README's port section for the capture rules):

- ``# guarded-by: <lockname>`` on a ``self.<attr> = ...`` line (or the line
  above it) declares that attribute protected by ``self.<lockname>``.
- ``# sdtpu-lint: captures(fn, key=tag, pool)`` on a ``def`` line (or the
  line above) declares that the function captures its ``fn`` parameter
  into a CUDA graph keyed by ``tag`` and returns the replay's output,
  which lies in the graphs' pool: the counterpart of the JAX package's
  ``traced`` / ``jitted(static=...)`` / ``donated`` markers, for a capture
  that goes through a call the resolver cannot follow (``GraphCache.run``
  reaches its backend's ``capture`` through an untyped attribute).
"""

from __future__ import annotations

import ast
import io
import os
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

PACKAGE = "stable_diffusion_webui_distributed_tpu_torch"

#: Rule identifiers (documented in ANALYSIS.md).
RULES = {
    "TP001": "host nondeterminism inside a CUDA-graph captured function",
    "TP002": "host read of a tensor's value inside a captured function",
    "TP003": "mutation of closed-over Python state inside a captured "
             "function",
    "RC001": "request/env-derived value in a CUDA-graph capture key",
    "RC002": "captured function closes over a request/env-derived value "
             "its capture key does not name",
    "RC003": "raw precision read outside pipeline/precision.py resolution",
    "EV001": "raw os.environ read outside runtime/config.py",
    "OB001": "time.time() used for a duration on a serving/pipeline/obs path",
    "OB002": "ad-hoc Prometheus metric name outside the central registry",
    "OB003": "journal event literal outside the registered event set",
    "OB004": "alert-rule registration outside the obs/alerts.py registry",
    "OB005": "outbound network call in obs/ outside "
             "federation/notify/stitch",
    "LK001": "guarded attribute accessed without holding its lock",
    "LK002": "guarded-by annotation names an unknown lock",
    "LK003": "lock-acquisition-order inversion",
    "LK004": "blocking device/network/time call while holding a lock",
    "LK005": "lock-order cycle reachable from thread entry points "
             "(potential deadlock)",
    "AT001": "check-then-act across a re-acquired lock "
             "(atomicity violation)",
    "TH001": "raw daemon Thread loop outside runtime/daemon.py",
    "DN001": "graph replay output read after a later replay of its cache",
    "TP004": "tensor of a capture escapes the captured function into self",
    "FL001": "unguarded mutable container in a lock-bearing fleet class",
    "AL001": "allowlist entry expired",
    "AL002": "allowlist entry matched no finding",
    "CA001": "payload hashing or cache-key construction outside "
             "cache/keys.py",
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative posix path
    line: int
    symbol: str  # dotted qualname of the enclosing scope, or "<module>"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.symbol}] {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message}


@dataclass
class FuncInfo:
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    qualname: str
    cls: Optional[str]  # immediately-enclosing class name, if any
    parent_qual: str  # qualname of the enclosing scope ("" for module level)


@dataclass
class ModuleInfo:
    path: str  # repo-relative posix path
    tree: ast.Module
    source: str
    comments: Dict[int, str] = field(default_factory=dict)  # line -> text
    aliases: Dict[str, str] = field(default_factory=dict)  # name -> dotted
    funcs: Dict[str, FuncInfo] = field(default_factory=dict)  # qualname -> info
    classes: Dict[str, ast.ClassDef] = field(default_factory=dict)

    # -- comment conventions -------------------------------------------------

    def marker(self, line: int, prefix: str) -> Optional[str]:
        """Return the comment payload for ``prefix`` on ``line`` or on a
        standalone comment line directly above (a trailing comment on the
        previous statement's line does NOT attach here)."""
        text = self.comments.get(line, "")
        if prefix in text:
            return text.split(prefix, 1)[1].strip()
        text = self.comments.get(line - 1, "")
        if prefix in text:
            lines = self.source.splitlines()
            if 0 < line - 1 <= len(lines) and \
                    lines[line - 2].lstrip().startswith("#"):
                return text.split(prefix, 1)[1].strip()
        return None

    # -- name resolution -----------------------------------------------------

    def dotted(self, node: ast.AST) -> Optional[Tuple[str, bool]]:
        """Flatten Name/Attribute chains to a canonical dotted path using the
        module's import aliases. Returns (path, resolved) where ``resolved``
        is True when the head name is a known import binding."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = parts[0]
        if head in self.aliases:
            return ".".join([self.aliases[head]] + parts[1:]), True
        return ".".join(parts), False

    def call_name(self, call: ast.Call) -> Tuple[str, bool]:
        got = self.dotted(call.func)
        return got if got is not None else ("", False)


def _collect_comments(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenError:
        pass
    return out


def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map every import binding (module-level or nested) to its canonical
    dotted origin: ``import numpy as np`` -> np: numpy; ``from torch.nn
    import functional as F`` -> F: torch.nn.functional."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                bound = a.asname or a.name.split(".")[0]
                target = a.name if a.asname else a.name.split(".")[0]
                out[bound] = target
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _index_scopes(mod: ModuleInfo) -> None:
    def visit(node: ast.AST, scope: List[str], cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(scope + [child.name])
                mod.funcs[qual] = FuncInfo(child, qual, cls, ".".join(scope))
                visit(child, scope + [child.name], None)
            elif isinstance(child, ast.ClassDef):
                qual = ".".join(scope + [child.name])
                mod.classes[qual] = child
                visit(child, scope + [child.name], child.name)
            else:
                visit(child, scope, cls)

    visit(mod.tree, [], None)


def load_module(abs_path: str, rel_path: str) -> Optional[ModuleInfo]:
    try:
        with open(abs_path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=rel_path)
    except (OSError, SyntaxError):
        return None
    mod = ModuleInfo(path=rel_path.replace(os.sep, "/"), tree=tree,
                     source=source, comments=_collect_comments(source),
                     aliases=_collect_aliases(tree))
    _index_scopes(mod)
    return mod


def walk_package(root: str, paths: Optional[Iterable[str]] = None
                 ) -> List[ModuleInfo]:
    """Load every .py file under ``root`` (or the explicit ``paths``, which
    may be files or directories, absolute or root-relative)."""
    files: List[Tuple[str, str]] = []
    if paths:
        for p in paths:
            ap = p if os.path.isabs(p) else os.path.join(root, p)
            if os.path.isdir(ap):
                for dirpath, _dirs, names in os.walk(ap):
                    for n in sorted(names):
                        if n.endswith(".py"):
                            fp = os.path.join(dirpath, n)
                            files.append((fp, os.path.relpath(fp, root)))
            elif ap.endswith(".py"):
                files.append((ap, os.path.relpath(ap, root)))
    else:
        pkg = os.path.join(root, PACKAGE)
        for dirpath, _dirs, names in os.walk(pkg):
            for n in sorted(names):
                if n.endswith(".py"):
                    fp = os.path.join(dirpath, n)
                    files.append((fp, os.path.relpath(fp, root)))
    mods = []
    for abs_path, rel in files:
        mod = load_module(abs_path, rel)
        if mod is not None:
            mods.append(mod)
    return mods


def func_locals(fn: ast.AST) -> set:
    """Parameter and locally-bound names of a function body (no recursion
    into nested defs — their scopes are separate)."""
    names = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            names.add(a.arg)
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)

    def scan(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                names.add(child.name)
                continue  # separate scope
            if isinstance(child, ast.Lambda):
                continue
            if isinstance(child, ast.Name) and isinstance(child.ctx,
                                                          (ast.Store, ast.Del)):
                names.add(child.id)
            elif isinstance(child, (ast.Global, ast.Nonlocal)):
                pass  # declared names are NOT locals
            scan(child)

    body = getattr(fn, "body", None)
    if isinstance(body, list):
        for st in body:
            scan(st)
    elif body is not None:  # Lambda
        scan(fn)
    return names


def declared_nonlocal(fn: ast.AST) -> set:
    """Names declared ``global``/``nonlocal`` directly in this function body
    (not in nested defs)."""
    out = set()

    def scan(node: ast.AST) -> None:
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            out.update(node.names)
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Lambda)):
                scan(child)

    for st in getattr(fn, "body", []) or []:
        scan(st)
    return out
