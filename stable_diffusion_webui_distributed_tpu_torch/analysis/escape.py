"""Pool-escape rule (TP004), retargeted at CUDA graphs.

A tensor that a captured body allocates lives in the graphs' memory pool
(``runtime/graphs.py``: every entry of a cache shares one pool). The
capture returns it as the entry's output, and the next replay of any entry
may write over it. Stored on ``self`` (or appended to a container there),
it outlives its call and silently changes under the next replay; the
eager call before the capture stores a tensor that the capture then
replaces with a different one.

TP003 already flags mutation of closed-over *locals* and globals inside
captured bodies, but deliberately excludes ``self``/``cls`` bases (module
state set outside the capture is legitimate). TP004 covers exactly that
blind spot, for values that are tensors of the capture:

- ``self.attr = <expr>`` (or ``self.attr[k] = ...``) inside a captured
  function where the expression derives from a tensor parameter (where
  the mapping is known) or from a tensor the body made (a ``torch.*``
  call, or an operation on such a value);
- ``self.attr.append/extend/add/update/setdefault/insert(...)`` with such
  an argument.

Shape, dtype and device introspection (``x.shape``, ``len(x)``) is a host
fact, not a tensor, and never taints.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from . import callgraph as callgraph_mod
from . import capture as capture_mod
from .capture import CapturedFn
from .core import Finding, ModuleInfo
from .purity import SHAPE_ATTRS, SHAPE_CALLS

_MUTATORS = {"append", "extend", "add", "update", "setdefault", "insert"}
#: ``torch.*`` calls that make no tensor
_NOT_TENSORS = ("torch.cuda.", "torch.backends.", "torch.profiler.",
                "torch.device", "torch.Generator", "torch.no_grad",
                "torch.inference_mode", "torch.enable_grad",
                "torch.autocast", "torch.get_", "torch.set_",
                "torch.is_", "torch.finfo", "torch.iinfo")


def _torch_made(mod: ModuleInfo, node: ast.Call) -> bool:
    name, resolved = mod.call_name(node)
    if not resolved or not name.startswith("torch."):
        return False
    if name.startswith("torch.nn.") and \
            not name.startswith("torch.nn.functional."):
        return False
    return not name.startswith(_NOT_TENSORS)


def _tensor_use(node: ast.AST, tainted: Set[str],
                mod: ModuleInfo) -> Optional[str]:
    """Name (or call) of a tensor used *as a value* in ``node``."""
    if isinstance(node, ast.Attribute):
        if node.attr in SHAPE_ATTRS:
            return None  # a host fact
        return _tensor_use(node.value, tainted, mod)
    if isinstance(node, ast.Call):
        name, _res = mod.call_name(node)
        if name.split(".")[-1] in SHAPE_CALLS:
            return None
        if _torch_made(mod, node):
            return f"{name}()"
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            got = _tensor_use(a, tainted, mod)
            if got is not None:
                return got
        return _tensor_use(node.func, tainted, mod) \
            if not isinstance(node.func, ast.Name) else None
    if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
        return node.id if node.id in tainted else None
    for child in ast.iter_child_nodes(node):
        got = _tensor_use(child, tainted, mod)
        if got is not None:
            return got
    return None


def _self_base(t: ast.AST) -> bool:
    while isinstance(t, (ast.Attribute, ast.Subscript)):
        t = t.value
    return isinstance(t, ast.Name) and t.id in ("self", "cls")


def _check_captured(cf: CapturedFn) -> List[Finding]:
    mod, fn = cf.mod, cf.node
    tainted: Set[str] = set(cf.tensor_params or ())

    # two sweeps: propagate through local assignments, so
    # `y = x * sigma; self.cache = y` is still an escape
    for _sweep in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                if _tensor_use(node.value, tainted, mod) is not None:
                    for t in node.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                tainted.add(n.id)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name):
                if _tensor_use(node.value, tainted, mod) is not None:
                    tainted.add(node.target.id)

    out: List[Finding] = []

    def flag(node: ast.AST, where: str, name: str) -> None:
        out.append(Finding(
            "TP004", mod.path, node.lineno, cf.symbol,
            f"tensor '{name}' of the capture escapes the captured function "
            f"({cf.why}) into {where}: it lives in the graphs' pool and the "
            f"next replay overwrites it — return it, or copy it into a "
            f"buffer made outside the capture"))

    for node in ast.walk(fn):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)) and \
                    _self_base(t):
                value = getattr(node, "value", None)
                if value is None:
                    continue
                name = _tensor_use(value, tainted, mod)
                if name is not None:
                    flag(t, f"'{ast.unparse(t)}'", name)
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS and _self_base(node.func.value):
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                name = _tensor_use(a, tainted, mod)
                if name is not None:
                    flag(node, f"'{ast.unparse(node.func.value)}."
                               f"{node.func.attr}(...)'", name)
                    break
    return out


def check(modules: List[ModuleInfo], prog=None) -> List[Finding]:
    prog = prog if prog is not None else callgraph_mod.build(modules)
    findings: List[Finding] = []
    for cf in capture_mod.of(prog).captured():
        findings.extend(_check_captured(cf))
    return findings
