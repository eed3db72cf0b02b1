"""Capture-purity rules (TP001/TP002/TP003), retargeted at CUDA graphs.

A CUDA graph records the kernels its body launches once and replays them
after that: the Python body runs at the eager first call and at the
capture, never at a replay. Anything the body does besides enqueueing
device work (reading a clock, drawing from host RNG, mutating closed-over
state, reading a device value back to branch on it) either bakes one value
into every replay or, for a host read, synchronises inside the capture,
which fails it. The serving layer's byte-identical-replay guarantee rests
on captured code being pure; these rules machine-check it.

Captured functions are found by ``analysis/capture.py``: the callable at a
captured position of a call (``GraphCache.run``'s ``fn`` and every wrapper
that passes one on), ``torch.cuda.graph`` bodies and ``capture_begin``
regions, every ``nn.Module`` method, and what those call.

- TP001: host nondeterminism: ``time.*``, ``datetime`` clocks, ``random``,
  ``numpy.random``, ``uuid``, ``os.urandom``, and torch's draws
  (``torch.rand*``, ``torch.randn*``, ``torch.normal`` ...) without a
  ``generator=``. A draw through an explicit generator is the sanctioned
  randomness, as ``jax.random`` is in the JAX package.
- TP002: a host read of a tensor's value: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` anywhere in a captured body, and, where the
  parameters that carry tensors are known (the callable at a captured
  position), a Python branch or ``bool``/``int``/``float`` on one of them.
  Shape, dtype and device introspection, ``is None`` tests and membership
  in an input dict are host facts of the capture's key and fine.
- TP003: mutation of closed-over state (a non-local name, or one declared
  ``global``/``nonlocal``): it happens at the eager call and the capture
  and never at a replay.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from . import callgraph as callgraph_mod
from . import capture as capture_mod
from .capture import CapturedFn
from .core import Finding, ModuleInfo

#: Host-nondeterminism call prefixes (canonical dotted names).
BANNED_PREFIXES = ("numpy.random.", "random.", "secrets.", "time.")
BANNED_EXACT = {
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
    "uuid.uuid4", "uuid.uuid1", "os.urandom",
}
#: torch's draws: host nondeterminism unless a generator is named
TORCH_DRAWS = {
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial", "torch.poisson",
}
#: tensor methods that read a device value back to the host
HOST_READS = {"item", "tolist", "cpu", "numpy"}

#: attributes and calls of a tensor that are host facts of the capture key
SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad", "is_sparse"}
SHAPE_CALLS = {"len", "isinstance", "getattr", "hasattr", "callable", "type",
               "dim", "size", "numel", "stride", "element_size",
               "is_contiguous", "is_floating_point", "get", "keys"}
#: conversions that read a tensor's value
VALUE_CASTS = {"bool", "int", "float"}


# -- TP001 -------------------------------------------------------------------

def _check_host_calls(cf: CapturedFn) -> List[Finding]:
    out = []
    for node in ast.walk(cf.node):
        if not isinstance(node, ast.Call):
            continue
        name, resolved = cf.mod.call_name(node)
        if not resolved:
            continue
        banned = name in BANNED_EXACT or \
            any(name.startswith(p) for p in BANNED_PREFIXES)
        if name in TORCH_DRAWS and \
                not any(kw.arg == "generator" for kw in node.keywords):
            banned = True
        if banned:
            out.append(Finding(
                "TP001", cf.mod.path, node.lineno, cf.symbol,
                f"host-nondeterministic call {name}() inside captured "
                f"function ({cf.why}); every replay repeats the captured "
                f"value — draw through an explicit torch.Generator or pass "
                f"the value in as a per-call input"))
    return out


# -- TP002 -------------------------------------------------------------------

def _tensor_uses(node: ast.AST, tensors: Set[str],
                 mod: ModuleInfo) -> List[ast.Name]:
    """Names in a branch test that would read a tensor's value. Shape,
    dtype and device introspection, None checks and membership in an
    input dict are host facts."""
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops) and \
                all(isinstance(c, ast.Constant) and c.value is None
                    for c in node.comparators):
            return []
        if all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
            return _tensor_uses(node.left, tensors, mod)
    if isinstance(node, ast.Attribute):
        if node.attr in SHAPE_ATTRS:
            return []
        return _tensor_uses(node.value, tensors, mod)
    if isinstance(node, ast.Call):
        name, _res = mod.call_name(node)
        if name.split(".")[-1] in SHAPE_CALLS:
            return []
        out: List[ast.Name] = []
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            out.extend(_tensor_uses(a, tensors, mod))
        return out
    if isinstance(node, ast.Name):
        return [node] if node.id in tensors else []
    out = []
    for child in ast.iter_child_nodes(node):
        out.extend(_tensor_uses(child, tensors, mod))
    return out


def _check_host_reads(cf: CapturedFn) -> List[Finding]:
    out = []

    def flag(line: int, what: str) -> None:
        out.append(Finding(
            "TP002", cf.mod.path, line, cf.symbol,
            f"host read of a tensor ({what}) inside captured function "
            f"({cf.why}): it synchronises inside the capture, which fails "
            f"it or bakes one branch into every replay — keep the decision "
            f"on the device (torch.where) or make it a key of the capture"))

    for node in ast.walk(cf.node):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in HOST_READS and not node.args:
            flag(node.lineno, f".{node.func.attr}()")
    tensors = cf.tensor_params
    if not tensors:
        return out
    for node in ast.walk(cf.node):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            for name in _tensor_uses(node.test, tensors, cf.mod):
                flag(name.lineno, f"a branch on '{name.id}'")
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in VALUE_CASTS:
            for a in node.args:
                for name in _tensor_uses(a, tensors, cf.mod):
                    flag(name.lineno, f"{node.func.id}() of '{name.id}'")
    return out


# -- TP003 -------------------------------------------------------------------

def _check_mutation(cf: CapturedFn) -> List[Finding]:
    local, declared = cf.locals, cf.declared
    out = []

    def base_name(t: ast.AST) -> Optional[ast.Name]:
        while isinstance(t, (ast.Attribute, ast.Subscript)):
            t = t.value
        return t if isinstance(t, ast.Name) else None

    def flag(node: ast.AST, what: str) -> None:
        out.append(Finding(
            "TP003", cf.mod.path, node.lineno, cf.symbol,
            f"mutation of closed-over state ({what}) inside captured "
            f"function ({cf.why}); a captured body runs at the eager call "
            f"and the capture, never at a replay — return the value "
            f"instead"))

    for node in ast.walk(cf.node):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                if t.id in declared:
                    flag(t, f"nonlocal/global '{t.id}'")
            elif isinstance(t, (ast.Attribute, ast.Subscript)):
                base = base_name(t)
                if base is not None and base.id not in local \
                        and base.id not in ("self", "cls"):
                    flag(t, f"'{base.id}' is not local here")
    return out


def check(modules: List[ModuleInfo], prog=None) -> List[Finding]:
    prog = prog if prog is not None else callgraph_mod.build(modules)
    findings: List[Finding] = []
    for cf in capture_mod.of(prog).captured():
        findings.extend(_check_host_calls(cf))
        findings.extend(_check_host_reads(cf))
        findings.extend(_check_mutation(cf))
    return findings
