"""TH001: raw daemon Thread loops must live on runtime/daemon.py.

Five subsystems grew the same hand-rolled shape — ``threading.Thread(
target=..., daemon=True)`` around a ``while not halt:`` loop, with a
private ``_halt`` Event and ad-hoc stop/join conventions. Each copy is
a fresh chance at the classic footguns: forgetting to clear the halt
flag on restart, joining without a timeout, or (worst) naming the flag
``_stop`` and shadowing ``threading.Thread._stop``, which ``join()``
calls internally — a latent hang that only fires on interpreter
shutdown ordering. ``runtime/daemon.py``'s StoppableDaemon is the one
blessed implementation (composition over Thread, uniform
start/stop/join, tick injection for tests); this rule keeps new loops
from growing off it.

Flags:

- a ``threading.Thread(..., daemon=True)`` construction whose resolved
  ``target`` contains a ``while`` loop (a worker *loop*, not a one-off
  background task — single-shot helpers stay legal);
- a ``threading.Thread`` subclass whose ``run()`` contains a ``while``
  loop, daemon or not (subclassing Thread is how the ``_stop`` shadow
  happens).

``runtime/daemon.py`` itself is exempt — it is the implementation.
Honest limit: a target the resolver cannot follow (dynamic dispatch,
``functools.partial``) is not flagged; the rule under-reports rather
than guessing.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from . import callgraph
from .core import Finding, ModuleInfo
from .lockorder import _attr_target, _callable_arg, _name_target

__all__ = ["check"]

_EXEMPT = "runtime/daemon.py"


def _has_while(node: ast.AST) -> bool:
    return any(isinstance(n, ast.While) for n in ast.walk(node))


def _daemon_true(call: ast.Call) -> bool:
    for k in call.keywords:
        if k.arg == "daemon":
            return isinstance(k.value, ast.Constant) and \
                k.value.value is True
    return False


def check(modules: List[ModuleInfo],
          prog: Optional[callgraph.Program] = None) -> List[Finding]:
    if prog is None:
        prog = callgraph.build(modules)
    findings: List[Finding] = []
    for mod in modules:
        if mod.path.endswith(_EXEMPT):
            continue
        # Thread subclasses with a run() loop
        for clsqual, cls in mod.classes.items():
            if not any((got := mod.dotted(base)) is not None and
                       got[0].endswith("threading.Thread")
                       for base in cls.bases):
                continue
            run_info = mod.funcs.get(f"{clsqual}.run")
            if run_info is not None and _has_while(run_info.node):
                findings.append(Finding(
                    "TH001", mod.path, cls.lineno, clsqual,
                    f"{cls.name} subclasses threading.Thread around a "
                    f"run() loop — use runtime/daemon.py StoppableDaemon "
                    f"(uniform start/stop/join, tick injection, no "
                    f"Thread private-attribute shadowing)"))
        # raw daemon Thread(...) constructions with a looping target
        for qual, info in mod.funcs.items():
            if not isinstance(info.node,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            local = prog.local_types(mod, info)
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call):
                    continue
                name, _res = mod.call_name(node)
                if not (name.endswith("threading.Thread")
                        or name == "Thread"):
                    continue
                if not _daemon_true(node):
                    continue
                target = _callable_arg(node, "target", -1)
                tqual: Optional[str] = None
                if isinstance(target, ast.Name):
                    tqual = _name_target(mod, info, target.id)
                elif isinstance(target, ast.Attribute):
                    tqual = _attr_target(mod, info, prog, target, local)
                if tqual is None:
                    continue
                tinfo = mod.funcs.get(tqual)
                if tinfo is not None and _has_while(tinfo.node):
                    findings.append(Finding(
                        "TH001", mod.path, node.lineno, qual,
                        f"raw daemon Thread around looping target "
                        f"'{tqual}' — use runtime/daemon.py "
                        f"StoppableDaemon instead of a hand-rolled "
                        f"halt-flag loop"))
    return findings
