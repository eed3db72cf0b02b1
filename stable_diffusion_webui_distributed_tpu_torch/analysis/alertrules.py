"""OB004: alert-rule registration outside the closed obs/alerts.py set.

``obs/alerts.py`` owns the alert-rule registry: the closed rule set is
what makes the chaos-validated recall/false-positive gate meaningful —
``bench.py --alerts`` labels its phases against rule names it knows, the
journal vocabulary pins ``alert_firing``/``alert_resolved`` payload
shapes, and ``sdtpu_alert_state{rule}`` label cardinality stays bounded.
A ``register_rule`` call anywhere else silently grows the evaluated set
without the gate ever exercising the new detector, so this rule flags
any ``register_rule(...)`` / ``AlertRule(...)`` registration spelled
outside the registry module.

Constructing an :class:`AlertRule` alone is fine anywhere (tests build
throwaway rules constantly); only handing one to ``register_rule`` is
confined. A deliberate out-of-module registration (e.g. a deployment
plugin) opts out with ``# sdtpu-lint: alert`` on the line or the
standalone comment line above, same marker discipline as OB001/EV001.

The rule also checks ``severity=`` literals on *any* ``AlertRule(...)``
construction against the closed page/warn/info set: severity drives the
notifier's channel routing (SDTPU_NOTIFY_ROUTES keys are severities),
so a misspelled literal silently routes a paging alert to no channel at
all. The runtime ``__post_init__`` raises too, but only when the rule
is built — a plugin module's rogue literal should fail lint, not the
first deploy.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .core import Finding, ModuleInfo
from .envrules import _enclosing_symbol

MARKER_PREFIX = "sdtpu-lint:"
MARKER = "alert"

#: The module that owns the rule registry; everything inside it is exempt.
REGISTRY_MODULE = "obs/alerts.py"

#: The confined registration entry point (any dotted spelling).
REGISTRATION_CALLS = ("register_rule",)

#: The closed severity set — must mirror ``obs.alerts.SEVERITIES``
#: (the analysis passes are AST-only and never import the package).
SEVERITIES = frozenset({"page", "warn", "info"})

#: The constructor whose ``severity=`` keyword is checked.
RULE_CONSTRUCTORS = ("AlertRule",)


def _exempt(mod: ModuleInfo, line: int) -> bool:
    payload = mod.marker(line, MARKER_PREFIX)
    return payload is not None and MARKER in payload.split()


def _bad_severity(node: ast.Call) -> Optional[str]:
    """The rogue severity literal of an AlertRule(...) call, if any.

    Only string constants are judged — a computed severity is runtime
    territory (``__post_init__`` raises there)."""
    for kw in node.keywords:
        if kw.arg != "severity":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                and v.value not in SEVERITIES:
            return v.value
    return None


def check(modules: List[ModuleInfo]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        in_registry = mod.path.endswith(REGISTRY_MODULE)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name, _resolved = mod.call_name(node)
            if not name:
                continue
            short = name.rsplit(".", 1)[-1]
            line = node.lineno
            if short in RULE_CONSTRUCTORS:
                bad = _bad_severity(node)
                if bad is not None and not _exempt(mod, line):
                    findings.append(Finding(
                        "OB004", mod.path, line,
                        _enclosing_symbol(mod, line),
                        f"alert severity {bad!r} outside the closed "
                        "page/warn/info set; SDTPU_NOTIFY_ROUTES routes "
                        "by these exact keys, so a rogue literal "
                        "silently un-routes the alert"))
                continue
            if in_registry:
                continue
            if short not in REGISTRATION_CALLS:
                continue
            if _exempt(mod, line):
                continue
            findings.append(Finding(
                "OB004", mod.path, line, _enclosing_symbol(mod, line),
                "alert-rule registration outside obs/alerts.py; add the "
                "rule to the closed registry there so the bench recall "
                "gate exercises it (or mark a deliberate plugin site "
                "with '# sdtpu-lint: alert')"))
    return findings
