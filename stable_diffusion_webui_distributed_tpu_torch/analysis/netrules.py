"""OB005: outbound-network calls in obs/ outside the sanctioned set.

The observability plane is read-mostly and passive by design — metrics,
traces, journal, TSDB. Exactly four modules are allowed to speak to the
network: ``obs/stitch.py`` (remote trace fetch), ``obs/federation.py``
(the fleet metrics prober), ``obs/notify.py`` (webhook delivery), and
``obs/push.py`` (the delta-stream subscriber). Each of those routes
every call through the single
``SDTPU_OBS_HTTP_TIMEOUT_S`` timeout knob and carries per-node fault
isolation; an HTTP call sneaking into any *other* obs/ module bypasses
both (an unbounded ``urlopen`` inside, say, the alert engine can hang
the evaluation loop on a dead remote).

This rule flags ``urlopen(...)`` and requests-style verb calls
(``requests.get`` / ``session.post`` / ...) inside obs/ modules outside
the sanctioned set. A deliberate exception opts out with
``# sdtpu-lint: netcall`` on the line or the standalone comment line
above, same marker discipline as OB001/OB004/EV001.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, ModuleInfo
from .envrules import _enclosing_symbol

MARKER_PREFIX = "sdtpu-lint:"
MARKER = "netcall"

#: The obs/ modules allowed to make outbound network calls.
SANCTIONED = ("obs/federation.py", "obs/notify.py", "obs/push.py",
              "obs/stitch.py")

#: requests/Session HTTP verb method names.
VERBS = frozenset({"get", "post", "put", "patch", "delete", "head",
                   "request"})

#: Attribute owners whose verb calls count as outbound HTTP.
_HTTP_OWNERS = frozenset({"requests", "session"})


def _in_obs(path: str) -> bool:
    path = path.replace("\\", "/")
    return "/obs/" in path or path.startswith("obs/")


def _exempt(mod: ModuleInfo, line: int) -> bool:
    payload = mod.marker(line, MARKER_PREFIX)
    return payload is not None and MARKER in payload.split()


def _is_net_call(name: str) -> bool:
    parts = name.split(".")
    if parts[-1] == "urlopen":
        return True
    if len(parts) >= 2 and parts[-1] in VERBS \
            and parts[-2] in _HTTP_OWNERS:
        return True
    return False


def check(modules: List[ModuleInfo]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        if not _in_obs(mod.path):
            continue
        if mod.path.replace("\\", "/").endswith(SANCTIONED):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name, _resolved = mod.call_name(node)
            if not name or not _is_net_call(name):
                continue
            line = node.lineno
            if _exempt(mod, line):
                continue
            findings.append(Finding(
                "OB005", mod.path, line, _enclosing_symbol(mod, line),
                "outbound network call in obs/ outside "
                "federation/notify/stitch; route it through one of the "
                "sanctioned modules so the SDTPU_OBS_HTTP_TIMEOUT_S "
                "bound and per-node fault isolation apply (or mark a "
                "deliberate site with '# sdtpu-lint: netcall')"))
    return findings
