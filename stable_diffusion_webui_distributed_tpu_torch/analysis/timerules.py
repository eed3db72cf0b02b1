"""OB001: wall-clock ``time.time()`` on latency-measurement paths.

The observability layer (obs/) defines every span, histogram sample, and
stage timing as a host-side ``time.perf_counter()`` interval: monotonic,
unaffected by NTP slews, and the clock Chrome-trace ``ts``/``dur`` fields
are derived from. A stray ``time.time()`` difference on a serving or
pipeline path silently produces durations that can go negative under clock
adjustment and that disagree with every other span in the trace — so inside
the scoped packages the call is flagged wherever it appears.

Genuine wall-clock uses (timestamps for humans, e.g. the flight recorder's
``recorded_at``) opt out with a ``# sdtpu-lint: wallclock`` marker on the
call line or the standalone comment line above.
"""

from __future__ import annotations

import ast
from typing import List

from .core import PACKAGE, Finding, ModuleInfo
from .envrules import _enclosing_symbol

#: Package subtrees where durations feed spans/histograms and time.time()
#: is presumed to be a (buggy) duration measurement. Other paths — config
#: quarantine stamps, allowlist expiry, schedulers comparing deadlines —
#: legitimately want wall-clock and are out of scope.
SCOPED = (
    f"{PACKAGE}/serving/",
    f"{PACKAGE}/pipeline/",
    f"{PACKAGE}/obs/",
)

MARKER_PREFIX = "sdtpu-lint:"
MARKER = "wallclock"


def _exempt(mod: ModuleInfo, line: int) -> bool:
    payload = mod.marker(line, MARKER_PREFIX)
    return payload is not None and MARKER in payload.split()


def check(modules: List[ModuleInfo]) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        if not any(s in mod.path for s in SCOPED):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name, resolved = mod.call_name(node)
            if not (resolved and name == "time.time"):
                continue
            line = node.lineno
            if _exempt(mod, line):
                continue
            findings.append(Finding(
                "OB001", mod.path, line, _enclosing_symbol(mod, line),
                "time.time() on a serving/pipeline/obs path; durations "
                "must use time.perf_counter() (mark genuine wall-clock "
                "timestamps with '# sdtpu-lint: wallclock')"))
    return findings
