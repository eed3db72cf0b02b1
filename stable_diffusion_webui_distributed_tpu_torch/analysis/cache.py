"""Per-module analysis cache + git-scoped reporting for sdtpu-lint.

The cache file (``.sdtpu-torch-lint-cache.json`` at the repo root,
gitignored; its own name, so it never races the JAX lint's cache)
stores one entry per analyzed module, keyed by the sha256 of the module's
content, all salted with a digest of the analyzer's own sources plus the
Python version — editing any rule module or upgrading Python invalidates
everything.

Reuse contract (honest version):

- **All keys hit** → the cached findings are returned without running any
  pass: the repeat-gate case (CI re-runs, pre-commit with no edits) costs
  one hash sweep.
- **Any key misses** → the whole-program passes rerun. Findings are
  whole-program facts (fixed-point taint summaries, the cross-module lock
  graph), so partial reuse of *findings* would be unsound. What IS reused
  on a partial miss is the taint-summary table: summaries for functions in
  unchanged modules (minus import-dependents of the changed set) seed the
  fixed point, so only changed modules + dependents get re-summarized.

``--changed`` mode is a *reporting* scope, not an analysis scope: the full
package is still analyzed (anything less would miss cross-module effects),
then findings are filtered to the git-changed files plus their transitive
import dependents.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, ModuleInfo

CACHE_BASENAME = ".sdtpu-torch-lint-cache.json"
_SALT: Optional[str] = None


def analyzer_salt() -> str:
    """Digest of the analyzer's own source files + Python version: any
    rule change invalidates every cache entry."""
    global _SALT
    if _SALT is not None:
        return _SALT
    h = hashlib.sha256()
    h.update(sys.version.encode())
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    for name in sorted(os.listdir(pkg_dir)):
        if not name.endswith(".py"):
            continue
        try:
            with open(os.path.join(pkg_dir, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
        except OSError:
            continue
    _SALT = h.hexdigest()
    return _SALT


def module_key(mod: ModuleInfo) -> str:
    h = hashlib.sha256()
    h.update(analyzer_salt().encode())
    h.update(mod.path.encode())
    h.update(mod.source.encode())
    return h.hexdigest()


class Cache:
    def __init__(self, root: str):
        self.path = os.path.join(root, CACHE_BASENAME)
        self.data: Dict[str, object] = {}
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and \
                    loaded.get("salt") == analyzer_salt():
                self.data = loaded
        except (OSError, ValueError):
            pass

    # -- lookup --------------------------------------------------------------

    def split(self, modules: List[ModuleInfo]
              ) -> Tuple[Set[str], Dict[str, str]]:
        """(dirty module paths, path -> key). Dirty = content key differs
        from the cached one, or the module is new; modules that vanished
        count as a miss too (their findings may be stale)."""
        keys = {m.path: module_key(m) for m in modules}
        entries = self.data.get("modules", {})
        dirty = {p for p, k in keys.items()
                 if not isinstance(entries, dict)
                 or entries.get(p, {}).get("key") != k}
        if isinstance(entries, dict):
            dirty |= {p for p in entries if p not in keys}
        return dirty, keys

    def cached_findings(self) -> Optional[List[Finding]]:
        raw = self.data.get("findings")
        if not isinstance(raw, list):
            return None
        out = []
        for d in raw:
            try:
                out.append(Finding(d["rule"], d["path"], d["line"],
                                   d["symbol"], d["message"]))
            except (KeyError, TypeError):
                return None
        return out

    def seed_summaries(self, clean_paths: Set[str]) -> Dict[str, Dict]:
        """Serialized FuncSummary fields for functions defined in clean
        modules, used to seed the fixed point."""
        entries = self.data.get("modules", {})
        out: Dict[str, Dict] = {}
        if not isinstance(entries, dict):
            return out
        for p in clean_paths:
            summ = entries.get(p, {}).get("summaries", {})
            if isinstance(summ, dict):
                out.update(summ)
        return out

    # -- store ---------------------------------------------------------------

    def store(self, keys: Dict[str, str], findings: List[Finding],
              summaries_by_path: Dict[str, Dict[str, Dict]]) -> None:
        self.data = {
            "salt": analyzer_salt(),
            "modules": {p: {"key": k,
                            "summaries": summaries_by_path.get(p, {})}
                        for p, k in keys.items()},
            "findings": [f.as_dict() for f in findings],
        }
        try:
            with open(self.path, "w", encoding="utf-8") as f:
                json.dump(self.data, f)
        except OSError:
            pass  # read-only checkout: cache is best-effort


def git_changed_paths(root: str) -> Set[str]:
    """Repo-relative paths of files modified vs HEAD plus untracked files
    (the working-tree view a pre-commit hook cares about)."""
    out: Set[str] = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(args, cwd=root, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            return set()
        if proc.returncode != 0:
            return set()
        out.update(l.strip() for l in proc.stdout.splitlines() if l.strip())
    return {p for p in out if p.endswith(".py")}
