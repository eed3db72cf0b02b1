"""Committed allowlist for accepted findings (AL001/AL002).

Entries match on (rule, path, symbol) — deliberately NOT on line numbers, so
unrelated edits to a file don't invalidate the entry. Every entry must carry
a ``reason``; an optional ``expires`` (ISO date) turns the suppression into
a dated debt: past that date the finding resurfaces AND the stale entry is
reported as AL001. Entries that match nothing are reported as AL002 so the
allowlist can only shrink, never silently rot.

Format (JSON list, committed at analysis/allowlist.json):

    [{"rule": "RC001",
      "path": "stable_diffusion_webui_distributed_tpu_torch/pipeline/engine.py",
      "symbol": "Engine.encode_prompts",
      "reason": "clip_skip is clamped to [0, 12]; bounded cache key",
      "expires": "2026-12-31"}]
"""

from __future__ import annotations

import datetime
import json
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .core import Finding

DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "allowlist.json")


@dataclass
class Entry:
    rule: str
    path: str
    symbol: str
    reason: str
    expires: Optional[str] = None
    index: int = 0

    def matches(self, f: Finding) -> bool:
        return (self.rule == f.rule and self.path == f.path
                and self.symbol == f.symbol)

    def expired(self, today: datetime.date) -> bool:
        if not self.expires:
            return False
        try:
            return datetime.date.fromisoformat(self.expires) < today
        except ValueError:
            return True  # unparseable date = expired, fail safe


def load(path: Optional[str] = None) -> Tuple[List[Entry], str]:
    path = path or DEFAULT_PATH
    if not os.path.exists(path):
        return [], path
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    entries = []
    for i, item in enumerate(raw):
        entries.append(Entry(rule=item["rule"], path=item["path"],
                             symbol=item["symbol"],
                             reason=item.get("reason", ""),
                             expires=item.get("expires"), index=i))
    return entries, path


def apply(findings: List[Finding], entries: List[Entry], list_path: str,
          today: Optional[datetime.date] = None
          ) -> Tuple[List[Finding], List[Finding]]:
    """Partition findings into (reported, suppressed), appending AL001/AL002
    meta-findings about the allowlist itself to the reported set."""
    today = today or datetime.date.today()
    reported: List[Finding] = []
    suppressed: List[Finding] = []
    used = [False] * len(entries)
    for f in findings:
        entry = None
        for e in entries:
            if e.matches(f):
                used[e.index] = True
                entry = e
                break
        if entry is None:
            reported.append(f)
        elif entry.expired(today):
            reported.append(f)
            # the AL001 below explains why the suppression lapsed
        else:
            suppressed.append(f)
    rel = list_path.replace(os.sep, "/")
    for e in entries:
        if e.expired(today) and used[e.index]:
            reported.append(Finding(
                "AL001", rel, e.index + 1, f"{e.rule}:{e.symbol}",
                f"allowlist entry expired {e.expires}; its finding is "
                f"reported again — fix it or renew the entry with a reason"))
        elif not used[e.index]:
            reported.append(Finding(
                "AL002", rel, e.index + 1, f"{e.rule}:{e.symbol}",
                "allowlist entry matched no finding; delete it"))
    return reported, suppressed
