"""The fleet-merged journal timeline (``GET /internal/fleet/timeline``).

Port of the JAX package's ``obs/fleetlog.py``. Each node's journal
(``obs/journal.py``) is a causally chained record on one clock, but a
fan-out request's story spans the master and every worker it touched, each
on its own monotonic clock. This module holds the master's merge:

- :func:`ingest`: the push plane (``obs/push.py`` ``DeltaSubscriber``)
  streams each worker's journal events here with the round-trip-midpoint
  clock offset (``obs/stitch.py``) estimated on the same fetch, so each
  remote time lands on the master's clock: ``t_fleet = t_mono +
  offset_s``. Buffers are bounded per node and deduplicated by ``seq``: a
  batch delivered again after a reconnect is not inserted twice.
- :func:`timeline`: one ordered fleet timeline, the local journal (offset
  0, node ``local``) merged with every streamed worker, by ``t_fleet`` with
  ``(node, seq)`` breaking ties; ``t_fleet`` is clamped monotonic per node
  at ingest, so a later offset estimate cannot reorder a node against
  itself. ``?request_id=`` narrows it to one request: master and worker
  share the request id (``X-SDTPU-Request-Id``), so one filter gives the
  cross-node story.
- :func:`causal_violations`: a child placed before its parent of the same
  node (a broken offset or merge); the document carries their count.

Passive and bounded: nothing here is on the request path, the merge is
linear in the retained events at read time, and with the journal off the
document is empty with ``enabled: false``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_int,
)

#: Node label for the master's own journal in the merged timeline.
LOCAL_NODE = "local"


def capacity() -> int:
    """Per-node retained-event bound (rides SDTPU_JOURNAL_MAX — the
    fleet view never retains more per node than a node itself does)."""
    return max(16, env_int("SDTPU_JOURNAL_MAX", 4096))


def enabled() -> bool:
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        journal as obs_journal,
    )

    return obs_journal.enabled()


class FleetLog:
    """Bounded per-node event buffers + the merge."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # node -> seq -> event row; OrderedDict gives FIFO eviction in
        # seq order (ingest only ever appends higher seqs per node).
        self._nodes: Dict[str, "OrderedDict[int, Dict[str, Any]]"] = {}
        self._offsets: Dict[str, float] = {}           # guarded-by: _lock
        self._last_t_fleet: Dict[str, float] = {}      # guarded-by: _lock
        self._ingested = 0                             # guarded-by: _lock
        self._deduped = 0                              # guarded-by: _lock
        self._evicted = 0                              # guarded-by: _lock

    def ingest(self, node: str, events: List[Dict[str, Any]],
               offset_s: float = 0.0) -> int:
        """Add a batch of one node's journal events, with the clock
        offset that places them on the master clock. Events already
        held (same node+seq — a redelivered batch) are dropped;
        returns how many were new."""
        node = str(node)
        added = 0
        cap = capacity()
        with self._lock:
            ring = self._nodes.setdefault(node, OrderedDict())
            self._offsets[node] = float(offset_s)
            last_t = self._last_t_fleet.get(node)
            for ev in events:
                try:
                    seq = int(ev["seq"])
                    t_mono = float(ev["t_mono"])
                except (KeyError, TypeError, ValueError):
                    continue
                if seq in ring:
                    self._deduped += 1
                    continue
                t_fleet = t_mono + float(offset_s)
                # per-node seq order must survive offset re-estimates:
                # clamp t_fleet monotonic within the node
                if last_t is not None and t_fleet < last_t:
                    t_fleet = last_t
                last_t = t_fleet
                ring[seq] = {
                    "node": node,
                    "seq": seq,
                    "event": str(ev.get("event", "")),
                    "request_id": str(ev.get("request_id", "")),
                    "t_mono": t_mono,
                    "t_fleet": t_fleet,
                    "parent": ev.get("parent"),
                    "attrs": dict(ev.get("attrs") or {}),
                }
                added += 1
                while len(ring) > cap:
                    ring.popitem(last=False)
                    self._evicted += 1
            if last_t is not None:
                self._last_t_fleet[node] = last_t
            self._ingested += added
        return added

    def merged(self, request_id: Optional[str] = None,
               ) -> List[Dict[str, Any]]:
        """The fleet timeline: local journal + every streamed node,
        ordered by ``(t_fleet, node, seq)``."""
        rows: List[Dict[str, Any]] = []
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                journal as obs_journal,
            )

            if obs_journal.enabled():
                local = obs_journal.JOURNAL.snapshot()["events"]
            else:
                local = []
        except Exception:  # noqa: BLE001 — the view stays passive
            local = []
        for ev in local:
            rows.append({
                "node": LOCAL_NODE,
                "seq": ev.get("seq"),
                "event": ev.get("event"),
                "request_id": ev.get("request_id"),
                "t_mono": ev.get("t_mono"),
                "t_fleet": ev.get("t_mono"),
                "parent": ev.get("parent"),
                "attrs": dict(ev.get("attrs") or {}),
            })
        with self._lock:
            for ring in self._nodes.values():
                rows.extend(dict(r) for r in ring.values())
        if request_id is not None:
            rid = str(request_id)
            rows = [r for r in rows if r["request_id"] == rid]
        rows.sort(key=lambda r: (r["t_fleet"], r["node"], r["seq"]))
        return rows

    def nodes(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            out = {}
            for node, ring in self._nodes.items():
                out[node] = {
                    "count": len(ring),
                    "offset_s": self._offsets.get(node, 0.0),
                }
            return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"ingested": self._ingested,
                    "deduped": self._deduped,
                    "evicted": self._evicted}

    def clear(self) -> None:
        with self._lock:
            self._nodes.clear()
            self._offsets.clear()
            self._last_t_fleet.clear()
            self._ingested = 0
            self._deduped = 0
            self._evicted = 0


def causal_violations(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Parent-before-child check over a merged timeline.

    An event whose ``parent`` seq (same node — journal parents are
    node-local) appears *later* in the list is a violation: the merge
    (or a clock offset) placed an effect before its cause. Parents
    missing entirely (evicted from the bounded buffers, or outside a
    ``request_id`` filter) are not violations. Returns one row per
    violation with both positions."""
    pos: Dict[Any, int] = {}
    for i, ev in enumerate(events):
        pos[(ev.get("node"), ev.get("seq"))] = i
    out: List[Dict[str, Any]] = []
    for i, ev in enumerate(events):
        parent = ev.get("parent")
        if parent is None:
            continue
        j = pos.get((ev.get("node"), parent))
        if j is not None and j > i:
            out.append({
                "node": ev.get("node"),
                "seq": ev.get("seq"),
                "event": ev.get("event"),
                "request_id": ev.get("request_id"),
                "parent": parent,
                "child_index": i,
                "parent_index": j,
            })
    return out


#: The process-wide fleet log; the push plane's subscribers feed it.
LOG = FleetLog()


def ingest(node: str, events: List[Dict[str, Any]],
           offset_s: float = 0.0) -> int:
    """Stream one node's journal events into the fleet timeline."""
    return LOG.ingest(node, events, offset_s=offset_s)


def timeline(request_id: Optional[str] = None) -> Dict[str, Any]:
    """The ``GET /internal/fleet/timeline`` document."""
    events = LOG.merged(request_id=request_id)
    violations = causal_violations(events)
    return {
        "enabled": enabled(),
        "nodes": LOG.nodes(),
        "count": len(events),
        "violations": len(violations),
        "violation_rows": violations,
        "events": events,
    }


def reset() -> None:
    """Drop every buffered node (between tests or phases)."""
    global LOG
    LOG = FleetLog()
