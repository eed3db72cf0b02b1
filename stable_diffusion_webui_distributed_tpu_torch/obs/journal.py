"""The request journal: a bounded, append-only log of lifecycle events.

Port of the JAX package's ``obs/journal.py``. Where a span tree says where
a request's time went, the journal records the decisions made about it:
admitted or throttled, which bucket it landed in, leader or follower of a
coalesced group, which worker got which slice, a failed slice requeued
and where, a fault a chaos plan delivered.

Every event carries a monotonically increasing ``seq``, a monotonic
timestamp, the request id, a causal ``parent`` (the previous event of the
same request unless the caller names one) and free-form attributes. The
``received`` event holds the post-``fix_seed`` payload dump and its
:func:`fingerprint`, the anchor a replay re-executes.

Off by default: ``SDTPU_JOURNAL=1`` turns it on (read per event), and
``SDTPU_JOURNAL_MAX`` bounds the ring (events, not requests). :func:`emit`
is a no-op returning None while off, so a call site that builds expensive
attributes (payload dumps) checks :func:`enabled` first. Event types are a
closed set: emitting one outside :data:`EVENTS` raises. The set is the JAX
package's, emit sites of modules the port does not have yet (watchdog,
alerts, notify, federation, push, aot) included, so a journal of either
package reads the same.

The ring drops its oldest events on a run longer than its capacity;
``SDTPU_JOURNAL_SINK=<path>`` spills each evicted event to that file as
one JSON line, and ``SDTPU_JOURNAL_SINK_MAX_MB`` rotates the file once
(to ``<path>.1``) past that size, so ring and sink together keep a
complete record.

Served at ``GET /internal/journal[?request_id=]``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
    env_float,
    env_int,
    env_str,
)

#: The closed set of journal event types: the serving tier first, then the
#: scheduler tier, then the health, chaos, alerting, delivery, push and
#: warm-pool planes (the JAX package's set).
EVENTS = frozenset({
    # serving tier (dispatcher)
    "received",
    "admitted",
    "throttled",
    "degraded",
    "bucketed",
    "coalesced_leader",
    "coalesced_follower",
    "dispatched",
    "preempted",
    "resumed",
    "decoded",
    "merged",
    "completed",
    "failed",
    # caching tier (cache/, emitted by the dispatcher)
    "embed_cache_hit",
    "result_dedupe_hit",
    "prefix_resumed",
    # scheduler tier (World, Job)
    "planned",
    "job_dispatched",
    "job_completed",
    "job_failed",
    "requeued",
    # health / watchdog plane
    "watchdog_stall",
    "worker_state",
    # chaos (sim/chaos.py)
    "fault_injected",
    "fault_cleared",
    # alerting plane
    "alert_firing",
    "alert_resolved",
    # delivery / federation plane
    "notify_sent",
    "notify_failed",
    "notify_dropped",
    "federation_poll_failed",
    # push control plane
    "push_buffer_evicted",
    "push_fallback",
    # artifact store / warm pool (fleet/pool.py)
    "aot_fallback",
    "pool_spawned",
    "pool_retired",
})

DEFAULT_CAPACITY = 4096

#: How many distinct request ids keep a live causal-parent pointer.
_PARENT_INDEX_CAP = 256


def enabled() -> bool:
    """The journal's gate, read per call."""
    return env_flag("SDTPU_JOURNAL", False)


def sink_path() -> str:
    """The spill file of ring-evicted events ("" = none), read per call."""
    return env_str("SDTPU_JOURNAL_SINK", "")


def sink_max_bytes() -> int:
    """The spill file's cap (``SDTPU_JOURNAL_SINK_MAX_MB``); 0 = none.
    Past it the file is renamed to ``<sink>.1`` (replacing an older one)
    and writing starts a fresh file: at most twice the cap on disk."""
    mb = env_float("SDTPU_JOURNAL_SINK_MAX_MB", 0.0)
    return max(0, int(mb * 1024 * 1024))


def fingerprint(obj: Any) -> str:
    """Stable short hash of a JSON-able object (payload dumps)."""
    data = json.dumps(obj, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(data).hexdigest()[:16]


class EventJournal:
    """Bounded, append-only structured event log."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = env_int("SDTPU_JOURNAL_MAX", DEFAULT_CAPACITY)
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self._seq = 0                                      # guarded-by: _lock
        # request id -> seq of its latest event, for causal chaining
        self._last_by_rid: OrderedDict = OrderedDict()     # guarded-by: _lock
        # the sink's state has its own lock: no file write under _lock
        self._sink_lock = threading.Lock()
        self._sink_spilled = 0                             # guarded-by: _sink_lock
        self._sink_bytes = 0                               # guarded-by: _sink_lock
        self._sink_rotations = 0                           # guarded-by: _sink_lock
        self._sink_seen = ""                               # guarded-by: _sink_lock

    def emit(self, event: str, request_id: str,
             parent: Optional[int] = None,
             **attrs: Any) -> Optional[Dict[str, Any]]:
        """Append one event; a no-op returning None while the journal is
        off. ``parent`` defaults to the request's previous event."""
        if not enabled():
            return None
        if event not in EVENTS:
            raise ValueError(f"unregistered journal event {event!r}; "
                             f"add it to obs.journal.EVENTS")
        rid = str(request_id)
        t_mono = time.monotonic()
        sink = sink_path()
        spill = None
        with self._lock:
            self._seq += 1
            if parent is None:
                parent = self._last_by_rid.get(rid)
            entry = {
                "seq": self._seq,
                "event": event,
                "request_id": rid,
                "t_mono": t_mono,
                "parent": parent,
                "attrs": dict(attrs),
            }
            if sink and len(self._events) == self._events.maxlen:
                spill = self._events[0]
            self._events.append(entry)
            self._last_by_rid[rid] = self._seq
            self._last_by_rid.move_to_end(rid)
            while len(self._last_by_rid) > _PARENT_INDEX_CAP:
                self._last_by_rid.popitem(last=False)
        if spill is not None:
            self._spill(sink, spill)
        return entry

    def _spill(self, sink: str, entry: Dict[str, Any]) -> None:
        """Best-effort JSONL append of one evicted event (concurrent
        evictions may land out of seq order; readers sort by seq), the
        file rotated once past :func:`sink_max_bytes`."""
        try:
            line = json.dumps(entry, sort_keys=True, default=str) + "\n"
            cap = sink_max_bytes()
            with self._sink_lock:
                if sink != self._sink_seen:
                    # a new sink path: the cap counts what is already there
                    self._sink_seen = sink
                    try:
                        self._sink_bytes = os.path.getsize(sink)
                    except OSError:
                        self._sink_bytes = 0
                if cap > 0 and self._sink_bytes > 0 \
                        and self._sink_bytes + len(line) > cap:
                    try:
                        os.replace(sink, sink + ".1")
                        self._sink_rotations += 1
                        self._sink_bytes = 0
                    except OSError:
                        pass  # keep appending; rotation is best-effort
                with open(sink, "a", encoding="utf-8") as fh:
                    fh.write(line)
                self._sink_spilled += 1
                self._sink_bytes += len(line)
        except OSError:
            pass

    def sink_status(self) -> Dict[str, Any]:
        """The sink's path and its spill and rotation counts (served in
        ``/internal/sim``)."""
        with self._sink_lock:
            spilled = self._sink_spilled
            nbytes = self._sink_bytes
            rotations = self._sink_rotations
        return {"path": sink_path(), "spilled": spilled,
                "bytes": nbytes, "rotations": rotations}

    def events_for(self, request_id: str) -> List[Dict[str, Any]]:
        """One request's events, in seq order."""
        rid = str(request_id)
        with self._lock:
            return [dict(e) for e in self._events if e["request_id"] == rid]

    def snapshot(self, request_id: Optional[str] = None) -> Dict[str, Any]:
        """The ``/internal/journal`` document."""
        with self._lock:
            if request_id:
                events = [dict(e) for e in self._events
                          if e["request_id"] == str(request_id)]
            else:
                events = [dict(e) for e in self._events]
            total = self._seq
        return {
            "enabled": enabled(),
            "capacity": self.capacity,
            "count": len(events),
            "total_emitted": total,
            "events": events,
        }

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._last_by_rid.clear()
            self._seq = 0
        with self._sink_lock:
            self._sink_spilled = 0
            self._sink_bytes = 0
            self._sink_rotations = 0
            self._sink_seen = ""

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


#: The process-wide journal; its capacity is read once, here.
JOURNAL = EventJournal()


def emit(event: str, request_id: str, parent: Optional[int] = None,
         **attrs: Any) -> Optional[Dict[str, Any]]:
    """:meth:`EventJournal.emit` on :data:`JOURNAL`."""
    return JOURNAL.emit(event, request_id, parent=parent, **attrs)
