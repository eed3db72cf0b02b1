"""The push control plane (``SDTPU_PUSH``): streaming worker deltas.

Port of the JAX package's ``obs/push.py``. The federation prober
(``obs/federation.py``) learns about remote workers by polling them:
staleness is bounded below by the poll's cadence, each scrape ships the
whole TSDB document again, and a worker's journal never leaves it. This
module turns the flow around:

- **Worker side** (:class:`DeltaBuffer`): a bounded buffer indexed by
  cursor, fed from the worker's own telemetry: journal events, TSDB samples
  of the federated series, and worker-counter totals. Each entry gets the
  next cursor; ``GET /internal/deltas?cursor=N`` (``server/api.py``)
  long-polls and answers everything after N with ``next_cursor``, so a
  consumer that reconnects resumes where it left off, with no loss and no
  duplicate. Past ``SDTPU_PUSH_CURSOR_BUF`` retained entries the oldest is
  evicted; evictions are counted, journaled as ``push_buffer_evicted`` and
  reported as ``lost`` to a cursor that predates the retained window.
- **Master side** (:class:`DeltaSubscriber`, one per worker, each on a
  ``runtime/daemon.py`` ``StoppableDaemon``): long-polls the worker's
  deltas, reconnects with exponential backoff, resumes from its cursor,
  and writes what it reads into the same ``worker:<label>/...`` and
  ``fleet/...`` series the prober fills, so the alert rules and the
  autoscaler's fleet signal do not care which plane fed them. Journal
  entries go to the fleet timeline (``obs/fleetlog.py``) with the
  round-trip-midpoint clock offset (``obs/stitch.py``). A worker that
  answers 404 (the gate off there) demotes its subscriber to the prober's
  fetch and digest (``push_fallback`` journaled).

Staleness keeps the prober's meaning: anchored at the fetch's round-trip
midpoint, stale past :func:`federation.stale_after_s`, so
``worker_metrics_stale`` fires alike under either plane.

Off by default: with ``SDTPU_PUSH`` unset no World registers as the
source, ``/internal/deltas`` answers 404, :func:`tick` returns 0 and no
daemon starts. Nothing in the port starts the daemons by itself (as in the
JAX package).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
    env_float,
    env_int,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.daemon import (
    StoppableDaemon,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    federation,
    stitch,
)

#: Long-poll slice: how long one /internal/deltas request may hold the
#: connection waiting for fresh entries before answering empty.
DEFAULT_WAIT_S = 0.25

#: Hard cap on entries per response (a reconnecting subscriber with an
#: ancient cursor pages through the buffer instead of one giant body).
_MAX_ENTRIES_PER_RESPONSE = 500

#: Reconnect backoff: base * 2**consecutive_failures, capped.
_BACKOFF_BASE_S = 0.05
_BACKOFF_MAX_S = 2.0


def enabled() -> bool:
    """Push gate — re-read per call so tests can flip the env var."""
    return env_flag("SDTPU_PUSH", False)


def cursor_buf() -> int:
    """Worker-side retained-entry depth (SDTPU_PUSH_CURSOR_BUF)."""
    return max(16, env_int("SDTPU_PUSH_CURSOR_BUF", 1024))


def wait_s() -> float:
    """Long-poll hold (SDTPU_PUSH_WAIT_S); the subscriber's fetches and
    the /internal/deltas default both resolve here."""
    return max(0.0, env_float("SDTPU_PUSH_WAIT_S", DEFAULT_WAIT_S))


# -- worker side -------------------------------------------------------------

class DeltaBuffer:
    """Cursor-indexed bounded buffer over the worker's local telemetry.

    Entries are dicts with a ``cursor`` plus a ``kind``: ``journal``
    (one journal event), ``sample`` (one TSDB sample of a federated
    series), or ``counter`` (a worker-counter total that changed).
    :meth:`ingest` pulls from the live sources; :meth:`collect` is the
    ``GET /internal/deltas`` body. Tests feed :meth:`publish` directly.
    """

    def __init__(self, capacity: Optional[int] = None,
                 clock=time.monotonic) -> None:
        self._clock = clock
        self._capacity = capacity
        self._lock = threading.Lock()
        self._entries: Deque[Dict[str, Any]] = deque()  # guarded-by: _lock
        self._next = 1                                 # guarded-by: _lock
        self._evicted = 0                              # guarded-by: _lock
        # source positions (last journal seq / per-series sample time /
        # counter totals already shipped)               guarded-by: _lock
        self._journal_seq = -1
        self._series_pos: Dict[str, float] = {}
        self._counter_last: Dict[str, float] = {}

    def capacity(self) -> int:
        return self._capacity if self._capacity is not None else cursor_buf()

    def publish(self, kind: str, payload: Dict[str, Any]) -> int:
        """Append one entry (assigning its cursor); returns how many
        old entries were evicted to make room."""
        cap = self.capacity()
        with self._lock:
            entry = dict(payload)
            entry["cursor"] = self._next
            entry["kind"] = kind
            self._next += 1
            self._entries.append(entry)
            evicted = 0
            while len(self._entries) > cap:
                self._entries.popleft()
                evicted += 1
            self._evicted += evicted
        return evicted

    # -- source ingestion --------------------------------------------------

    def ingest(self, now: Optional[float] = None) -> int:
        """Pull everything new from the journal, the federated TSDB
        series, and the worker counters; returns how many entries
        landed. Evictions forced by the pass are journaled once (the
        ``push_buffer_evicted`` closed-vocabulary event) so a slow
        consumer's loss is in the decision trail, not just a counter."""
        appended = 0
        evicted = 0
        for kind, payload in self._gather(now):
            evicted += self.publish(kind, payload)
            appended += 1
        if evicted:
            self._journal_eviction(evicted)
        return appended

    def _gather(self, now: Optional[float]) -> List[
            Tuple[str, Dict[str, Any]]]:
        """Snapshot the sources and diff them against the shipped
        positions (positions advance under the lock; the snapshots are
        taken outside it: the sources have their own locks)."""
        out: List[Tuple[str, Dict[str, Any]]] = []
        events: List[Dict[str, Any]] = []
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                journal as obs_journal,
            )

            if obs_journal.enabled():
                events = obs_journal.JOURNAL.snapshot()["events"]
        except Exception:  # noqa: BLE001 — telemetry stays passive
            events = []
        samples: Dict[str, List[Tuple[float, float]]] = {}
        totals: Dict[str, float] = {}
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                tsdb as obs_tsdb,
            )

            if obs_tsdb.enabled():
                for name in federation._REMOTE_SERIES:
                    samples[name] = obs_tsdb.STORE.window(name, 0)
        except Exception:  # noqa: BLE001
            samples = {}
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                prometheus as obs_prom,
            )

            totals = {
                "requests_total":
                    obs_prom.WORKER_COUNTERS["requests"].total(),
                "failures_total":
                    obs_prom.WORKER_COUNTERS["failures"].total(),
            }
        except Exception:  # noqa: BLE001
            totals = {}
        with self._lock:
            for ev in events:
                seq = ev.get("seq", -1)
                if seq > self._journal_seq:
                    self._journal_seq = seq
                    out.append(("journal", {"event": dict(ev)}))
            for name, ring in samples.items():
                pos = self._series_pos.get(name)
                for t, v in ring:
                    if pos is None or t > pos:
                        out.append(("sample", {"name": name,
                                               "t": t, "v": v}))
                        self._series_pos[name] = t
                        pos = t
            for name, total in totals.items():
                last = self._counter_last.get(name)
                if last is None and not total:
                    # a zero initial total carries no signal; don't
                    # spend a cursor on it
                    self._counter_last[name] = total
                    continue
                if last != total:
                    self._counter_last[name] = total
                    out.append(("counter", {"name": name, "total": total}))
        return out

    @staticmethod
    def _journal_eviction(n: int) -> None:
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                journal as obs_journal,
            )

            if obs_journal.enabled():
                obs_journal.emit("push_buffer_evicted", "push-buffer",
                                 evicted=n)
        except Exception:  # noqa: BLE001 — telemetry stays passive
            pass

    # -- the endpoint body -------------------------------------------------

    def collect(self, cursor: int, hold_s: float = 0.0,
                max_entries: int = _MAX_ENTRIES_PER_RESPONSE,
                ) -> Dict[str, Any]:
        """The ``GET /internal/deltas?cursor=N`` document: every entry
        after ``cursor`` (bounded), the buffer's ``next_cursor``, how
        many entries the consumer's cursor can no longer reach
        (``lost`` — evicted before it fetched), and a ``clock_us``
        sample for the subscriber's RTT-midpoint clock correction.
        Long-polls up to ``hold_s`` when nothing is pending."""
        cursor = max(0, int(cursor))
        deadline = self._clock() + max(0.0, hold_s)
        while True:
            self.ingest()
            with self._lock:
                entries = [dict(e) for e in self._entries
                           if e["cursor"] > cursor][:max_entries]
                next_cursor = self._next - 1
                evicted_total = self._evicted
                oldest = self._entries[0]["cursor"] if self._entries \
                    else None
            if entries or self._clock() >= deadline:
                break
            # idle long-poll slice: re-ingest on a short cadence (no
            # lock held across the sleep)
            time.sleep(min(0.02, max(0.001, deadline - self._clock())))
        if oldest is not None:
            lost = max(0, oldest - cursor - 1)
        else:
            lost = max(0, next_cursor - cursor)
        return {
            "enabled": enabled(),
            "next_cursor": next_cursor,
            "evicted_total": evicted_total,
            "lost": lost,
            "clock_us": self._clock() * 1e6,
            "entries": entries,
        }

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"retained": len(self._entries),
                    "next_cursor": self._next - 1,
                    "evicted_total": self._evicted}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._next = 1
            self._evicted = 0
            self._journal_seq = -1
            self._series_pos.clear()
            self._counter_last.clear()


#: Process-wide buffer behind GET /internal/deltas.
BUFFER = DeltaBuffer()


def serve_deltas(cursor: int = 0,
                 hold_s: Optional[float] = None) -> Dict[str, Any]:
    """Module-level endpoint body; the API layer 404s with the gate off
    (so a push-preferring master falls back to polling this node)."""
    if hold_s is None:
        hold_s = wait_s()
    return BUFFER.collect(cursor, hold_s=hold_s)


# -- master side -------------------------------------------------------------

def _subscribable(worker: Any) -> bool:
    """A worker the push plane can stream from: its backend has an
    in-process fetch (``push_fetch``) or anything the federation prober
    could poll (a 404 demotes it to polling)."""
    backend = getattr(worker, "backend", None)
    if backend is None:
        return False
    if callable(getattr(backend, "push_fetch", None)):
        return True
    return federation._pollable(worker)


class DeltaSubscriber:
    """One worker's delta stream -> the local TSDB + fleet timeline.

    ``poll_once`` is one fetch/apply cycle (a caller drives it directly
    with an explicit clock); :meth:`start`/:meth:`stop` run it on
    a StoppableDaemon whose period stretches with the reconnect backoff.
    After a 404 the subscriber *falls back to polling* this worker with
    the federation prober's own fetch + digest — same series, higher
    staleness.
    """

    def __init__(self, label: str, backend: Any, store=None,
                 clock=time.monotonic, manager: Optional[Any] = None,
                 ) -> None:
        self.label = str(label)
        self.backend = backend
        self._store = store
        self._clock = clock
        self._manager = manager
        self._lock = threading.Lock()
        self.mode = "push"                             # guarded-by: _lock
        self.cursor = 0                                # guarded-by: _lock
        self._failures_row = 0       # consecutive; guarded-by: _lock
        self._st: Dict[str, Any] = {                   # guarded-by: _lock
            "first_seen": None, "last_ok": None, "rtt_s": None,
            "last_error": None, "polls": 0, "failures": 0}
        self._applied = 0                              # guarded-by: _lock
        self._duplicates = 0                           # guarded-by: _lock
        self._lost = 0                                 # guarded-by: _lock
        self._fallbacks = 0                            # guarded-by: _lock
        self._offset_s: Optional[float] = None         # guarded-by: _lock
        self._counters: Dict[str, float] = {}          # guarded-by: _lock
        self._row: Dict[str, float] = {}               # guarded-by: _lock
        self._daemon = StoppableDaemon(
            f"sdtpu-push-{self.label}", self._daemon_tick, self._period,
            immediate=True)

    def store(self):
        if self._store is not None:
            return self._store
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            tsdb as obs_tsdb,
        )

        return obs_tsdb.STORE

    # -- daemon plumbing ---------------------------------------------------

    def _period(self) -> float:
        with self._lock:
            failures = self._failures_row
        if failures:
            return min(_BACKOFF_MAX_S, _BACKOFF_BASE_S * (2 ** failures))
        # the long-poll hold paces the loop; the period only bounds the
        # idle re-check latency
        return max(0.01, _BACKOFF_BASE_S)

    def _daemon_tick(self) -> None:
        try:
            self.poll_once()
        except Exception:  # noqa: BLE001 — the stream must survive
            pass

    def start(self) -> None:
        self._daemon.start()

    def stop(self, timeout_s: float = 2.0) -> bool:
        return self._daemon.stop(timeout_s=timeout_s)

    def alive(self) -> bool:
        return self._daemon.alive()

    # -- fetch -------------------------------------------------------------

    def _fetch(self, cursor: int) -> Tuple[Dict[str, Any], float, float]:
        """(doc, t0, t1): one bracketed delta fetch. ``push_fetch`` is an
        in-process fetch (tests); the HTTP path carries the plane's
        timeout, at least the long-poll's hold. Raises
        ``stitch.HTTPStatusError`` with the status on a non-2xx answer
        (404: fall back to polling)."""
        t0 = self._clock()
        fetcher = getattr(self.backend, "push_fetch", None)
        if callable(fetcher):
            doc = fetcher(cursor)
        else:
            timeout = max(stitch.http_timeout_s(), wait_s() + 0.5)
            doc = stitch.fetch_json(
                self.backend, f"/internal/deltas?cursor={int(cursor)}",
                timeout=timeout)
        return doc, t0, self._clock()

    # -- one cycle ---------------------------------------------------------

    def poll_once(self, now: Optional[float] = None) -> int:
        """One fetch/apply cycle; returns how many entries applied (or
        TSDB samples landed, on the poll-fallback path). Never raises
        out of a fetch failure — the failure is bookkept and the series
        records staleness growth instead."""
        if now is None:
            now = self._clock()
        with self._lock:
            if self._st["first_seen"] is None:
                self._st["first_seen"] = now
            self._st["polls"] += 1
            mode = self.mode
            cursor = self.cursor
        if mode == "poll":
            return self._poll_fallback(now)
        try:
            doc, t0, t1 = self._fetch(cursor)
        except stitch.HTTPStatusError as e:
            if e.status == 404:
                self._demote(now, str(e))
                return self._poll_fallback(now)
            self._note_failure(now, str(e))
            return 0
        except Exception as e:  # noqa: BLE001 — per-node fault isolation
            self._note_failure(now, f"{type(e).__name__}: {e}")
            return 0
        return self._apply(doc, t0, t1, now)

    def _demote(self, now: float, detail: str) -> None:
        """404: the worker predates /internal/deltas (or runs with the
        gate off) — journal once and poll it from here on."""
        with self._lock:
            if self.mode == "poll":
                return
            self.mode = "poll"
            self._fallbacks += 1
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                journal as obs_journal,
            )

            if obs_journal.enabled():
                obs_journal.emit("push_fallback", f"push-{self.label}",
                                 worker=self.label, detail=detail)
        except Exception:  # noqa: BLE001 — telemetry stays passive
            pass

    def _note_failure(self, now: float, detail: str) -> None:
        with self._lock:
            self._failures_row += 1
            self._st["failures"] += 1
            self._st["last_error"] = detail
            anchor = self._st["last_ok"] if self._st["last_ok"] is not None \
                else self._st["first_seen"]
        staleness = max(0.0, now - anchor)
        self.store().record(f"worker:{self.label}/staleness_s",
                            staleness, t=now)
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                journal as obs_journal,
            )

            if obs_journal.enabled():
                obs_journal.emit("federation_poll_failed",
                                 f"federation-{self.label}",
                                 worker=self.label, transport="push",
                                 error=detail)
        except Exception:  # noqa: BLE001 — telemetry stays passive
            pass
        self._after_cycle(now)

    def _apply(self, doc: Dict[str, Any], t0: float, t1: float,
               now: float) -> int:
        """Digest one delta document into the poll prober's series +
        the fleet timeline. Duplicate entries (cursor <= ours — a retry
        that raced its own response) are dropped; a reported ``lost``
        (evicted before we fetched) is accumulated."""
        store = self.store()
        rtt = max(0.0, t1 - t0)
        offset_us, _rtt_us = stitch.clock_offset_us(
            doc, t0 * 1e6, t1 * 1e6)
        offset_s = offset_us / 1e6
        entries = doc.get("entries") or []
        journal_events: List[Dict[str, Any]] = []
        applied = 0
        with self._lock:
            self._failures_row = 0
            self._st["last_ok"] = t0 + rtt / 2.0
            self._st["rtt_s"] = rtt
            self._st["last_error"] = None
            self._offset_s = offset_s
            self._lost += max(0, int(doc.get("lost") or 0))
            cursor = self.cursor
            for e in entries:
                c = int(e.get("cursor") or 0)
                if c <= cursor:
                    self._duplicates += 1
                    continue
                cursor = c
                applied += 1
                kind = e.get("kind")
                if kind == "counter":
                    name = str(e.get("name"))
                    try:
                        self._counters[name] = float(e.get("total"))
                    except (TypeError, ValueError):
                        pass
                elif kind == "journal":
                    ev = e.get("event")
                    if isinstance(ev, dict):
                        journal_events.append(ev)
            self.cursor = cursor
            self._applied += applied
            counters = dict(self._counters)
            row = self._row
            requests = counters.get("requests_total", 0.0)
            failures = counters.get("failures_total", 0.0)
            row["requests_total"] = requests
            row["failures_total"] = failures
            row["error_rate"] = failures / requests if requests > 0 else 0.0
            anchor = self._st["last_ok"]
        # series writes off the lock (the store has its own)
        staleness = max(0.0, now - anchor)
        store.record(f"worker:{self.label}/staleness_s", staleness, t=now)
        store.record(f"worker:{self.label}/poll_rtt_s", rtt, t=now)
        sample_rows: Dict[str, float] = {}
        for e in entries:
            if e.get("kind") != "sample":
                continue
            try:
                t_remote, v = float(e.get("t")), float(e.get("v"))
            except (TypeError, ValueError):
                continue
            name = str(e.get("name"))
            # place the remote sample on the master clock, never in the
            # master's future (an offset estimate can overshoot)
            t_local = min(now, t_remote + offset_s)
            store.record(f"worker:{self.label}/{name}", v, t=t_local)
            sample_rows[name] = v
        with self._lock:
            for name, v in sample_rows.items():
                self._row[name] = v
            self._row.setdefault("queue_wait_p95_s", 0.0)
            row = dict(self._row)
        # prober parity: every row key lands each cycle (a consumer of
        # the series never sees a key-by-key patchwork); samples from
        # this batch already sit on their corrected remote timestamps
        for key, value in row.items():
            if key in sample_rows:
                continue
            store.record(f"worker:{self.label}/{key}", value, t=now)
        if journal_events:
            try:
                from stable_diffusion_webui_distributed_tpu_torch.obs import (
                    fleetlog,
                )

                fleetlog.ingest(self.label, journal_events,
                                offset_s=offset_s)
            except Exception:  # noqa: BLE001 — timeline stays passive
                pass
        self._after_cycle(now)
        return applied

    def _poll_fallback(self, now: float) -> int:
        """The demoted path: one federation-prober-style scrape of this
        worker, recorded into the same series."""
        store = self.store()
        try:
            metrics_text, doc, t0, t1 = federation.fetch_documents(
                self.backend, clock=self._clock)
        except Exception as e:  # noqa: BLE001 — per-node fault isolation
            self._note_failure(now, f"{type(e).__name__}: {e}")
            return 0
        rtt = max(0.0, t1 - t0)
        row = federation.FederationProber._digest(metrics_text, doc)
        row["poll_rtt_s"] = rtt
        with self._lock:
            self._failures_row = 0
            self._st["last_ok"] = t0 + rtt / 2.0
            self._st["rtt_s"] = rtt
            self._st["last_error"] = None
            self._row = dict(row)
            anchor = self._st["last_ok"]
        staleness = max(0.0, now - anchor)
        store.record(f"worker:{self.label}/staleness_s", staleness, t=now)
        landed = 1
        for key, value in row.items():
            store.record(f"worker:{self.label}/{key}", value, t=now)
            landed += 1
        self._after_cycle(now)
        return landed

    def _after_cycle(self, now: float) -> None:
        if self._manager is not None:
            try:
                self._manager.record_fleet(now)
            except Exception:  # noqa: BLE001 — aggregation stays passive
                pass

    # -- views -------------------------------------------------------------

    def staleness_s(self, now: Optional[float] = None) -> float:
        if now is None:
            now = self._clock()
        with self._lock:
            anchor = self._st["last_ok"] if self._st["last_ok"] is not None \
                else (self._st["first_seen"]
                      if self._st["first_seen"] is not None else now)
        return max(0.0, now - anchor)

    def status(self) -> Dict[str, Any]:
        now = self._clock()
        with self._lock:
            st = dict(self._st)
            out = {
                "mode": self.mode,
                "cursor": self.cursor,
                "applied": self._applied,
                "duplicates": self._duplicates,
                "lost": self._lost,
                "fallbacks": self._fallbacks,
                "polls": st["polls"],
                "failures": st["failures"],
                "rtt_s": st["rtt_s"],
                "last_error": st["last_error"],
                "offset_s": self._offset_s,
            }
        out["staleness_s"] = self.staleness_s(now)
        out["stale"] = out["staleness_s"] >= federation.stale_after_s()
        out["daemon"] = self.alive()
        return out


class PushManager:
    """The fleet of subscribers + the ``fleet/...`` aggregate writer.

    One subscriber per pollable worker of the registered source (same
    contract as the federation prober: a World or iterable).
    :meth:`tick` is the deterministic entry point;
    :meth:`start`/:meth:`stop` run every subscriber's daemon.
    """

    def __init__(self, store=None, clock=time.monotonic) -> None:
        self._store = store
        self._clock = clock
        self._lock = threading.Lock()
        self._source: Any = None                       # guarded-by: _lock
        self._subs: Dict[str, DeltaSubscriber] = {}    # guarded-by: _lock
        self._ticks = 0                                # guarded-by: _lock
        self._started = False                          # guarded-by: _lock

    def store(self):
        if self._store is not None:
            return self._store
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            tsdb as obs_tsdb,
        )

        return obs_tsdb.STORE

    def set_source(self, source: Any) -> None:
        with self._lock:
            self._source = source

    def source(self) -> Any:
        with self._lock:
            return self._source

    def _sync_subscribers(self) -> List[DeltaSubscriber]:
        """Create/retire subscribers to mirror the source's pollable
        workers; returns the live list. New subscribers start their
        daemon iff the manager is in started state."""
        source = self.source()
        workers = [w for w in stitch._workers_of(source or [])
                   if _subscribable(w)]
        live: List[DeltaSubscriber] = []
        to_start: List[DeltaSubscriber] = []
        to_stop: List[DeltaSubscriber] = []
        with self._lock:
            seen = set()
            for w in workers:
                label = str(getattr(w, "label", "?"))
                seen.add(label)
                sub = self._subs.get(label)
                if sub is None or sub.backend is not getattr(
                        w, "backend", None):
                    if sub is not None:
                        to_stop.append(sub)
                    sub = DeltaSubscriber(label, w.backend,
                                          store=self._store,
                                          clock=self._clock, manager=self)
                    self._subs[label] = sub
                    if self._started:
                        to_start.append(sub)
                live.append(sub)
            for label in list(self._subs):
                if label not in seen:
                    to_stop.append(self._subs.pop(label))
        for sub in to_stop:
            sub.stop()
        for sub in to_start:
            sub.start()
        return live

    def tick(self, now: Optional[float] = None) -> int:
        """One synchronous cycle over every subscriber; returns how
        many entries/samples applied. No-op (0) with the gate off."""
        if not enabled():
            return 0
        if now is None:
            now = self._clock()
        applied = 0
        for sub in self._sync_subscribers():
            applied += sub.poll_once(now)
        with self._lock:
            self._ticks += 1
        self.record_fleet(now)
        return applied

    def record_fleet(self, now: Optional[float] = None) -> None:
        """The ``fleet/...`` aggregates, from the subscribers' latest
        state — the poll prober's exact shape, so the fleet-scope alert
        rules and the autoscaler signal are plane-agnostic."""
        if now is None:
            now = self._clock()
        with self._lock:
            subs = list(self._subs.values())
        if not subs:
            return
        store = self.store()
        deadline = federation.stale_after_s()
        stale_count = 0
        error_rates: List[float] = []
        p95s: List[float] = []
        failures = 0
        for sub in subs:
            if sub.staleness_s(now) >= deadline:
                stale_count += 1
            with sub._lock:
                row = dict(sub._row)
                failures += sub._st["failures"]
                had_ok = sub._st["last_ok"] is not None
            if not had_ok:
                # never reached: its share of the fleet error rate is 1.0
                error_rates.append(1.0)
                continue
            error_rates.append(row.get("error_rate", 0.0))
            p95s.append(row.get("queue_wait_p95_s", 0.0))
        local_p95 = 0.0
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                prometheus as obs_prom,
            )

            local_p95 = obs_prom.fleet_queue_wait_p95()
        except Exception:  # noqa: BLE001 — aggregation stays passive
            pass
        for name, value in (
                ("fleet/queue_wait_p95_s", max([local_p95] + p95s)),
                ("fleet/error_rate",
                 sum(error_rates) / len(error_rates) if error_rates
                 else 0.0),
                ("fleet/worker_stale_count", float(stale_count)),
                ("fleet/poll_failures_total", float(failures))):
            store.record(name, value, t=now)

    def start(self) -> bool:
        """Start every subscriber's daemon (idempotent); False with the
        gate off."""
        if not enabled():
            return False
        with self._lock:
            self._started = True
        for sub in self._sync_subscribers():
            sub.start()
        return True

    def stop(self) -> None:
        with self._lock:
            self._started = False
            subs = list(self._subs.values())
        for sub in subs:
            sub.stop()

    def summary(self) -> Dict[str, Any]:
        """The ``GET /internal/push`` document."""
        with self._lock:
            subs = dict(self._subs)
            ticks = self._ticks
        workers = {label: sub.status() for label, sub in subs.items()}
        return {
            "enabled": enabled(),
            "cursor_buf": cursor_buf(),
            "wait_s": wait_s(),
            "ticks": ticks,
            "buffer": BUFFER.stats(),
            "event_loss": sum(w["lost"] for w in workers.values()),
            "duplicates": sum(w["duplicates"] for w in workers.values()),
            "workers": workers,
        }


#: The process-wide manager. A World registers itself as the source at
#: construction when the gate is on (``scheduler/world.py``); a caller may
#: also :func:`set_source` and :func:`tick` directly.
PUSH = PushManager()


def set_source(source: Any) -> None:
    """Register the subscriber fleet's worker source."""
    PUSH.set_source(source)


def source() -> Any:
    return PUSH.source()


def tick(now: Optional[float] = None) -> int:
    """One gated subscriber sweep; 0 with SDTPU_PUSH off."""
    return PUSH.tick(now=now)


def start_daemons() -> bool:
    """Start the per-worker subscriber daemons; False with the gate
    off."""
    return PUSH.start()


def stop_daemons() -> None:
    PUSH.stop()


def reset() -> None:
    """Stop every daemon and rebuild the manager + the worker-side
    buffer (between tests or phases); the source registration does not
    survive: a World registers at its construction."""
    global PUSH
    PUSH.stop()
    PUSH = PushManager()
    BUFFER.clear()


def summary() -> Dict[str, Any]:
    """The ``GET /internal/push`` document (served even when off)."""
    return PUSH.summary()
