"""Alert notification delivery (``SDTPU_NOTIFY_URL`` /
``SDTPU_NOTIFY_ROUTES``).

Port of the JAX package's ``obs/notify.py``. The alert engine
(``obs/alerts.py``) hands every firing and resolved transition here; it
is routed by its severity to a channel, queued on that channel's bounded
queue, and a drain thread POSTs one JSON document per transition to the
channel's webhook.

Routing: ``SDTPU_NOTIFY_ROUTES`` maps severities, and tenant-scoped
overrides, to URLs: ``page=<url1>,warn=<url2>`` sends pages to url1 and
warnings to url2, and ``tenantA:page=<url3>`` overrides the page route for
transitions that carry ``tenant="tenantA"``. The lookup goes
``tenant:severity``, then ``severity``, then the ``SDTPU_NOTIFY_URL``
default channel; a transition with none of them is not queued.

Delivery, per channel:

- off the alert engine's thread, and never under a lock: the queue
  hand-off is the only locked region; the POST, its retries and the
  backoff sleeps run on the drain thread with no lock held;
- ``_MAX_ATTEMPTS`` tries per transition with exponential backoff
  (``_BACKOFF_BASE_S * 2**attempt``); one that exhausts them counts as
  failed and is not queued again;
- a (channel, rule, event) transition queued within
  ``SDTPU_NOTIFY_DEDUP_S`` seconds of the same one is dropped as
  ``deduped``;
- past ``_MAX_QUEUE`` undelivered transitions a channel drops the newest
  (``dropped``, journaled as ``notify_dropped``).

Every outcome counts ``sdtpu_notify_total{channel,outcome}``, and the
journal (when on) gets ``notify_sent`` / ``notify_failed`` /
``notify_dropped`` without the URL (a webhook URL may hold a token). The
POST's timeout is the plane's ``SDTPU_OBS_HTTP_TIMEOUT_S``
(``obs/stitch.py``).

Off by default: with both knobs empty :func:`notify_transition` returns
before touching a queue, and no thread starts.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
    env_str,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.daemon import (
    StoppableDaemon,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import stitch

#: Undelivered-transition queue depth per channel; the newest transition
#: past it is dropped (paging lag must not grow memory without bound).
_MAX_QUEUE = 256

#: Delivery attempts per transition before it counts as failed.
_MAX_ATTEMPTS = 3

#: Backoff base: sleep ``_BACKOFF_BASE_S * 2**attempt`` between tries.
_BACKOFF_BASE_S = 0.05

#: Idle re-check cadence of the drain daemon; ``wake()`` on enqueue cuts
#: it short, so this only bounds shutdown/straggler latency.
_DRAIN_PERIOD_S = 0.2

DEFAULT_DEDUP_S = 60.0

#: Channel name of the single-URL (SDTPU_NOTIFY_URL) route.
DEFAULT_CHANNEL = "default"


def enabled() -> bool:
    """Notify gate — any configured route arms delivery."""
    return bool(url()) or bool(routes())


def url() -> str:
    """Default-channel webhook endpoint (SDTPU_NOTIFY_URL); '' = none."""
    return env_str("SDTPU_NOTIFY_URL", "")


def routes() -> Dict[str, str]:
    """Severity-routing table (SDTPU_NOTIFY_ROUTES): comma-separated
    ``key=url`` entries where ``key`` is a severity (``page``/``warn``/
    ``info``) or a tenant-scoped override (``tenant:severity``).
    Malformed entries are skipped; URLs must not contain commas."""
    out: Dict[str, str] = {}
    for part in env_str("SDTPU_NOTIFY_ROUTES", "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, target = part.split("=", 1)
        key, target = key.strip(), target.strip()
        if key and target:
            out[key] = target
    return out


def channel_for(severity: str,
                tenant: Optional[str] = None) -> Optional[Tuple[str, str]]:
    """Resolve a transition's (channel name, URL): the tenant-scoped
    route wins, then the severity route, then the SDTPU_NOTIFY_URL
    default channel; None when nothing is configured for it."""
    table = routes()
    sev = str(severity)
    if tenant:
        key = f"{tenant}:{sev}"
        if key in table:
            return key, table[key]
    if sev in table:
        return sev, table[sev]
    base = url()
    if base:
        return DEFAULT_CHANNEL, base
    return None


def dedup_s() -> float:
    """Dedup window: identical (channel, rule, event) transitions inside
    it are dropped instead of delivered twice (SDTPU_NOTIFY_DEDUP_S)."""
    return max(0.0, env_float("SDTPU_NOTIFY_DEDUP_S", DEFAULT_DEDUP_S))


class Notifier:
    """Per-channel bounded queues + one daemon drain thread."""

    def __init__(self, clock=time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        # channel -> FIFO of undelivered items         guarded-by: _lock
        self._queues: Dict[str, Deque[Dict[str, Any]]] = {}
        # (channel, rule, event) -> enqueue time of the last accepted
        self._last_sent: Dict[Any, float] = {}         # guarded-by: _lock
        # channel -> outcome -> count                  guarded-by: _lock
        self._counts: Dict[str, Dict[str, int]] = {}   # guarded-by: _lock
        self._pending = 0                              # guarded-by: _lock
        self._daemon = StoppableDaemon("sdtpu-notify-drain",
                                       self._drain_once, _DRAIN_PERIOD_S,
                                       immediate=True)

    # -- enqueue (alert-engine side; cheap, lock only for the hand-off) ----

    def notify_transition(self, rule: str, event: str, value: Any,
                          detail: str, *, severity: str = "warn",
                          tenant: Optional[str] = None,
                          force: bool = False) -> bool:
        """Route + queue one firing/resolved transition for delivery;
        returns True when it was accepted (not deduped/dropped/gated
        off). ``force=True`` bypasses the env gate: a transition with no
        configured route lands on a channel named by its severity, so the
        queue and drain run without a URL."""
        route = channel_for(severity, tenant)
        if route is None:
            if not force:
                return False
            route = (str(severity) or DEFAULT_CHANNEL, "")
        channel = route[0]
        now = self._clock()
        item = {"rule": str(rule), "event": str(event), "value": value,
                "detail": str(detail), "severity": str(severity),
                "channel": channel}
        if tenant:
            item["tenant"] = str(tenant)
        key = (channel, item["rule"], item["event"])
        rejected = None
        with self._lock:
            q = self._queues.setdefault(channel, deque())
            last = self._last_sent.get(key)
            if last is not None and now - last < dedup_s():
                rejected = "deduped"
            elif len(q) >= _MAX_QUEUE:
                rejected = "dropped"
            else:
                self._last_sent[key] = now
                q.append(item)
                self._pending += 1
            if rejected is not None:
                per = self._counts.setdefault(channel, {})
                per[rejected] = per.get(rejected, 0) + 1
        if rejected is not None:
            _count_outcome(rejected, channel)
            if rejected == "dropped":
                _journal_dropped(item)
            return False
        self._daemon.start()  # idempotent; restart-safe after stop()
        self._daemon.wake()
        return True

    # -- drain daemon (all blocking work lives here, no locks held) --------

    def _next_item(self) -> Optional[Dict[str, Any]]:
        """Pop the head of the first non-empty channel queue, rotating
        that channel to the back so a busy page channel cannot starve
        the warn/info channels."""
        with self._lock:
            for name in list(self._queues):
                q = self._queues[name]
                if q:
                    self._queues[name] = self._queues.pop(name)
                    return q.popleft()
        return None

    def _drain_once(self) -> None:
        """One daemon tick: drain everything queued right now."""
        while not self._daemon.stopped():
            item = self._next_item()
            if item is None:
                return
            delivered, attempts = self._deliver(item)
            outcome = "sent" if delivered else "failed"
            channel = item.get("channel", DEFAULT_CHANNEL)
            with self._lock:
                self._pending -= 1
                per = self._counts.setdefault(channel, {})
                per[outcome] = per.get(outcome, 0) + 1
            _count_outcome(outcome, channel)
            _journal_outcome(item, delivered, attempts)

    def _deliver(self, item: Dict[str, Any]) -> "tuple[bool, int]":
        """POST one transition with retry + exponential backoff; returns
        (delivered, attempts). Runs on the drain thread only — never
        call with any lock held. The URL is re-resolved from the
        routing table at delivery time so env flips apply mid-queue."""
        channel = item.get("channel", DEFAULT_CHANNEL)
        target = routes().get(channel) or (
            url() if channel == DEFAULT_CHANNEL else "")
        if not target:
            return False, 0
        body = dict(item)
        body["ts"] = time.time()  # sdtpu-lint: wallclock — pager-facing
        data = json.dumps(body, sort_keys=True, default=str).encode("utf-8")
        timeout = stitch.http_timeout_s()
        for attempt in range(_MAX_ATTEMPTS):
            if attempt:
                time.sleep(_BACKOFF_BASE_S * (2 ** (attempt - 1)))
            try:
                req = urllib.request.Request(
                    target, data=data,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    if 200 <= resp.status < 300:
                        return True, attempt + 1
            except Exception:  # noqa: BLE001 — delivery is best-effort
                pass
        return False, _MAX_ATTEMPTS

    # -- synchronization + views -------------------------------------------

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until every queued transition has a delivery outcome
        (deterministic tests and phases); False on timeout."""
        deadline = self._clock() + max(0.0, timeout_s)
        while True:
            with self._lock:
                pending = self._pending
            if pending <= 0:
                return True
            if self._clock() >= deadline:
                return False
            self._daemon.wake()
            time.sleep(0.005)

    def stop(self) -> None:
        self._daemon.stop(timeout_s=2.0)

    def counts(self) -> Dict[str, int]:
        """Outcome counts aggregated across channels (the single-channel
        notifier's historical shape)."""
        with self._lock:
            out: Dict[str, int] = {}
            for per in self._counts.values():
                for outcome, n in per.items():
                    out[outcome] = out.get(outcome, 0) + n
            return out

    def counts_by_channel(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {ch: dict(per) for ch, per in self._counts.items()}

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            per_queue = {ch: len(q) for ch, q in self._queues.items()}
            pending = self._pending
            by_channel = {ch: dict(per) for ch, per in self._counts.items()}
        counts: Dict[str, int] = {}
        for per in by_channel.values():
            for outcome, n in per.items():
                counts[outcome] = counts.get(outcome, 0) + n
        channels = {}
        for ch in sorted(set(per_queue) | set(by_channel)):
            channels[ch] = {"queued": per_queue.get(ch, 0),
                            "outcomes": by_channel.get(ch, {})}
        alive = self._daemon.alive()
        return {"enabled": enabled(), "dedup_s": dedup_s(),
                "queued": sum(per_queue.values()), "pending": pending,
                "outcomes": counts, "dropped": counts.get("dropped", 0),
                "draining": alive, "channels": channels}


def _count_outcome(outcome: str, channel: str = DEFAULT_CHANNEL) -> None:
    try:
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            prometheus as obs_prom,
        )

        obs_prom.notify_count(outcome, channel=channel)
    except Exception:  # noqa: BLE001 — telemetry stays passive
        pass


def _journal_outcome(item: Dict[str, Any], delivered: bool,
                     attempts: int) -> None:
    """Journal one delivery outcome (URL deliberately omitted: webhook
    URLs routinely embed tokens and the journal is replayable)."""
    try:
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            journal as obs_journal,
        )

        if obs_journal.enabled():
            obs_journal.emit(
                "notify_sent" if delivered else "notify_failed",
                f"notify-{item.get('rule', '')}",
                rule=item.get("rule"), alert_event=item.get("event"),
                severity=item.get("severity"),
                channel=item.get("channel"), attempts=attempts)
    except Exception:  # noqa: BLE001 — telemetry stays passive
        pass


def _journal_dropped(item: Dict[str, Any]) -> None:
    """Journal one queue-overflow drop (no URL, same token discipline):
    a page that never left the process must be visible in the decision
    trail, not just a counter."""
    try:
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            journal as obs_journal,
        )

        if obs_journal.enabled():
            obs_journal.emit(
                "notify_dropped", f"notify-{item.get('rule', '')}",
                rule=item.get("rule"), alert_event=item.get("event"),
                severity=item.get("severity"),
                channel=item.get("channel"))
    except Exception:  # noqa: BLE001 — telemetry stays passive
        pass


#: The process-wide notifier (the alert engine feeds it); :func:`reset`
#: rebuilds it.
NOTIFIER = Notifier()


def notify_transition(rule: str, event: str, value: Any, detail: str, *,
                      severity: str = "warn",
                      tenant: Optional[str] = None) -> bool:
    """Module-level convenience for :meth:`Notifier.notify_transition`;
    no-op (False) with no route configured for the severity."""
    return NOTIFIER.notify_transition(rule, event, value, detail,
                                      severity=severity, tenant=tenant)


def flush(timeout_s: float = 5.0) -> bool:
    return NOTIFIER.flush(timeout_s)


def reset() -> None:
    """Stop the drain thread and rebuild the notifier."""
    global NOTIFIER
    NOTIFIER.stop()
    NOTIFIER = Notifier()


def summary() -> Dict[str, Any]:
    return NOTIFIER.summary()
