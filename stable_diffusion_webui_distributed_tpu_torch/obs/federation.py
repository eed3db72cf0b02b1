"""Fleet-federated metrics (``SDTPU_FEDERATION``): one view of every node.

Port of the JAX package's ``obs/federation.py``. ``/internal/metrics`` and
``/internal/tsdb`` cover one process; this module is the master's prober.
On each :func:`tick` (or on the daemon's cadence, the TSDB sampler's
interval: one clock for the plane) it reads every pollable worker's
``/internal/metrics`` and ``/internal/tsdb`` and records them into the
local TSDB (``obs/tsdb.py``) as

- ``worker:<label>/<series>``: staleness, error rate, queue-wait and e2e
  p95, request and failure totals, the poll's round trip;
- ``fleet/...``: the worst queue-wait p95 of the fleet (this node's own
  included), the mean error rate (an unreachable worker counts 1.0), the
  count of stale workers and the poll failures so far.

:func:`parse_prom_text` reads the port's exposition (``obs/prometheus.py``)
as well as the JAX package's. Faults stay per node: a dead or hung worker
journals one ``federation_poll_failed``, its staleness grows, and the tick
goes on; every fetch has the plane's ``SDTPU_OBS_HTTP_TIMEOUT_S``
(``obs/stitch.py``), and a document is dated at its fetch's round-trip
midpoint, so staleness is the data's age, not the transfer's.

The series feed the fleet-scope alert rules (``worker_metrics_stale``,
``fleet_error_rate``, ``obs/alerts.py``), and :func:`fleet_queue_wait_p95`
gives ``fleet/slices.py`` a fleet-wide scale signal. Served at ``GET
/internal/fleet``.

Off by default: with ``SDTPU_FEDERATION`` unset no World registers as the
source, :func:`tick` returns 0 and no daemon starts. Nothing in the port
starts the daemon by itself (as in the JAX package).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.daemon import (
    StoppableDaemon,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import stitch

#: A worker is stale when its freshest successful poll is older than
#: STALE_FACTOR sampling intervals (floored so a fast test cadence
#: cannot flag a healthy worker between back-to-back ticks).
STALE_FACTOR = 3.0
STALE_FLOOR_S = 0.25

#: Remote series latched per worker from its /internal/tsdb document.
_REMOTE_SERIES: Tuple[str, ...] = ("queue_wait_p95_s", "e2e_p95_s")


def enabled() -> bool:
    """Federation gate — re-read per call so tests can flip the env var."""
    return env_flag("SDTPU_FEDERATION", False)


def stale_after_s() -> float:
    """Freshness deadline for a worker's federated metrics."""
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        tsdb as obs_tsdb,
    )

    return max(STALE_FLOOR_S, STALE_FACTOR * obs_tsdb.interval_s())


def parse_prom_text(text: str) -> Dict[str, float]:
    """Minimal Prometheus text-format digest: family name -> sum of its
    sample values across label sets (enough for counter totals; comments
    and malformed lines are skipped)."""
    out: Dict[str, float] = {}
    for line in (text or "").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(None, 1)
        if len(parts) != 2:
            continue
        try:
            value = float(parts[1])
        except ValueError:
            continue
        name = parts[0].split("{", 1)[0].strip()
        if name:
            out[name] = out.get(name, 0.0) + value
    return out


def _pollable(worker: Any) -> bool:
    """A worker the prober can scrape: its backend has an in-process fetch
    (``fed_fetch``) or an HTTP endpoint (address and port)."""
    backend = getattr(worker, "backend", None)
    if backend is None:
        return False
    if callable(getattr(backend, "fed_fetch", None)):
        return True
    return bool(getattr(backend, "address", None)) \
        and bool(getattr(backend, "port", None))


def fetch_documents(backend: Any, clock=time.monotonic) -> Tuple[
        Optional[str], Optional[Dict[str, Any]], float, float]:
    """(metrics_text, tsdb_doc, t0, t1): one worker's scrape through one
    bracketed fetch window. ``fed_fetch`` is an in-process fetch (tests);
    the HTTP path carries the plane's timeout on every call so a hung
    worker cannot stall the caller. Shared by the poll prober and the
    push plane's per-node poll fallback (``obs/push.py``)."""
    t0 = clock()
    fetcher = getattr(backend, "fed_fetch", None)
    if callable(fetcher):
        metrics_text, tsdb_doc = fetcher()
    else:
        timeout = stitch.http_timeout_s()
        metrics_text = stitch.checked("/internal/metrics", *backend.fetch(
            "/internal/metrics", timeout=timeout))
        tsdb_doc = stitch.fetch_json(backend, "/internal/tsdb",
                                     timeout=timeout)
    return metrics_text, tsdb_doc, t0, clock()


class FederationProber:
    """Per-worker poll state machine + TSDB series writer.

    ``store`` defaults to the live TSDB; tests pass their own
    :class:`~.tsdb.SeriesStore` and drive :meth:`tick` with an explicit
    clock for determinism. ``source`` is a World (``.workers``) or any
    iterable of workers, same contract as obs/stitch.py.
    """

    def __init__(self, source: Any = None, store=None,
                 clock=time.monotonic) -> None:
        self._store = store
        self._clock = clock
        self._lock = threading.Lock()
        self._source = source                          # guarded-by: _lock
        # label -> poll/staleness bookkeeping            guarded-by: _lock
        self._status: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._polls = 0                                # guarded-by: _lock
        self._poll_failures = 0                        # guarded-by: _lock
        self._ticks = 0                                # guarded-by: _lock

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

    # -- one worker ---------------------------------------------------------

    def _fetch(self, backend: Any) -> Tuple[Optional[str],
                                            Optional[Dict[str, Any]],
                                            float, float]:
        """One worker's scrape bracket; see :func:`fetch_documents`."""
        return fetch_documents(backend, clock=self._clock)

    @staticmethod
    def _digest(metrics_text: Optional[str],
                tsdb_doc: Optional[Dict[str, Any]]) -> Dict[str, float]:
        """Flatten one worker's scrape into the per-worker series row."""
        row: Dict[str, float] = {}
        prom = parse_prom_text(metrics_text or "")
        # sdtpu-lint: metric — reads of the remote's registered families
        requests = prom.get("sdtpu_worker_requests_total", 0.0)
        # sdtpu-lint: metric
        failures = prom.get("sdtpu_worker_failures_total", 0.0)
        row["requests_total"] = requests
        row["failures_total"] = failures
        row["error_rate"] = failures / requests if requests > 0 else 0.0
        series = (tsdb_doc or {}).get("series") or {}
        for name in _REMOTE_SERIES:
            entry = series.get(name) or {}
            latest = entry.get("latest") if isinstance(entry, dict) else None
            if isinstance(latest, (list, tuple)) and len(latest) == 2:
                try:
                    row[name] = float(latest[1])
                except (TypeError, ValueError):
                    pass
        row.setdefault("queue_wait_p95_s", 0.0)
        return row

    # -- the tick -----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        """One poll sweep over every pollable worker; returns how many
        TSDB samples landed. No-op (0) with the gate off or no source."""
        if not enabled():
            return 0
        source = self.source()
        if source is None:
            return 0
        if now is None:
            now = self._clock()
        workers = [w for w in stitch._workers_of(source) if _pollable(w)]
        rows: List[Tuple[str, Optional[Dict[str, float]]]] = []
        for w in workers:
            label = str(getattr(w, "label", "?"))
            with self._lock:
                st = self._status.setdefault(label, {
                    "first_seen": now, "polls": 0, "failures": 0,
                    "last_ok": None, "last_error": None, "rtt_s": None,
                    "stale": False})
                st["polls"] += 1
                self._polls += 1
            try:
                metrics_text, doc, t0, t1 = self._fetch(w.backend)
                rtt = max(0.0, t1 - t0)
                row = self._digest(metrics_text, doc)
                row["poll_rtt_s"] = rtt
                with self._lock:
                    # clock-correction pattern (obs/stitch.py): the
                    # document corresponds to the fetch RTT midpoint
                    st["last_ok"] = t0 + rtt / 2.0
                    st["last_error"] = None
                    st["rtt_s"] = rtt
            except Exception as e:  # noqa: BLE001 — per-node fault isolation
                row = None
                with self._lock:
                    st["failures"] += 1
                    self._poll_failures += 1
                    st["last_error"] = f"{type(e).__name__}: {e}"
                self._journal_failure(label, e)
            rows.append((label, row))
        return self._record(rows, now)

    def _record(self, rows: List[Tuple[str, Optional[Dict[str, float]]]],
                now: float) -> int:
        store = self.store()
        landed = 0
        stale_count = 0
        error_rates: List[float] = []
        p95s: List[float] = []
        for label, row in rows:
            with self._lock:
                st = self._status[label]
                anchor = st["last_ok"] if st["last_ok"] is not None \
                    else st["first_seen"]
                staleness = max(0.0, now - anchor)
                st["stale"] = staleness >= stale_after_s()
                stale = st["stale"]
            if stale:
                stale_count += 1
            store.record(f"worker:{label}/staleness_s", staleness, t=now)
            landed += 1
            if row is None:
                # unreachable: its share of the fleet error rate is 1.0
                error_rates.append(1.0)
                continue
            for key, value in row.items():
                store.record(f"worker:{label}/{key}", value, t=now)
                landed += 1
            error_rates.append(row.get("error_rate", 0.0))
            p95s.append(row.get("queue_wait_p95_s", 0.0))
        with self._lock:
            self._ticks += 1
            poll_failures = self._poll_failures
        if rows:
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
                     sum(error_rates) / len(error_rates)),
                    ("fleet/worker_stale_count", float(stale_count)),
                    ("fleet/poll_failures_total", float(poll_failures))):
                store.record(name, value, t=now)
                landed += 1
        return landed

    @staticmethod
    def _journal_failure(label: str, exc: Exception) -> None:
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                journal as obs_journal,
            )

            if obs_journal.enabled():
                obs_journal.emit("federation_poll_failed",
                                 f"federation-{label}", worker=label,
                                 error=f"{type(exc).__name__}: {exc}")
        except Exception:  # noqa: BLE001 — telemetry stays passive
            pass

    # -- views --------------------------------------------------------------

    def fleet_queue_wait_p95(self) -> float:
        """Latest federated worst-of-fleet queue-wait p95 (0.0 before the
        first tick) — the autoscaler's fleet-wide scale signal."""
        latest = self.store().latest("fleet/queue_wait_p95_s")
        return float(latest[1]) if latest is not None else 0.0

    def summary(self) -> Dict[str, Any]:
        """The ``GET /internal/fleet`` document."""
        now = self._clock()
        deadline = stale_after_s()
        with self._lock:
            workers = {}
            for label, st in self._status.items():
                anchor = st["last_ok"] if st["last_ok"] is not None \
                    else st["first_seen"]
                staleness = max(0.0, now - anchor)
                workers[label] = {
                    "polls": st["polls"],
                    "failures": st["failures"],
                    "staleness_s": staleness,
                    "stale": staleness >= deadline,
                    "rtt_s": st["rtt_s"],
                    "last_error": st["last_error"],
                }
            polls = self._polls
            poll_failures = self._poll_failures
            ticks = self._ticks
        store = self.store()
        for label, row in workers.items():
            for metric in ("error_rate", "queue_wait_p95_s"):
                latest = store.latest(f"worker:{label}/{metric}")
                row[metric] = (float(latest[1])
                               if latest is not None else None)
        fleet = {}
        for name in ("fleet/queue_wait_p95_s", "fleet/error_rate",
                     "fleet/worker_stale_count"):
            latest = store.latest(name)
            fleet[name.split("/", 1)[1]] = (
                float(latest[1]) if latest is not None else None)
        with _DAEMON_LOCK:
            daemon_alive = _DAEMON is not None and _DAEMON.alive()
        return {
            "enabled": enabled(),
            "stale_after_s": deadline,
            "ticks": ticks,
            "polls_total": polls,
            "poll_failures_total": poll_failures,
            "daemon": daemon_alive,
            "workers": workers,
            "fleet": fleet,
        }

    def clear(self) -> None:
        with self._lock:
            self._status.clear()
            self._polls = 0
            self._poll_failures = 0
            self._ticks = 0


#: The process-wide prober. A World registers itself as the source at
#: construction when the gate is on (``scheduler/world.py``); a caller
#: may also :func:`set_source` and :func:`tick` directly.
PROBER = FederationProber()


# -- polling daemon ----------------------------------------------------------

_DAEMON_LOCK = threading.Lock()
_DAEMON: Optional[StoppableDaemon] = None  # guarded-by: _DAEMON_LOCK


def _probe_tick() -> None:
    """One guarded poll sweep (reads PROBER at call time so reset()'s
    rebind takes effect without a daemon restart)."""
    try:
        PROBER.tick()
    except Exception:  # noqa: BLE001 — the sweep must survive
        pass


def set_source(source: Any) -> None:
    """Register the prober's worker source (a World or iterable)."""
    PROBER.set_source(source)


def source() -> Any:
    return PROBER.source()


def tick(now: Optional[float] = None) -> int:
    """One gated poll sweep; 0 with SDTPU_FEDERATION off."""
    return PROBER.tick(now=now)


def fleet_queue_wait_p95() -> float:
    """Fleet-wide scale signal for the autoscaler; 0.0 when off."""
    if not enabled():
        return 0.0
    return PROBER.fleet_queue_wait_p95()


def start_daemon() -> bool:
    """Start the poll daemon (idempotent); False with the gate off."""
    global _DAEMON
    if not enabled():
        return False
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        tsdb as obs_tsdb,
    )

    with _DAEMON_LOCK:
        if _DAEMON is not None and _DAEMON.alive():
            return True
        _DAEMON = StoppableDaemon("sdtpu-federation-prober", _probe_tick,
                                  obs_tsdb.interval_s, immediate=True)
        _DAEMON.start()
    return True


def stop_daemon() -> None:
    global _DAEMON
    with _DAEMON_LOCK:
        daemon = _DAEMON
        _DAEMON = None
    if daemon is not None:
        daemon.stop(timeout_s=2.0)


def reset() -> None:
    """Stop the daemon and rebuild the prober (between tests or phases);
    the source registration does not survive: a World registers at its
    construction."""
    global PROBER
    stop_daemon()
    PROBER = FederationProber()


def summary() -> Dict[str, Any]:
    """The ``GET /internal/fleet`` document (served even when off)."""
    return PROBER.summary()
