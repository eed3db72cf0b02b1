"""In-process time-series store (``SDTPU_TSDB``): bounded metric history.

Port of the JAX package's ``obs/tsdb.py``. ``/internal/metrics`` renders
instantaneous values; this module keeps their history, so a question such
as "when did the queue-wait p95 start climbing?" has an answer and the
autoscaler and the alert engine (``obs/alerts.py``) read windowed trends.
A fixed-depth ring per series is sampled by a daemon (or by an explicit
:func:`tick`, for deterministic tests) from the port's own sources:

- ``queue_wait_p95_s`` / ``e2e_p95_s``: a rank-interpolated p95
  (:func:`quantile_from_counts`) over the fixed-ladder histograms of
  ``obs/prometheus.py``;
- ``slo_attainment.<tenant>.<class>`` / ``slo_burn.<tenant>.<class>``:
  the perf ledger's SLO rows (``obs/perf.py``), with ``slo_burn_worst``;
- counter totals (requests, dispatches, worker failures, UNAVAILABLE
  demotions, watchdog stalls, and ``compiles_total``: the engine's CUDA-graph
  captures, which stand where the JAX package counts its compiles, as the
  ``capture`` span stands for its ``compile`` span), for windowed
  :meth:`SeriesStore.rate` and :meth:`SeriesStore.increase`;
- ``hbm_bytes_in_use`` / ``hbm_peak_bytes`` / ``device_live_buffers``
  from ``torch.cuda.memory_stats()``: ``allocated_bytes.all.current``,
  ``allocated_bytes.all.peak`` and ``active.all.current``. A read is host
  bookkeeping of the caching allocator: it never waits for the card, and
  nothing here calls ``torch.cuda.synchronize()``. On the CPU the readers
  return None and these series never appear (no made-up numbers).

The perf ledger keeps each serving group's watermark from
:func:`dispatch_memory_sample`, read after each dispatch; with the gate on
that read also lands in the series. A snapshot file (``SDTPU_TSDB_DIR``)
has the JAX package's JSON schema, so either package loads the other's.
Served at ``GET /internal/tsdb``.

Off by default: ``SDTPU_TSDB=1`` turns it on, ``SDTPU_TSDB_INTERVAL_S``
sets the daemon's cadence and ``SDTPU_TSDB_POINTS`` the ring depth. With
the gate off no daemon starts and :func:`tick` returns 0. Nothing in the
port starts the daemon by itself (as in the JAX package): a caller runs
:func:`start_daemon`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
    env_float,
    env_int,
    env_str,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.daemon import (
    StoppableDaemon,
)

DEFAULT_INTERVAL_S = 1.0
DEFAULT_POINTS = 512

#: the series namespace's bound (tenant names come from users)
_MAX_SERIES = 256

#: the series the flight recorder keeps with a failure or stall entry;
#: slo_burn.* and hbm_* ride along by prefix
FLIGHT_SERIES: Tuple[str, ...] = (
    "queue_wait_p95_s", "e2e_p95_s", "worker_failures_total",
    "worker_unavailable_total", "watchdog_stalls_total",
    "compiles_total", "slo_burn_worst")
_FLIGHT_PREFIXES: Tuple[str, ...] = ("slo_burn.", "hbm_")
_FLIGHT_POINTS = 64


def enabled() -> bool:
    """The TSDB's gate, read per call."""
    return env_flag("SDTPU_TSDB", False)


def interval_s() -> float:
    """The daemon's sampling cadence (seconds)."""
    return max(0.01, env_float("SDTPU_TSDB_INTERVAL_S", DEFAULT_INTERVAL_S))


# -- durability (SDTPU_TSDB_DIR) ---------------------------------------------

SNAPSHOT_BASENAME = "tsdb_snapshot.json"

#: the daemon saves a snapshot every this many ticks, and once at its stop
_SAVE_EVERY_TICKS = 10


def snapshot_dir() -> str:
    """The snapshot directory (``SDTPU_TSDB_DIR``); "" = no snapshots."""
    return env_str("SDTPU_TSDB_DIR", "")


def snapshot_path(base: Optional[str] = None) -> str:
    return os.path.join(base or snapshot_dir(), SNAPSHOT_BASENAME)


# -- derived series ----------------------------------------------------------

def quantile_from_counts(bounds: Tuple[float, ...], counts: List[int],
                         n: int, q: float) -> float:
    """The q-quantile of a fixed-ladder histogram (``counts`` per bucket
    with the +Inf overflow, as ``Histogram.snapshot`` gives them),
    interpolated linearly inside the bucket that holds the rank; the +Inf
    bucket clamps to the top finite bound."""
    if n <= 0:
        return 0.0
    target = max(1.0, q * n)
    cum = 0.0
    lo = 0.0
    for i, c in enumerate(counts):
        if i >= len(bounds):
            return float(bounds[-1])
        hi = float(bounds[i])
        if c > 0 and cum + c >= target:
            return lo + (hi - lo) * (target - cum) / c
        cum += c
        lo = hi
    return float(bounds[-1])


def _cuda_stats() -> Optional[Dict]:
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        return torch.cuda.memory_stats()
    except Exception:  # noqa: BLE001 — telemetry stays passive
        return None


def device_memory_stats() -> Optional[Dict[str, int]]:
    """``{bytes_in_use, peak_bytes_in_use, num_allocs}`` of the current
    card, or None without one."""
    stats = _cuda_stats()
    if not stats:
        return None
    out: Dict[str, int] = {}
    for key, src in (("bytes_in_use", "allocated_bytes.all.current"),
                     ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                     ("num_allocs", "allocation.all.allocated")):
        if src in stats:
            out[key] = int(stats[src])
    return out or None


def live_buffer_count() -> Optional[int]:
    """Live allocations on the current card (the caching allocator's
    ``active.all.current``), or None without one."""
    stats = _cuda_stats()
    if not stats or "active.all.current" not in stats:
        return None
    return int(stats["active.all.current"])


# -- the store ---------------------------------------------------------------

class SeriesStore:
    """One fixed-depth ring of (monotonic time, value) samples per series
    name, behind one lock."""

    def __init__(self, points: Optional[int] = None) -> None:
        if points is None:
            points = env_int("SDTPU_TSDB_POINTS", DEFAULT_POINTS)
        self.points = max(8, int(points))
        self._lock = threading.Lock()
        # name -> ring of (t_mono, value)                guarded-by: _lock
        self._series: "OrderedDict[str, Deque[Tuple[float, float]]]" = \
            OrderedDict()
        self._samples_total = 0                        # guarded-by: _lock
        self._dropped_series = 0                       # guarded-by: _lock

    def record(self, name: str, value: Any,
               t: Optional[float] = None) -> None:
        """Append one sample. A value that is not a number is dropped, and
        so is a new series once the namespace is full."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if t is None:
            t = time.monotonic()
        key = str(name)
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= _MAX_SERIES:
                    self._dropped_series += 1
                    return
                ring = deque(maxlen=self.points)
                self._series[key] = ring
            ring.append((float(t), v))
            self._samples_total += 1

    def names(self) -> List[str]:
        with self._lock:
            return list(self._series)

    def window(self, name: str, window_s: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """The samples of ``name`` in the trailing ``window_s`` seconds,
        oldest first; the whole ring when ``window_s`` <= 0."""
        with self._lock:
            ring = self._series.get(str(name))
            samples = list(ring) if ring is not None else []
        if not samples or window_s <= 0:
            return samples
        if now is None:
            now = time.monotonic()
        cutoff = now - float(window_s)
        return [s for s in samples if s[0] >= cutoff]

    def latest(self, name: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            ring = self._series.get(str(name))
            return ring[-1] if ring else None

    # -- windowed queries ---------------------------------------------------

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """A counter's increase per second over the window (Prometheus's
        ``rate()`` without reset handling: these counters reset only with
        the process); None under two samples."""
        w = self.window(name, window_s, now=now)
        if len(w) < 2:
            return None
        dt = w[-1][0] - w[0][0]
        if dt <= 0:
            return None
        return (w[-1][1] - w[0][1]) / dt

    def increase(self, name: str, window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
        """A counter's increase over the window; None under two samples."""
        w = self.window(name, window_s, now=now)
        if len(w) < 2:
            return None
        return w[-1][1] - w[0][1]

    def avg_over_time(self, name: str, window_s: float,
                      now: Optional[float] = None) -> Optional[float]:
        w = self.window(name, window_s, now=now)
        if not w:
            return None
        return sum(v for _t, v in w) / len(w)

    def quantile_over_time(self, name: str, q: float, window_s: float,
                           now: Optional[float] = None) -> Optional[float]:
        """The rank-interpolated q-quantile of the window's values (None
        when it is empty)."""
        w = self.window(name, window_s, now=now)
        if not w:
            return None
        values = sorted(v for _t, v in w)
        if len(values) == 1:
            return values[0]
        pos = max(0.0, min(1.0, float(q))) * (len(values) - 1)
        i = int(pos)
        frac = pos - i
        if i + 1 >= len(values):
            return values[-1]
        return values[i] + (values[i + 1] - values[i]) * frac

    # -- sampling -----------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> int:
        """One pass over every source; returns how many samples landed.
        Reads existing metric objects and the allocator's host-side
        statistics only: nothing waits for the card."""
        if now is None:
            now = time.monotonic()
        recs: List[Tuple[str, Any]] = []
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                prometheus as obs_prom,
            )

            for key, series in (("queue_wait", "queue_wait_p95_s"),
                                ("e2e", "e2e_p95_s")):
                h = obs_prom.HISTOGRAMS[key]
                counts, _total, n = h.snapshot()
                if n > 0:
                    recs.append((series, quantile_from_counts(
                        h.bounds, counts, n, 0.95)))
            recs.append(("worker_failures_total",
                         obs_prom.WORKER_COUNTERS["failures"].total()))
            recs.append(("worker_unavailable_total", sum(
                v for k, v in
                obs_prom.WORKER_COUNTERS["transitions"].snapshot().items()
                if k and k[-1] == "UNAVAILABLE")))
            recs.append(("watchdog_stalls_total",
                         obs_prom.WATCHDOG_COUNTER.total()))
        except Exception:  # noqa: BLE001 — sampling never throws
            pass
        try:
            from stable_diffusion_webui_distributed_tpu_torch.serving.metrics \
                import METRICS

            s = METRICS.summary()
            recs.append(("requests_total", s["requests"]))
            recs.append(("dispatches_total", s["dispatches"]))
            recs.append(("compiles_total", sum(s["compiles"].values())))
        except Exception:  # noqa: BLE001
            pass
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                perf as obs_perf,
            )

            worst = None
            for row in obs_perf.LEDGER.summary()["slo"]:
                tag = f'{row["tenant"]}.{row["class"]}'
                recs.append((f"slo_attainment.{tag}", row["attainment"]))
                burn = row["burn_rate"]
                recs.append((f"slo_burn.{tag}", burn))
                if burn is not None:
                    worst = burn if worst is None else max(worst, burn)
            if worst is not None:
                recs.append(("slo_burn_worst", worst))
        except Exception:  # noqa: BLE001
            pass
        mem = device_memory_stats()
        if mem is not None:
            if "bytes_in_use" in mem:
                recs.append(("hbm_bytes_in_use", mem["bytes_in_use"]))
            if "peak_bytes_in_use" in mem:
                recs.append(("hbm_peak_bytes", mem["peak_bytes_in_use"]))
            live = live_buffer_count()
            if live is not None:
                recs.append(("device_live_buffers", live))
        landed = 0
        for name, value in recs:
            if value is None:
                continue
            self.record(name, value, t=now)
            landed += 1
        return landed

    # -- snapshots ----------------------------------------------------------

    def snapshot(self, max_points: Optional[int] = None,
                 names: Optional[List[str]] = None) -> Dict[str, Any]:
        """Each series' samples, oldest first (the trailing ``max_points``
        when given)."""
        with self._lock:
            items = [(k, list(ring)) for k, ring in self._series.items()
                     if names is None or k in names]
        out: Dict[str, Any] = {}
        for name, samples in items:
            if max_points is not None and len(samples) > max_points:
                samples = samples[-max_points:]
            out[name] = {
                "count": len(samples),
                "latest": list(samples[-1]) if samples else None,
                "samples": [[t, v] for t, v in samples],
            }
        return out

    def dump(self) -> Dict[str, Any]:
        """The snapshot document (every ring at full depth). Times are
        ``time.monotonic()``, which on Linux counts from boot: comparable
        across restarts within one boot; :meth:`load_merge` drops what
        lies in the future (a previous boot's)."""
        with self._lock:
            return {
                "schema": 1,
                "points": self.points,
                "saved_t_mono": time.monotonic(),
                "series": {k: [[t, v] for t, v in ring]
                           for k, ring in self._series.items()},
            }

    def load_merge(self, doc: Any) -> int:
        """Merge a :meth:`dump` document into the rings; returns how many
        samples landed. A document that is not a dict, a malformed series
        or a sample that is not numeric adds nothing, and a sample stamped
        after now is dropped. Restored samples do not count in
        ``samples_total`` (sampled by this process)."""
        if not isinstance(doc, dict):
            return 0
        series = doc.get("series")
        if not isinstance(series, dict):
            return 0
        now = time.monotonic()
        landed = 0
        for name, samples in series.items():
            if not isinstance(samples, (list, tuple)):
                continue
            clean: List[Tuple[float, float]] = []
            for s in samples:
                try:
                    t, v = float(s[0]), float(s[1])
                except (TypeError, ValueError, IndexError):
                    continue
                if t > now:
                    continue
                clean.append((t, v))
            if not clean:
                continue
            key = str(name)
            with self._lock:
                ring = self._series.get(key)
                if ring is None:
                    if len(self._series) >= _MAX_SERIES:
                        self._dropped_series += 1
                        continue
                    ring = deque(maxlen=self.points)
                    self._series[key] = ring
                merged = sorted(set(list(ring) + clean))
                ring.clear()
                ring.extend(merged[-self.points:])
            landed += len(clean)
        return landed

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"series": len(self._series),
                    "samples_total": self._samples_total,
                    "dropped_series": self._dropped_series}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._samples_total = 0
            self._dropped_series = 0


#: The process-wide store; :func:`reset` rebuilds it from the knobs.
STORE = SeriesStore()


def save_snapshot(store: Optional[SeriesStore] = None,
                  path: Optional[str] = None) -> bool:
    """Write the store's :meth:`~SeriesStore.dump` (to a temporary file,
    then ``os.replace``: a crash leaves the previous snapshot whole).
    False without ``SDTPU_TSDB_DIR`` or ``path``, or on a write error."""
    if path is None:
        base = snapshot_dir()
        if not base:
            return False
        path = snapshot_path(base)
    store = store if store is not None else STORE
    tmp = f"{path}.tmp"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(store.dump(), f, sort_keys=True)
        os.replace(tmp, path)
        return True
    except OSError:
        return False


def load_snapshot(store: Optional[SeriesStore] = None,
                  path: Optional[str] = None) -> int:
    """Merge a snapshot file into the store; returns how many samples
    landed (0 for a missing, truncated or corrupt file)."""
    if path is None:
        base = snapshot_dir()
        if not base:
            return 0
        path = snapshot_path(base)
    store = store if store is not None else STORE
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return 0
    return store.load_merge(doc)


# -- the sampling daemon -----------------------------------------------------

_DAEMON_LOCK = threading.Lock()
_DAEMON: Optional[StoppableDaemon] = None  # guarded-by: _DAEMON_LOCK
_DAEMON_STORE: Optional[SeriesStore] = None  # guarded-by: _DAEMON_LOCK


def _make_sampler(store: SeriesStore, period_s: float) -> StoppableDaemon:
    """The sampling daemon; it also drives the alert engine's evaluation
    (one clock for both)."""
    ticks = 0

    def sample() -> None:
        nonlocal ticks
        tick(store=store)
        ticks += 1
        if ticks % _SAVE_EVERY_TICKS == 0 and snapshot_dir():
            save_snapshot(store)

    return StoppableDaemon("sdtpu-tsdb-sampler", sample, period_s)


def tick(store: Optional[SeriesStore] = None) -> int:
    """One sample and one alert evaluation; 0 with the gate off."""
    if not enabled():
        return 0
    if store is None:
        store = STORE
    landed = store.sample_once()
    try:
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            alerts as obs_alerts,
        )

        obs_alerts.evaluate()
    except Exception:  # noqa: BLE001 — sampling never throws
        pass
    return landed


def start_daemon() -> bool:
    """Start the sampling daemon (idempotent); False with the gate off."""
    global _DAEMON, _DAEMON_STORE
    if not enabled():
        return False
    with _DAEMON_LOCK:
        if _DAEMON is not None and _DAEMON.alive():
            return True
        if snapshot_dir():
            load_snapshot(STORE)
        _DAEMON = _make_sampler(STORE, interval_s())
        _DAEMON_STORE = STORE
        _DAEMON.start()
    return True


def stop_daemon() -> None:
    global _DAEMON, _DAEMON_STORE
    with _DAEMON_LOCK:
        daemon, store = _DAEMON, _DAEMON_STORE
        _DAEMON = _DAEMON_STORE = None
    if daemon is not None:
        daemon.stop(timeout_s=2.0)
        if store is not None and snapshot_dir():
            save_snapshot(store)


def reset() -> None:
    """Stop the daemon and rebuild the store from the knobs. With
    ``SDTPU_TSDB_DIR`` set the new store merges the snapshot: a reset is
    a restart, and the history survives it."""
    global STORE
    stop_daemon()
    STORE = SeriesStore()
    if enabled() and snapshot_dir():
        load_snapshot(STORE)


def dispatch_memory_sample() -> Optional[Dict[str, int]]:
    """One dispatch's device-memory read: :func:`device_memory_stats` with
    ``live_buffers`` for the perf ledger's group rows, and with the gate
    on the same read as the ``hbm_*`` and ``device_live_buffers`` series.
    None on the CPU."""
    mem = device_memory_stats()
    if mem is None:
        return None
    live = live_buffer_count()
    if live is not None:
        mem["live_buffers"] = live
    if enabled():
        now = time.monotonic()
        if "bytes_in_use" in mem:
            STORE.record("hbm_bytes_in_use", mem["bytes_in_use"], t=now)
        if "peak_bytes_in_use" in mem:
            STORE.record("hbm_peak_bytes", mem["peak_bytes_in_use"], t=now)
        if live is not None:
            STORE.record("device_live_buffers", live, t=now)
    return mem


def flight_window() -> Optional[Dict[str, Any]]:
    """The bounded view of the store the flight recorder keeps with a
    failure or stall entry; None with the gate off."""
    if not enabled():
        return None
    keep = [n for n in STORE.names()
            if n in FLIGHT_SERIES or n.startswith(_FLIGHT_PREFIXES)]
    return {"interval_s": interval_s(),
            "series": STORE.snapshot(max_points=_FLIGHT_POINTS,
                                     names=keep)}


def summary() -> Dict[str, Any]:
    """The ``GET /internal/tsdb`` document."""
    stats = STORE.stats()
    with _DAEMON_LOCK:
        daemon_alive = _DAEMON is not None and _DAEMON.alive()
    return {
        "enabled": enabled(),
        "interval_s": interval_s(),
        "points": STORE.points,
        "daemon": daemon_alive,
        "series_count": stats["series"],
        "samples_total": stats["samples_total"],
        "dropped_series": stats["dropped_series"],
        "series": STORE.snapshot(),
    }
