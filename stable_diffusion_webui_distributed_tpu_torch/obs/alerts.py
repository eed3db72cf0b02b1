"""Burn-rate and anomaly alerting over the TSDB (``SDTPU_ALERTS``).

Port of the JAX package's ``obs/alerts.py``. The TSDB (``obs/tsdb.py``)
keeps the metric history; this module evaluates a closed registry of nine
rules against it (the JAX package's names, kinds, series, thresholds and
severities) and runs each rule through a pending -> firing -> resolved
state machine:

- ``burn_rate``: multi-window SLO burn alerts. The fast pair reads the 5 m
  and 1 h windows at a burn of 14.4 or more, the slow pair the 1 h and 6 h
  windows at 6 or more; both windows must agree. Window lengths scale by
  ``SDTPU_ALERT_TIMESCALE``, so a short run replays hours in seconds with
  the same thresholds.
- ``anomaly``: an EWMA z-score on a sampled series (the queue-wait p95) or
  on a counter's windowed rate (captures, failures), with an absolute floor
  so a quiet series cannot alarm on noise; ``for_count`` consecutive hits
  are needed before firing, so a single jump pends and clears.
- ``increase``: a windowed threshold on a counter that stays flat in
  healthy operation (watchdog stalls, UNAVAILABLE demotions, stale
  federated workers).

Every transition to firing or back journals ``alert_firing`` /
``alert_resolved`` (``obs/journal.py``), counts ``sdtpu_alerts_total{rule,
state}``, sets ``sdtpu_alert_state{rule}`` (``obs/prometheus.py``) and
hands the transition to the notifier (``obs/notify.py``); a firing also
lands a flight-recorder entry, which carries the TSDB window the detector
saw. ``fleet/slices.py`` reads :func:`scale_up_firing` as a scale-up
signal beside its queue-wait trigger. :func:`register_rule` is called in
this module only.

Off by default: ``SDTPU_ALERTS=1`` turns it on (it needs ``SDTPU_TSDB=1``
for data); off, :func:`evaluate` returns at once. ``obs/tsdb.py``'s
:func:`~.tsdb.tick` evaluates after each sample.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
    env_float,
)

#: SRE-book burn thresholds: the fast pair catches a budget-exhausting
#: burn in minutes, the slow pair a slow leak in hours.
FAST_BURN = 14.4
SLOW_BURN = 6.0

#: Transition history retained per engine (state(), /internal/alerts).
_HISTORY_CAP = 256


def enabled() -> bool:
    """Alert-engine gate — re-read per call so tests can flip it."""
    return env_flag("SDTPU_ALERTS", False)


def timescale() -> float:
    """Window compression factor: rule windows (wall-clock seconds) are
    multiplied by this, so scenario runs replay the 5m/1h/6h SLO windows
    in seconds (``SDTPU_ALERT_TIMESCALE=0.01`` -> 3s/36s/216s)."""
    return max(1e-6, env_float("SDTPU_ALERT_TIMESCALE", 1.0))


#: The closed severity vocabulary. Routing (SDTPU_NOTIFY_ROUTES) keys on
#: these literals, so a typo'd severity would silently never page —
#: construction rejects it.
SEVERITIES = frozenset({"page", "warn", "info"})


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One closed-registry alert rule.

    ``kind`` selects the detector: ``burn_rate`` (``series`` is a
    prefix matched against ``slo_burn.*`` series, ``windows_s`` the
    (short, long) pair, ``threshold`` the burn floor), ``anomaly``
    (EWMA z-score on the series value, or on its windowed rate when
    ``use_rate``), ``increase`` (windowed counter increase >=
    ``threshold``). ``for_count`` consecutive true evaluations gate
    pending -> firing. ``scale_up`` marks the rule as an autoscaler
    scale-up signal. ``severity`` routes the rule's notifications
    (obs/notify.py SDTPU_NOTIFY_ROUTES): a closed set — ``page`` wakes
    a human, ``warn`` is actionable during business hours, ``info`` is
    context only — enforced at construction."""

    name: str
    kind: str                        # "burn_rate" | "anomaly" | "increase"
    series: str
    description: str
    windows_s: Tuple[float, float] = (300.0, 3600.0)
    threshold: float = 1.0
    for_count: int = 1
    use_rate: bool = False
    z: float = 6.0
    alpha: float = 0.3
    warmup: int = 8
    min_value: float = 0.0
    scale_up: bool = False
    severity: str = "warn"           # "page" | "warn" | "info"

    def __post_init__(self) -> None:
        if self.kind not in ("burn_rate", "anomaly", "increase"):
            raise ValueError(f"unknown alert-rule kind {self.kind!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown alert severity {self.severity!r} "
                f"(expected one of {sorted(SEVERITIES)})")


_REGISTRY_LOCK = threading.Lock()
#: name -> rule: the closed rule set every engine evaluates, registered
#: in this module only.
_RULES: "collections.OrderedDict[str, AlertRule]" = \
    collections.OrderedDict()  # guarded-by: _REGISTRY_LOCK


def register_rule(rule: AlertRule) -> AlertRule:
    """Declare one alert rule (called in this module only).
    Re-registering a name raises: two detectors sharing a name would
    corrupt the lifecycle metrics."""
    with _REGISTRY_LOCK:
        if rule.name in _RULES:
            raise ValueError(f"alert rule {rule.name!r} already registered")
        _RULES[rule.name] = rule
    return rule


def registered_rules() -> Dict[str, AlertRule]:
    with _REGISTRY_LOCK:
        return dict(_RULES)


# -- the closed rule set -----------------------------------------------------

register_rule(AlertRule(
    name="slo_burn_fast", kind="burn_rate", series="slo_burn.",
    description="Fast SLO budget burn: 5m AND 1h windows both >= 14.4x "
                "(exhausts a 30d budget in ~2 days).",
    windows_s=(300.0, 3600.0), threshold=FAST_BURN, for_count=1,
    scale_up=True, severity="page"))
register_rule(AlertRule(
    name="slo_burn_slow", kind="burn_rate", series="slo_burn.",
    description="Slow SLO budget burn: 1h AND 6h windows both >= 6x.",
    windows_s=(3600.0, 21600.0), threshold=SLOW_BURN, for_count=1,
    scale_up=True, severity="warn"))
register_rule(AlertRule(
    name="queue_wait_anomaly", kind="anomaly", series="queue_wait_p95_s",
    description="Queue-wait p95 running away from its EWMA baseline "
                "(z-score with sustain requirement).",
    for_count=3, z=6.0, alpha=0.3, warmup=8, min_value=0.25,
    scale_up=True, severity="warn"))
register_rule(AlertRule(
    name="compile_rate_anomaly", kind="anomaly", series="compiles_total",
    description="Compile-storm detector: windowed stage-compile rate "
                "z-scoring far above its EWMA baseline.",
    windows_s=(300.0, 3600.0), use_rate=True, for_count=2, z=6.0,
    warmup=8, min_value=2.0, severity="info"))
register_rule(AlertRule(
    name="error_rate_anomaly", kind="anomaly",
    series="worker_failures_total",
    description="Worker-failure rate above its EWMA baseline (a healthy "
                "fleet's failure counter is flat).",
    windows_s=(300.0, 3600.0), use_rate=True, for_count=1, z=6.0,
    warmup=4, min_value=1e-6, severity="warn"))
register_rule(AlertRule(
    name="worker_flap", kind="increase",
    series="worker_unavailable_total",
    description="Worker health flap: any UNAVAILABLE demotion inside "
                "the fast window.",
    windows_s=(300.0, 3600.0), threshold=1.0, for_count=1,
    severity="warn"))
register_rule(AlertRule(
    name="watchdog_stall", kind="increase",
    series="watchdog_stalls_total",
    description="Hang-watchdog stall detections inside the fast window.",
    windows_s=(300.0, 3600.0), threshold=1.0, for_count=1,
    severity="page"))
register_rule(AlertRule(
    name="worker_metrics_stale", kind="increase",
    series="fleet/worker_stale_count",
    description="Fleet-scope: a federated worker's metrics went stale "
                "(no successful poll inside the freshness deadline) — "
                "the worker is dead or partitioned. Dormant without "
                "SDTPU_FEDERATION (series never recorded).",
    windows_s=(300.0, 3600.0), threshold=1.0, for_count=1,
    severity="page"))
register_rule(AlertRule(
    name="fleet_error_rate", kind="anomaly", series="fleet/error_rate",
    description="Fleet-scope: federated mean worker error rate jumping "
                "off its EWMA baseline (an unreachable worker counts as "
                "1.0). Dormant without SDTPU_FEDERATION.",
    for_count=1, z=6.0, warmup=4, min_value=0.1, severity="page"))


class AlertEngine:
    """Pending/firing/resolved state machine over the rule registry.

    ``store`` defaults to the live TSDB; tests pass their own
    :class:`~.tsdb.SeriesStore` and drive :meth:`evaluate` with an
    explicit clock for determinism.
    """

    def __init__(self, store=None, clock: Callable[[], float]
                 = time.monotonic) -> None:
        self._store = store
        self._clock = clock
        self._lock = threading.Lock()
        # rule name -> mutable state                    guarded-by: _lock
        self._state: Dict[str, Dict[str, Any]] = {
            name: self._fresh_state() for name in registered_rules()}
        # bounded transition history                    guarded-by: _lock
        self._history: Deque[Dict[str, Any]] = \
            collections.deque(maxlen=_HISTORY_CAP)

    @staticmethod
    def _fresh_state() -> Dict[str, Any]:
        return {"state": "ok", "true_count": 0, "pending_since": None,
                "firing_since": None, "ewma": None, "ewvar": 0.0,
                "ewma_samples": 0, "last_value": None, "last_z": None}

    def store(self):
        if self._store is not None:
            return self._store
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            tsdb as obs_tsdb,
        )

        return obs_tsdb.STORE

    # -- per-kind conditions ----------------------------------------------

    def _burn_condition(self, rule: AlertRule, store, now: float,
                        st: Dict[str, Any]) -> Tuple[bool, Any, str]:
        ts = timescale()
        short_w, long_w = (rule.windows_s[0] * ts, rule.windows_s[1] * ts)
        names = [n for n in store.names() if n.startswith(rule.series)]
        worst: Optional[float] = None
        worst_name = ""
        for name in names:
            short = store.avg_over_time(name, short_w, now=now)
            long = store.avg_over_time(name, long_w, now=now)
            if short is None or long is None:
                continue
            burn = min(short, long)  # both windows must clear the bar
            if worst is None or burn > worst:
                worst, worst_name = burn, name
        if worst is None:
            return False, None, "no burn samples"
        return (worst >= rule.threshold, worst,
                f"{worst_name} min-window burn {worst:.2f} "
                f"vs {rule.threshold:.1f}")

    def _anomaly_condition(self, rule: AlertRule, store, now: float,
                           st: Dict[str, Any]) -> Tuple[bool, Any, str]:
        if rule.use_rate:
            value = store.rate(rule.series,
                               rule.windows_s[0] * timescale(), now=now)
        else:
            latest = store.latest(rule.series)
            value = latest[1] if latest is not None else None
        if value is None:
            return False, None, "no samples"
        mean = st["ewma"]
        var = st["ewvar"]
        samples = st["ewma_samples"]
        z = None
        cond = False
        if mean is not None and samples >= rule.warmup:
            # std floor: 10% of |mean| or a small absolute epsilon, so a
            # near-constant series cannot z-explode on measurement noise
            std = math.sqrt(max(var, 0.0))
            std = max(std, 0.1 * abs(mean), 1e-6)
            z = (value - mean) / std
            cond = z >= rule.z and value >= rule.min_value
        # EWMA/EWVar update AFTER the test: the detector compares against
        # the pre-sample baseline
        if mean is None:
            st["ewma"], st["ewvar"] = float(value), 0.0
        else:
            a = rule.alpha
            delta = float(value) - mean
            st["ewma"] = mean + a * delta
            st["ewvar"] = (1.0 - a) * (var + a * delta * delta)
        st["ewma_samples"] = samples + 1
        detail = (f"value {value:.4g}, ewma {st['ewma']:.4g}"
                  + (f", z {z:.2f} vs {rule.z:.1f}" if z is not None
                     else ", warming up"))
        st["last_z"] = z
        return cond, value, detail

    def _increase_condition(self, rule: AlertRule, store, now: float,
                            st: Dict[str, Any]) -> Tuple[bool, Any, str]:
        inc = store.increase(rule.series,
                             rule.windows_s[0] * timescale(), now=now)
        if inc is None:
            return False, None, "no samples"
        return (inc >= rule.threshold, inc,
                f"window increase {inc:.4g} vs {rule.threshold:.4g}")

    # -- the state machine -------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation pass over every rule; returns (and records)
        the state transitions it produced."""
        if now is None:
            now = self._clock()
        store = self.store()
        transitions: List[Dict[str, Any]] = []
        for name, rule in registered_rules().items():
            with self._lock:
                st = self._state.setdefault(name, self._fresh_state())
                if rule.kind == "burn_rate":
                    cond, value, detail = self._burn_condition(
                        rule, store, now, st)
                elif rule.kind == "anomaly":
                    cond, value, detail = self._anomaly_condition(
                        rule, store, now, st)
                else:
                    cond, value, detail = self._increase_condition(
                        rule, store, now, st)
                st["last_value"] = value
                prev = st["state"]
                new = prev
                if cond:
                    st["true_count"] += 1
                    if prev == "ok":
                        new = "pending"
                        st["pending_since"] = now
                    if st["true_count"] >= rule.for_count \
                            and prev != "firing":
                        new = "firing"
                        st["firing_since"] = now
                else:
                    st["true_count"] = 0
                    if prev == "firing":
                        new = "ok"  # resolved
                    elif prev == "pending":
                        new = "ok"
                    st["pending_since"] = None
                    if new == "ok":
                        st["firing_since"] = None
                st["state"] = new
                entry = None
                if new != prev:
                    entry = {"rule": name, "from": prev, "to": new,
                             "t": now, "value": value, "detail": detail}
                    self._history.append(entry)
            if entry is not None:
                transitions.append(entry)
                if new == "firing" or (prev == "firing" and new == "ok"):
                    self._announce(rule, prev, new, value, detail)
        return transitions

    def _announce(self, rule: AlertRule, prev: str, new: str,
                  value: Any, detail: str) -> None:
        """Journal + Prometheus + flight-recorder side effects of a
        firing/resolved transition; best-effort, never throws into the
        evaluation loop."""
        firing = new == "firing"
        event = "alert_firing" if firing else "alert_resolved"
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                journal as obs_journal,
            )

            if obs_journal.enabled():
                obs_journal.emit(event, f"alert-{rule.name}",
                                 rule=rule.name, kind=rule.kind,
                                 series=rule.series, value=value,
                                 severity=rule.severity, detail=detail)
        except Exception:  # noqa: BLE001 — telemetry stays passive
            pass
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                prometheus as obs_prom,
            )

            obs_prom.alert_count(rule.name,
                                 "firing" if firing else "resolved")
            obs_prom.set_alert_state(rule.name, 1.0 if firing else 0.0)
        except Exception:  # noqa: BLE001
            pass
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                notify as obs_notify,
            )

            obs_notify.notify_transition(rule.name, event, value, detail,
                                         severity=rule.severity)
        except Exception:  # noqa: BLE001
            pass
        if firing:
            try:
                from stable_diffusion_webui_distributed_tpu_torch.obs import (
                    flightrec,
                )

                flightrec.RECORDER.record(
                    f"alert-{rule.name}", "alert_firing",
                    f"{rule.name}: {detail}", events=[])
            except Exception:  # noqa: BLE001
                pass

    # -- views -------------------------------------------------------------

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, st in self._state.items()
                          if st["state"] == "firing")

    def scale_up_firing(self) -> List[str]:
        """Firing rules marked as autoscaler scale-up signals."""
        rules = registered_rules()
        return [n for n in self.firing()
                if n in rules and rules[n].scale_up]

    def history(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._history]

    def state(self) -> Dict[str, Any]:
        rules = registered_rules()
        with self._lock:
            per_rule = {
                name: {"state": st["state"],
                       "kind": rules[name].kind if name in rules else "",
                       "scale_up": bool(rules[name].scale_up)
                       if name in rules else False,
                       "true_count": st["true_count"],
                       "pending_since": st["pending_since"],
                       "firing_since": st["firing_since"],
                       "last_value": st["last_value"],
                       "last_z": st["last_z"]}
                for name, st in self._state.items()}
            history = [dict(e) for e in self._history]
        return {"rules": per_rule,
                "firing": sorted(n for n, r in per_rule.items()
                                 if r["state"] == "firing"),
                "history": history}

    def clear(self) -> None:
        with self._lock:
            self._state = {name: self._fresh_state()
                           for name in registered_rules()}
            self._history.clear()


#: Process-wide engine (the TSDB daemon drives it; /internal/alerts and
#: the autoscaler read it). Tests construct their own for odd clocks.
ENGINE = AlertEngine()


def reset() -> None:
    """Rebuild the process-wide engine (between tests or phases)."""
    global ENGINE
    ENGINE = AlertEngine()


def evaluate() -> List[Dict[str, Any]]:
    """One gated evaluation pass; [] with SDTPU_ALERTS off."""
    if not enabled():
        return []
    return ENGINE.evaluate()


def firing() -> List[str]:
    if not enabled():
        return []
    return ENGINE.firing()


def scale_up_firing() -> List[str]:
    """The autoscaler's alert-sourced scale-up signal; [] when off."""
    if not enabled():
        return []
    return ENGINE.scale_up_firing()


def state_snapshot() -> Optional[Dict[str, Any]]:
    """Bounded alert-state view for flight-recorder enrichment; None
    with the gate off (no-op enrichment)."""
    if not enabled():
        return None
    return ENGINE.state()


def summary() -> Dict[str, Any]:
    """The ``GET /internal/alerts`` document (schema pinned by tests)."""
    doc: Dict[str, Any] = {
        "enabled": enabled(),
        "timescale": timescale(),
        "registered": {name: {"kind": r.kind, "series": r.series,
                              "description": r.description,
                              "scale_up": r.scale_up,
                              "severity": r.severity}
                       for name, r in registered_rules().items()},
    }
    doc.update(ENGINE.state())
    return doc
