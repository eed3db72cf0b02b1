"""Slice registry + autoscale signals.

Port of the JAX package's ``fleet/slices.py``. A *slice* is a logical
partition of the devices serving one group of traffic (a model family at
a precision, e.g. ``sdxl/bf16``). This registry is the fleet's placement
table — which serving groups live on which slices and how many replicas
each has — and the decision engine that turns the queue-wait evidence
into scale-up/scale-down signals.

The decision engine never touches a device — it reads histogram
quantiles and emits :class:`ScaleDecision` records — so it is fully
CPU-testable. Acting on a decision is the warm pool's job
(``fleet/pool.py`` ``WarmPool.attach_autoscale``), wired through
:meth:`AutoscaleEngine.add_hook`.

Signal: the per-class gate queue-wait p95 (``obs/prometheus.py``
``fleet_queue_wait_p95``). Sustained p95 above ``SDTPU_AUTOSCALE_UP_S``
asks for a replica; p95 below ``SDTPU_AUTOSCALE_DOWN_S`` with more than
``min_replicas`` releases one. A cooldown stops flapping, and scale-down
is vetoed while the worker-health feed reports a sick worker.

Two more feeds, as in the JAX package: with ``SDTPU_FEDERATION`` on the
quantile source takes the federated worst-of-fleet p95
(``obs/federation.py``) when it is higher, and the alert source lists the
firing alert rules marked ``scale_up`` (``obs/alerts.py``; [] with
``SDTPU_ALERTS`` off).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

DEFAULT_UP_P95_S = 5.0
DEFAULT_DOWN_P95_S = 0.5
DEFAULT_COOLDOWN_S = 60.0
#: audit-ring capacity default (SDTPU_AUTOSCALE_AUDIT)
DEFAULT_AUDIT_CAP = 256


@dataclasses.dataclass
class SliceInfo:
    """One logical mesh slice and the serving group pinned to it."""

    name: str
    group: str = ""                 # serving group key, e.g. "sdxl/bf16"
    mesh_axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    replicas: int = 1
    min_replicas: int = 1
    max_replicas: int = 4


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    slice_name: str
    direction: str                  # "up" | "down"
    reason: str
    p95_s: float
    replicas: int                   # replica count AFTER the decision


class SliceRegistry:
    """Thread-safe name -> :class:`SliceInfo` table."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slices: Dict[str, SliceInfo] = {}  # guarded-by: _lock

    def register(self, info: SliceInfo) -> None:
        with self._lock:
            self._slices[info.name] = info

    def get(self, name: str) -> Optional[SliceInfo]:
        with self._lock:
            return self._slices.get(name)

    def for_group(self, group: str) -> List[SliceInfo]:
        with self._lock:
            return [s for s in self._slices.values() if s.group == group]

    def set_replicas(self, name: str, replicas: int) -> None:
        with self._lock:
            s = self._slices.get(name)
            if s is not None:
                s.replicas = max(s.min_replicas,
                                 min(s.max_replicas, int(replicas)))

    def summary(self) -> Dict[str, Dict]:
        with self._lock:
            return {name: dataclasses.asdict(s)
                    for name, s in self._slices.items()}


class AutoscaleEngine:
    """Queue-wait-driven scale decisions over a :class:`SliceRegistry`.

    ``quantile_source`` abstracts the Prometheus read — production passes
    :func:`obs.prometheus.fleet_queue_wait_p95`, tests pass a lambda.
    Hooks receive every emitted :class:`ScaleDecision`; the registry's
    replica count is updated first, so a hook reads the post-decision
    state.
    """

    def __init__(self, registry: SliceRegistry,
                 quantile_source: Optional[Callable[[], float]] = None,
                 up_p95_s: Optional[float] = None,
                 down_p95_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 clock=time.monotonic,
                 health_source: Optional[Callable[[], Dict[str, Dict]]]
                 = None,
                 alert_source: Optional[Callable[[], List[str]]]
                 = None) -> None:
        from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
            env_float, env_int,
        )

        self.registry = registry
        self.quantile_source = quantile_source \
            or _default_quantile_source
        self.up_p95_s = env_float("SDTPU_AUTOSCALE_UP_S", DEFAULT_UP_P95_S) \
            if up_p95_s is None else up_p95_s
        self.down_p95_s = env_float("SDTPU_AUTOSCALE_DOWN_S",
                                    DEFAULT_DOWN_P95_S) \
            if down_p95_s is None else down_p95_s
        self.cooldown_s = env_float("SDTPU_AUTOSCALE_COOLDOWN_S",
                                    DEFAULT_COOLDOWN_S) \
            if cooldown_s is None else cooldown_s
        self._clock = clock
        #: optional worker-health feed (World.health_summary) — scale-down
        #: is vetoed while any worker looks unhealthy, since the apparent
        #: headroom may just be capacity the fleet already lost
        self.health_source = health_source
        #: alert feed: firing scale_up-marked rules trigger a scale-up
        #: beside the queue-wait point read; [] with SDTPU_ALERTS off
        self.alert_source = alert_source or _default_alert_source
        if quantile_source is None or alert_source is None:
            # the default feeds raise with a gate on whose feed is not
            # ported; here, not inside decide(), which treats a failing
            # feed as advisory
            if quantile_source is None:
                _default_quantile_source()
            if alert_source is None:
                _default_alert_source()
        self._lock = threading.Lock()
        self._hooks: List[Callable[[ScaleDecision], None]] = []  # guarded-by: _lock
        self._last_decision: Dict[str, float] = {}  # guarded-by: _lock
        #: bounded decision audit ring (``/internal/autoscale``) —
        #: each entry is asdict(decision) + a wall-clock decided_at so an
        #: operator can line decisions up against external monitoring
        self._audit_cap = max(1, env_int("SDTPU_AUTOSCALE_AUDIT",
                                         DEFAULT_AUDIT_CAP))
        # guarded-by: _lock
        self._decisions: Deque[ScaleDecision] = \
            collections.deque(maxlen=self._audit_cap)
        # guarded-by: _lock
        self._audit: Deque[Dict[str, object]] = \
            collections.deque(maxlen=self._audit_cap)
        self._audit_total = 0  # guarded-by: _lock
        set_autoscale(self)  # last engine created serves /internal/autoscale

    def add_hook(self, hook: Callable[[ScaleDecision], None]) -> None:
        with self._lock:
            self._hooks.append(hook)

    def unhealthy_workers(self) -> List[str]:
        """Labels the health feed currently considers unhealthy (3+
        consecutive failures, >=50% rolling error rate, or UNAVAILABLE);
        empty when no ``health_source`` is attached."""
        if self.health_source is None:
            return []
        try:
            summaries = self.health_source() or {}
        except Exception:  # noqa: BLE001 — advisory feed, never fatal
            return []
        bad = []
        for label, s in summaries.items():
            if int(s.get("consecutive_failures", 0)) >= 3 \
                    or float(s.get("error_rate", 0.0)) >= 0.5 \
                    or s.get("state") == "UNAVAILABLE":
                bad.append(label)
        return sorted(bad)

    def firing_alerts(self) -> List[str]:
        """Firing scale_up-marked alert rules (the alert feed); empty
        when the feed fails or the alert engine is gated off."""
        try:
            return sorted(self.alert_source() or [])
        except Exception:  # noqa: BLE001 — advisory feed, never fatal
            return []

    def decide(self) -> List[ScaleDecision]:
        """One evaluation pass over every registered slice; returns (and
        dispatches to hooks) the decisions made this pass."""
        p95 = float(self.quantile_source())
        now = self._clock()
        unhealthy = self.unhealthy_workers()
        alerts = self.firing_alerts()
        out: List[ScaleDecision] = []
        for name, info in self.registry.summary().items():
            with self._lock:
                last = self._last_decision.get(name, -1e18)
                in_cooldown = now - last < self.cooldown_s
            if in_cooldown:
                continue
            replicas = info["replicas"]
            decision = None
            if (p95 >= self.up_p95_s or alerts) \
                    and replicas < info["max_replicas"]:
                if p95 >= self.up_p95_s:
                    reason = (f"queue-wait p95 {p95:.2f}s "
                              f">= {self.up_p95_s:.2f}s")
                else:
                    reason = (f"alert {','.join(alerts)} firing "
                              f"(scale-up signal)")
                decision = ScaleDecision(
                    name, "up", reason, p95, replicas + 1)
            elif p95 <= self.down_p95_s and replicas > info["min_replicas"]:
                if unhealthy:
                    # low queue wait with sick workers is not surplus
                    # capacity — hold replicas until the fleet heals
                    continue
                decision = ScaleDecision(
                    name, "down",
                    f"queue-wait p95 {p95:.2f}s <= {self.down_p95_s:.2f}s",
                    p95, replicas - 1)
            if decision is None:
                continue
            self.registry.set_replicas(name, decision.replicas)
            with self._lock:
                self._last_decision[name] = now
                self._decisions.append(decision)
                entry = dict(dataclasses.asdict(decision))
                entry["decided_at"] = time.time()  # audit-log wall clock
                # execution outcome: seeded "no_executor"; an attached
                # executor (fleet/pool.py attach_autoscale) upgrades it
                # to executed/failed via record_execution
                entry["execution"] = {"outcome": "no_executor"}
                self._audit.append(entry)
                self._audit_total += 1
                hooks = list(self._hooks)
            for hook in hooks:  # outside the lock: hooks may re-enter
                hook(decision)
            out.append(decision)
        return out

    def record_execution(self, decision: ScaleDecision, outcome: str,
                         detail: str = "") -> bool:
        """Upgrade a decision's audit entry with its execution outcome
        (``executed`` / ``failed``) once an attached executor (the warm
        pool) has actually spawned or retired capacity. Matches the most
        recent still-``no_executor`` entry for this decision; returns
        False if the ring has already evicted it."""
        want = dataclasses.asdict(decision)
        with self._lock:
            for entry in reversed(self._audit):
                if entry.get("execution", {}).get("outcome") \
                        != "no_executor":
                    continue
                if all(entry.get(k) == v for k, v in want.items()):
                    entry["execution"] = {
                        "outcome": str(outcome),
                        "detail": str(detail),
                        "executed_at": time.time(),
                    }
                    return True
        return False

    def history(self) -> List[ScaleDecision]:
        with self._lock:
            return list(self._decisions)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            decisions = list(self._decisions)
        return {
            "slices": self.registry.summary(),
            "thresholds": {"up_p95_s": self.up_p95_s,
                           "down_p95_s": self.down_p95_s,
                           "cooldown_s": self.cooldown_s},
            "decisions": [dataclasses.asdict(d)
                          for d in list(decisions)[-16:]],
        }

    def audit(self) -> Dict[str, object]:
        """Full bounded audit ring for ``/internal/autoscale`` — every
        retained decision with its wall-clock timestamp, plus how many
        were made overall so a reader can tell when the ring wrapped."""
        with self._lock:
            entries = list(self._audit)
            total = self._audit_total
        return {
            "active": True,
            "slices": self.registry.summary(),
            "thresholds": {"up_p95_s": self.up_p95_s,
                           "down_p95_s": self.down_p95_s,
                           "cooldown_s": self.cooldown_s},
            "capacity": self._audit_cap,
            "decisions_total": total,
            "decisions": entries,
            "unhealthy_workers": self.unhealthy_workers(),
            "firing_alerts": self.firing_alerts(),
        }


# -- module-level active engine (server/api.py reads it) -------------------

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[AutoscaleEngine] = None  # guarded-by: _ACTIVE_LOCK


def set_autoscale(engine: Optional[AutoscaleEngine]) -> None:
    """Install ``engine`` as the process-wide autoscaler (last one wins);
    ``AutoscaleEngine.__init__`` calls this automatically."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = engine


def get_autoscale() -> Optional[AutoscaleEngine]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def _default_quantile_source() -> float:
    """Worst per-class p95 of the fleet queue-wait histograms — the
    autoscaler keys on the most-starved class, not the average. With
    SDTPU_FEDERATION on, the federated worst-of-fleet p95
    (``obs/federation.py``) folds in, so the scale signal is fleet-wide
    rather than node-local."""
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        prometheus as obs_prom,
    )

    local = obs_prom.fleet_queue_wait_p95()
    try:
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            federation as obs_fed,
        )

        if obs_fed.enabled():
            return max(local, obs_fed.fleet_queue_wait_p95())
    except Exception:  # noqa: BLE001 — the scale signal stays node-local
        pass
    return local


def _default_alert_source() -> List[str]:
    """Firing scale_up-marked alert rules (``obs/alerts.py``; [] with
    SDTPU_ALERTS off)."""
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        alerts as obs_alerts,
    )

    return obs_alerts.scale_up_firing()
