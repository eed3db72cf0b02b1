"""The parts of the JAX package's ``obs/prometheus.py`` the fleet tier
reads.

- :class:`Histogram`: thread-safe, on the fixed bucket ladder
  :data:`BUCKETS`, with the bucket-upper-bound :meth:`~Histogram.quantile`;
- :func:`fleet_observe_queue_wait` / :func:`fleet_queue_wait_p95`: one
  gate queue-wait histogram per priority class, fed by the serving
  dispatcher, read by the autoscaler (``fleet/slices.py``);
- :class:`EtaGauge` / :data:`ETA_GAUGE`: the live predicted-vs-actual ETA
  error across every backend, fed by ``scheduler/eta.record_eta_error``;
  SLO admission (``scheduler/eta.admission_eta``) falls back to it when a
  calibration has no error history of its own.

- :func:`observe_stage_graph` / :func:`stage_graph_histograms`: one
  ``sdtpu_stage_graph_seconds`` histogram per stage-graph node name
  (encode, denoise, decode, merge), fed by ``parallel/stage_graph.py``;
- :class:`LabeledCounter` and :data:`SIM_FAULT_COUNTER`
  (``sdtpu_sim_faults_total{kind}``), fed by the chaos plan
  (``sim/chaos.py``) through :func:`sim_fault_count`.

Left for ROADMAP item 10, with the rest of the exporter: the metric
registry and its text exposition (``/internal/metrics``), the request,
compile and cold-start histograms, and the other labelled counters
(``fleet_count`` among them).
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

#: The fixed bucket ladder (seconds), the JAX package's.
BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0)


class Histogram:
    """Thread-safe fixed-bucket histogram (``name``, ``help`` and
    ``labels`` are kept for the exposition item 10 brings)."""

    def __init__(self, name: str, help_text: str,
                 buckets: Iterable[float] = BUCKETS,
                 labels: str = "") -> None:
        self.name = name
        self.help = help_text
        self.labels = labels
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts: List[int] = [0] * (len(self.bounds) + 1)  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock

    def observe(self, value: float) -> None:
        v = float(value)
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def clear(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts with the +Inf overflow, sum, count)."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (0 when empty)."""
        counts, _total, n = self.snapshot()
        if n <= 0:
            return 0.0
        target = q * n
        running = 0
        for i, c in enumerate(counts):
            running += c
            if running >= target:
                return self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1]
        return self.bounds[-1]


_FLEET_LOCK = threading.Lock()
#: per-class queue-wait histograms, made at the first observation
_FLEET_QUEUE_WAIT: Dict[str, Histogram] = {}  # guarded-by: _FLEET_LOCK


def fleet_observe_queue_wait(cls: str, seconds: float) -> None:
    """One request's gate queue wait under its priority class."""
    with _FLEET_LOCK:
        h = _FLEET_QUEUE_WAIT.get(cls)
        if h is None:
            h = Histogram("sdtpu_fleet_queue_wait_seconds",
                          "Gate queue wait by priority class.",
                          labels=f'class="{cls}"')
            _FLEET_QUEUE_WAIT[cls] = h
    h.observe(seconds)


def fleet_queue_wait_p95(cls: Optional[str] = None) -> float:
    """The p95 gate wait of one class, or of the worst class when ``cls``
    is None (the autoscale signal keys on the most-starved class)."""
    with _FLEET_LOCK:
        hists = ([_FLEET_QUEUE_WAIT[cls]]
                 if cls is not None and cls in _FLEET_QUEUE_WAIT
                 else list(_FLEET_QUEUE_WAIT.values()))
    if not hists:
        return 0.0
    return max(h.quantile(0.95) for h in hists)


_STAGE_GRAPH_LOCK = threading.Lock()
#: per-stage-node host seconds, made at the first observation
_STAGE_GRAPH_LAT: Dict[str, Histogram] = {}  # guarded-by: _STAGE_GRAPH_LOCK


def observe_stage_graph(stage: str, seconds: float) -> None:
    """One stage-graph node's host interval (encode, denoise dispatch,
    decode dispatch, merge fetch), by stage name."""
    with _STAGE_GRAPH_LOCK:
        h = _STAGE_GRAPH_LAT.get(stage)
        if h is None:
            h = Histogram("sdtpu_stage_graph_seconds",
                          "Stage-graph node host seconds by stage.",
                          labels=f'stage="{stage}"')
            _STAGE_GRAPH_LAT[stage] = h
    h.observe(seconds)


def stage_graph_histograms() -> Dict[str, Histogram]:
    """The stage-graph histograms by stage name."""
    with _STAGE_GRAPH_LOCK:
        return dict(_STAGE_GRAPH_LAT)


def clear_histograms() -> None:
    """Forget every fleet queue-wait and stage-graph observation (tests,
    phases)."""
    with _FLEET_LOCK:
        _FLEET_QUEUE_WAIT.clear()
    with _STAGE_GRAPH_LOCK:
        _STAGE_GRAPH_LAT.clear()


class LabeledCounter:
    """Thread-safe counter family with a fixed label-name tuple."""

    def __init__(self, name: str, help_text: str,
                 label_names: Tuple[str, ...]) -> None:
        self.name = name
        self.help = help_text
        self.label_names = label_names
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, ...], float] = {}  # guarded-by: _lock

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        key = tuple(str(labels.get(ln, "")) for ln in self.label_names)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0.0) + float(n)

    def total(self) -> float:
        with self._lock:
            return sum(self._counts.values())


SIM_FAULT_COUNTER = LabeledCounter(
    "sdtpu_sim_faults_total",
    "Chaos faults injected by the scenario engine (SDTPU_SIM) by kind.",
    ("kind",))


def sim_fault_count(kind: str, n: float = 1.0) -> None:
    SIM_FAULT_COUNTER.inc(n, kind=kind)


class EtaGauge:
    """Live predicted-vs-actual ETA error across every backend: the
    calibration's MPE feedback as one process-wide gauge, with the same
    window and the same |error| >= 500% rejection."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # window and rejection from scheduler.eta at the first record (an
        # import here would pull the scheduler package in)
        self._errors: Optional[Deque[float]] = None  # guarded-by: _lock
        self._samples = 0  # guarded-by: _lock
        self._last_predicted: Optional[float] = None  # guarded-by: _lock
        self._last_actual: Optional[float] = None  # guarded-by: _lock

    def record(self, predicted: float, actual: float) -> None:
        from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
            eta as eta_mod,
        )

        if actual <= 0 or predicted <= 0:
            return
        error = (predicted - actual) / actual * 100.0
        if abs(error) >= eta_mod.MPE_REJECT_ABS_PERCENT:
            return
        with self._lock:
            if self._errors is None:
                self._errors = deque(maxlen=eta_mod.MPE_WINDOW)
            self._errors.append(error)
            self._samples += 1
            self._last_predicted = float(predicted)
            self._last_actual = float(actual)

    def mpe(self) -> float:
        with self._lock:
            if not self._errors:
                return 0.0
            return sum(self._errors) / len(self._errors)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            mpe = (sum(self._errors) / len(self._errors)
                   if self._errors else 0.0)
            return {
                "mpe_percent": mpe,
                "samples": self._samples,
                "last_predicted_s": self._last_predicted,
                "last_actual_s": self._last_actual,
            }

    def clear(self) -> None:
        with self._lock:
            self._errors = None
            self._samples = 0
            self._last_predicted = None
            self._last_actual = None


#: The process-wide ETA calibration gauge (scheduler/eta.py feeds it).
ETA_GAUGE = EtaGauge()
