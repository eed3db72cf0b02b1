"""Prometheus text exposition (format 0.0.4), without a client library.

A copy of the JAX package's ``obs/prometheus.py``. Fixed-ladder latency
histograms give p50/p95/p99 where ``StageStats`` keeps rolling means:

- ``sdtpu_request_e2e_seconds``: a request's whole latency (``obs/spans.py``
  observes it when a request's root closes);
- ``sdtpu_queue_wait_seconds``: the coalesce-queue wait (dispatcher);
- ``sdtpu_device_dispatch_seconds``: a denoise chunk's host seconds
  (``StageStats.timer("denoise_chunk")`` through :func:`observe_stage`;
  on the port the time to queue the chunk);
- ``sdtpu_decode_seconds``: the decode's dispatch and its fetch;
- ``sdtpu_lora_apply_seconds`` and ``sdtpu_cold_start_seconds``;

and, by label, the gate queue wait per priority class (the autoscaler's
signal, ``fleet/slices.py``), the CUDA-graph capture seconds per kind and
the stage-graph node seconds per stage and a kernel library's load from
the artifact store per kind (``sdtpu_aot_load_seconds``). :func:`render`
adds every ``DispatchMetrics`` and ``StageStats`` scalar, the labelled
counters (the dispatch precision mix, LoRA switches, fleet admissions,
quota throttles, preemptions and requests, worker health, watchdog
stalls, cache events, artifact-store outcomes, chaos faults, alert
transitions and notification outcomes), the alert
state gauge, the worker latency EWMAs, the perf ledger's groups
(``obs/perf.py``, empty with ``SDTPU_PERF`` off) and the live ETA
mean-percent-error gauge (:data:`ETA_GAUGE`, which SLO admission falls back
to), so ``GET /internal/metrics`` holds ``/internal/status``'s numbers in
scrapeable form. :func:`register_metric` is the one way to name a family.
``obs/federation.py`` reads a remote's exposition back
(``parse_prom_text``).
"""

from __future__ import annotations

import bisect
import re
import threading
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

#: The fixed bucket ladder (seconds), the same for every histogram.
BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0)


def _fmt(v: Any) -> str:
    """A sample value: ints bare, floats by repr, None as NaN."""
    if v is None:
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


#: the longest label value exposed (tenant and class names come from users)
_MAX_LABEL_LEN = 100


def sanitize_label_value(v: Any) -> str:
    """A user-supplied label value made safe: control characters and DEL
    dropped (``\\n`` kept, it escapes), then truncated."""
    s = str(v)
    s = "".join(ch for ch in s if (ord(ch) >= 32 or ch == "\n")
                and ord(ch) != 127)
    return s[:_MAX_LABEL_LEN]


def _label(v: Any) -> str:
    s = sanitize_label_value(v)
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


# -- the metric registry -------------------------------------------------------

#: a legal family name (the exposition grammar)
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

_REGISTRY_LOCK = threading.Lock()
#: family name -> (type, help): the metric namespace
_REGISTRY: Dict[str, Tuple[str, str]] = {}  # guarded-by: _REGISTRY_LOCK


class MetricRegistrationError(ValueError):
    """A bad name or type, or a name registered again as another type."""


def register_metric(name: str, mtype: str, help_text: str) -> str:
    """Declare a family (idempotently) and return its name."""
    if not _NAME_RE.match(name):
        raise MetricRegistrationError(
            f"metric name {name!r} must match {_NAME_RE.pattern}")
    if mtype not in ("counter", "gauge", "histogram"):
        raise MetricRegistrationError(
            f"metric type {mtype!r} must be counter/gauge/histogram")
    with _REGISTRY_LOCK:
        prev = _REGISTRY.get(name)
        if prev is not None and prev[0] != mtype:
            raise MetricRegistrationError(
                f"metric {name} already registered as {prev[0]}, "
                f"not {mtype}")
        _REGISTRY[name] = (mtype, help_text)
    return name


def registered_metrics() -> Dict[str, Tuple[str, str]]:
    """The declared families: name -> (type, help)."""
    with _REGISTRY_LOCK:
        return dict(_REGISTRY)


def _bucket_label(b: float) -> str:
    return _fmt(b) if b != int(b) else f"{b:.1f}"


class Histogram:
    """Thread-safe fixed-bucket histogram (cumulative ``le`` exposition).
    ``labels`` is a rendered label body merged into every sample."""

    def __init__(self, name: str, help_text: str,
                 buckets: Iterable[float] = BUCKETS,
                 labels: str = "") -> None:
        self.name = register_metric(name, "histogram", help_text)
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
        """The bucket-upper-bound estimate of the q-quantile (0 when
        empty)."""
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

    def render(self, header: bool = True) -> List[str]:
        counts, total, n = self.snapshot()
        lines = []
        if header:
            lines += [f"# HELP {self.name} {self.help}",
                      f"# TYPE {self.name} histogram"]
        pre = f"{self.labels}," if self.labels else ""
        suf = f"{{{self.labels}}}" if self.labels else ""
        running = 0
        for bound, c in zip(self.bounds, counts):
            running += c
            lines.append(f'{self.name}_bucket{{{pre}le='
                         f'"{_bucket_label(bound)}"}} {running}')
        lines.append(f'{self.name}_bucket{{{pre}le="+Inf"}} {n}')
        lines.append(f"{self.name}_sum{suf} {_fmt(total)}")
        lines.append(f"{self.name}_count{suf} {n}")
        return lines


HISTOGRAMS: Dict[str, Histogram] = {
    "e2e": Histogram(
        "sdtpu_request_e2e_seconds",
        "End-to-end request latency (span-root duration)."),
    "queue_wait": Histogram(
        "sdtpu_queue_wait_seconds",
        "Time a request waited in the coalesce queue before its device "
        "dispatch."),
    "device_dispatch": Histogram(
        "sdtpu_device_dispatch_seconds",
        "Denoise-chunk device dispatch latency (host-observed)."),
    "decode": Histogram(
        "sdtpu_decode_seconds",
        "VAE decode latency (dispatch + fetch halves observed "
        "separately)."),
    "lora_apply": Histogram(
        "sdtpu_lora_apply_seconds",
        "LoRA adapter activation latency: traced factor-set builds "
        "(SDTPU_LORA_TRACED, host-side padding/bucketing only — zero "
        "merges, zero recompiles) observed per build."),
    "cold_start": Histogram(
        "sdtpu_cold_start_seconds",
        "Fresh-engine time to first served image (warm pool spawns, "
        "fleet/pool.py)."),
}

#: StageStats stage -> histogram key (other stages appear only as
#: ``sdtpu_stage_seconds`` gauges)
STAGE_TO_HIST: Dict[str, str] = {
    "denoise_chunk": "device_dispatch",
    "vae_decode_dispatch": "decode",
    "vae_decode_fetch": "decode",
}


def observe_hist(name: str, value: float) -> None:
    h = HISTOGRAMS.get(name)
    if h is not None:
        h.observe(value)


def observe_lora_apply(seconds: float) -> None:
    """One traced factor-set build (``Engine._traced_set_for``)."""
    HISTOGRAMS["lora_apply"].observe(seconds)


def observe_stage(stage: str, seconds: float) -> None:
    key = STAGE_TO_HIST.get(stage)
    if key is not None:
        HISTOGRAMS[key].observe(seconds)


def observe_cold_start(seconds: float) -> None:
    """One fresh engine's time to its first image (pool spawns)."""
    HISTOGRAMS["cold_start"].observe(seconds)


# -- capture latency (runtime/graphs.py through obs/perf.py) -----------------

_COMPILE_LOCK = threading.Lock()
#: per-kind capture-latency histograms, made at the first capture
_COMPILE_LAT: Dict[str, Histogram] = {}  # guarded-by: _COMPILE_LOCK


def observe_compile(kind: str, seconds: float) -> None:
    """One CUDA-graph capture's seconds (its eager first call and the
    capture), by graph kind; the perf ledger reports it with
    ``SDTPU_PERF`` on."""
    with _COMPILE_LOCK:
        h = _COMPILE_LAT.get(kind)
        if h is None:
            h = Histogram(
                "sdtpu_compile_seconds",
                "CUDA-graph capture latency (eager first call + capture) "
                "by graph kind.",
                labels=f'kind="{_label(kind)}"')
            _COMPILE_LAT[kind] = h
    h.observe(seconds)


# -- the kernel-library artifact store (serving/aot.py) ----------------------

_AOT_LOAD_LOCK = threading.Lock()
#: per-kind load latency of a library from the artifact store (its hash
#: check and ``ctypes`` load), made at the first load; a sibling of
#: sdtpu_compile_seconds, never the same family
_AOT_LOAD_LAT: Dict[str, Histogram] = {}  # guarded-by: _AOT_LOAD_LOCK


def observe_aot_load(kind: str, seconds: float) -> None:
    """One library's load from the store, by kind (its source's stem)."""
    with _AOT_LOAD_LOCK:
        h = _AOT_LOAD_LAT.get(kind)
        if h is None:
            h = Histogram(
                "sdtpu_aot_load_seconds",
                "AOT artifact deserialize latency by stage kind.",
                labels=f'kind="{_label(kind)}"')
            _AOT_LOAD_LAT[kind] = h
    h.observe(seconds)


# -- the stage-graph executor (parallel/stage_graph.py) -----------------------

_STAGE_GRAPH_LOCK = threading.Lock()
#: per-stage-node host seconds, made at the first observation; not
#: sdtpu_stage_seconds, a gauge family of its own
_STAGE_GRAPH_LAT: Dict[str, Histogram] = {}  # guarded-by: _STAGE_GRAPH_LOCK


def observe_stage_graph(stage: str, seconds: float) -> None:
    """One stage-graph node's host interval (encode, denoise dispatch,
    decode dispatch, merge fetch), by stage name."""
    with _STAGE_GRAPH_LOCK:
        h = _STAGE_GRAPH_LAT.get(stage)
        if h is None:
            h = Histogram(
                "sdtpu_stage_graph_seconds",
                "Stage-graph node host seconds by stage.",
                labels=f'stage="{_label(stage)}"')
            _STAGE_GRAPH_LAT[stage] = h
    h.observe(seconds)


def stage_graph_histograms() -> Dict[str, Histogram]:
    """The stage-graph histograms by stage name."""
    with _STAGE_GRAPH_LOCK:
        return dict(_STAGE_GRAPH_LAT)


# -- labelled counters ---------------------------------------------------------

class LabeledCounter:
    """Thread-safe counter family with a fixed label-name tuple."""

    def __init__(self, name: str, help_text: str,
                 label_names: Tuple[str, ...]) -> None:
        self.name = register_metric(name, "counter", help_text)
        self.help = help_text
        self.label_names = label_names
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, ...], float] = {}  # guarded-by: _lock

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        key = tuple(str(labels.get(ln, "")) for ln in self.label_names)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0.0) + float(n)

    def value(self, **labels: Any) -> float:
        key = tuple(str(labels.get(ln, "")) for ln in self.label_names)
        with self._lock:
            return self._counts.get(key, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._counts.values())

    def snapshot(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._counts)

    def clear(self) -> None:
        with self._lock:
            self._counts = {}

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        snap = self.snapshot()
        for key in sorted(snap):
            body = ",".join(f'{ln}="{_label(v)}"'
                            for ln, v in zip(self.label_names, key))
            lines.append(f"{self.name}{{{body}}} {_fmt(snap[key])}")
        return lines


#: the fleet tier's counters (fleet/policy.py and the dispatcher feed them)
FLEET_COUNTERS: Dict[str, LabeledCounter] = {
    "admissions": LabeledCounter(
        "sdtpu_fleet_admissions_total",
        "Admission decisions by class and outcome "
        "(accept/degrade/reject).", ("class", "decision")),
    "quota_throttles": LabeledCounter(
        "sdtpu_fleet_quota_throttles_total",
        "Requests throttled by per-tenant token-bucket quotas.",
        ("tenant",)),
    "preemptions": LabeledCounter(
        "sdtpu_fleet_preemptions_total",
        "Chunk-boundary device yields by the preempted job's class.",
        ("class",)),
    "requests": LabeledCounter(
        "sdtpu_fleet_requests_total",
        "Requests entering the fleet gate by tenant and class.",
        ("tenant", "class")),
}

#: device dispatches by resolved serving precision, weighted by the
#: requests each carried (:func:`count_precision`)
PRECISION_COUNTER = LabeledCounter(
    "sdtpu_dispatch_precision_total",
    "Requests dispatched to the device by resolved serving precision.",
    ("precision",))

#: adapter-set activations by mode: ``merged`` (merged into the weights)
#: or ``traced`` (a factor set riding into the evaluations)
LORA_SWITCH_COUNTER = LabeledCounter(
    "sdtpu_lora_switch_total",
    "LoRA adapter-set switches by serving mode (merged/traced).",
    ("mode",))


def count_lora_switch(mode: str, n: float = 1.0) -> None:
    LORA_SWITCH_COUNTER.inc(n, mode=mode)


#: worker health (WorkerHealth and the World's requeue feed them)
WORKER_COUNTERS: Dict[str, LabeledCounter] = {
    "requests": LabeledCounter(
        "sdtpu_worker_requests_total",
        "Generation requests sent to each worker backend.", ("worker",)),
    "failures": LabeledCounter(
        "sdtpu_worker_failures_total",
        "Failed generation requests per worker.", ("worker",)),
    "requeued_images": LabeledCounter(
        "sdtpu_worker_requeued_images_total",
        "Images requeued away from a failed worker.", ("worker",)),
    "transitions": LabeledCounter(
        "sdtpu_worker_state_transitions_total",
        "Worker state-machine transitions by destination state.",
        ("worker", "to")),
}

#: the hang watchdog's stalls (obs/watchdog.py), by watched operation
WATCHDOG_COUNTER = LabeledCounter(
    "sdtpu_watchdog_stalls_total",
    "Dispatches or remote jobs that exceeded k x their ETA "
    "(SDTPU_WATCHDOG_FACTOR).", ("name",))

#: the caching tier's events by layer and outcome (cache/)
CACHE_COUNTER = LabeledCounter(
    "sdtpu_cache_events_total",
    "Caching-tier events (SDTPU_CACHE) by layer and outcome.",
    ("layer", "outcome"))


def cache_count(layer: str, outcome: str, n: float = 1.0) -> None:
    """One caching-tier event: ``layer`` embed_pos, embed_neg, result or
    prefix; ``outcome`` hit, miss, joined, resumed or captured."""
    CACHE_COUNTER.inc(n, layer=layer, outcome=outcome)


#: chaos faults delivered by sim/chaos.py, by kind
SIM_FAULT_COUNTER = LabeledCounter(
    "sdtpu_sim_faults_total",
    "Chaos faults injected by the scenario engine (SDTPU_SIM) by kind.",
    ("kind",))


def sim_fault_count(kind: str, n: float = 1.0) -> None:
    SIM_FAULT_COUNTER.inc(n, kind=kind)


#: artifact-store events by outcome: ``hit`` (a library loaded from the
#: store), ``miss`` (no cell: built), ``saved`` (a build stored),
#: ``fallback`` (a cell of another fingerprint or damaged: built, journaled
#: as ``aot_fallback``). Fed by serving/aot.py and ops/nvcc.py.
AOT_COUNTER = LabeledCounter(
    "sdtpu_aot_total",
    "AOT executable artifact events (SDTPU_AOT) by outcome.",
    ("outcome",))


def aot_count(outcome: str, n: float = 1.0) -> None:
    AOT_COUNTER.inc(n, outcome=outcome)


_SIM_LOCK = threading.Lock()
#: worst per-(tenant, class) SLO burn rate from the last scored scenario
#: run; None until ``sim/score.py`` scores one, omitted from the exposition
#: while None
_SIM_SLO_BURN: Optional[float] = None  # guarded-by: _SIM_LOCK


def set_sim_slo_burn(value: Optional[float]) -> None:
    """Record the last scenario run's worst SLO burn rate (sim/score.py)."""
    global _SIM_SLO_BURN
    with _SIM_LOCK:
        _SIM_SLO_BURN = None if value is None else float(value)


def sim_slo_burn() -> Optional[float]:
    with _SIM_LOCK:
        return _SIM_SLO_BURN

#: alert state transitions by rule and state (firing / resolved), from
#: ``obs/alerts.py``
ALERT_COUNTER = LabeledCounter(
    "sdtpu_alerts_total",
    "Alert state transitions (SDTPU_ALERTS) by rule and state.",
    ("rule", "state"))

_ALERT_LOCK = threading.Lock()
#: rule name -> 1.0 while firing, 0.0 once resolved; a rule is absent until
#: its first transition
_ALERT_STATE: Dict[str, float] = {}  # guarded-by: _ALERT_LOCK


def alert_count(rule: str, state: str, n: float = 1.0) -> None:
    ALERT_COUNTER.inc(n, rule=rule, state=state)


def set_alert_state(rule: str, value: float) -> None:
    with _ALERT_LOCK:
        _ALERT_STATE[str(rule)] = float(value)


def alert_states() -> Dict[str, float]:
    with _ALERT_LOCK:
        return dict(_ALERT_STATE)


#: webhook delivery outcomes (sent / failed / deduped / dropped) from
#: ``obs/notify.py``, by channel (the severity route, or "default")
NOTIFY_COUNTER = LabeledCounter(
    "sdtpu_notify_total",
    "Alert notification delivery outcomes (SDTPU_NOTIFY_URL / "
    "SDTPU_NOTIFY_ROUTES) by channel and outcome.",
    ("channel", "outcome"))


def notify_count(outcome: str, n: float = 1.0,
                 channel: str = "default") -> None:
    NOTIFY_COUNTER.inc(n, channel=channel, outcome=outcome)


_WORKER_LOCK = threading.Lock()
#: per-worker generate-latency EWMA
_WORKER_LATENCY_EWMA: Dict[str, float] = {}  # guarded-by: _WORKER_LOCK


def worker_count(name: str, n: float = 1.0, **labels: Any) -> None:
    c = WORKER_COUNTERS.get(name)
    if c is not None:
        c.inc(n, **labels)


def set_worker_latency(worker: str, ewma_s: float) -> None:
    with _WORKER_LOCK:
        _WORKER_LATENCY_EWMA[str(worker)] = float(ewma_s)


def count_watchdog_stall(name: str) -> None:
    WATCHDOG_COUNTER.inc(name=name)


def watchdog_stalls_total() -> float:
    return WATCHDOG_COUNTER.total()


def fleet_count(name: str, n: float = 1.0, **labels: Any) -> None:
    c = FLEET_COUNTERS.get(name)
    if c is not None:
        c.inc(n, **labels)


def count_precision(precision: str, n: float = 1.0) -> None:
    """One device dispatch carrying ``n`` requests at ``precision``."""
    if precision:
        PRECISION_COUNTER.inc(n, precision=precision)


_FLEET_LOCK = threading.Lock()
#: per-class gate queue-wait histograms, made at the first observation
_FLEET_QUEUE_WAIT: Dict[str, Histogram] = {}  # guarded-by: _FLEET_LOCK


def fleet_observe_queue_wait(cls: str, seconds: float) -> None:
    """One request's gate queue wait under its priority class."""
    with _FLEET_LOCK:
        h = _FLEET_QUEUE_WAIT.get(cls)
        if h is None:
            h = Histogram(
                "sdtpu_fleet_queue_wait_seconds",
                "Gate queue wait by priority class.",
                labels=f'class="{_label(cls)}"')
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


def clear_histograms() -> None:
    """Forget every observation and count (tests, phases)."""
    for h in HISTOGRAMS.values():
        h.clear()
    with _FLEET_LOCK:
        _FLEET_QUEUE_WAIT.clear()
    with _COMPILE_LOCK:
        _COMPILE_LAT.clear()
    with _AOT_LOAD_LOCK:
        _AOT_LOAD_LAT.clear()
    with _STAGE_GRAPH_LOCK:
        _STAGE_GRAPH_LAT.clear()
    for c in FLEET_COUNTERS.values():
        c.clear()
    PRECISION_COUNTER.clear()
    LORA_SWITCH_COUNTER.clear()
    for c in WORKER_COUNTERS.values():
        c.clear()
    WATCHDOG_COUNTER.clear()
    CACHE_COUNTER.clear()
    AOT_COUNTER.clear()
    SIM_FAULT_COUNTER.clear()
    ALERT_COUNTER.clear()
    NOTIFY_COUNTER.clear()
    with _ALERT_LOCK:
        _ALERT_STATE.clear()
    set_sim_slo_burn(None)
    with _WORKER_LOCK:
        _WORKER_LATENCY_EWMA.clear()


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


# -- the exposition ------------------------------------------------------------

def _scalar(lines: List[str], name: str, mtype: str, help_text: str,
            value: Any, labels: str = "") -> None:
    register_metric(name, mtype, help_text)
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} {mtype}")
    lines.append(f"{name}{labels} {_fmt(value)}")


def _labeled_family(lines: List[str], name: str, mtype: str,
                    help_text: str,
                    samples: List[Tuple[str, Any]]) -> None:
    """One HELP/TYPE header and a sample per (label body, value); a family
    without samples is left out."""
    if not samples:
        return
    register_metric(name, mtype, help_text)
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} {mtype}")
    for body, value in samples:
        lines.append(f"{name}{{{body}}} {_fmt(value)}")


def _render_perf(lines: List[str]) -> None:
    """The perf ledger's families: per-(bucket, cadence, precision, lora)
    MFU, padding and device seconds, and per-(tenant, class) SLO gauges;
    absent until ``SDTPU_PERF`` records something."""
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        perf as obs_perf,
    )

    s = obs_perf.LEDGER.summary()

    def body(g):
        return (f'bucket="{_label(g["bucket"])}",'
                f'cadence="{g["cadence"]}",'
                f'precision="{_label(g["precision"])}",'
                f'lora="{_label(g.get("lora", ""))}"')

    groups = s["groups"]
    _labeled_family(
        lines, "sdtpu_perf_dispatches_total", "counter",
        "Device dispatches by serving group (perf ledger).",
        [(body(g), g["dispatches"]) for g in groups])
    _labeled_family(
        lines, "sdtpu_perf_device_seconds_total", "counter",
        "Device seconds (CUDA events around each dispatch's denoise and "
        "decode) by serving group.",
        [(body(g), g["device_s"]) for g in groups])
    _labeled_family(
        lines, "sdtpu_perf_flops_total", "counter",
        "Dispatched UNet FLOPs by serving group (FlopCounterMode priced).",
        [(body(g), g["flops"]) for g in groups])
    _labeled_family(
        lines, "sdtpu_perf_mfu", "gauge",
        "Live MFU: dispatched FLOPs / device seconds / chip peak "
        "(NaN when the peak is unknown, e.g. CPU).",
        [(body(g), g["mfu"]) for g in groups])
    _labeled_family(
        lines, "sdtpu_perf_padding_ratio", "gauge",
        "Padded-dispatched pixels / true-requested pixels by group.",
        [(body(g), g["padding_ratio"]) for g in groups])
    _labeled_family(
        lines, "sdtpu_perf_padding_waste", "gauge",
        "Fraction of dispatched pixels that were bucket padding.",
        [(body(g), g["padding_waste"]) for g in groups])
    _labeled_family(
        lines, "sdtpu_perf_compute_padding_ratio", "gauge",
        "Attention-computed pixels / true-requested pixels by group "
        "(masked ragged rows excluded from the numerator).",
        [(body(g), g.get("compute_padding_ratio")) for g in groups])
    _labeled_family(
        lines, "sdtpu_perf_token_padding_ratio", "gauge",
        "Padded conditioning tokens / true prompt tokens by group.",
        [(body(g), g.get("token_padding_ratio")) for g in groups])

    def slo_body(r):
        return (f'tenant="{_label(r["tenant"])}",'
                f'class="{_label(r["class"])}"')

    slo = s["slo"]
    _labeled_family(
        lines, "sdtpu_fleet_slo_attainment", "gauge",
        "Fraction of fleet-gated requests meeting their SLO, by tenant "
        "and class.", [(slo_body(r), r["attainment"]) for r in slo])
    _labeled_family(
        lines, "sdtpu_fleet_slo_burn_rate", "gauge",
        "Windowed SLO miss fraction over the error budget (1.0 = burning "
        "exactly the budget).", [(slo_body(r), r["burn_rate"]) for r in slo])


def _labeled_histograms(lines: List[str], lock: threading.Lock,
                        hists: Dict[str, Histogram]) -> None:
    with lock:
        ordered = [hists[k] for k in sorted(hists)]
    for i, h in enumerate(ordered):
        lines.extend(h.render(header=(i == 0)))


def render() -> str:
    """The ``/internal/metrics`` body."""
    from stable_diffusion_webui_distributed_tpu_torch.runtime.trace import (
        STATS,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
        METRICS,
    )

    lines: List[str] = []
    for h in HISTOGRAMS.values():
        lines.extend(h.render())

    s = METRICS.summary()
    _scalar(lines, "sdtpu_serving_requests_total", "counter",
            "Requests accepted by the serving dispatcher.", s["requests"])
    _scalar(lines, "sdtpu_serving_bucket_hits_total", "counter",
            "Requests whose shape matched a bucket exactly.",
            s["bucket_hits"])
    _scalar(lines, "sdtpu_serving_bucket_misses_total", "counter",
            "Requests padded up to a bucket.", s["bucket_misses"])
    _scalar(lines, "sdtpu_serving_bucket_bypasses_total", "counter",
            "Requests that bypassed bucketing (hires/img2img/no fit).",
            s["bucket_bypasses"])
    _scalar(lines, "sdtpu_serving_bucket_hit_rate", "gauge",
            "bucket_hits / (bucket_hits + bucket_misses).",
            s["bucket_hit_rate"])
    _scalar(lines, "sdtpu_serving_dispatches_total", "counter",
            "Device batches executed.", s["dispatches"])
    _scalar(lines, "sdtpu_serving_coalesced_dispatches_total", "counter",
            "Dispatches that merged >= 2 requests.",
            s["coalesced_dispatches"])
    _scalar(lines, "sdtpu_serving_coalesce_factor", "gauge",
            "Mean requests per device dispatch.", s["coalesce_factor"])
    _scalar(lines, "sdtpu_serving_avg_queue_wait_seconds", "gauge",
            "Rolling mean coalesce-queue wait.", s["avg_queue_wait_s"])
    _scalar(lines, "sdtpu_serving_avg_padding_ratio", "gauge",
            "Mean bucket-px / requested-px over bucketed requests.",
            s["avg_padding_ratio"])
    _scalar(lines, "sdtpu_serving_unet_flops_total", "counter",
            "UNet FLOPs dispatched (FlopCounterMode pricing).",
            s["unet_flops_total"])
    _scalar(lines, "sdtpu_serving_unet_images_total", "counter",
            "Images decoded to outputs.", s["unet_images"])
    _scalar(lines, "sdtpu_serving_unet_flops_per_image", "gauge",
            "Mean dispatched UNet FLOPs per output image.",
            s["unet_flops_per_image"])

    _labeled_family(
        lines, "sdtpu_stage_compiles_total", "counter",
        "CUDA-graph captures (one per evaluation signature) by graph kind.",
        [(f'kind="{_label(kind)}"', s["compiles"][kind])
         for kind in sorted(s["compiles"])])
    _labeled_family(
        lines, "sdtpu_stage_cache_hits_total", "counter",
        "Captured CUDA-graph replays by graph kind.",
        [(f'kind="{_label(kind)}"', s["cache_hits"][kind])
         for kind in sorted(s["cache_hits"])])

    timings = STATS.summary()
    _labeled_family(
        lines, "sdtpu_stage_seconds", "gauge",
        "Rolling stage wall-clock stats (StageStats window).",
        [(f'stage="{_label(stage)}",stat="{stat}"', timings[stage][stat])
         for stage in sorted(timings)
         for stat in ("mean", "p50", "last")])
    _labeled_family(
        lines, "sdtpu_stage_samples", "gauge",
        "Rolling StageStats sample count per stage.",
        [(f'stage="{_label(stage)}"', timings[stage]["count"])
         for stage in sorted(timings)])

    lines.extend(PRECISION_COUNTER.render())
    lines.extend(LORA_SWITCH_COUNTER.render())
    for c in FLEET_COUNTERS.values():
        lines.extend(c.render())
    for c in WORKER_COUNTERS.values():
        lines.extend(c.render())
    lines.extend(WATCHDOG_COUNTER.render())
    lines.extend(CACHE_COUNTER.render())
    lines.extend(AOT_COUNTER.render())
    lines.extend(SIM_FAULT_COUNTER.render())
    lines.extend(ALERT_COUNTER.render())
    lines.extend(NOTIFY_COUNTER.render())
    _labeled_family(
        lines, "sdtpu_alert_state", "gauge",
        "Current alert state by rule (1 = firing, 0 = resolved/ok); "
        "rules absent until their first transition.",
        [(f'rule="{_label(k)}"', v)
         for k, v in sorted(alert_states().items())])
    burn = sim_slo_burn()
    if burn is not None:
        _scalar(lines, "sdtpu_sim_slo_burn", "gauge",
                "Worst per-(tenant, class) SLO burn rate from the last "
                "scored scenario run (sim/score.py).", burn)
    with _WORKER_LOCK:
        worker_lat = dict(_WORKER_LATENCY_EWMA)
    _labeled_family(
        lines, "sdtpu_worker_latency_ewma_seconds", "gauge",
        "EWMA of per-worker generate latency (WorkerHealth window).",
        [(f'worker="{_label(k)}"', v)
         for k, v in sorted(worker_lat.items())])
    _labeled_histograms(lines, _FLEET_LOCK, _FLEET_QUEUE_WAIT)
    _labeled_histograms(lines, _COMPILE_LOCK, _COMPILE_LAT)
    _labeled_histograms(lines, _AOT_LOAD_LOCK, _AOT_LOAD_LAT)
    _labeled_histograms(lines, _STAGE_GRAPH_LOCK, _STAGE_GRAPH_LAT)
    _render_perf(lines)

    eta = ETA_GAUGE.summary()
    _scalar(lines, "sdtpu_eta_mpe_percent", "gauge",
            "Live ETA mean percent error (paper MPE window).",
            eta["mpe_percent"])
    _scalar(lines, "sdtpu_eta_samples_total", "counter",
            "Accepted predicted-vs-actual ETA samples.", eta["samples"])
    return "\n".join(lines) + "\n"
