"""Per-request span trees behind a ``contextvars`` request context, with
the device time of the spans that enqueue work on the card.

A copy of the JAX package's ``obs/spans.py``. One :class:`SpanTracer`
(:data:`TRACER`) holds every request trace in flight and the most recent
finished ones (``SDTPU_OBS_MAX_REQUESTS``, default 256). A request context
is minted at the HTTP server's ingress, or by the serving dispatcher for a
direct caller (:func:`maybe_request`); code on that thread, or on one
entered through :func:`bind_current` (the engine's device thread enters
every task so, ``runtime/runner.py``), opens child spans with :func:`span`,
and ``runtime/trace.py`` feeds every ``StageStats.timer`` block in as a
leaf span (:func:`stage_event`). A coalesced follower gets the leader's
device span mirrored into its own tree (:func:`mirror_span`). A request
that ends in an error, is interrupted or takes ``SDTPU_OBS_SLOW_S``
(default 30 s) or more goes to the flight recorder. ``SDTPU_OBS=0``
switches the tracer off; :func:`export_chrome` gives Chrome trace-event
JSON for Perfetto or ``chrome://tracing``.

Spans time the host with ``time.perf_counter()``, and a span never waits
for the device. The port dispatches asynchronously, so a host span around
a device stage measures how long the host took to queue its work. Spans
opened with ``device=True`` (``dispatch.device``, ``denoise_range``, and
the stage graph's ``stage.denoise`` and ``stage.decode``) therefore also
carry ``device_ms``: the engine brackets the work it queues on the card
with a pair of CUDA events (:func:`device_interval`: the denoise loop and
each decode), and each pair is added to every device span open around it
(:class:`DeviceTime`). The pairs are read only once their end event has
completed (``Event.query``): at the group's own wait for its decode, or
later at export, never through a new synchronisation. On the CPU there
are no events and no ``device_ms``.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import itertools
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.obs import (
    flightrec,
    prometheus,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
    env_float,
    env_int,
)

#: finished request traces kept for /internal/trace.json
DEFAULT_MAX_REQUESTS = 256
#: e2e seconds from which a request is flight-recorded as slow; 0 = never
DEFAULT_SLOW_S = 30.0

#: the perf_counter base of trace-event timestamps (µs)
_EPOCH = time.perf_counter()
_PID = os.getpid()

#: span ids; ``next`` on a count is atomic under the GIL
_IDS = itertools.count(1)

#: (RequestTrace, parent span id) of the code now executing, or None
_CURRENT: "contextvars.ContextVar[Optional[Tuple[RequestTrace, int]]]" = \
    contextvars.ContextVar("sdtpu_torch_obs_request",  # sdtpu-lint: metric
                           default=None)

#: the device-time accumulators open around the code now executing
_SINKS: "contextvars.ContextVar[Tuple[DeviceTime, ...]]" = \
    contextvars.ContextVar("sdtpu_torch_obs_device",  # sdtpu-lint: metric
                           default=())


class DeviceTime:
    """Pairs of CUDA events around the device work of one span or one
    dispatch, summed to milliseconds once their end events complete."""

    __slots__ = ("_lock", "_pairs", "_ms", "intervals")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pairs: List[Tuple[Any, Any]] = []  # guarded-by: _lock
        self._ms = 0.0  # guarded-by: _lock
        #: pairs ever added (0 on the CPU: no device time to report)
        self.intervals = 0

    def add(self, start, end) -> None:
        with self._lock:
            self._pairs.append((start, end))
            self.intervals += 1

    def ms(self) -> Optional[float]:
        """The bracketed device milliseconds, or None while a pair's end
        event has not completed (or when nothing was bracketed). Reads
        only completed events: never waits."""
        with self._lock:
            if not self.intervals:
                return None
            pending = []
            for start, end in self._pairs:
                if end.query():
                    self._ms += float(start.elapsed_time(end))
                else:
                    pending.append((start, end))
            self._pairs = pending
            return None if pending else self._ms


@contextlib.contextmanager
def device_sink(dev: Optional[DeviceTime]) -> Iterator[None]:
    """Let :func:`device_interval` add its pairs to ``dev`` (when not
    None) inside the block, besides the sinks already open."""
    if dev is None:
        yield
        return
    token = _SINKS.set(_SINKS.get() + (dev,))
    try:
        yield
    finally:
        _SINKS.reset(token)


class DeviceInterval:
    """The bracket :func:`device_interval` returns: a CUDA event recorded
    on ``device``'s current stream when it opens (:meth:`resume`) and one
    when it closes (:meth:`pause`), the pair added to every sink open at
    its creation. Paused around work that is not its owner's (a fleet
    yield's interloper). Inert on the CPU or with no sink open."""

    __slots__ = ("_device", "_sinks", "_start")

    def __init__(self, device) -> None:
        self._device = device
        self._sinks = _SINKS.get() \
            if getattr(device, "type", "cpu") == "cuda" else ()
        self._start = None

    def resume(self) -> None:
        if self._sinks and self._start is None:
            import torch

            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._device))

    def pause(self) -> None:
        if self._start is None:
            return
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self._device))
        for sink in self._sinks:
            sink.add(self._start, end)
        self._start = None

    def __enter__(self) -> "DeviceInterval":
        self.resume()
        return self

    def __exit__(self, *exc) -> None:
        self.pause()


def device_interval(device) -> DeviceInterval:
    """Bracket the device work a ``with`` block queues on ``device``'s
    current stream with two CUDA events, added to every open sink."""
    return DeviceInterval(device)


class Span:
    """One timed region: ``t0`` perf_counter seconds, ``dur`` seconds;
    ``dev`` the device time of a device span."""

    __slots__ = ("span_id", "parent_id", "name", "t0", "dur", "tid",
                 "attrs", "dev")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 t0: float, dur: float, tid: int, attrs: Dict[str, Any],
                 dev: Optional[DeviceTime] = None) -> None:
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.dur = dur
        self.tid = tid
        self.attrs = attrs
        self.dev = dev


class RequestTrace:
    """All spans of one request and its terminal status."""

    __slots__ = ("request_id", "name", "attrs", "t0", "dur", "status",
                 "detail", "spans", "root_id")

    def __init__(self, request_id: str, name: str,
                 attrs: Dict[str, Any]) -> None:
        self.request_id = request_id
        self.name = name
        self.attrs = attrs
        self.t0 = time.perf_counter()
        self.dur = 0.0
        self.status = "active"  # active | ok | error | interrupted | slow
        self.detail = ""
        self.spans: List[Span] = []  # appended under TRACER's lock
        self.root_id = next(_IDS)


def _span_event(req: RequestTrace, sp: Span) -> Dict[str, Any]:
    """One Chrome trace event ("X", complete; µs)."""
    args: Dict[str, Any] = {"request_id": req.request_id,
                            "span_id": sp.span_id}
    if sp.parent_id is not None:
        args["parent_id"] = sp.parent_id
    for k, v in sp.attrs.items():
        args.setdefault(str(k), v)
    if sp.dev is not None:
        ms = sp.dev.ms()
        if ms is not None:
            args["device_ms"] = ms
    return {
        "ph": "X",
        "cat": "sdtpu",
        "name": sp.name,
        "pid": _PID,
        "tid": sp.tid,
        "ts": (sp.t0 - _EPOCH) * 1e6,
        "dur": sp.dur * 1e6,
        "args": args,
    }


class SpanTracer:
    """The bounded, locked store of request traces."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_requests: Optional[int] = None,
                 slow_s: Optional[float] = None) -> None:
        if enabled is None:
            enabled = env_flag("SDTPU_OBS", True)
        if max_requests is None:
            max_requests = env_int("SDTPU_OBS_MAX_REQUESTS",
                                   DEFAULT_MAX_REQUESTS)
        if slow_s is None:
            slow_s = env_float("SDTPU_OBS_SLOW_S", DEFAULT_SLOW_S)
        #: read once here; tests and the chip smoke flip it
        self.enabled = bool(enabled)
        self.slow_s = max(0.0, float(slow_s or 0.0))
        self._lock = threading.Lock()
        self._active: Dict[str, RequestTrace] = {}  # guarded-by: _lock
        self._done: Deque[RequestTrace] = deque(
            maxlen=max(1, int(max_requests or DEFAULT_MAX_REQUESTS)))  # guarded-by: _lock

    def open(self, req: RequestTrace) -> None:
        with self._lock:
            self._active[req.request_id] = req

    def close(self, req: RequestTrace) -> None:
        with self._lock:
            self._active.pop(req.request_id, None)
            self._done.append(req)

    def record(self, req: Optional[RequestTrace], sp: Span) -> None:
        """Append a finished span to a trace (any thread)."""
        if req is None or not self.enabled:
            return
        with self._lock:
            req.spans.append(sp)

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._done.clear()

    def export_chrome(self) -> Dict[str, Any]:
        """Every kept trace as a Chrome trace-event JSON object."""
        with self._lock:
            pairs = [(req, sp)
                     for req in list(self._done) + list(self._active.values())
                     for sp in list(req.spans)]
        # events are built outside the lock: a device span reads its
        # completed CUDA events there
        events = [_span_event(req, sp) for req, sp in pairs]
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "clock_us": now_us()}

    def events_for(self, req: RequestTrace) -> List[Dict[str, Any]]:
        with self._lock:
            spans = list(req.spans)
        return [_span_event(req, sp) for sp in spans]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "active": len(self._active),
                "retained": len(self._done),
                "capacity": self._done.maxlen,
                "slow_threshold_s": self.slow_s,
            }

    def finished(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._done)


#: The process-wide tracer.
TRACER = SpanTracer()


@contextlib.contextmanager
def request(request_id: Optional[str] = None, name: str = "request",
            **attrs: Any) -> Iterator[Optional[RequestTrace]]:
    """The root context of one request: mints or takes its id, opens the
    root span, and at the end feeds the e2e histogram and hands a failed,
    interrupted or slow request to the flight recorder."""
    tr = TRACER
    if not tr.enabled:
        yield None
        return
    rid = str(request_id or uuid.uuid4().hex)
    req = RequestTrace(rid, name, dict(attrs))
    tr.open(req)
    token = _CURRENT.set((req, req.root_id))
    error: Optional[str] = None
    try:
        yield req
    except BaseException as e:  # noqa: BLE001 — recorded, then re-raised
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        _CURRENT.reset(token)
        _finish(tr, req, error)


def _finish(tr: SpanTracer, req: RequestTrace, error: Optional[str]) -> None:
    req.dur = time.perf_counter() - req.t0
    if error is not None:
        req.status, req.detail = "error", error
    elif req.status == "interrupted":
        pass  # marked while in flight (cancel)
    elif tr.slow_s > 0 and req.dur >= tr.slow_s:
        req.status = "slow"
        req.detail = f"e2e {req.dur:.3f}s >= {tr.slow_s:.3f}s threshold"
    else:
        req.status = "ok"
    root = Span(req.root_id, None, req.name, req.t0, req.dur,
                threading.get_ident(), dict(req.attrs, status=req.status))
    tr.record(req, root)
    tr.close(req)
    prometheus.observe_hist("e2e", req.dur)
    if req.status != "ok":
        flightrec.RECORDER.record(
            request_id=req.request_id, reason=req.status, detail=req.detail,
            duration_s=req.dur, events=tr.events_for(req))


@contextlib.contextmanager
def span(name: str, device: bool = False,
         **attrs: Any) -> Iterator[Optional[Span]]:
    """A child span under the active request; a cheap no-op outside one.
    ``device=True``: the span also sums the device work bracketed inside
    it (``device_ms``)."""
    tr = TRACER
    ctx = _CURRENT.get()
    if ctx is None or not tr.enabled:
        yield None
        return
    req, parent = ctx
    sp = Span(next(_IDS), parent, name, time.perf_counter(), 0.0,
              threading.get_ident(), dict(attrs),
              DeviceTime() if device else None)
    token = _CURRENT.set((req, sp.span_id))
    try:
        with device_sink(sp.dev):
            yield sp
    finally:
        _CURRENT.reset(token)
        sp.dur = time.perf_counter() - sp.t0
        tr.record(req, sp)


@contextlib.contextmanager
def maybe_request(request_id: Optional[str] = None, name: str = "request",
                  **attrs: Any) -> Iterator[Optional[RequestTrace]]:
    """:func:`request`, unless one is active already (the HTTP ingress
    minted it): then the active trace."""
    ctx = _CURRENT.get()
    if ctx is not None:
        yield ctx[0]
        return
    with request(request_id, name, **attrs) as req:
        yield req


def now_us() -> float:
    """The trace clock now (µs on the base of the events' ``ts``)."""
    return (time.perf_counter() - _EPOCH) * 1e6


def traceparent() -> Optional[str]:
    """The W3C traceparent of the active request (the trace id derived
    from the request id, so every hop agrees), or None outside one."""
    ctx = _CURRENT.get()
    if ctx is None:
        return None
    req, parent = ctx
    trace_id = hashlib.sha256(req.request_id.encode("utf-8")).hexdigest()[:32]
    span_id = f"{parent & ((1 << 64) - 1):016x}"
    return f"00-{trace_id}-{span_id}-01"


def current() -> Optional[RequestTrace]:
    ctx = _CURRENT.get()
    return None if ctx is None else ctx[0]


def current_request_id() -> Optional[str]:
    ctx = _CURRENT.get()
    return None if ctx is None else ctx[0].request_id


def add_span(req: Optional[RequestTrace], name: str, t0: float, dur: float,
             attrs: Optional[Dict[str, Any]] = None,
             parent_id: Optional[int] = None,
             lane: Optional[int] = None,
             dev: Optional[DeviceTime] = None) -> Optional[Span]:
    """Record an interval measured already into ``req`` from any thread.
    ``lane`` replaces the span's tid (the stage graph's fixed lanes,
    ``parallel/stage_graph.py`` ``LANES``); ``dev`` its device time."""
    if req is None or not TRACER.enabled:
        return None
    sp = Span(next(_IDS), req.root_id if parent_id is None else parent_id,
              name, t0, max(0.0, dur),
              threading.get_ident() if lane is None else lane,
              dict(attrs or {}), dev)
    TRACER.record(req, sp)
    return sp


def mirror_span(req: Optional[RequestTrace], name: str, src: Optional[Span],
                **attrs: Any) -> Optional[Span]:
    """``src``'s interval (and device time) copied into another request's
    trace: a coalesced follower's view of its leader's dispatch."""
    if req is None or src is None:
        return None
    return add_span(req, name, src.t0, src.dur, attrs=dict(attrs),
                    dev=src.dev)


def mark(req: Optional[RequestTrace], status: str, detail: str = "") -> None:
    """Flag a request in flight (e.g. "interrupted"); its root reads it
    when it closes."""
    if req is None:
        return
    req.status = status
    if detail:
        req.detail = detail


def stage_event(stage: str, seconds: float,
                t0: Optional[float] = None) -> None:
    """A leaf span and the stage histogram for one ``StageStats.timer``
    block (``runtime/trace.py``)."""
    prometheus.observe_stage(stage, seconds)
    tr = TRACER
    ctx = _CURRENT.get()
    if ctx is None or not tr.enabled:
        return
    req, parent = ctx
    if t0 is None:
        t0 = time.perf_counter() - seconds
    tr.record(req, Span(next(_IDS), parent, stage, t0, seconds,
                        threading.get_ident(), {}))


def bind_current(fn):
    """``fn`` wrapped to run under the caller's request context on
    another thread (a thread start does not carry contextvars)."""
    ctx = contextvars.copy_context()

    def run(*args: Any, **kwargs: Any) -> Any:
        return ctx.run(fn, *args, **kwargs)

    return run
