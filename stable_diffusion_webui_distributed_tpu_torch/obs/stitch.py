"""Cross-node trace stitching: one timeline for a fan-out request.

Port of the JAX package's ``obs/stitch.py``. Each node's span store
timestamps its events against its own ``perf_counter`` base
(``obs/spans.py`` ``_EPOCH``), so a master's trace and a remote's cannot
be overlaid as they are. This module reads each remote's
``/internal/trace.json`` through the worker's own HTTP backend
(``HTTPBackend.fetch``: its TLS and auth), estimates the remote trace
clock's offset from the fetch's round trip (the remote's ``clock_us``
sample is taken to fall at the midpoint of the request), shifts every
remote event onto the master's clock, retags its ``pid`` as
``worker:<label>`` and merges everything into one Chrome trace: the
master's dispatch spans above each worker's generate spans, in Perfetto.
Remote events keep their ``args``, the ``device_ms`` of a device span
included.

A master's outbound job carries ``X-SDTPU-Request-Id``
(``HTTPBackend.generate``), so the remote roots its trace under the same
request id and the merged events share ``args.request_id``.

On demand only (``GET /internal/stitched-trace.json``): no thread, nothing
on the request path.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import spans

#: the per-remote fetch timeout (seconds): a dead worker must not hang the
#: stitched export
FETCH_TIMEOUT_S = 5.0


def http_timeout_s(default: float = FETCH_TIMEOUT_S) -> float:
    """The plane's outbound HTTP timeout (``SDTPU_OBS_HTTP_TIMEOUT_S``).

    Trace stitching, federation polls, push fetches and webhook delivery
    all read their timeout here, so one knob bounds how long a hung remote
    can stall any of them. Floored at 0.05 s."""
    t = env_float("SDTPU_OBS_HTTP_TIMEOUT_S", default)
    return max(0.05, float(t if t is not None else default))


def _workers_of(source: Any) -> List[Any]:
    """A World's ``workers``, or a plain iterable of workers; nothing for
    a source that is neither (a bare engine's node has no remotes)."""
    ws = getattr(source, "workers", None)
    if ws is None:
        ws = source or []
    try:
        return list(ws)
    except TypeError:
        return []


def _http(backend: Any) -> bool:
    """A backend the plane reads over HTTP: an address and a ``fetch``."""
    return bool(getattr(backend, "address", None)) \
        and callable(getattr(backend, "fetch", None))


def checked(path: str, status: int, body: bytes) -> str:
    """A fetched body as text, or ``HTTPStatusError`` for a status other
    than 2xx."""
    if not 200 <= status < 300:
        raise HTTPStatusError(status, f"GET {path} answered {status}")
    return body.decode("utf-8", "replace")


def fetch_json(backend: Any, path: str,
               timeout: Optional[float] = None) -> Any:
    """The JSON body of a GET of ``path`` on the node (``backend.fetch``);
    raises ``HTTPStatusError`` on a status other than 2xx."""
    return json.loads(checked(path, *backend.fetch(path, timeout=timeout)))


class HTTPStatusError(Exception):
    """A plane read that answered a status other than 2xx."""

    def __init__(self, status: int, detail: str) -> None:
        super().__init__(detail)
        self.status = status


def fetch_remote_trace(backend: Any,
                       timeout: Optional[float] = None,
                       ) -> Tuple[Dict[str, Any], float, float]:
    """A remote's ``/internal/trace.json``: ``(document, t0_us, t1_us)``
    with the fetch's bracket on the local trace clock."""
    if timeout is None:
        timeout = http_timeout_s()
    path = "/internal/trace.json"
    t0 = spans.now_us()
    status, body = backend.fetch(path, timeout=timeout)
    t1 = spans.now_us()
    return json.loads(checked(path, status, body)), t0, t1


def clock_offset_us(doc: Dict[str, Any], t0_us: float,
                    t1_us: float) -> Tuple[float, float]:
    """``(offset, rtt)`` in µs: a remote ``ts`` plus ``offset`` lies on the
    local trace clock. The remote's ``clock_us`` sample is taken to fall
    at the round trip's midpoint."""
    remote = float(doc.get("clock_us") or 0.0)
    rtt = max(0.0, t1_us - t0_us)
    midpoint = t0_us + rtt / 2.0
    return midpoint - remote, rtt


def merge_remote(events: List[Dict[str, Any]], doc: Dict[str, Any],
                 label: str, offset_us: float) -> int:
    """Shift one remote document's events onto the local clock and append
    them with ``pid="worker:<label>"``; returns how many."""
    remote_events = doc.get("traceEvents") or []
    for ev in remote_events:
        ev = dict(ev)
        ev["ts"] = float(ev.get("ts", 0.0)) + offset_us
        ev["pid"] = f"worker:{label}"
        events.append(ev)
    return len(remote_events)


def stitch(source: Any,
           tracer: Optional[spans.SpanTracer] = None) -> Dict[str, Any]:
    """The merged Chrome trace of the master and its remotes. ``source``
    is a World (or an iterable of workers); a worker without an HTTP
    backend adds nothing, and an unreachable one is reported in ``nodes``
    rather than failing the export."""
    tracer = tracer or spans.TRACER
    base = tracer.export_chrome()
    events: List[Dict[str, Any]] = list(base.get("traceEvents") or [])
    nodes: List[Dict[str, Any]] = [{
        "node": "master", "events": len(events),
        "offset_us": 0.0, "rtt_us": 0.0, "error": None,
    }]
    for w in _workers_of(source):
        backend = getattr(w, "backend", None)
        label = getattr(w, "label", "?")
        if backend is None or not _http(backend):
            continue
        node = {"node": f"worker:{label}", "events": 0,
                "offset_us": 0.0, "rtt_us": 0.0, "error": None}
        try:
            doc, t0, t1 = fetch_remote_trace(backend)
            offset, rtt = clock_offset_us(doc, t0, t1)
            node["offset_us"] = offset
            node["rtt_us"] = rtt
            node["events"] = merge_remote(events, doc, label, offset)
        except Exception as e:  # noqa: BLE001 — per-node fault isolation
            node["error"] = f"{type(e).__name__}: {e}"
        nodes.append(node)
    events.sort(key=lambda ev: float(ev.get("ts", 0.0)))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "clock_us": spans.now_us(), "nodes": nodes}
