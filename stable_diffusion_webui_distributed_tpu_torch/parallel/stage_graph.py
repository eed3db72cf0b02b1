"""The stage-graph executor: encode, denoise, ControlNet and decode of
several groups overlapped on the host timeline.

Port of the JAX package's ``parallel/stage_graph.py``. One host thread
drives the card: each stage dispatches its device work without waiting
for it (the engine's ``sync=False`` denoise, the decode into pinned host
memory behind a CUDA event), so the host runs ahead and group *i*'s image
fetch and PNG encode, or group *i+1*'s prompt encode, overlap group
*i+1*'s denoise on the card.

- :class:`StageGraph` — one dispatch group's stages as named nodes with
  data-dependency edges, run in insertion (= topological) order on the
  calling thread.
- :class:`GraphRunner` — the depth-limited FIFO window of groups in
  flight. ``submit`` runs a graph's nodes now and defers its ``flush``
  (the host materialisation of the decode) until more than ``depth``
  groups are in flight; ``drain`` flushes everything in order, which is
  also the interrupt and preempt seam (the gallery is in global image
  order, so the oldest group always materialises first).
- :class:`OverlapClock` — host-timeline accounting: encode, decode and
  merge intervals are scored against the OTHER groups' open or closed
  denoise windows, giving the ``stage_overlap_ratio``. Overlap is
  measured, never assumed.

Byte identity: the graph never changes WHAT is computed (every draw is
keyed by global image index, the denoise runs the same evaluations on the
engine's one stream, and only the host's pacing changes), so staged images
are byte-identical to the serial path's.

Gate: ``SDTPU_STAGE_GRAPH`` (off). ``SDTPU_STAGE_DEPTH`` sizes the window;
``SDTPU_STAGE_CN_DEVICES`` the devices of the stage-ahead ControlNet tower
(``pipeline/engine.py`` ``Engine._stage_cn_device``).

Each node's host seconds feed ``sdtpu_stage_graph_seconds`` (labelled by
stage, ``obs/prometheus.py``) and are drawn as a ``stage.<name>`` span of
the active request on the stage's fixed trace lane (:data:`LANES`), so
``/internal/trace.json`` shows overlapped stages of several groups on one
swimlane per stage; ``stage.denoise`` and ``stage.decode`` also carry the
``device_ms`` of the work they queued (``obs/spans.py``). The module
imports no torch.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
    env_int,
)

__all__ = [
    "CLOCK",
    "GraphRunner",
    "OverlapClock",
    "StageGraph",
    "StageNode",
    "cn_slice_devices",
    "depth",
    "enabled",
    "to_mesh",
]

#: Fixed trace lanes (a trace's tid) so every stage kind gets its own
#: swimlane.
LANES = {
    "encode": -101,
    "controlnet": -102,
    "denoise": -103,
    "decode": -104,
    "merge": -105,
    "refine": -106,
}


#: the stages whose spans carry the device time of the work they queue
DEVICE_STAGES = ("denoise", "decode")


def enabled() -> bool:
    """SDTPU_STAGE_GRAPH: txt2img (the engine) and coalesced groups (the
    serving dispatcher) through the stage-graph executor."""
    return env_flag("SDTPU_STAGE_GRAPH", False)


def depth() -> int:
    """SDTPU_STAGE_DEPTH: the groups in flight (>= 1). Depth 1 is the
    serial loop's one decode trailing one group."""
    return max(1, env_int("SDTPU_STAGE_DEPTH", 1))


def cn_slice_devices() -> int:
    """SDTPU_STAGE_CN_DEVICES: devices carved off for the ControlNet
    stage (0 = evaluate on the UNet's device)."""
    return max(0, env_int("SDTPU_STAGE_CN_DEVICES", 0))


def to_mesh(x, mesh, batch: bool):
    """``x`` on ``mesh``, a device of the port (one card per tower, so
    ``batch`` changes nothing); None leaves it where it is, as the JAX
    package's ``mesh=None`` does."""
    del batch
    if mesh is None or x is None:
        return x
    return x.to(mesh, non_blocking=True)


class OverlapClock:
    """Host-timeline overlap accounting across dispatch groups.

    A denoise window opens when a group's denoise stage starts
    dispatching and closes when the group's flush has its images (the
    async path) or when a blocking denoise returns. A stage interval
    (encode, decode dispatch, merge fetch) scores the seconds it spent
    inside ANY other group's denoise window; its own group is excluded,
    so a stage never overlaps the denoise it feeds. Open windows clamp to
    "now"."""

    _KEEP = 512  # windows retained

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # guarded-by: _lock (every field below)
        self._open: List[List[Any]] = []     # [t0, group], still running
        self._closed: List[Tuple[float, float, Any]] = []
        self._stage_s = 0.0
        self._overlap_s = 0.0
        self._events = 0

    def begin_denoise(self, group: Any, t0: Optional[float] = None) -> None:
        with self._lock:
            self._open.append([time.perf_counter() if t0 is None else t0,
                               group])

    def end_denoise(self, group: Any, t1: Optional[float] = None) -> None:
        t1 = time.perf_counter() if t1 is None else t1
        with self._lock:
            for idx, (t0, grp) in enumerate(self._open):
                if grp == group:
                    self._open.pop(idx)
                    self._closed.append((t0, t1, grp))
                    if len(self._closed) > self._KEEP:
                        del self._closed[:-self._KEEP]
                    return

    def note_stage(self, t0: float, t1: float, group: Any) -> float:
        """Record one encode, decode or merge host interval; returns (and
        adds up) the seconds of it inside other groups' denoise
        windows."""
        ov = self.overlap_of(t0, t1, exclude_group=group)
        with self._lock:
            self._stage_s += max(0.0, t1 - t0)
            self._overlap_s += ov
            self._events += 1
        return ov

    def overlap_of(self, t0: float, t1: float,
                   exclude_group: Any = None) -> float:
        """Seconds of [t0, t1] covered by the union of other groups'
        denoise windows (open windows clamp to now)."""
        now = time.perf_counter()
        with self._lock:
            wins = [(a, b) for a, b, grp in self._closed
                    if grp != exclude_group and b > t0 and a < t1]
            wins += [(a, now) for a, grp in self._open
                     if grp != exclude_group and now > t0 and a < t1]
        if not wins or t1 <= t0:
            return 0.0
        wins.sort()
        total = 0.0
        cur_a, cur_b = wins[0]
        for a, b in wins[1:]:
            if a > cur_b:
                total += max(0.0, min(cur_b, t1) - max(cur_a, t0))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        total += max(0.0, min(cur_b, t1) - max(cur_a, t0))
        return total

    def summary(self) -> Dict[str, float]:
        with self._lock:
            ratio = (self._overlap_s / self._stage_s) if self._stage_s \
                else 0.0
            return {"stage_s": self._stage_s,
                    "overlap_s": self._overlap_s,
                    "events": float(self._events),
                    "stage_overlap_ratio": ratio}

    def reset(self) -> None:
        with self._lock:
            self._open.clear()
            self._closed.clear()
            self._stage_s = 0.0
            self._overlap_s = 0.0
            self._events = 0


#: The process-wide clock the engine and the dispatcher feed.
CLOCK = OverlapClock()


class StageNode:
    """One stage of a dispatch group: name, callable, dependency names,
    and the host-timeline record of its run."""

    __slots__ = ("name", "fn", "deps", "kind", "result", "t0", "t1",
                 "overlap", "ran", "dev")

    def __init__(self, name: str, fn: Callable[..., Any],
                 deps: Tuple[str, ...], kind: Optional[str]) -> None:
        self.name = name
        self.fn = fn
        self.deps = deps
        self.kind = kind
        self.result: Any = None
        self.t0 = 0.0
        self.t1 = 0.0
        self.overlap = 0.0
        self.ran = False
        #: the device time of the work it queued (``obs/spans.py``)
        self.dev = None

    def seconds(self) -> float:
        return max(0.0, self.t1 - self.t0)


class StageGraph:
    """The stages of ONE dispatch group as a dependency graph.

    ``add`` requires every dependency to exist already, so insertion order
    is a topological order and a cycle cannot be built. ``run(until=...)``
    runs the nodes not yet run on the calling thread, stopping after
    ``until``: the serving dispatcher runs encode, denoise and decode
    under the device gate and the merge after releasing it.

    A node's ``kind`` routes its accounting: ``"stage"`` is scored against
    other groups' denoise windows; ``"denoise"`` opens this group's window
    at its start, and the :class:`GraphRunner` (or the caller, with
    :meth:`close_denoise`) closes it when the flush has the images;
    ``"denoise_sync"`` opens and closes it around the node; None is not
    accounted. ``on_stage(name, seconds)`` fires after every node (the
    dispatcher's ``Ticket.on_stage``). ``obs=False`` feeds no
    histogram."""

    def __init__(self, label: str = "", group: Any = None,
                 clock: Optional[OverlapClock] = None,
                 on_stage: Optional[Callable[[str, float], None]] = None,
                 obs: bool = True) -> None:
        self.label = label
        self.group = group
        self.clock = clock
        self.on_stage = on_stage
        self.obs = obs
        self.open_denoise = False  # an async window the runner closes
        self._nodes: "Dict[str, StageNode]" = {}  # insertion = topo order

    def add(self, name: str, fn: Callable[..., Any],
            deps: Sequence[str] = (), kind: Optional[str] = "stage") -> None:
        if name in self._nodes:
            raise ValueError(f"stage graph: duplicate node {name!r}")
        for d in deps:
            if d not in self._nodes:
                raise ValueError(
                    f"stage graph: node {name!r} depends on undefined "
                    f"{d!r} (dependencies must be added first)")
        self._nodes[name] = StageNode(name, fn, tuple(deps), kind)

    def node(self, name: str) -> StageNode:
        return self._nodes[name]

    def results(self) -> Dict[str, Any]:
        return {n.name: n.result for n in self._nodes.values() if n.ran}

    def stage_seconds(self) -> float:
        """Host seconds of every completed ``"stage"`` node."""
        return sum(n.seconds() for n in self._nodes.values()
                   if n.ran and n.kind == "stage")

    def stage_overlap(self) -> float:
        return sum(n.overlap for n in self._nodes.values()
                   if n.ran and n.kind == "stage")

    def run(self, until: Optional[str] = None) -> Dict[str, Any]:
        """Run the nodes not yet run in insertion order, stopping AFTER
        ``until`` when given; returns name -> result of every node run so
        far."""
        for node in self._nodes.values():
            if node.ran:
                if node.name == until:
                    break
                continue
            node.t0 = time.perf_counter()
            if node.kind in ("denoise", "denoise_sync") \
                    and self.clock is not None:
                self.clock.begin_denoise(self.group, node.t0)
                self.open_denoise = True
            if self.obs:
                from stable_diffusion_webui_distributed_tpu_torch.obs import (
                    spans as obs_spans,
                )

                if obs_spans.TRACER.enabled and node.name in DEVICE_STAGES:
                    node.dev = obs_spans.DeviceTime()
                with obs_spans.device_sink(node.dev):
                    node.result = node.fn(
                        *(self._nodes[d].result for d in node.deps))
            else:
                node.result = node.fn(
                    *(self._nodes[d].result for d in node.deps))
            node.t1 = time.perf_counter()
            node.ran = True
            if self.clock is not None:
                if node.kind == "denoise_sync":
                    self.clock.end_denoise(self.group, node.t1)
                    self.open_denoise = False
                elif node.kind == "stage":
                    node.overlap = self.clock.note_stage(
                        node.t0, node.t1, self.group)
            self._observe(node)
            if node.name == until:
                break
        return self.results()

    def close_denoise(self, t1: Optional[float] = None) -> None:
        """Close this group's async denoise window (its flush has the
        images)."""
        if self.open_denoise and self.clock is not None:
            self.clock.end_denoise(self.group, t1)
            self.open_denoise = False

    def _observe(self, node: StageNode) -> None:
        secs = node.seconds()
        if self.obs:
            try:
                from stable_diffusion_webui_distributed_tpu_torch.obs import (
                    prometheus as obs_prom,
                )
                from stable_diffusion_webui_distributed_tpu_torch.obs import (
                    spans as obs_spans,
                )

                obs_prom.observe_stage_graph(node.name, secs)
                obs_spans.add_span(
                    obs_spans.current(), f"stage.{node.name}", node.t0,
                    secs, attrs={"group": str(self.group),
                                 "graph": self.label},
                    lane=LANES.get(node.name), dev=node.dev)
            except Exception:  # noqa: BLE001 — obs stays best-effort
                pass
        if self.on_stage is not None:
            try:
                self.on_stage(node.name, secs)
            except Exception:  # noqa: BLE001 — callbacks stay best-effort
                pass


class GraphRunner:
    """Depth-limited FIFO window of per-group :class:`StageGraph`\\ s.

    ``submit`` runs the graph's nodes NOW (their device work dispatches
    without waiting) and queues its ``flush`` until more than ``depth``
    groups are in flight, so the newest group's device work is always
    queued ahead of an older group's blocking fetch. ``drain`` flushes
    everything in order: the interrupt and preempt seam.

    ``submit`` and ``drain`` may race (a drain from the dispatching thread
    while a cancel drains elsewhere); each flush runs UNDER the runner's
    lock, so a racing drain can never reorder or repeat a flush: the
    gallery's order is the invariant."""

    def __init__(self, depth: int = 1,
                 clock: Optional[OverlapClock] = None) -> None:
        self._lock = threading.Lock()
        # guarded-by: _lock (_in_flight, flushed; flushes run under it)
        self._in_flight: List[Tuple[StageGraph, Callable[[Dict[str, Any]],
                                                         None]]] = []
        self._depth = max(1, int(depth))
        self._clock = clock
        self.flushed = 0

    def submit(self, graph: StageGraph,
               flush: Callable[[Dict[str, Any]], None]) -> None:
        graph.run()
        with self._lock:
            self._in_flight.append((graph, flush))
            excess = len(self._in_flight) - self._depth
        self._flush_n(excess)

    def drain(self) -> None:
        self._flush_n(None)

    def in_flight(self) -> int:
        with self._lock:
            return len(self._in_flight)

    def _flush_n(self, k: Optional[int]) -> None:
        """Flush up to ``k`` oldest graphs (None = all). Each pop and its
        flush run under the lock, so racing drains serialise per item; a
        competitor that already emptied the window ends this loop."""
        done = 0
        while k is None or done < k:
            with self._lock:
                if not self._in_flight:
                    return
                graph, flush = self._in_flight.pop(0)
                t0 = time.perf_counter()
                try:
                    flush(graph.results())
                finally:
                    t1 = time.perf_counter()
                    # the fetch returning proves the group's device work
                    # is done: close its denoise window, then score the
                    # fetch against the OTHER windows
                    graph.close_denoise(t1)
                    if self._clock is not None:
                        self._clock.note_stage(t0, t1, graph.group)
                    self.flushed += 1
            done += 1
