"""Priority classes and the weighted-fair device gate.

Port of the JAX package's ``fleet/policy.py``. The fleet tier turns the
dispatcher's single FIFO execution lock into a scheduled resource:
requests carry a tenant id and a priority class (``interactive`` /
``batch`` / ``best_effort``), waiters are ordered by weighted-fair
queueing with starvation-free aging, and long preemptible jobs yield the
device to interactive traffic at chunk boundaries (the engine's interrupt
poll points, ``pipeline/engine.py``).

Everything here is host-side policy, testable with a fake clock. The
class table, the queue and the gate are the JAX package's line for line.
The preempt hook is not: in the port every generation runs on the
engine's one device thread, so the JAX hook's thread filter would never
let the owner yield, and a yield that blocked the device thread would
deadlock. :class:`EnginePreemptHook` answers only its owning execution
and serves the interloper's tasks while it waits (``runtime/runner.py``).

With ``SDTPU_JOURNAL`` on, :meth:`FleetGate.yield_device` journals
``preempted`` and ``resumed`` under the yielding entry's request id, and
counts ``sdtpu_fleet_preemptions_total`` by class (``obs/prometheus.py``).

Knobs (``runtime/config.py``):

- ``SDTPU_FLEET`` — master switch; 0 (default) keeps the dispatcher's
  plain execution-lock path as it was.
- ``SDTPU_FLEET_CLASSES`` — ``name:weight`` list overriding class weights,
  e.g. ``interactive:8,batch:2,best_effort:1``.
- ``SDTPU_SLO_INTERACTIVE_S`` — interactive completion SLO (seconds) the
  admission controller enforces (fleet/admission.py).
- ``SDTPU_FLEET_AGING_S`` — waiters older than this are served oldest
  first regardless of fair-queue tags (starvation bound).
- ``SDTPU_FLEET_QUANTUM_S`` — minimum device tenure before a preemptible
  job may be asked to yield (anti-thrash).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from stable_diffusion_webui_distributed_tpu_torch.obs import (
    journal as obs_journal,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)

INTERACTIVE = "interactive"
BATCH = "batch"
BEST_EFFORT = "best_effort"

#: default WFQ weights per class (SDTPU_FLEET_CLASSES overrides)
DEFAULT_WEIGHTS = {INTERACTIVE: 8.0, BATCH: 2.0, BEST_EFFORT: 1.0}
DEFAULT_SLO_INTERACTIVE_S = 30.0
DEFAULT_AGING_S = 10.0
DEFAULT_QUANTUM_S = 0.25


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """One priority class: fair-share weight, optional completion SLO, and
    the preemption relation (who this class may displace)."""

    name: str
    weight: float
    slo_s: Optional[float] = None  # None = no completion SLO
    preemptible: bool = False      # may be asked to yield mid-denoise
    preempts: Tuple[str, ...] = ()  # classes a waiter of this class bumps


def _parse_class_weights(raw: str) -> Dict[str, float]:
    """``interactive:8,batch:2`` -> {..}; malformed entries are skipped via
    env_parsed's warn-and-default contract (the caller wraps us)."""
    out: Dict[str, float] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, weight = part.partition(":")
        w = float(weight)  # ValueError propagates to env_parsed
        if w <= 0:
            raise ValueError(f"weight for {name!r} must be > 0")
        out[name.strip()] = w
    return out


class FleetPolicy:
    """Resolved class table + scheduler constants (immutable after init)."""

    def __init__(self,
                 weights: Optional[Dict[str, float]] = None,
                 slo_interactive_s: Optional[float] = None,
                 aging_s: Optional[float] = None,
                 quantum_s: Optional[float] = None) -> None:
        w = dict(DEFAULT_WEIGHTS)
        w.update(weights or {})
        slo = DEFAULT_SLO_INTERACTIVE_S if slo_interactive_s is None \
            else slo_interactive_s
        self.classes: Dict[str, ClassPolicy] = {
            INTERACTIVE: ClassPolicy(
                INTERACTIVE, w[INTERACTIVE],
                slo_s=(slo if slo > 0 else None),
                preemptible=False, preempts=(BATCH, BEST_EFFORT)),
            BATCH: ClassPolicy(BATCH, w[BATCH], preemptible=True),
            BEST_EFFORT: ClassPolicy(
                BEST_EFFORT, w[BEST_EFFORT], preemptible=True),
        }
        # custom classes from SDTPU_FLEET_CLASSES: scheduled like batch
        for name, weight in w.items():
            if name not in self.classes:
                self.classes[name] = ClassPolicy(name, weight,
                                                 preemptible=True)
        self.aging_s = DEFAULT_AGING_S if aging_s is None else aging_s
        self.quantum_s = DEFAULT_QUANTUM_S if quantum_s is None \
            else quantum_s

    def resolve(self, name: Optional[str]) -> ClassPolicy:
        """Class lookup: unset -> interactive (the pre-fleet behavior for
        every request), unknown -> best_effort (never let a typo grab the
        high-priority lane)."""
        if not name:
            return self.classes[INTERACTIVE]
        return self.classes.get(str(name), self.classes[BEST_EFFORT])

    @classmethod
    def from_env(cls) -> "FleetPolicy":
        from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
            env_float, env_parsed,
        )

        weights = env_parsed("SDTPU_FLEET_CLASSES", _parse_class_weights,
                             {}, "class:weight list")
        return cls(
            weights=weights,
            slo_interactive_s=env_float("SDTPU_SLO_INTERACTIVE_S",
                                        DEFAULT_SLO_INTERACTIVE_S),
            aging_s=env_float("SDTPU_FLEET_AGING_S", DEFAULT_AGING_S),
            quantum_s=env_float("SDTPU_FLEET_QUANTUM_S", DEFAULT_QUANTUM_S))


def fleet_enabled(config=None) -> bool:
    """Master switch. Env SDTPU_FLEET wins; otherwise the config model's
    ``fleet_enabled`` field; default off (pre-fleet byte-identity)."""
    from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
        env_flag, env_str,
    )

    if env_str("SDTPU_FLEET"):
        return env_flag("SDTPU_FLEET", False)
    if config is not None:
        val = getattr(config, "fleet_enabled", None)
        if val is not None:
            return bool(val)
    return False


class GateEntry:
    """One waiter at the device gate (a request or a coalesced group)."""

    _seq = itertools.count()

    def __init__(self, policy: ClassPolicy, tenant: str = "default",
                 cost: float = 1.0, request_id: str = "") -> None:
        self.policy = policy
        self.tenant = tenant
        self.cost = max(0.0, float(cost))  # images — the WFQ work unit
        self.request_id = request_id
        self.seq = next(GateEntry._seq)
        self.enqueued: Optional[float] = None  # stamped by the queue
        self.tag: float = 0.0                  # WFQ virtual finish time

    @property
    def flow(self) -> Tuple[str, str]:
        return (self.tenant, self.policy.name)


class WeightedFairQueue:
    """Virtual-time weighted-fair queue over (tenant, class) flows with an
    aging override: any waiter older than ``aging_s`` is served oldest
    first, bounding starvation no matter how the weights are set.

    Thread-safe on its own lock so it can also be inspected (depth, peek)
    outside the gate's condition variable.
    """

    def __init__(self, aging_s: float = DEFAULT_AGING_S,
                 clock=time.monotonic) -> None:
        self.aging_s = aging_s
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: List[GateEntry] = []  # guarded-by: _lock
        self._flow_tag: Dict[Tuple[str, str], float] = {}  # guarded-by: _lock
        self._vt = 0.0  # guarded-by: _lock — virtual time floor

    def push(self, entry: GateEntry, recost: bool = True) -> None:
        """Enqueue. ``recost=False`` re-admits a preempted runner without
        charging its cost again — it keeps its original finish tag, so a
        yielded batch job resumes after the interactive waiters that bumped
        it but ahead of work that arrived later."""
        with self._lock:
            if entry.enqueued is None:
                entry.enqueued = self._clock()
            prev = self._flow_tag.get(entry.flow, 0.0)
            if recost:
                entry.tag = max(self._vt, prev) \
                    + entry.cost / max(entry.policy.weight, 1e-9)
                self._flow_tag[entry.flow] = entry.tag
            else:
                entry.tag = max(prev, entry.tag)
            self._entries.append(entry)

    def select(self) -> Optional[GateEntry]:
        """The waiter that should run next (non-destructive)."""
        with self._lock:
            if not self._entries:
                return None
            now = self._clock()
            aged = [e for e in self._entries
                    if e.enqueued is not None
                    and now - e.enqueued >= self.aging_s]
            if aged:
                return min(aged, key=lambda e: (e.enqueued, e.seq))
            # the preemption relation outranks fair-queue tags: a waiter
            # whose class has an entitled preemptor queued must not win
            # the gate ahead of it. Without this, a yielded batch runner
            # (re-queued with its KEPT tag, which predates the virtual
            # time its own admission advanced) selects itself straight
            # back and the yield livelocks. Aging above still bounds
            # starvation of the preempted class.
            bumped = set()
            for e in self._entries:
                bumped.update(e.policy.preempts)
            pool = [e for e in self._entries
                    if e.policy.name not in bumped] or self._entries
            return min(pool, key=lambda e: (e.tag, e.seq))

    def remove(self, entry: GateEntry) -> None:
        with self._lock:
            if entry in self._entries:
                self._entries.remove(entry)
                self._vt = max(self._vt, entry.tag)

    def has_preemptor_for(self, policy: ClassPolicy) -> bool:
        """Is any waiter entitled to bump a runner of class ``policy``?"""
        with self._lock:
            return any(policy.name in e.policy.preempts
                       for e in self._entries)

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def depth_by_class(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for e in self._entries:
                out[e.policy.name] = out.get(e.policy.name, 0) + 1
            return out


class FleetGate:
    """Policy-ordered replacement for the dispatcher's bare exec lock.

    ``acquire``/``release`` bracket one device execution exactly like the
    lock did, but the next runner is chosen by the weighted-fair queue,
    and a preemptible runner polls :meth:`should_yield` at chunk
    boundaries (via the engine preempt hook) — ``yield_device`` then
    releases the device, lets the preemptor run, and blocks until the
    queue selects this entry again. All denoise-loop state lives in the
    yielding frame, so resumption is byte-identical and replays the same
    captured graphs (no new capture).
    """

    def __init__(self, policy: Optional[FleetPolicy] = None,
                 clock=time.monotonic) -> None:
        self.policy = policy or FleetPolicy()
        self._clock = clock
        self._cv = threading.Condition()
        self.queue = WeightedFairQueue(self.policy.aging_s, clock)
        self._running: Optional[GateEntry] = None  # guarded-by: _cv
        self._run_started = 0.0  # guarded-by: _cv
        self._preemptions = 0  # guarded-by: _cv

    # -- lock-like protocol -------------------------------------------------

    def acquire(self, entry: GateEntry, recost: bool = True) -> None:
        self.queue.push(entry, recost=recost)
        try:
            with self._cv:
                while self._running is not None \
                        or self.queue.select() is not entry:
                    # timeout: aging promotions change the selection
                    # without a release event; a bounded wait keeps the
                    # bound live
                    self._cv.wait(0.25)
                self.queue.remove(entry)
                self._running = entry
                self._run_started = self._clock()
        except BaseException:
            # a dying waiter (e.g. KeyboardInterrupt inside cv.wait) must
            # not leave its entry queued: select() would keep returning
            # the orphan — oldest entry wins the aging branch — and every
            # other waiter would deadlock permanently
            self.queue.remove(entry)
            with self._cv:
                if self._running is entry:
                    self._running = None
                self._cv.notify_all()
            raise

    def release(self, entry: GateEntry) -> None:
        with self._cv:
            if self._running is entry:
                self._running = None
            self._cv.notify_all()

    # -- preemption ---------------------------------------------------------

    def should_yield(self, entry: GateEntry) -> bool:
        """Poll: does a queued waiter outrank this (running) entry?  Cheap
        — called between denoise chunk dispatches."""
        with self._cv:
            if self._running is not entry or not entry.policy.preemptible:
                return False
            if self._clock() - self._run_started < self.policy.quantum_s:
                return False
        return self.queue.has_preemptor_for(entry.policy)

    def yield_device(self, entry: GateEntry) -> None:
        """Give the device up and re-queue without re-charging cost; the
        call returns when the queue hands the device back."""
        with self._cv:
            self._preemptions += 1
            if self._running is entry:
                self._running = None
            self._cv.notify_all()
        obs_prom.fleet_count("preemptions", **{"class": entry.policy.name})
        if obs_journal.enabled() and entry.request_id:
            obs_journal.emit("preempted", entry.request_id,
                             **{"class": entry.policy.name})
        self.acquire(entry, recost=False)
        if obs_journal.enabled() and entry.request_id:
            obs_journal.emit("resumed", entry.request_id,
                             **{"class": entry.policy.name})

    # -- introspection ------------------------------------------------------

    def preemption_count(self) -> int:
        with self._cv:
            return self._preemptions

    def summary(self) -> Dict[str, object]:
        with self._cv:
            running = self._running
            preemptions = self._preemptions
        return {
            "queue_depth": self.queue.depth(),
            "queue_by_class": self.queue.depth_by_class(),
            "running_class": running.policy.name if running else None,
            "preemptions": preemptions,
            "classes": {name: {"weight": c.weight, "slo_s": c.slo_s,
                               "preemptible": c.preemptible}
                        for name, c in self.policy.classes.items()},
        }


class EnginePreemptHook:
    """The object installed as ``engine.preempt_hook`` for one preemptible
    execution on ``runner``, the engine's device thread
    (``runtime/runner.py``).

    Owner-filtered, where the JAX package filters by thread: the
    interloper that runs during a yield sees the same engine attribute
    and runs on the same device thread, so the hook binds to the
    execution that first polls it (the denoise loop of the entry that
    installed it, ``runner.current()``) and answers no other. Off the
    device thread it answers nothing. While the runner serves a yield, a
    nested execution's own hook never yields: its frame lies above the
    yielded one, which must resume first.

    ``yield_device`` hands the gate's re-acquire to a helper thread and
    runs the tasks other threads queue meanwhile
    (``DeviceRunner.serve_while``)."""

    def __init__(self, gate: FleetGate, entry: GateEntry, runner) -> None:
        self._gate = gate
        self._entry = entry
        self._runner = runner
        self._owner: Optional[int] = None  # bound at the first poll

    def _owns(self) -> bool:
        me = self._runner.current()
        if me is None:
            return False
        if self._owner is None:
            self._owner = me
        return me == self._owner

    def should_yield(self) -> bool:
        return self._owns() and not self._runner.yielding \
            and self._gate.should_yield(self._entry)

    def yield_device(self) -> None:
        if self._owns():
            self._runner.serve_while(self._gate.yield_device, self._entry)
