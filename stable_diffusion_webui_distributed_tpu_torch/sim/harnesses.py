"""Schedule-explorer harnesses for the port's real lock protocols.

Port of the JAX package's ``sim/harnesses.py``, over the port's objects.
Each harness is a ``build(ex)`` callable for :func:`sim.sched.explore`:
it constructs a real subsystem object (FleetGate, ServingDispatcher,
Notifier, StoppableDaemon), spawns the threads that race over it, and
returns an invariant checker run after every completed interleaving.
The explorer then drives the harness across a seed range of PCT-style
priority schedules; a deadlock, livelock, task exception, or checker
violation fails that seed.

Ground rules (these are load-bearing — see sim/sched.py):

- ``locksan.install()`` must be active BEFORE a harness's ``build(ex)``
  runs: locks and events the subsystem creates in its constructor must be
  the sanitized wrappers, or a managed thread hard-blocks the whole
  explorer on a raw primitive. The ``explore`` entry asserts install;
  each ``build`` constructs all objects fresh rather than touching
  module-level singletons (whose locks were born raw at import time).
- Blocking that a harness thread performs must route through wrapped
  primitives (Lock/Condition/Event built post-install). Timed waits are
  fine — they burn ``timeout_yields`` grants and give up, which is how
  the 0.25 s cv-wait in FleetGate.acquire stays live under the
  scheduler.
- Network and env are off-limits: delivery callables are stubbed per
  instance, and the notifier harness uses ``notify_transition``'s
  ``force=True`` seam instead of setting ``SDTPU_NOTIFY_URL`` (EV001).

The harnesses cover the lock protocols a static lock analysis reasons about:
condition-variable handoff (FleetGate), two-lock leader/follower
coalescing with cancellation (dispatcher), multi-channel
producer/drain-daemon shutdown (notifier), daemon stop/restart
(StoppableDaemon), the push-plane delta subscriber's cursor-resume
fetch/apply cycle racing reconnect and stop (DeltaSubscriber), and the
stage-graph runner's submit/drain FIFO with per-stage completion
callbacks racing cancel and preempt (GraphRunner).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

# Imported eagerly on purpose, before any explorer exists, for two
# reasons. FleetGate.yield_device and the notifier's outcome counters
# lazy-import the journal and the exposition inside the code under test:
# a first run would execute the import (creating module-level locks mid-run
# on a managed thread) while every later run skips it, splitting the trace
# and breaking same-seed determinism. And a module imported after
# ``locksan.install()`` builds its module-level locks as wrappers, which
# some of the standard library cannot take (``concurrent.futures`` hands
# its lock's ``_at_fork_reinit`` to ``os.register_at_fork``, and torch
# imports it), so the subsystems under test are imported here too.
from ..fleet import policy as fleet_policy
from ..fleet import pool as fleet_pool
from ..obs import journal as _journal  # noqa: F401
from ..obs import notify as notify_mod
from ..obs import prometheus as _prometheus  # noqa: F401
from ..obs import push as push_mod
from ..obs import tsdb as tsdb_mod
from ..parallel import stage_graph
from ..runtime.daemon import StoppableDaemon
from ..serving import dispatcher as disp_mod
from . import sched

__all__ = [
    "HARNESSES",
    "daemon_restart_harness",
    "delta_subscriber_harness",
    "dispatcher_coalesce_harness",
    "fleet_gate_harness",
    "notifier_drain_harness",
    "run_harness",
    "stage_graph_harness",
    "warm_pool_harness",
]


# -- FleetGate: acquire / should_yield / yield_device ------------------------

def fleet_gate_harness(ex: "sched.Explorer") -> Callable[[], List[str]]:
    """A preemptible batch runner and an interactive runner race over one
    FleetGate. The batch runner polls ``should_yield`` at its chunk
    boundaries and yields the device; the interactive waiter must get
    in, and at most one runner may ever hold the device."""

    # Deterministic stepping clock: quantum 0 makes should_yield purely
    # queue-driven, huge aging keeps the WFQ selection order fixed.
    ticks = [0.0]

    def clock() -> float:
        ticks[0] += 1.0
        return ticks[0]

    pol = fleet_policy.FleetPolicy(aging_s=1000.0, quantum_s=0.0)
    gate = fleet_policy.FleetGate(pol, clock=clock)
    active = [0]
    violations: List[str] = []

    def enter(who: str) -> None:
        active[0] += 1
        if active[0] > 1:
            violations.append(
                f"mutual exclusion broken: {who} entered with "
                f"{active[0] - 1} other holder(s)")

    def leave() -> None:
        active[0] -= 1

    def batch_runner() -> None:
        entry = fleet_policy.GateEntry(
            pol.resolve("batch"), tenant="t-batch", cost=2.0,
            request_id="rq-batch")
        gate.acquire(entry)
        enter("batch")
        for _ in range(2):  # two chunk boundaries
            if gate.should_yield(entry):
                leave()
                gate.yield_device(entry)
                enter("batch")
        leave()
        gate.release(entry)

    def interactive_runner() -> None:
        entry = fleet_policy.GateEntry(
            pol.resolve("interactive"), tenant="t-int", cost=1.0,
            request_id="rq-int")
        gate.acquire(entry)
        enter("interactive")
        leave()
        gate.release(entry)

    ex.spawn(batch_runner, "batch")
    ex.spawn(interactive_runner, "interactive")

    def check() -> List[str]:
        out = list(violations)
        if gate.summary()["running_class"] is not None:
            out.append("gate still owned after both runners returned")
        if gate.queue.depth() != 0:
            out.append(f"gate queue leaked {gate.queue.depth()} entries")
        return out

    return check


# -- ServingDispatcher: coalesce + cancel ------------------------------------

def dispatcher_coalesce_harness(ex: "sched.Explorer") \
        -> Callable[[], List[str]]:
    """Three submitters race through ``_run_grouped`` (leader election,
    follower wait, group close under the exec lock) while a fourth
    thread cancels one of them. Every ticket must complete, no group or
    ticket-table entry may leak, and a finished ticket is either
    cancelled or carries a result.

    The port's leader runs its group through ``engine.run_on_device``, on
    the engine's own device thread (``runtime/runner.py``), which the
    explorer does not manage. The harness's engine is a stand-in whose
    ``run_on_device`` calls the stubbed executor inline on the leader's
    thread, as the JAX harness calls its stubbed ``_execute_group``."""

    class _InlineEngine:
        @staticmethod
        def run_on_device(fn, *args):
            return fn(*args)

    disp = disp_mod.ServingDispatcher(engine=_InlineEngine(), window=0.0)

    class _Run:
        total_images = 1

    run = _Run()
    # One bucket for everyone (forces coalescing pressure); the key only
    # needs the [-3]/[-2]/[-1] slots _run_grouped reads.
    disp._group_key = lambda r: ("harness", 0, 0, "bf16")
    disp._dispatch_eta = lambda r, images: None

    def execute_group(g, engine) -> None:
        for t in g.tickets:
            if not t.cancelled.is_set():
                t.result = f"img-{t.request_id}"

    disp._execute_group = execute_group
    tickets: List["disp_mod.Ticket"] = []

    def submitter(rid: str) -> Callable[[], None]:
        def body() -> None:
            t = disp_mod.Ticket(run, run, "txt2img", False, rid)
            tickets.append(t)
            with disp._lock:
                disp._tickets[rid] = t
            try:
                disp._run_grouped(t)
            finally:
                with disp._lock:
                    disp._tickets.pop(rid, None)
        return body

    def canceller() -> None:
        disp.cancel("r2")

    for rid in ("r1", "r2", "r3"):
        ex.spawn(submitter(rid), f"submit-{rid}")
    ex.spawn(canceller, "cancel-r2")

    def check() -> List[str]:
        out: List[str] = []
        for t in tickets:
            if not t.done.is_set():
                out.append(f"ticket {t.request_id} never completed")
            if t.error is not None:
                out.append(f"ticket {t.request_id} errored: {t.error!r}")
            if t.result is None and not t.cancelled.is_set():
                out.append(f"ticket {t.request_id} lost its result")
        with disp._lock:
            leaked_groups = len(disp._groups)
            leaked_tickets = sorted(disp._tickets)
        if leaked_groups:
            out.append(f"group table leaked {leaked_groups} groups")
        if leaked_tickets:
            out.append(f"ticket table leaked {leaked_tickets}")
        return out

    return check


# -- Notifier: producer enqueue vs drain daemon vs stop ----------------------

def notifier_drain_harness(ex: "sched.Explorer") -> Callable[[], List[str]]:
    """Two producers enqueue transitions onto two *different* severity
    channels (forced no-route transitions land on a channel named by
    their severity) while a stopper shuts the notifier down as soon as
    both have finished. Delivery is stubbed. The per-channel queue
    accounting must balance: ``pending`` mirrors the union of the
    channel queues, every accepted item is sent, failed, or still
    pending on its own channel — never dropped on the floor — and no
    item crosses channels."""

    n = notify_mod.Notifier()
    n._deliver = lambda item: (True, 1)  # no network from the harness
    accepted = [0]
    produced = threading.Event()  # post-install: cooperative wait
    remaining = [2]
    severities = ("page", "warn")

    def producer(idx: int) -> Callable[[], None]:
        def body() -> None:
            for j in range(2):
                # distinct rules: the dedup window must not eat any
                if n.notify_transition(f"rule-{idx}-{j}", "firing", j,
                                       "harness",
                                       severity=severities[idx],
                                       force=True):
                    with n._lock:
                        accepted[0] += 1
            remaining[0] -= 1
            if remaining[0] == 0:
                produced.set()
        return body

    def stopper() -> None:
        produced.wait()
        n.stop()

    ex.spawn(producer(0), "produce-0")
    ex.spawn(producer(1), "produce-1")
    ex.spawn(stopper, "stopper")

    def check() -> List[str]:
        out: List[str] = []
        with n._lock:
            pending = n._pending
            queued = sum(len(q) for q in n._queues.values())
            channels = set(n._queues) | set(n._counts)
            totals: Dict[str, int] = {}
            for per in n._counts.values():
                for outcome, count in per.items():
                    totals[outcome] = totals.get(outcome, 0) + count
        sent = totals.get("sent", 0)
        failed = totals.get("failed", 0)
        deduped = totals.get("deduped", 0)
        dropped = totals.get("dropped", 0)
        if pending != queued:
            out.append(f"pending {pending} != queued {queued}")
        if sent + failed + pending != accepted[0]:
            out.append(
                f"accounting leak: sent {sent} + failed {failed} + "
                f"pending {pending} != accepted {accepted[0]}")
        if deduped or dropped:
            out.append(f"unexpected rejects: deduped={deduped} "
                       f"dropped={dropped}")
        if not channels <= set(severities):
            out.append(f"items crossed channels: {sorted(channels)}")
        return out

    return check


# -- DeltaSubscriber: delta stream reconnect vs stop -------------------------

def delta_subscriber_harness(ex: "sched.Explorer") \
        -> Callable[[], List[str]]:
    """Two threads each run a start()/poll_once()/stop() cycle against
    one DeltaSubscriber (the push-plane daemon lifecycle under a
    reset() racing a start) while a producer publishes entries into the
    worker-side buffer and the in-process fetch seam injects one
    disconnect. Whatever the interleaving: cursor resume keeps the
    stream lossless (``applied == cursor`` — every cursor up to the
    high-water mark applied exactly once, redeliveries deduped, nothing
    reported lost) and the final stop wins (no daemon thread
    survives)."""

    buf = push_mod.DeltaBuffer(capacity=64)
    calls = [0]

    class _Backend:
        """In-process fetch seam; call #2 raises (a mid-stream
        disconnect the subscriber must resume across)."""

        @staticmethod
        def push_fetch(cursor: int):
            calls[0] += 1
            if calls[0] == 2:
                raise OSError("simulated disconnect")
            return buf.collect(cursor, hold_s=0.0)

    store = tsdb_mod.SeriesStore()
    sub = push_mod.DeltaSubscriber("w0", _Backend(), store=store)
    produced = threading.Event()  # post-install: cooperative wait

    def producer() -> None:
        for i in range(4):
            buf.publish("sample", {"name": "queue_wait_p95_s",
                                   "t": float(i), "v": float(i)})
        produced.set()

    def cycle() -> None:
        sub.start()
        produced.wait()
        sub.poll_once()
        sub.stop(timeout_s=0.1)

    ex.spawn(producer, "producer")
    ex.spawn(cycle, "cycle-a")
    ex.spawn(cycle, "cycle-b")

    def check() -> List[str]:
        out: List[str] = []
        with sub._lock:
            applied = sub._applied
            lost = sub._lost
            cursor = sub.cursor
        if lost:
            out.append(f"subscriber reported {lost} lost entries")
        if applied != cursor:
            out.append(f"applied {applied} != cursor {cursor} "
                       "(an entry double-applied or skipped)")
        if sub.alive():
            out.append("subscriber daemon survived both stop() calls")
        if not sub._daemon.stopped():
            out.append("halt flag clear after both stop() calls")
        return out

    return check


# -- StoppableDaemon: concurrent stop / restart ------------------------------

def daemon_restart_harness(ex: "sched.Explorer") -> Callable[[], List[str]]:
    """Two threads each run a start()/stop() cycle against one
    StoppableDaemon (the TSDB sampler lifecycle under a reset() racing a
    start_daemon()). Whatever the interleaving, the final stop must win:
    no loop thread survives and the halt flag is set."""

    ticked = [0]

    def tick() -> None:
        ticked[0] += 1

    d = StoppableDaemon("harness-sampler", tick, 0.01)

    def cycle() -> None:
        d.start()
        d.stop(timeout_s=0.1)

    ex.spawn(cycle, "cycle-a")
    ex.spawn(cycle, "cycle-b")

    def check() -> List[str]:
        out: List[str] = []
        if not d.stopped():
            out.append("halt flag clear after both stop() calls")
        if d.alive():
            out.append("daemon thread survived both stop() calls")
        return out

    return check


# -- StageGraph/GraphRunner: submit vs preempt-drain vs cancel ---------------

def stage_graph_harness(ex: "sched.Explorer") -> Callable[[], List[str]]:
    """A producer submits three encode→denoise→decode StageGraphs through
    one GraphRunner while a preemptor drains mid-stream (the engine's
    chunk-boundary yield runs drain() from a racing thread) and a
    canceller stops the producer between submissions (the interrupt
    seam). Whatever the interleaving: each submitted group's per-stage
    completion callbacks fire in dependency order, every submitted group
    flushes exactly once in submission (FIFO = gallery) order, nothing
    stays in flight, and every denoise window is closed."""

    # fresh objects: the module-level CLOCK's lock was born raw at import
    clock = stage_graph.OverlapClock()
    runner = stage_graph.GraphRunner(depth=1, clock=clock)
    stages: List[tuple] = []   # (group, stage) completion log
    flushes: List[int] = []    # group ids in flush order
    submitted: List[int] = []
    cancel = threading.Event()  # post-install: cooperative wait

    def make_graph(gid: int):
        g = stage_graph.StageGraph(
            label=f"g{gid}", group=gid, clock=clock,
            on_stage=lambda name, secs, gid=gid: stages.append((gid, name)),
            obs=False)
        g.add("encode", lambda gid=gid: f"enc{gid}", kind="stage")
        g.add("denoise", lambda e, gid=gid: f"lat{gid}",
              deps=("encode",), kind="denoise")
        g.add("decode", lambda e, lat, gid=gid: f"img{gid}",
              deps=("encode", "denoise"), kind="stage")
        return g

    def producer() -> None:
        for gid in range(3):
            if cancel.is_set():
                break
            submitted.append(gid)
            runner.submit(make_graph(gid),
                          lambda res, gid=gid: flushes.append(gid))
        runner.drain()

    def preemptor() -> None:
        runner.drain()

    def canceller() -> None:
        cancel.set()

    ex.spawn(producer, "producer")
    ex.spawn(preemptor, "preempt-drain")
    ex.spawn(canceller, "cancel")

    def check() -> List[str]:
        out: List[str] = []
        for gid in submitted:
            order = [s for g, s in stages if g == gid]
            if order != ["encode", "denoise", "decode"]:
                out.append(f"group {gid} stage callbacks out of order: "
                           f"{order}")
        if flushes != submitted:
            out.append(f"flush order {flushes} != submit order {submitted}")
        if runner.in_flight():
            out.append(f"{runner.in_flight()} graphs left in flight")
        if runner.flushed != len(submitted):
            out.append(f"flushed {runner.flushed} != "
                       f"submitted {len(submitted)}")
        with clock._lock:
            left_open = len(clock._open)
        if left_open:
            out.append(f"{left_open} denoise windows left open")
        return out

    return check


# -- WarmPool: checkout vs chaos-kill vs heal vs retire ----------------------

def warm_pool_harness(ex: "sched.Explorer") -> Callable[[], List[str]]:
    """Two borrowers check residents in and out of one WarmPool while a
    chaos thread kills resident-1 then heals back to target size and a
    fourth thread retires one resident (the autoscale down path).
    Whatever the interleaving: every checkout gets an engine and is
    balanced by a release, a retired resident never lingers once
    drained, inflight counts return to zero, and the pool never drains
    below one ready resident (retire_one refuses the last; kill is
    followed by a heal)."""

    spawned = [0]

    def factory(name: str) -> object:
        spawned[0] += 1
        return object()  # the protocol under test is bookkeeping-only

    pool = fleet_pool.WarmPool(factory, size=2)
    violations: List[str] = []

    def borrower(tag: str) -> Callable[[], None]:
        def body() -> None:
            for _ in range(2):
                res = pool.acquire()
                if res.engine is None:
                    violations.append(f"{tag} checked out a bare resident")
                if res.inflight < 1:
                    violations.append(
                        f"{tag} acquired {res.name} with inflight "
                        f"{res.inflight}")
                pool.release(res)
        return body

    def chaos() -> None:
        pool.kill("resident-1")
        pool.heal()

    def retirer() -> None:
        pool.retire_one()

    ex.spawn(borrower("borrower-a"), "borrower-a")
    ex.spawn(borrower("borrower-b"), "borrower-b")
    ex.spawn(chaos, "chaos-kill-heal")
    ex.spawn(retirer, "retire")

    def check() -> List[str]:
        out = list(violations)
        with pool._lock:
            residents = list(pool._residents.values())
        ready = 0
        for r in residents:
            if r.inflight != 0:
                out.append(f"{r.name} left inflight={r.inflight}")
            if r.state == "retired":
                out.append(f"retired {r.name} leaked (drained but still "
                           f"in the table)")
            if r.state == "ready":
                ready += 1
        if ready < 1:
            out.append("pool drained below one ready resident")
        if spawned[0] != pool.summary()["spawns_total"]:
            out.append(f"factory ran {spawned[0]} times but pool counted "
                       f"{pool.summary()['spawns_total']} spawns")
        return out

    return check


HARNESSES: Dict[str, Callable[["sched.Explorer"],
                              Optional[Callable[[], List[str]]]]] = {
    "fleet_gate": fleet_gate_harness,
    "dispatcher_coalesce": dispatcher_coalesce_harness,
    "notifier_drain": notifier_drain_harness,
    "daemon_restart": daemon_restart_harness,
    "delta_subscriber": delta_subscriber_harness,
    "stage_graph": stage_graph_harness,
    "warm_pool": warm_pool_harness,
}


def run_harness(name: str, seeds: range) -> List["sched.ExploreResult"]:
    """Explore one named harness across ``seeds`` (locksan must already
    be installed — tests do this via the session fixture)."""
    return sched.explore(HARNESSES[name], seeds)
