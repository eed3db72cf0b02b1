"""Deterministic schedule explorer over locksan yield points.

Port of the JAX package's ``sim/sched.py``. The runtime lockset
sanitizer (runtime/locksan.py) wraps every ``threading`` lock and
condition created after ``install()``. This module exploits that seam:
an :class:`Explorer` registers itself via ``locksan.set_scheduler`` and
every lock acquire/release, condition wait/notify, thread start and
thread join performed by a *managed* thread becomes a cooperative yield
point. Exactly one managed thread
runs at a time (a token handed around with raw, unwrapped locks), so a
run's interleaving is a pure function of the seed — no wall-clock, no
OS scheduler, no flakes.

Scheduling is PCT-style (probabilistic concurrency testing): each task
draws a random priority at registration, the highest-priority runnable
task runs until its next yield point, and at a few seeded
priority-change steps the running task is demoted — shallow-depth bug
interleavings (the common kind) get hit with high probability across a
modest seed sweep. ≥64 seeds per harness is the repo's floor
(``tests/test_torch_sched.py``).

Verdicts, per run:

- **deadlock** — unfinished tasks remain and none is runnable: every
  one is blocked on a lock whose owner cannot run, waiting on a
  condition nobody can notify, or joining a thread that cannot finish.
  The detail names each task's blocker — that plus the trace is the
  repro.
- **livelock** — the step budget ran out (tasks kept yielding without
  finishing); harnesses treat it as a failure too.
- **completed** — every task ran to the end of its body; the harness
  then checks its own invariants over the shared state.

Scope and honest limits: only threads spawned through
:meth:`Explorer.spawn` (or started by managed code while the explorer
is active — ``Thread.start`` is adopted) are serialized. Locks created
*before* ``locksan.install()`` are raw and invisible — a managed thread
hard-blocking on one would hang the explorer, so harnesses construct
fresh objects after install and never touch module-level locks born at
import time. Timed waits don't model real time: a timeout burns a fixed
number of yields (``timeout_yields``) and then gives up, which keeps
runs finite and deterministic but means "waited 0.25 s" and "waited
60 s" explore identically.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.runtime import locksan

__all__ = ["Explorer", "ExploreResult"]


@dataclass
class ExploreResult:
    seed: int
    steps: int = 0
    trace: List[str] = field(default_factory=list)
    deadlocked: bool = False
    deadlock: Optional[str] = None
    livelock: bool = False
    completed: bool = False
    errors: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.completed and not self.deadlocked \
            and not self.livelock and not self.errors

    def digest(self) -> str:
        """Stable fingerprint of the interleaving (determinism tests
        compare digests across repeated same-seed runs)."""
        import hashlib
        return hashlib.sha256("\n".join(self.trace).encode()).hexdigest()


class _Task:
    def __init__(self, tid: int, name: str):
        self.tid = tid
        self.name = name
        self.gate = locksan._real_lock()
        self.gate.acquire()  # starts closed; a grant opens it
        self.prio = 0.0
        self.started = False
        self.finished = False
        self.blocked_on: Optional[int] = None  # id(raw lock)
        self.blocked_name = ""
        self.wait_cell: Optional[List[bool]] = None  # untimed cond wait
        self.join_target: Optional["_Task"] = None
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None


class Explorer:
    """One seeded exploration run. Usage::

        ex = Explorer(seed)
        ex.spawn(body_a, "a")
        ex.spawn(body_b, "b")
        result = ex.run()

    ``run()`` requires ``locksan.install()`` to be active (the harness
    fixtures handle it) and must not be nested.
    """

    def __init__(self, seed: int, max_steps: int = 4000,
                 timeout_yields: int = 3, change_points: int = 6,
                 change_horizon: int = 64, eps: float = 0.25):
        self.seed = seed
        self.max_steps = max_steps
        #: scheduling grants a timed wait/join burns before timing out
        self.timeout_yields = timeout_yields
        #: probability a grant ignores priorities and picks uniformly —
        #: pure PCT underexplores the tiny harnesses (a high-priority
        #: task runs to completion through its own yield points)
        self.eps = eps
        self._rng = random.Random(seed)
        self._tasks: List[_Task] = []
        self._tls = threading.local()
        self._control = locksan._real_lock()
        #: id(raw lock) -> [task, recursion count]
        self._owners: Dict[int, List] = {}
        self._result = ExploreResult(seed=seed)
        self._step = 0
        # PCT priority-change points, drawn over the realistic run
        # horizon (harness runs are tens of steps; drawing over
        # max_steps would mean the change almost never lands mid-run)
        self._change_steps = {
            self._rng.randrange(change_horizon)
            for _ in range(change_points)}
        self._anon: Dict[int, str] = {}  # id(raw) -> stable per-run name
        self._orig_start = None
        self._orig_join = None
        self._orig_alive = None
        self._ran = False

    # -- registration --------------------------------------------------------

    def spawn(self, body: Callable[[], object], name: str) -> None:
        """Register a managed task; its thread starts at ``run()``."""
        task = self._register(name)
        task.thread = threading.Thread(
            target=self._task_body, args=(task, body),
            name=name, daemon=True)

    def _register(self, name: str) -> _Task:
        task = _Task(len(self._tasks), name)
        task.prio = self._rng.random()
        self._tasks.append(task)
        return task

    def _task_body(self, task: _Task, body: Callable[[], object]) -> None:
        self._tls.task = task
        task.gate.acquire()  # wait for the first grant
        try:
            body()
        except BaseException as e:  # noqa: BLE001 — recorded, not raised
            task.error = e
        finally:
            task.finished = True
            self._trace(task, "finish")
            self._control.release()  # hand the token home for good

    # -- thread adoption (code under test spawning its own threads) ----------

    class _StartedGate:
        """Stand-in for ``Thread._started`` on an adopted thread.

        ``Thread.start`` blocks on ``_started.wait()`` until the child's
        bootstrap calls ``_started.set()`` — but the bootstrap runs on
        the raw OS thread BEFORE the adoption wrapper parks it on its
        grant gate, so the set() lands at wall-clock time, not at a
        schedule point. A managed parent would then sometimes fast-path
        the wait and sometimes cooperatively block, splitting the trace
        on OS timing. The gate makes the parent's wait a deterministic
        no-op: the explorer's own grant gate is what actually sequences
        the child, so waiting for the bootstrap buys nothing.
        """

        def __init__(self, real) -> None:
            self._real = real

        def is_set(self):
            return self._real.is_set()

        def set(self):
            self._real.set()

        def wait(self, timeout=None):
            return True

    def _install_thread_patches(self) -> None:
        self._orig_start = threading.Thread.start
        self._orig_join = threading.Thread.join
        self._orig_alive = threading.Thread.is_alive
        explorer = self

        def start(th):
            if explorer._current() is None:
                return explorer._orig_start(th)
            task = explorer._register(th.name)
            task.thread = th
            task.started = True  # grantable as soon as the OS thread parks
            th._started = Explorer._StartedGate(th._started)
            orig_run = th.run

            def run():
                explorer._tls.task = task
                task.gate.acquire()
                try:
                    orig_run()
                except BaseException as e:  # noqa: BLE001
                    task.error = e
                finally:
                    task.finished = True
                    explorer._trace(task, "finish")
                    explorer._control.release()

            th.run = run
            explorer._trace(explorer._current(), f"spawn:{th.name}")
            return explorer._orig_start(th)

        def is_alive(th):
            # A finished task's OS thread tears down at wall-clock time
            # (tstate release), so the real is_alive() read is racy even
            # under a serialized schedule. For managed threads, liveness
            # is the task state the scheduler already sequences.
            cur = explorer._current()
            target = next((t for t in explorer._tasks
                           if t.thread is th), None)
            if cur is None or target is None:
                return explorer._orig_alive(th)
            return target.started and not target.finished

        def join(th, timeout=None):
            cur = explorer._current()
            target = next((t for t in explorer._tasks
                           if t.thread is th), None)
            if cur is None or target is None:
                return explorer._orig_join(th, timeout)
            if timeout is None:
                cur.join_target = target
                explorer._yield(cur, f"join:{target.name}")
                cur.join_target = None
                return
            for _ in range(explorer.timeout_yields):
                if target.finished:
                    return
                explorer._yield(cur, f"join:{target.name}")
            return

        threading.Thread.start = start
        threading.Thread.join = join
        threading.Thread.is_alive = is_alive

    def _remove_thread_patches(self) -> None:
        if self._orig_start is not None:
            threading.Thread.start = self._orig_start
            threading.Thread.join = self._orig_join
            threading.Thread.is_alive = self._orig_alive
            self._orig_start = self._orig_join = None

    # -- locksan scheduler protocol ------------------------------------------

    def managed(self) -> bool:
        return getattr(self._tls, "task", None) is not None

    def _current(self) -> Optional[_Task]:
        return getattr(self._tls, "task", None)

    def _lock_name(self, lock) -> str:
        """Trace-stable lock label: the locksan name, or a per-run
        first-sight sequence number (never ``id()`` — traces must be
        byte-identical across same-seed runs)."""
        if lock._san_name is not None:
            return lock._san_name
        key = id(lock._raw)
        if key not in self._anon:
            self._anon[key] = f"anon{len(self._anon)}"
        return self._anon[key]

    def lock_acquire(self, lock, blocking=True, timeout=-1) -> bool:
        task = self._current()
        raw = lock._raw
        name = self._lock_name(lock)
        budget = self.timeout_yields if (timeout is not None
                                         and timeout >= 0) else None
        # the pre-acquire scheduling point: without it, consecutive
        # acquires by one task are atomic and no inversion can interleave
        self._yield(task, f"pre:{name}")
        while True:
            if raw.acquire(False):
                owner = self._owners.get(id(raw))
                if owner is not None and owner[0] is task:
                    owner[1] += 1  # RLock recursion
                else:
                    self._owners[id(raw)] = [task, 1]
                self._trace(task, f"acquire:{name}")
                return True
            if not blocking:
                self._trace(task, f"tryfail:{name}")
                return False
            if budget is not None:
                if budget <= 0:
                    self._trace(task, f"timeout:{name}")
                    return False
                budget -= 1
                self._yield(task, f"blocked:{name}")
                continue
            task.blocked_on = id(raw)
            task.blocked_name = name
            self._yield(task, f"blocked:{name}")
            task.blocked_on = None
            task.blocked_name = ""

    def lock_release(self, lock) -> None:
        task = self._current()
        raw = lock._raw
        name = self._lock_name(lock)
        owner = self._owners.get(id(raw))
        if owner is not None and owner[0] is task:
            owner[1] -= 1
            if owner[1] <= 0:
                del self._owners[id(raw)]
        raw.release()
        self._trace(task, f"release:{name}")
        self._yield(task, f"released:{name}")

    def cond_wait(self, cond, timeout) -> bool:
        task = self._current()
        cell = [False]
        cond._coop_waiters.append(cell)
        lock = cond._san_lock
        lock.release()  # routes back through lock_release (yields)
        woken = False
        if timeout is None:
            task.wait_cell = cell
            self._yield(task, "cond_wait")
            task.wait_cell = None
            woken = cell[0]
        else:
            for _ in range(self.timeout_yields):
                self._yield(task, "cond_wait")
                if cell[0]:
                    woken = True
                    break
        if not woken and cell in cond._coop_waiters:
            cond._coop_waiters.remove(cell)
        lock.acquire()
        return woken

    # -- the scheduling loop -------------------------------------------------

    def run(self) -> ExploreResult:
        if self._ran:
            raise RuntimeError("Explorer instances are single-use")
        self._ran = True
        if not locksan.installed():
            raise RuntimeError("schedule exploration requires "
                               "locksan.install() (see the sched fixtures)")
        prior = locksan.scheduler()
        locksan.set_scheduler(self)
        self._install_thread_patches()
        self._control.acquire()  # token starts with the scheduler
        try:
            for task in self._tasks:
                task.started = True
                task.thread.start()
            self._loop()
        finally:
            self._remove_thread_patches()
            locksan.set_scheduler(prior)
            # reap: every finished task's thread exits on its own; give
            # stragglers (deadlocked tasks still parked on their gates)
            # nothing — they are daemon threads and the result records
            # them. Releasing their gates here would run them unmanaged.
        res = self._result
        res.steps = self._step
        res.completed = all(t.finished for t in self._tasks)
        res.errors = [f"{t.name}: {t.error!r}" for t in self._tasks
                      if t.error is not None]
        if res.completed:
            for t in self._tasks:  # patches removed above: plain joins
                t.thread.join(timeout=5.0)
        return res

    def _runnable(self, task: _Task) -> bool:
        if task.finished or not task.started:
            return False
        if task.blocked_on is not None and task.blocked_on in self._owners:
            return False
        if task.wait_cell is not None and not task.wait_cell[0]:
            return False
        if task.join_target is not None and not task.join_target.finished:
            return False
        return True

    def _loop(self) -> None:
        while True:
            live = [t for t in self._tasks if t.started and not t.finished]
            if not live:
                return
            runnable = [t for t in live if self._runnable(t)]
            if not runnable:
                self._result.deadlocked = True
                self._result.deadlock = "; ".join(
                    f"{t.name} {self._blocker(t)}" for t in live)
                return
            if self._step >= self.max_steps:
                self._result.livelock = True
                return
            if self._step in self._change_steps and len(runnable) > 1:
                top = max(runnable, key=lambda t: (t.prio, -t.tid))
                top.prio -= 1.0 + self._rng.random()
            if len(runnable) > 1 and self._rng.random() < self.eps:
                task = runnable[self._rng.randrange(len(runnable))]
            else:
                task = max(runnable, key=lambda t: (t.prio, -t.tid))
            self._step += 1
            task.gate.release()  # grant
            self._control.acquire()  # until it yields or finishes

    def _blocker(self, t: _Task) -> str:
        if t.blocked_on is not None:
            owner = self._owners.get(t.blocked_on)
            who = owner[0].name if owner else "?"
            return f"blocked on {t.blocked_name} held by {who}"
        if t.wait_cell is not None:
            return "in cond.wait with nobody left to notify"
        if t.join_target is not None:
            return f"joining {t.join_target.name}"
        return "not runnable"

    def _yield(self, task: _Task, why: str) -> None:
        self._trace(task, f"yield:{why}")
        self._control.release()
        task.gate.acquire()

    def _trace(self, task: Optional[_Task], event: str) -> None:
        name = task.name if task is not None else "<sched>"
        self._result.trace.append(f"{len(self._result.trace)}:{name}:{event}")


def explore(build: Callable[["Explorer"], Optional[Callable[[], List[str]]]],
            seeds: range) -> List[ExploreResult]:
    """Run one harness across a seed range. ``build`` receives a fresh
    Explorer, spawns its tasks, and may return an invariant checker
    (zero-arg callable returning a list of violation strings, called
    after a completed run). Results carry any violations as errors."""
    results = []
    for seed in seeds:
        ex = Explorer(seed)
        check = build(ex)
        res = ex.run()
        if res.ok and check is not None:
            res.errors.extend(check())
        results.append(res)
    return results
