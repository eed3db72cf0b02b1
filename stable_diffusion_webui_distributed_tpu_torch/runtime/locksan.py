"""Runtime lockset sanitizer, its runtime half (default off).

Port of the JAX package's ``runtime/locksan.py``. :func:`install` replaces
the ``threading.Lock`` / ``threading.RLock`` / ``threading.Condition``
factories with wrappers that

- **name** each lock at creation by inspecting the creating frame: a lock
  born from ``self._lock = threading.Lock()`` inside ``WorkerNode.__init__``
  is named ``WorkerNode._lock``, the qualified name a static lock-order
  graph uses, so the two graphs diff cleanly;
- **record** every nested acquisition as an ordered edge (held → acquired)
  **per thread** (keyed by thread ident), plus a process-global union, via
  a thread-local held stack;
- implement the ``Condition`` protocol (``_release_save`` /
  ``_acquire_restore`` / ``_is_owned``) so ``cond.wait()`` pops and
  re-pushes the held stack, and **detect** a ``Condition.wait`` entered
  while an *unrelated* named lock is still held (the wait blocks with that
  lock pinned: a convoy, and with a second thread a deadlock);
- run **Goodlock-style cycle detection** over the union of all threads'
  edges (:func:`runtime_cycles`): a cycle means two threads acquired the
  same locks in opposite orders at runtime, the deadlock precondition,
  even if the interleaving that deadlocks never fired in this run.

:func:`divergence` compares observed edges against a static graph given as
a dict: an observed edge between two statically-known lock names with no
static path in that direction means the static model missed a real
ordering. Anonymous locks (no ``self.<attr> =`` creation site, stdlib
internals) never participate. The static graph of a package and its
``lockorder`` annotations come from the lint over source code, which the
port does not have yet (ROADMAP), so this module has no ``static_graph``
or ``declared_orders``.

The module is also the instrumentation seam for the deterministic
schedule explorer (``sim/sched.py``): :func:`set_scheduler` installs a
cooperative scheduler, and every lock acquire/release and condition
wait/notify on a scheduler-managed thread routes through it instead of
the raw primitive; those are exactly the yield points the explorer
serializes. With no scheduler installed (the default, including every
serving path) the branch is two ``None`` checks.

Default off: importing this module patches nothing; ``install()`` is the
only entry point with side effects, and ``uninstall()`` restores the real
factories. The wrapper adds two dict lookups and a list append per
acquire: fine for tests, not meant for serving.
"""

from __future__ import annotations

import linecache
import re
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_ATTR_ASSIGN = re.compile(r"self\s*\.\s*(\w+)\s*(?::[^=]+)?=")

_real_lock = threading.Lock
_real_rlock = threading.RLock
_real_condition = threading.Condition
#: Thread.start's code object, captured before anything (the explorer)
#: can patch it — _note_wait uses it to recognize the bootstrap
#: handshake wait on the child's _started event.
_THREAD_START_CODE = threading.Thread.start.__code__

_installed = False
#: union of every thread's observed (held, acquired) edges
_edges: Set[Tuple[str, str]] = set()
#: thread ident -> that thread's observed edges (Goodlock input)
_edges_per_thread: Dict[int, Set[Tuple[str, str]]] = {}
#: (held-names, waiting-on) pairs for cond.wait entered with extra locks
_wait_violations: Set[Tuple[Tuple[str, ...], str, str]] = set()
_edges_guard = _real_lock()
_tls = threading.local()

#: the cooperative schedule explorer (sim/sched.py), or None. Never set
#: outside an explorer run; every hot-path check is ``_sched is None``.
_sched = None


def set_scheduler(sched) -> None:
    """Install (or with ``None`` remove) the cooperative scheduler that
    lock/condition operations on managed threads route through."""
    global _sched
    _sched = sched


def scheduler():
    return _sched


def _active_sched():
    s = _sched
    if s is not None and s.managed():
        return s
    return None


def _held_stack() -> List["_SanLock"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _name_from_frame(depth: int = 2) -> Optional[str]:
    """``Class.attr`` for a ``self.<attr> = threading.Lock()`` creation
    site, else None (anonymous)."""
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return None
    obj = frame.f_locals.get("self")
    if obj is None:
        return None
    line = linecache.getline(frame.f_code.co_filename, frame.f_lineno)
    m = _ATTR_ASSIGN.search(line)
    if m is None:
        return None
    return f"{type(obj).__name__}.{m.group(1)}"


def _note_wait(lock: "_SanLock") -> None:
    """Record a ``Condition.wait`` entered while other named locks are
    held: the wait releases *its own* lock but keeps the rest pinned
    for the whole sleep — a convoy, and (if the notifier needs one of
    them) a deadlock.

    One wait is exempt: ``Thread.start``'s bootstrap handshake on the
    child's ``_started`` event. The interpreter's ``_bootstrap_inner``
    sets that event *before* any user code runs on the child, so no
    held lock can ever block the waker — flagging it would force every
    "spawn a worker under my state lock" site into contortions for a
    deadlock that cannot happen."""
    held = [h._san_name for h in _held_stack()
            if h is not lock and h._san_name is not None
            and h._san_name != lock._san_name]
    if not held:
        return
    f = sys._getframe(1)
    while f is not None:
        if f.f_code is _THREAD_START_CODE:
            return
        f = f.f_back
    entry = (tuple(sorted(set(held))), lock._san_name or "<anon>",
             threading.current_thread().name)
    with _edges_guard:
        _wait_violations.add(entry)


class _SanLock:
    """Order-recording wrapper around a real Lock/RLock."""

    def __init__(self, raw, name: Optional[str]):
        self._raw = raw
        self._san_name = name

    # -- bookkeeping ---------------------------------------------------------

    def _push(self) -> None:
        stack = _held_stack()
        if self._san_name is not None:
            new_edges = [
                (h._san_name, self._san_name) for h in stack
                if h._san_name is not None and h._san_name != self._san_name]
            if new_edges:
                ident = threading.get_ident()
                with _edges_guard:
                    _edges.update(new_edges)
                    _edges_per_thread.setdefault(ident, set()).update(
                        new_edges)
        stack.append(self)

    def _pop(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking=True, timeout=-1):
        s = _active_sched()
        if s is not None:
            got = s.lock_acquire(self, blocking, timeout)
        else:
            got = self._raw.acquire(blocking, timeout)
        if got:
            self._push()
        return got

    def release(self):
        self._pop()
        s = _active_sched()
        if s is not None:
            return s.lock_release(self)
        return self._raw.release()

    def locked(self):
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- Condition protocol (cond.wait releases and reacquires) -------------

    def _release_save(self):
        _note_wait(self)
        self._pop()
        if hasattr(self._raw, "_release_save"):
            return self._raw._release_save()
        self._raw.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._raw, "_acquire_restore"):
            self._raw._acquire_restore(state)
        else:
            self._raw.acquire()
        self._push()

    def _is_owned(self):
        if hasattr(self._raw, "_is_owned"):
            return self._raw._is_owned()
        if self._raw.acquire(False):
            self._raw.release()
            return False
        return True

    def __repr__(self):
        return f"<SanLock {self._san_name or 'anon'} {self._raw!r}>"


class _SanCondition:
    """Condition wrapper: pure delegation to a real ``threading.Condition``
    normally (the real Condition drives the wrapped lock's
    ``_release_save``/``_acquire_restore``, so edge and wait bookkeeping
    happen exactly as before) — but on a scheduler-managed thread,
    ``wait``/``notify`` become cooperative yield points so the explorer
    can serialize them deterministically instead of sleeping real time."""

    def __init__(self, lock=None):
        if lock is None:
            lock = _rlock_factory()
        self._san_lock = lock if isinstance(lock, _SanLock) else None
        self._real = _real_condition(lock)
        #: cooperative waiters: per-waiter one-shot flags ([False] cells)
        self._coop_waiters: List[List[bool]] = []

    # -- lock passthrough ----------------------------------------------------

    def acquire(self, *args, **kwargs):
        return self._real.acquire(*args, **kwargs)

    def release(self):
        return self._real.release()

    def __enter__(self):
        self._real.__enter__()
        return self

    def __exit__(self, *exc):
        return self._real.__exit__(*exc)

    def _is_owned(self):
        return self._real._is_owned()

    # -- wait/notify ---------------------------------------------------------

    def wait(self, timeout=None):
        s = _active_sched()
        if s is not None and self._san_lock is not None:
            _note_wait(self._san_lock)
            return s.cond_wait(self, timeout)
        return self._real.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        s = _active_sched()
        if s is not None and self._san_lock is not None:
            result = predicate()
            while not result:
                if not self.wait(timeout):
                    return predicate()
                result = predicate()
            return result
        return self._real.wait_for(predicate, timeout)

    def notify(self, n=1):
        if _sched is not None and self._coop_waiters:
            woken = 0
            while self._coop_waiters and woken < n:
                self._coop_waiters.pop(0)[0] = True
                woken += 1
            if woken >= n:
                return
            n -= woken
        return self._real.notify(n)

    def notify_all(self):
        if _sched is not None and self._coop_waiters:
            for cell in self._coop_waiters:
                cell[0] = True
            del self._coop_waiters[:]
        return self._real.notify_all()

    notifyAll = notify_all

    def __repr__(self):
        return f"<SanCondition {self._real!r}>"


def _lock_factory():
    return _SanLock(_real_lock(), _name_from_frame())


def _rlock_factory(*args, **kwargs):
    return _SanLock(_real_rlock(*args, **kwargs), _name_from_frame())


def _cond_factory(lock=None):
    return _SanCondition(lock)


def install() -> None:
    """Patch the threading factories (idempotent). ``Condition()`` with
    no explicit lock picks the RLock patch up too: CPython resolves
    ``RLock`` through the threading module globals at call time — and
    ``Event``/``Barrier`` built after install resolve ``Condition`` the
    same way, so their waits are cooperative under the explorer."""
    global _installed
    if _installed:
        return
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _cond_factory
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    threading.Condition = _real_condition
    _installed = False


def installed() -> bool:
    return _installed


def reset() -> None:
    with _edges_guard:
        _edges.clear()
        _edges_per_thread.clear()
        _wait_violations.clear()


def observed_edges() -> Set[Tuple[str, str]]:
    with _edges_guard:
        return set(_edges)


def edges_by_thread() -> Dict[int, Set[Tuple[str, str]]]:
    with _edges_guard:
        return {k: set(v) for k, v in _edges_per_thread.items()}


def wait_violations() -> List[Tuple[Tuple[str, ...], str, str]]:
    """Sorted (held-names, waiting-on, thread-name) records for every
    ``Condition.wait`` entered while holding an unrelated named lock."""
    with _edges_guard:
        return sorted(_wait_violations)


def runtime_cycles() -> List[List[str]]:
    """Goodlock-style check: cycles in the union of all threads' observed
    acquisition edges. A cycle means opposite-order acquisitions really
    executed — a deadlock waiting for the right interleaving — even when
    this run happened not to interleave them fatally."""
    edges = observed_edges()
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles: List[List[str]] = []
    seen: Set[frozenset] = set()

    def dfs(node: str, stack: List[str], on_stack: Set[str],
            visited: Set[str]) -> None:
        visited.add(node)
        on_stack.add(node)
        stack.append(node)
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_stack:
                cyc = stack[stack.index(nxt):] + [nxt]
                key = frozenset(cyc)
                if key not in seen:
                    seen.add(key)
                    cycles.append(cyc)
            elif nxt not in visited:
                dfs(nxt, stack, on_stack, visited)
        stack.pop()
        on_stack.discard(node)

    visited: Set[str] = set()
    for node in sorted(graph):
        if node not in visited:
            dfs(node, [], set(), visited)
    return cycles


def divergence(observed: Set[Tuple[str, str]],
               static: Dict[str, Set[str]]) -> List[Tuple[str, str]]:
    """Observed edges between statically-known locks that the static
    graph (``{lock: {locks acquired under it}}``) has no path for: the
    static model missed a real ordering (or the runtime inverted a
    modeled one)."""
    nodes: Set[str] = set(static)
    for vs in static.values():
        nodes |= vs

    def reachable(a: str, b: str) -> bool:
        frontier, seen = [a], {a}
        while frontier:
            cur = frontier.pop()
            if cur == b:
                return True
            for nxt in static.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return False

    return sorted((a, b) for a, b in observed
                  if a in nodes and b in nodes and not reachable(a, b))
