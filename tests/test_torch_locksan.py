"""The port's runtime lockset sanitizer (``runtime/locksan.py``) against
the JAX package's, on the CPU.

- default off: importing the module patches nothing, ``uninstall``
  restores the real factories, and a lock-using workload gives the same
  result with the sanitizer on and off;
- the wrappers: creation-site naming, nested-acquisition edges, anonymous
  locks recording none, ``Condition.wait`` popping the held stack;
- the ordering checks: a Goodlock cycle from opposite orders in two
  threads, per-thread edges, a wait while holding an unrelated lock
  flagged, the ``Thread.start`` handshake exempt;
- ``divergence`` over synthetic graphs equals the JAX function's.

The static lock-order graph of a package (``static_graph``) comes with the
port of the lint, which it needs.
"""

import hashlib
import threading
import time

import pytest

from stable_diffusion_webui_distributed_tpu.runtime import (
    locksan as jax_locksan,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import locksan


@pytest.fixture
def sanitized():
    """Install the port's sanitizer for one test, restoring the real
    factories after."""
    assert not jax_locksan.installed()
    was = locksan.installed()
    locksan.install()
    locksan.reset()
    yield
    locksan.reset()
    if not was:
        locksan.uninstall()


def _workload():
    """A deterministic lock-using computation; returns a digest."""
    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self._cv_lock = threading.RLock()
            self.values = []

        def record(self, v):
            with self._lock:
                with self._cv_lock:
                    self.values.append(v * 3 + 1)

    c = Counter()
    threads = [threading.Thread(target=c.record, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    payload = ",".join(str(v) for v in sorted(c.values)).encode()
    return hashlib.sha256(payload).hexdigest()


def _run_in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=5)
    assert not t.is_alive()


def test_import_patches_nothing():
    assert not locksan.installed()
    assert threading.Lock is locksan._real_lock
    assert threading.RLock is locksan._real_rlock
    assert threading.Condition is locksan._real_condition
    assert locksan.scheduler() is None
    assert not hasattr(locksan, "static_graph")


def test_workload_is_identical_on_and_off(sanitized):
    with_san = _workload()
    locksan.uninstall()
    try:
        without = _workload()
    finally:
        locksan.install()
    assert with_san == without


def test_uninstall_restores_real_factories():
    locksan.install()
    assert locksan.installed()
    assert threading.Lock is not locksan._real_lock
    locksan.install()  # idempotent
    locksan.uninstall()
    assert threading.Lock is locksan._real_lock
    assert threading.RLock is locksan._real_rlock
    assert threading.Condition is locksan._real_condition
    locksan.uninstall()  # idempotent
    assert not locksan.installed()


def test_creation_site_naming(sanitized):
    class WorkerNode:
        def __init__(self):
            self._lock = threading.Lock()
            self._rlock: object = threading.RLock()

    node = WorkerNode()
    assert isinstance(node._lock, locksan._SanLock)
    assert node._lock._san_name == "WorkerNode._lock"
    assert node._rlock._san_name == "WorkerNode._rlock"
    assert threading.Lock()._san_name is None  # no self.<attr> site


def test_nested_acquisition_records_edge(sanitized):
    class Pair:
        def __init__(self):
            self.outer = threading.Lock()
            self.inner = threading.Lock()

    p = Pair()
    with p.outer:
        with p.inner:
            pass
    assert locksan.observed_edges() == {("Pair.outer", "Pair.inner")}
    a, b = threading.Lock(), threading.Lock()
    with a:
        with b:
            pass
    assert locksan.observed_edges() == {("Pair.outer", "Pair.inner")}


def test_rlock_recursion_records_no_self_edge(sanitized):
    class Box:
        def __init__(self):
            self._lock = threading.RLock()

    box = Box()
    with box._lock:
        with box._lock:
            pass
    assert locksan.observed_edges() == set()
    assert locksan._held_stack() == []


def test_condition_wait_pops_the_held_stack(sanitized):
    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.cv = threading.Condition(self._lock)

    box = Box()
    hits = []

    def waiter():
        with box.cv:
            box.cv.wait()
            hits.append(len(locksan._held_stack()))

    t = threading.Thread(target=waiter)
    t.start()
    deadline = time.monotonic() + 5
    while not hits and time.monotonic() < deadline:
        with box.cv:
            box.cv.notify()
    t.join(timeout=5)
    assert hits == [1]


class _Pair:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()

    def forward(self):
        with self.a:
            with self.b:
                pass

    def backward(self):
        with self.b:
            with self.a:
                pass


def test_opposite_orders_form_a_cycle(sanitized):
    p = _Pair()
    _run_in_thread(p.forward)
    assert locksan.runtime_cycles() == []
    per_thread = locksan.edges_by_thread()
    assert list(per_thread.values()) == [{("_Pair.a", "_Pair.b")}]
    _run_in_thread(p.backward)
    cycles = locksan.runtime_cycles()
    assert cycles == [["_Pair.a", "_Pair.b", "_Pair.a"]]


def test_wait_while_holding_an_unrelated_lock_is_flagged(sanitized):
    class Box:
        def __init__(self):
            self.outer = threading.Lock()
            self._lock = threading.Lock()
            self.cv = threading.Condition(self._lock)

    box = Box()

    def bad_waiter():
        with box.outer:
            with box.cv:
                box.cv.wait(timeout=0.01)

    def good_waiter():
        with box.cv:
            box.cv.wait(timeout=0.01)

    _run_in_thread(good_waiter)
    assert locksan.wait_violations() == []
    _run_in_thread(bad_waiter)
    (held, cv_name, _thread), = locksan.wait_violations()
    assert held == ("Box.outer",) and cv_name == "Box._lock"


def test_thread_start_bootstrap_wait_is_exempt(sanitized):
    class Owner:
        def __init__(self):
            self._lock = threading.Lock()

    owner = Owner()
    child = threading.Thread(target=lambda: None, daemon=True)
    started = child._started  # a sanitized Event: built after install
    real_set = started.set

    def slow_set():
        time.sleep(0.05)
        real_set()

    started.set = slow_set
    with owner._lock:
        child.start()
    child.join(timeout=5)
    assert locksan.wait_violations() == []


DIVERGENCE_CASES = {
    "consistent": ({("A.l", "B.l")}, {"A.l": {"B.l"}, "B.l": {"C.l"}}),
    "transitive": ({("A.l", "C.l")}, {"A.l": {"B.l"}, "B.l": {"C.l"}}),
    "inverted": ({("B.l", "A.l")}, {"A.l": {"B.l"}}),
    "unknown_node": ({("A.l", "Ghost.l")}, {"A.l": {"B.l"}}),
    "mixed": ({("C.l", "A.l"), ("A.l", "C.l"), ("B.l", "A.l"),
               ("X.l", "Y.l")}, {"A.l": {"B.l"}, "B.l": {"C.l"}}),
    "empty": (set(), {}),
}


@pytest.mark.parametrize("case", sorted(DIVERGENCE_CASES))
def test_divergence_matches_jax(case):
    observed, static = DIVERGENCE_CASES[case]
    out = locksan.divergence(observed, static)
    assert out == jax_locksan.divergence(observed, static)
    want = {"inverted": [("B.l", "A.l")],
            "mixed": [("B.l", "A.l"), ("C.l", "A.l")]}.get(case, [])
    assert out == want


def test_scheduler_seam(sanitized):
    class Sched:
        def managed(self):
            return False

    s = Sched()
    locksan.set_scheduler(s)
    try:
        assert locksan.scheduler() is s
        assert locksan._active_sched() is None  # this thread is unmanaged
        lock = threading.Lock()
        with lock:
            assert lock.locked()
    finally:
        locksan.set_scheduler(None)
    assert locksan.scheduler() is None
