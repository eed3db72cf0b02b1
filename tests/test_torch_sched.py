"""The port's schedule explorer (``sim/sched.py``) and its harnesses
(``sim/harnesses.py``) over the port's real lock protocols, on the CPU.

- explorer mechanics (JAX ``tests/test_sched.py``): completion, a task's
  exception recorded, livelock bounded, same seed → the same trace and
  digest, different seeds → different interleavings, the explorer
  refusing to run without ``locksan.install()`` or twice;
- the injected lock-order inversion and check-then-act race of
  ``tests/lint_fixtures/`` run under the explorer: the AB/BA pair
  deadlocks on some seed with its holders named, the consistent order
  survives every seed; the stale read loses an update on some seed, the
  re-validated fix holds on every seed. Their static pins (LK005, AT001)
  wait for the port of the lint;
- each of the seven harnesses (FleetGate, ServingDispatcher, Notifier,
  StoppableDaemon, DeltaSubscriber, GraphRunner, WarmPool) clean over 64
  seeds, exploring more than one interleaving, and the same digests for
  the same seeds.
"""

import importlib.util
import os
import threading

import pytest

from stable_diffusion_webui_distributed_tpu.runtime import (
    locksan as jax_locksan,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import locksan
from stable_diffusion_webui_distributed_tpu_torch.sim import harnesses, sched

FIXTURES = os.path.join(os.path.dirname(__file__), "lint_fixtures")
SEEDS = range(64)


@pytest.fixture
def sanitized():
    """Install the port's sanitizer for one test (the explorer refuses to
    run without it), restoring the real factories after."""
    assert not jax_locksan.installed()
    was = locksan.installed()
    locksan.install()
    locksan.reset()
    yield
    locksan.reset()
    if not was:
        locksan.uninstall()


def _load_fixture(name):
    """Import a lint fixture to run it (the lint only parses it)."""
    path = os.path.join(FIXTURES, name + ".py")
    spec = importlib.util.spec_from_file_location(f"torch_sched_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_racing_tasks_complete(sanitized):
    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0

        def bump(self):
            with self._lock:
                self.n += 1

    def build(ex):
        c = Counter()
        ex.spawn(c.bump, "t1")
        ex.spawn(c.bump, "t2")
        return lambda: [] if c.n == 2 else [f"lost update: n={c.n}"]

    results = sched.explore(build, SEEDS)
    assert all(r.ok for r in results)
    assert all(r.steps > 0 for r in results)


def test_task_exception_is_recorded_not_raised(sanitized):
    def build(ex):
        def boom():
            raise ValueError("injected")
        ex.spawn(boom, "boom")
        return None

    (res,) = sched.explore(build, range(1))
    assert res.completed and not res.ok
    assert "ValueError" in res.errors[0]


def test_livelock_detection_bounds_a_spinner(sanitized):
    ex = sched.Explorer(seed=0, max_steps=50)
    lock = threading.Lock()

    def spin():
        while True:
            with lock:
                pass

    ex.spawn(spin, "spinner")
    res = ex.run()
    assert res.livelock and not res.ok
    assert res.steps == 50


def test_explorer_needs_install_and_runs_once():
    assert not locksan.installed()
    ex = sched.Explorer(seed=0)
    with pytest.raises(RuntimeError, match="install"):
        ex.run()
    with pytest.raises(RuntimeError, match="single-use"):
        ex.run()
    assert locksan.scheduler() is None


def test_same_seed_is_bit_identical(sanitized):
    for seed in range(8):
        a = harnesses.run_harness("fleet_gate", range(seed, seed + 1))
        b = harnesses.run_harness("fleet_gate", range(seed, seed + 1))
        assert a[0].trace == b[0].trace
        assert a[0].digest() == b[0].digest()


def test_seeds_explore_distinct_interleavings(sanitized):
    digests = {r.digest()
               for r in harnesses.run_harness("fleet_gate", SEEDS)}
    assert len(digests) > 1


def test_explorer_reproduces_the_lock_order_deadlock(sanitized):
    fx = _load_fixture("lockorder_bad")

    def build(ex):
        pair = fx.Pair()
        ex.spawn(pair.forward, "forward")
        ex.spawn(pair.backward, "backward")
        return None

    results = sched.explore(build, SEEDS)
    dead = [r for r in results if r.deadlocked]
    assert dead, "no seed interleaved the AB/BA inversion fatally"
    assert "Pair.a" in dead[0].deadlock and "Pair.b" in dead[0].deadlock
    assert "held by" in dead[0].deadlock
    for r in results:
        assert r.deadlocked or r.ok


def test_consistent_order_survives_every_seed(sanitized):
    fx = _load_fixture("lockorder_bad")

    def build(ex):
        pair = fx.Pair()
        ex.spawn(pair.forward, "t1")
        ex.spawn(pair.forward, "t2")
        return None

    assert all(r.ok for r in sched.explore(build, SEEDS))


def _quota_build(fx, method):
    def build(ex):
        q = fx.Quota()
        q._balance["t"] = 2
        ex.spawn(lambda: getattr(q, method)("t", 1), "r1")
        ex.spawn(lambda: getattr(q, method)("t", 1), "r2")
        return lambda: [] if q._balance["t"] == 0 else [
            f"lost update: balance {q._balance['t']} != 0"]
    return build


def test_explorer_breaches_the_check_then_act(sanitized):
    fx = _load_fixture("atomicity_bad")
    results = sched.explore(_quota_build(fx, "reserve_value"), SEEDS)
    breached = [r for r in results if r.errors]
    assert breached, "no seed interleaved the check-then-act fatally"
    assert "lost update" in breached[0].errors[0]
    assert not any(r.deadlocked or r.livelock for r in results)


def test_revalidated_fix_holds_every_seed(sanitized):
    fx = _load_fixture("atomicity_bad")
    assert all(r.ok for r in sched.explore(_quota_build(fx, "reserve_ok"),
                                           SEEDS))


def test_seven_harnesses():
    assert sorted(harnesses.HARNESSES) == [
        "daemon_restart", "delta_subscriber", "dispatcher_coalesce",
        "fleet_gate", "notifier_drain", "stage_graph", "warm_pool"]


@pytest.mark.parametrize("name", sorted(harnesses.HARNESSES))
def test_harness_clean_over_64_seeds(sanitized, name):
    results = harnesses.run_harness(name, SEEDS)
    bad = [r for r in results if not r.ok]
    detail = "; ".join(
        f"seed {r.seed}: deadlock={r.deadlock!r} "
        f"livelock={r.livelock} errors={r.errors}" for r in bad[:3])
    assert not bad, f"{name}: {len(bad)}/{len(results)} seeds failed: " \
                    f"{detail}"
    assert len({r.digest() for r in results}) > 1


@pytest.mark.parametrize("name", sorted(harnesses.HARNESSES))
def test_harness_is_deterministic_per_seed(sanitized, name):
    a = harnesses.run_harness(name, range(5, 10))
    b = harnesses.run_harness(name, range(5, 10))
    assert [r.digest() for r in a] == [r.digest() for r in b]
    assert [r.trace for r in a] == [r.trace for r in b]
