"""The port's locksan session gate and its static half.

The JAX package runs its whole suite under ``SDTPU_LOCKSAN=1`` and, at
session teardown (JAX ``tests/conftest.py``), diffs the observed lock
orders against the static graph of its lint: no observed edge the static
model lacks (divergence), no Goodlock cycle in the union of the threads'
edges, no ``Condition.wait`` entered while holding another lock, and no
``lockorder`` annotation that no run exercised. Here the port's
sanitizer is installed around a lock-heavy subset instead: the seven
``sim/harnesses.py`` harnesses (the fleet gate and the dispatcher among
them) under the schedule explorer and again on plain threads, and a
``World`` executing requests over two stub workers. The same four checks
run against ``runtime/locksan.static_graph`` of the port.

``import torch`` and every subsystem under test come before
``install()``: the sanitizer's lock wrapper has no ``_at_fork_reinit``,
so a module first imported after it that registers one with
``os.register_at_fork`` (``concurrent.futures.thread``, which torch
imports) fails to import. Locks born at import (module singletons) are
therefore raw and unobserved; everything the workload constructs is
wrapped.
"""

import os
import threading

import torch  # noqa: F401 — imported before install(), see above

import pytest

from stable_diffusion_webui_distributed_tpu.runtime import (
    locksan as jax_locksan,
)
from stable_diffusion_webui_distributed_tpu_torch.pipeline.payload import (
    GenerationPayload,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime import locksan
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    worker as worker_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
    world as world_mod,
)
from stable_diffusion_webui_distributed_tpu_torch.sim import harnesses

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "stable_diffusion_webui_distributed_tpu_torch"
#: explorer seeds per harness (tests/test_torch_sched.py runs 64)
SEEDS = range(8)


class _Threads:
    """A harness spawner on plain threads (the explorer's ``spawn``)."""

    def __init__(self):
        self.threads = []

    def spawn(self, fn, name):
        t = threading.Thread(target=fn, name=name, daemon=True)
        self.threads.append(t)
        t.start()

    def join(self):
        for t in self.threads:
            t.join(timeout=20)
        return [t.name for t in self.threads if t.is_alive()]


def _stub_world():
    world = world_mod.World()
    for label in ("master", "remote"):
        world.add_worker(worker_mod.WorkerNode(
            label, worker_mod.StubBackend(
                worker_mod.StubBehavior(seconds_per_image=0.001)),
            master=label == "master", avg_ipm=2400.0))
    return world


@pytest.fixture(scope="module")
def session():
    """The lock-heavy subset under the port's sanitizer; what the gate
    reads afterwards."""
    assert not jax_locksan.installed() and not locksan.installed()
    locksan.install()
    locksan.reset()
    try:
        explored = {name: harnesses.run_harness(name, SEEDS)
                    for name in sorted(harnesses.HARNESSES)}
        threaded = {}
        for name, build in sorted(harnesses.HARNESSES.items()):
            spawner = _Threads()
            check = build(spawner)
            threaded[name] = (spawner.join(), check())
        world = _stub_world()
        results = [world.execute(GenerationPayload(
            prompt="gate", seed=seed, steps=4, batch_size=4, width=64,
            height=64, request_id=f"gate-{seed}")) for seed in (7, 8)]
        out = {"explored": explored, "threaded": threaded,
               "results": results,
               "observed": locksan.observed_edges(),
               "cycles": locksan.runtime_cycles(),
               "waits": locksan.wait_violations()}
    finally:
        locksan.reset()
        locksan.uninstall()
    return out


@pytest.fixture(scope="module")
def static():
    return locksan.static_graph(ROOT)


def test_the_subset_ran_clean(session):
    for name, results in session["explored"].items():
        bad = [r.seed for r in results if not r.ok]
        assert not bad, f"{name}: seeds {bad} failed under the explorer"
    for name, (alive, violations) in session["threaded"].items():
        assert not alive, f"{name}: threads still running: {alive}"
        assert not violations, f"{name}: {violations}"
    for seed, result in zip((7, 8), session["results"]):
        assert result.seeds == [seed + i for i in range(4)]
    # the subset exercises nested named locks: the diff is not vacuous
    assert session["observed"]


def test_no_divergence_from_the_static_graph(session, static):
    diverged = locksan.divergence(session["observed"], static)
    assert diverged == [], (
        "observed lock orderings missing from the static graph "
        "(analysis/locks.py): " + ", ".join(f"{a} -> {b}"
                                            for a, b in diverged))


def test_no_runtime_cycles(session):
    assert session["cycles"] == []


def test_no_wait_while_holding(session):
    assert session["waits"] == []


def test_every_lockorder_annotation_is_exercised(session):
    assert locksan.declared_orders(ROOT) - session["observed"] == set()


# -- the static half ---------------------------------------------------------

def test_static_graph_has_no_self_loops(static):
    assert static, "the port's static lock graph is empty"
    for node, succ in static.items():
        assert node not in succ, f"self-loop on {node}"


def test_static_graph_holds_the_port_lock_orders(static):
    # the World plans under its plan lock and reads its registry inside;
    # the fleet gate's condition guards its weighted-fair queue
    assert "World._registry_lock" in static["World._plan_lock"]
    assert "WeightedFairQueue._lock" in static["FleetGate._cv"]


def test_declared_orders_reads_the_port_annotations(tmp_path):
    # the port declares none today; a package with one reads it back
    assert locksan.declared_orders(ROOT) == set()
    pkg = tmp_path / PORT
    pkg.mkdir()
    (pkg / "pair.py").write_text(
        "import threading\n\n\n"
        "class Pair:\n"
        "    def __init__(self):\n"
        "        self.a = threading.Lock()\n"
        "        self.b = threading.Lock()\n\n"
        "    def forward(self):\n"
        "        # sdtpu-lint: lockorder Pair.a<Pair.b\n"
        "        with self.a:\n"
        "            with self.b:\n"
        "                pass\n")
    assert locksan.declared_orders(str(tmp_path)) == {("Pair.a", "Pair.b")}
    assert locksan.static_graph(str(tmp_path)) == {"Pair.a": {"Pair.b"}}


@pytest.mark.parametrize("observed,expected", [
    ({("World._plan_lock", "World._registry_lock")}, []),
    ({("World._registry_lock", "World._plan_lock")},
     [("World._registry_lock", "World._plan_lock")]),
    ({("FleetGate._cv", "WeightedFairQueue._lock"),
      ("WeightedFairQueue._lock", "FleetGate._cv")},
     [("WeightedFairQueue._lock", "FleetGate._cv")]),
    ({("World._plan_lock", "Unknown._lock")}, []),
], ids=["modeled", "inverted", "both-ways", "unknown-lock"])
def test_divergence_against_the_port_graph_equals_jax(static, observed,
                                                      expected):
    got = locksan.divergence(observed, static)
    assert got == expected
    assert got == jax_locksan.divergence(observed, static)
