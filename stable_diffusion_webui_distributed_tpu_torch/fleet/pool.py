"""Warm engine pool: pre-initialized residents the autoscaler can act on.

Port of the JAX package's ``fleet/pool.py``. A :class:`WarmPool` holds
in-process engine *residents*, each built by a caller-supplied factory and
warmed (``serving/warmup.warmup_engine``: on the card, the capture of a
CUDA graph per UNet evaluation of the ladder), with

- **checkout routing** — the dispatcher borrows the least-loaded ready
  resident per execution (``ServingDispatcher(pool=...)``), so admitted
  requests spread across residents the way the reference's World spreads
  jobs across its workers;
- **real executors** — :meth:`attach_autoscale` registers a hook that
  turns ``up`` decisions into spawns and ``down`` decisions into
  retirements, then upgrades the audit entry to ``executed`` / ``failed``
  via ``AutoscaleEngine.record_execution``;
- **healing** — a killed resident stops taking checkouts at once
  (requests already in flight on it finish on their own engine, never on
  a replacement), and :meth:`heal` spawns back to the target size.

Each resident is its own engine with its own device thread
(``runtime/runner.py``). The port's artifact store (``serving/aot.py``,
``SDTPU_AOT``) keeps built kernel libraries, not graphs, so a spawn on
the card still copies the weights and captures every graph (most of a
spawn's time, PERF.md section 6). A retired resident leaves the
table once it drains, and its engine is closed (its graphs dropped, its
thread ended), so its memory goes with the last reference.

Everything is in-process and synchronous — no daemon threads of its own.
Gated ``SDTPU_POOL`` (default off); knobs: ``SDTPU_POOL_SIZE`` (target
residents, default 2), ``SDTPU_POOL_COOLDOWN_S`` (min seconds between
autoscale-driven spawn/retire executions, default 0). With
``SDTPU_JOURNAL`` on, a spawn journals ``pool_spawned`` (with its
seconds) and a retirement ``pool_retired``, under ``pool-<name>``. A
spawn's seconds feed ``sdtpu_cold_start_seconds`` (``obs/prometheus.py``)
and stay on the resident (:meth:`summary`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.obs import (
    journal as obs_journal,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag, env_float, env_int,
)

DEFAULT_POOL_SIZE = 2


def enabled() -> bool:
    """Pool gate — re-read per call so tests/bench phases can flip it."""
    return env_flag("SDTPU_POOL", False)


class EngineResident:
    """One pooled engine and its serving state.

    States: ``ready`` (takes checkouts), ``dead`` (killed — takes
    no new checkouts; its inflight work belongs to it alone), ``retired``
    (scale-down — drains and drops). State flips are O(1) under the pool
    lock; the engine itself is built and warmed outside it."""

    def __init__(self, name: str, engine: Any, spawn_s: float) -> None:
        self.name = name
        self.engine = engine
        self.spawn_s = spawn_s
        self.state = "ready"
        self.inflight = 0
        self.checkouts_total = 0
        self.spawned_at = time.time()


class WarmPool:
    """A fixed-target pool of engine residents with least-loaded checkout.

    ``factory(name) -> engine`` builds one resident's engine; ``warm``
    (optional, ``warm(engine)``) runs after construction — typically
    ``serving.warmup.warmup_engine`` so the resident has captured the
    ladder's graphs before it ever sees traffic. Both run OUTSIDE the
    pool lock; only the bookkeeping is serialized."""

    def __init__(self, factory: Callable[[str], Any],
                 size: Optional[int] = None,
                 warm: Optional[Callable[[Any], Any]] = None,
                 clock=time.monotonic) -> None:
        self.factory = factory
        self.warm = warm
        self.size = max(1, env_int("SDTPU_POOL_SIZE", DEFAULT_POOL_SIZE)
                        if size is None else int(size))
        self.cooldown_s = env_float("SDTPU_POOL_COOLDOWN_S", 0.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._residents: Dict[str, EngineResident] = {}  # guarded-by: _lock
        self._spawn_seq = 0  # guarded-by: _lock
        self._last_exec = -1e18  # guarded-by: _lock (autoscale cooldown)
        self._spawns_total = 0  # guarded-by: _lock
        self._retires_total = 0  # guarded-by: _lock
        self._kills_total = 0  # guarded-by: _lock

    # -- lifecycle --------------------------------------------------------

    def _next_name(self) -> str:
        with self._lock:
            self._spawn_seq += 1
            return f"resident-{self._spawn_seq}"

    def spawn(self, name: Optional[str] = None) -> EngineResident:
        """Build + warm one resident (outside the lock) and register it.
        The build-to-ready wall time is the pool's cold start, kept as the
        resident's ``spawn_s``."""
        name = name or self._next_name()
        t0 = self._clock()
        engine = self.factory(name)
        if self.warm is not None:
            self.warm(engine)
        spawn_s = max(0.0, self._clock() - t0)
        obs_prom.observe_cold_start(spawn_s)
        res = EngineResident(name, engine, spawn_s)
        with self._lock:
            self._residents[name] = res
            self._spawns_total += 1
        if obs_journal.enabled():
            obs_journal.emit("pool_spawned", f"pool-{name}",
                             spawn_s=round(spawn_s, 4))
        return res

    def kill(self, name: str) -> bool:
        """A resident lost to a fault: it stops taking new checkouts
        NOW. Work already inflight on it keeps its engine —
        a request never re-runs on a replacement, so a heal can never
        double-merge images."""
        with self._lock:
            res = self._residents.get(name)
            if res is None or res.state != "ready":
                return False
            res.state = "dead"
            self._kills_total += 1
        return True

    def retire_one(self) -> Optional[str]:
        """Scale-down: mark the least-loaded ready resident retired (it
        drains naturally; a retired resident with zero inflight is
        dropped from the table). Refuses to retire the last ready one."""
        with self._lock:
            ready = [r for r in self._residents.values()
                     if r.state == "ready"]
            if len(ready) <= 1:
                return None
            res = min(ready, key=lambda r: (r.inflight, r.name))
            res.state = "retired"
            self._retires_total += 1
            dropped = res.inflight == 0
            if dropped:
                self._residents.pop(res.name, None)
            name = res.name
        if dropped:
            _drop(res)
        if obs_journal.enabled():
            obs_journal.emit("pool_retired", f"pool-{name}")
        return name

    def heal(self) -> List[str]:
        """Spawn residents until the ready count reaches the target size
        after a kill. Spawns run outside the lock, one at a time."""
        spawned: List[str] = []
        while True:
            with self._lock:
                ready = sum(1 for r in self._residents.values()
                            if r.state == "ready")
            if ready >= self.size:
                return spawned
            spawned.append(self.spawn().name)

    # -- checkout routing -------------------------------------------------

    def acquire(self) -> EngineResident:
        """Least-loaded ready resident (ties break by name for
        determinism); spawns synchronously when the pool is empty."""
        while True:
            with self._lock:
                ready = [r for r in self._residents.values()
                         if r.state == "ready"]
                if ready:
                    res = min(ready, key=lambda r: (r.inflight, r.name))
                    res.inflight += 1
                    res.checkouts_total += 1
                    return res
            # empty pool: build one (outside the lock), then retry the
            # selection — a racing acquire may win it, which is fine
            self.spawn()

    def release(self, res: EngineResident) -> None:
        with self._lock:
            res.inflight = max(0, res.inflight - 1)
            dropped = res.state == "retired" and res.inflight == 0 \
                and self._residents.pop(res.name, None) is not None
        if dropped:
            _drop(res)

    # -- autoscale executor -----------------------------------------------

    def attach_autoscale(self, autoscale) -> None:
        """Wire an ``AutoscaleEngine``'s decisions to real capacity: up
        spawns a resident, down retires one, and the decision's audit
        entry is upgraded from ``no_executor`` to ``executed`` /
        ``failed`` (detail says why — cooldown, last resident, error)."""

        def execute(decision) -> None:
            now = self._clock()
            with self._lock:
                if now - self._last_exec < self.cooldown_s:
                    in_cooldown = True
                else:
                    in_cooldown = False
                    self._last_exec = now
            if in_cooldown:
                autoscale.record_execution(decision, "failed", "cooldown")
                return
            try:
                if decision.direction == "up":
                    name = self.spawn().name
                    autoscale.record_execution(
                        decision, "executed", f"spawned {name}")
                else:
                    name = self.retire_one()
                    if name is None:
                        autoscale.record_execution(
                            decision, "failed", "last ready resident")
                    else:
                        autoscale.record_execution(
                            decision, "executed", f"retired {name}")
            except Exception as exc:  # noqa: BLE001 — audit, don't raise
                autoscale.record_execution(
                    decision, "failed", f"{type(exc).__name__}: {exc}")

        autoscale.add_hook(execute)

    # -- introspection ----------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """The pool block of ``/internal/status`` (ROADMAP item 11)."""
        with self._lock:
            residents = [
                {"name": r.name, "state": r.state, "inflight": r.inflight,
                 "checkouts_total": r.checkouts_total,
                 "spawn_s": round(r.spawn_s, 4)}
                for r in sorted(self._residents.values(),
                                key=lambda r: r.name)
            ]
            return {
                "enabled": enabled(),
                "size": self.size,
                "ready": sum(1 for r in self._residents.values()
                             if r.state == "ready"),
                "residents": residents,
                "spawns_total": self._spawns_total,
                "retires_total": self._retires_total,
                "kills_total": self._kills_total,
                "cooldown_s": self.cooldown_s,
            }


def _drop(res: EngineResident) -> None:
    """A drained retired resident leaves: its engine is closed (graphs
    dropped, device thread ended) and released, so its memory goes with
    the last reference."""
    engine, res.engine = res.engine, None
    close = getattr(engine, "close", None)
    if close is not None:
        close()


# -- module-level active pool ------------------------------------------------

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[WarmPool] = None  # guarded-by: _ACTIVE_LOCK


def set_pool(pool: Optional[WarmPool]) -> None:
    """Install ``pool`` as the process-wide warm pool (last one wins);
    the deployment that builds the pool calls this so the operator
    surface can report it (``/internal/status``, ROADMAP item 11)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = pool


def get_pool() -> Optional[WarmPool]:
    with _ACTIVE_LOCK:
        return _ACTIVE
