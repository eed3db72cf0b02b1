"""The chaos injector: seeded, scripted fault plans.

Port of the JAX package's ``sim/chaos.py``. A plan is delivered through
the ``CHAOS_HOOK`` seams:

- ``scheduler/world.py`` (``World.execute``) and ``serving/dispatcher.py``
  (``submit``) consult the hook once per request entering the system;
  that is where a plan's request counter advances, so "at request N" is
  deterministic;
- ``scheduler/worker.py`` consults it inside ``WorkerNode.request``'s
  try block just before the backend call, so a raised fault takes the
  existing failure path (a health demerit, the worker demoted to
  UNAVAILABLE, the World's requeue to the survivors) and a sleep looks
  like a wedged remote.

Kinds: ``kill`` (a hard backend failure), ``stall`` (a sleep long enough
for a watchdog), ``slow`` (degraded but completing), ``http_error`` (a
transient failure that clears after ``count`` hits). Every delivered
fault is journaled (``fault_injected``, then ``fault_cleared`` when its
count is spent, under the request id ``chaos-<seed>-<index>``) and counted
in ``sdtpu_sim_faults_total{kind}``.

:func:`arm` refuses unless ``SDTPU_SIM=1``; :func:`disarm` leaves every
seam None.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.obs import (
    journal as obs_journal,
)
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as obs_prom,
)

KINDS = ("kill", "stall", "slow", "http_error")


@dataclasses.dataclass
class Fault:
    """One scripted fault. ``worker`` names a label exactly; ``""`` or
    ``"any"`` matches the first worker consulted once the fault is armed.
    ``at_request`` arms it once the Nth request (1-based) has entered the
    system; ``count`` is how many backend calls it hits before it clears;
    ``duration_s`` is the sleep of ``stall`` and ``slow``."""

    kind: str
    worker: str = ""
    at_request: int = 1
    count: int = 1
    duration_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")


class ChaosPlan:
    """A fault script and its delivery state; :meth:`consult` is the
    hook."""

    def __init__(self, faults: List[Fault], seed: int = 0) -> None:
        self.faults = list(faults)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._step = 0  # guarded-by: _lock — requests entered so far
        # per-fault delivery state                       guarded-by: _lock
        self._state = [{"remaining": f.count, "injected": 0,
                        "cleared": False} for f in self.faults]

    def consult(self, site: str, **ctx: Any) -> None:
        """The ``CHAOS_HOOK`` entry point. What to deliver is decided
        under the lock; the sleep or the raise happens outside it."""
        if site in ("world.execute", "dispatcher.submit"):
            with self._lock:
                self._step += 1
            return
        if site != "worker.generate":
            return
        worker = str(ctx.get("worker", ""))
        deliver = []
        with self._lock:
            step = self._step
            for i, f in enumerate(self.faults):
                st = self._state[i]
                if st["remaining"] <= 0 or step < f.at_request:
                    continue
                if f.worker not in ("", "any") and f.worker != worker:
                    continue
                st["remaining"] -= 1
                st["injected"] += 1
                cleared = st["remaining"] == 0
                if cleared:
                    st["cleared"] = True
                deliver.append((i, f, cleared))
        for i, f, cleared in deliver:
            self._journal("fault_injected", i, f, worker, step)
            obs_prom.sim_fault_count(f.kind)
            if cleared:
                self._journal("fault_cleared", i, f, worker, step)
            if f.kind in ("stall", "slow"):
                time.sleep(max(0.0, f.duration_s))
            elif f.kind == "kill":
                raise ConnectionError(
                    f"chaos: injected kill on worker '{worker}'")
            elif f.kind == "http_error":
                raise ConnectionError(
                    f"chaos: injected transient http error on "
                    f"worker '{worker}'")

    def _journal(self, event: str, index: int, fault: Fault,
                 worker: str, step: int) -> None:
        if obs_journal.enabled():
            obs_journal.emit(event, f"chaos-{self.seed}-{index}",
                             kind=fault.kind, worker=worker, step=step,
                             at_request=fault.at_request)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "step": self._step,
                "faults": [
                    {"kind": f.kind, "worker": f.worker,
                     "at_request": f.at_request,
                     "injected": st["injected"],
                     "remaining": st["remaining"],
                     "cleared": st["cleared"]}
                    for f, st in zip(self.faults, self._state)
                ],
            }


_ARM_LOCK = threading.Lock()
_ARMED: Optional[ChaosPlan] = None  # guarded-by: _ARM_LOCK


def _seams():
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
        worker as worker_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.scheduler import (
        world as world_mod,
    )
    from stable_diffusion_webui_distributed_tpu_torch.serving import (
        dispatcher as dispatcher_mod,
    )

    return worker_mod, world_mod, dispatcher_mod


def arm(plan: ChaosPlan) -> ChaosPlan:
    """Install ``plan.consult`` in every ``CHAOS_HOOK`` seam. Refuses
    unless the scenario engine is on (``SDTPU_SIM=1``)."""
    from stable_diffusion_webui_distributed_tpu_torch import sim

    if not sim.enabled():
        raise RuntimeError("SDTPU_SIM is off; refusing to arm chaos hooks")
    global _ARMED
    with _ARM_LOCK:
        for mod in _seams():
            mod.CHAOS_HOOK = plan.consult
        _ARMED = plan
    return plan


def disarm() -> None:
    """Reset every ``CHAOS_HOOK`` seam to None (idempotent)."""
    global _ARMED
    with _ARM_LOCK:
        for mod in _seams():
            mod.CHAOS_HOOK = None
        _ARMED = None


def status() -> Dict[str, Any]:
    """The armed plan's state for ``/internal/sim`` (``armed: false``
    when idle)."""
    with _ARM_LOCK:
        plan = _ARMED
    if plan is None:
        return {"armed": False, "plan": None}
    return {"armed": True, "plan": plan.status()}
