"""The hang watchdog: stall detection for device dispatches and remote
jobs.

A copy of the JAX package's ``obs/watchdog.py``. The scheduler predicts
how long an operation should take (``scheduler/eta.py``); :func:`arm`
starts a one-shot daemon timer around an operation with a known ETA, and
if the operation has not disarmed it after ``SDTPU_WATCHDOG_FACTOR`` x ETA
seconds the watchdog

- records a dump of every thread's stack in the flight recorder
  (``obs/flightrec.py``),
- counts ``sdtpu_watchdog_stalls_total`` (``obs/prometheus.py``),
- journals ``watchdog_stall`` (``obs/journal.py``, when on), and
- calls the caller's ``on_stall``: ``World.execute`` marks the job
  stalled, abandons its thread and requeues its range.

Off by default: ``SDTPU_WATCHDOG_FACTOR`` <= 0 (the default 0) makes
:func:`arm` return None and start nothing. :func:`disarm` only signals
the timer: it runs on request paths.
"""

from __future__ import annotations

import logging
import sys
import threading
import traceback
from typing import Callable, Optional

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_float,
)
from stable_diffusion_webui_distributed_tpu_torch.runtime.daemon import (
    StoppableDaemon,
)

log = logging.getLogger(__name__)


def factor() -> float:
    """The stall threshold as a multiple of the ETA; <= 0 is off. Read
    per call."""
    return env_float("SDTPU_WATCHDOG_FACTOR", 0.0) or 0.0


def enabled() -> bool:
    return factor() > 0.0


def dump_stacks(max_frames: int = 40) -> str:
    """Every live thread's stack, named."""
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for tid, frame in sorted(sys._current_frames().items()):
        name = names.get(tid, "?")
        stack = "".join(traceback.format_stack(frame)[-max_frames:])
        chunks.append(f"Thread {name} (ident={tid}):\n{stack}")
    return "\n".join(chunks)


def arm(request_id: str, name: str, eta_s: Optional[float],
        on_stall: Optional[Callable[[], None]] = None,
        ) -> Optional[StoppableDaemon]:
    """Watch one operation; returns the handle to :func:`disarm` in a
    ``finally``, or None when the watchdog is off or no ETA is known."""
    k = factor()
    if k <= 0.0 or not eta_s or eta_s <= 0.0:
        return None
    deadline_s = k * float(eta_s)

    def fire() -> None:
        _record_stall(request_id, name, float(eta_s), deadline_s)
        if on_stall is not None:
            try:
                on_stall()
            except Exception:  # noqa: BLE001 — the stall is recorded
                pass

    timer = StoppableDaemon.one_shot(f"watchdog-{name}", deadline_s, fire)
    timer.start()
    return timer


def disarm(timer: Optional[StoppableDaemon]) -> None:
    if timer is not None:
        timer.halt()  # a signal only: disarm runs on request paths


def _record_stall(request_id: str, name: str, eta_s: float,
                  waited_s: float) -> None:
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        flightrec,
        journal,
    )
    from stable_diffusion_webui_distributed_tpu_torch.obs import (
        prometheus as prom,
    )

    stacks = dump_stacks()
    prom.count_watchdog_stall(name)
    if journal.enabled():
        journal.emit("watchdog_stall", request_id or "", name=name,
                     eta_s=eta_s, waited_s=waited_s)
    log.warning(
        "watchdog: %s stalled past %.2fs (%.2gx ETA %.2fs), request '%s'",
        name, waited_s, factor(), eta_s, request_id)
    flightrec.RECORDER.record(
        request_id or "", "watchdog_stall",
        f"{name} exceeded {factor():g}x ETA ({eta_s:.2f}s ETA, waited "
        f"{waited_s:.2f}s); thread stacks:\n{stacks}",
        events=[], duration_s=waited_s)
