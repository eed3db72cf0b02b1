"""sim/: the scenario engine's gate, its live state and chaos injection.

Port of the parts of the JAX package's ``sim/`` the port runs:
:func:`enabled` (``SDTPU_SIM``), the last scored run's record
(:func:`record_last_run`, :func:`last_run`) and :func:`summary`, the
``GET /internal/sim`` document; :mod:`.chaos` is the seeded fault plan
delivered through the ``CHAOS_HOOK`` seams of the serving dispatcher, the
World and the worker. The workload replay, the scorer, the sweep and the
schedule-explorer harnesses stay in ROADMAP item 12.

Off by default: the chaos hooks refuse to arm without ``SDTPU_SIM=1``, so
the default path never sees a hook.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_flag,
)


def enabled() -> bool:
    """The scenario engine's gate, read per call."""
    return env_flag("SDTPU_SIM", False)


_LOCK = threading.Lock()
#: name and score of the most recently scored scenario run
_LAST_RUN: Optional[Dict[str, Any]] = None  # guarded-by: _LOCK


def record_last_run(name: str, score: Dict[str, Any]) -> None:
    global _LAST_RUN
    with _LOCK:
        _LAST_RUN = {"name": str(name), "score": dict(score)}


def last_run() -> Optional[Dict[str, Any]]:
    with _LOCK:
        return None if _LAST_RUN is None else dict(_LAST_RUN)


def clear_last_run() -> None:
    global _LAST_RUN
    with _LOCK:
        _LAST_RUN = None


def summary() -> Dict[str, Any]:
    """The ``/internal/sim`` document: the gate, the journal sink's spill
    status, the armed chaos plan and the last scored run."""
    from stable_diffusion_webui_distributed_tpu_torch.obs.journal import (
        JOURNAL,
    )
    from stable_diffusion_webui_distributed_tpu_torch.sim import chaos

    return {
        "enabled": enabled(),
        "sink": JOURNAL.sink_status(),
        "chaos": chaos.status(),
        "last_run": last_run(),
    }
