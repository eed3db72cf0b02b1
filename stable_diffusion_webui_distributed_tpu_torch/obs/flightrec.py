"""The failure flight recorder: the last N failed, interrupted, slow or
stalled requests.

A copy of the JAX package's ``obs/flightrec.py``. ``obs/spans.py`` hands
every request that does not end ``ok`` here when its root closes (its
exported span events, so an entry is plain JSON), and the recorder adds
the lines the request logged (``runtime/logging.py``'s per-request index)
and the perf ledger's last dispatch (``obs/perf.py``, None with
``SDTPU_PERF`` off). The hang watchdog and the World's job failures record
here too, and so does the alert engine at each firing. Each entry also
holds what the detectors saw: the alert engine's state
(``obs/alerts.py`` ``state_snapshot``) and a bounded window of the TSDB
(``obs/tsdb.py`` ``flight_window``), each None with its gate off. The ring
holds ``SDTPU_OBS_FLIGHTREC`` entries (default 16) and ``GET
/internal/flightrec`` serves it.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from stable_diffusion_webui_distributed_tpu_torch.runtime.config import (
    env_int,
)

#: entries kept by default
DEFAULT_CAPACITY = 16


class FlightRecorder:
    """A bounded, thread-safe ring of JSON-plain failure entries."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        if capacity is None:
            capacity = env_int("SDTPU_OBS_FLIGHTREC", DEFAULT_CAPACITY)
        self._lock = threading.Lock()
        self._entries: Deque[Dict[str, Any]] = deque(
            maxlen=max(1, int(capacity or DEFAULT_CAPACITY)))  # guarded-by: _lock

    def record(self, request_id: str, reason: str, detail: str,
               events: List[Dict[str, Any]],
               duration_s: float = 0.0,
               perf: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Append one entry and return it. ``perf`` None takes the perf
        ledger's last dispatch."""
        from stable_diffusion_webui_distributed_tpu_torch.runtime.logging \
            import lines_for_request

        if perf is None:
            try:
                from stable_diffusion_webui_distributed_tpu_torch.obs import (
                    perf as obs_perf,
                )

                perf = obs_perf.LEDGER.last_dispatch()
            except Exception:  # noqa: BLE001 — the recorder never fails
                perf = None
        entry = {
            "request_id": str(request_id),
            "reason": str(reason),
            "detail": str(detail),
            # wall clock: a postmortem is read beside logs and dashboards
            "recorded_at": time.time(),  # sdtpu-lint: wallclock
            "duration_s": float(duration_s),
            "perf": perf,
            "spans": list(events),
            "logs": lines_for_request(request_id),
            "alerts": self._alert_snapshot(),
            "tsdb": self._tsdb_window(),
        }
        with self._lock:
            self._entries.append(entry)
        return entry

    @staticmethod
    def _alert_snapshot() -> Optional[Dict[str, Any]]:
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                alerts as obs_alerts,
            )

            return obs_alerts.state_snapshot()
        except Exception:  # noqa: BLE001 — the recorder never fails
            return None

    @staticmethod
    def _tsdb_window() -> Optional[Dict[str, Any]]:
        try:
            from stable_diffusion_webui_distributed_tpu_torch.obs import (
                tsdb as obs_tsdb,
            )

            return obs_tsdb.flight_window()
        except Exception:  # noqa: BLE001 — the recorder never fails
            return None

    def dump(self) -> Dict[str, Any]:
        """Every entry, oldest first: the ``/internal/flightrec`` body."""
        with self._lock:
            entries = list(self._entries)
            capacity = self._entries.maxlen
        return {"entries": entries, "capacity": capacity,
                "count": len(entries)}

    def dump_to_file(self, path: str) -> str:
        """:meth:`dump` written as JSON to ``path``."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.dump(), f, indent=2, default=str)
        return path

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: The process-wide recorder.
RECORDER = FlightRecorder()
