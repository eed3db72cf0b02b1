"""StoppableDaemon: a periodic background loop with a clean stop.

A copy of the JAX package's ``runtime/daemon.py`` for the two loops the
port's fleet runs: the World's heartbeat (``SDTPU_HEARTBEAT_S``) and a
remote request's in-flight interrupt watch. The daemon owns a plain
``threading.Thread`` rather than subclassing it, so no attribute can shadow
a private of ``Thread`` (``Thread.join`` calls ``self._stop()``).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

__all__ = ["StoppableDaemon"]


class StoppableDaemon:
    """Calls ``tick`` every ``period_s`` seconds on a daemon thread until
    stopped, the first time one period after ``start`` (both loops have
    nothing to do at once)."""

    def __init__(self, name: str, tick: Callable[[], object],
                 period_s: float) -> None:
        self.name = name
        self._tick = tick
        self._period_s = float(period_s)
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start(self) -> None:
        """Start the loop (a no-op while it runs; restartable after
        ``stop``)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._halt.clear()
            self._thread = threading.Thread(target=self._run,
                                            name=self.name, daemon=True)
            self._thread.start()

    def stop(self, timeout_s: float = 2.0) -> bool:
        """Signal the loop to exit and join it; True when it is gone."""
        with self._lock:
            thread = self._thread
        self._halt.set()
        if thread is None:
            return True
        thread.join(timeout=timeout_s)
        return not thread.is_alive()

    def halt(self) -> None:
        """Signal the loop to exit without joining: the way a tick ends
        its own loop, and the hot path's way (it must not block)."""
        self._halt.set()

    def _run(self) -> None:
        while not self._halt.wait(self._period_s):
            self._tick()
