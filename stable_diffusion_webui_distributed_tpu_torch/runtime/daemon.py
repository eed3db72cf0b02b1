"""StoppableDaemon: a periodic background loop with a clean stop.

A copy of the JAX package's ``runtime/daemon.py`` for the loops the
port runs: an engine's device thread (``runtime/runner.py``: a tick
blocks on its task queue, period 0), the World's heartbeat
(``SDTPU_HEARTBEAT_S``), a remote request's in-flight interrupt watch,
the hang watchdog's one-shot timers (:meth:`StoppableDaemon.one_shot`,
``obs/watchdog.py``), and the fleet telemetry plane's TSDB sampler,
federation prober, notify drain and push subscribers (``obs/``). The daemon owns a plain ``threading.Thread``
rather than subclassing it, so no attribute can shadow a private of
``Thread`` (``Thread.join`` calls ``self._stop()``).

The pause between ticks waits on an event: :meth:`StoppableDaemon.wake`
(the notifier's enqueue) and :meth:`StoppableDaemon.stop` cut it short.
``period_s`` may be a callable, read before every pause, so a knob's
change lands without a restart. ``immediate=True`` ticks once at the
start (the samplers); by default the first tick comes one period after
``start`` (the heartbeat and the watch have nothing to do at once).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Union

__all__ = ["StoppableDaemon"]


class StoppableDaemon:
    """Calls ``tick`` every ``period_s`` seconds on a daemon thread until
    stopped."""

    def __init__(self, name: str, tick: Callable[[], object],
                 period_s: Union[float, Callable[[], float]], *,
                 immediate: bool = False) -> None:
        self.name = name
        self._tick = tick
        self._period_s = period_s
        self._immediate = immediate
        self._one_shot = False
        self._halt = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    @classmethod
    def one_shot(cls, name: str, delay_s: float,
                 fire: Callable[[], object]) -> "StoppableDaemon":
        """A timer: ``fire`` once after ``delay_s`` unless ``stop`` or
        ``halt`` lands first."""
        d = cls(name, fire, delay_s)
        d._one_shot = True
        return d

    def start(self) -> None:
        """Start the loop (a no-op while it runs; restartable after
        ``stop``)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._halt.clear()
            self._wake.clear()
            self._thread = threading.Thread(target=self._run,
                                            name=self.name, daemon=True)
            self._thread.start()

    def stop(self, timeout_s: float = 2.0) -> bool:
        """Signal the loop to exit and join it; True when it is gone."""
        with self._lock:
            thread = self._thread
        self._halt.set()
        self._wake.set()
        if thread is None:
            return True
        thread.join(timeout=timeout_s)
        return not thread.is_alive()

    def halt(self) -> None:
        """Signal the loop to exit without joining: the way a tick ends
        its own loop, and the hot path's way (it must not block)."""
        self._halt.set()
        self._wake.set()

    def alive(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def is_current(self) -> bool:
        """True on the loop's own thread (a reference read: no lock, so a
        hot path may ask)."""
        return threading.current_thread() is self._thread

    def stopped(self) -> bool:
        """True once a stop or a halt has been signalled."""
        return self._halt.is_set()

    def wake(self) -> None:
        """Cut the current pause short."""
        self._wake.set()

    def _period(self) -> float:
        p = self._period_s
        return float(p() if callable(p) else p)

    def _pause(self) -> bool:
        """Wait out one period (a wake or a stop ends it early); True when
        the loop goes on."""
        self._wake.wait(self._period())
        self._wake.clear()
        return not self._halt.is_set()

    def _run(self) -> None:
        if self._immediate and not self._halt.is_set():
            self._tick()
        while self._pause():
            self._tick()
            if self._one_shot:
                return
