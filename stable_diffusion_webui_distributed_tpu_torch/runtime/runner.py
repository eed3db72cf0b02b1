"""The engine's one device thread and its task queue.

Every generation of an engine runs on one thread: PyTorch keeps cuBLAS and
cuDNN handles and cuDNN's plan cache per thread, and on the card the same
UNet call made from a fresh thread can give other bits. The JAX package
runs each execution on its dispatcher's own thread instead, and a
preempted job there blocks in the fleet gate while another thread runs
the interloper. On one thread that would deadlock: the yielding frame
would block the only thread that can run the interloper.

:class:`DeviceRunner` answers that. Other threads queue tasks and wait for
their results (:meth:`run`); a call made on the device thread itself runs
inline. :meth:`serve_while` is the yield: on the device thread it hands a
blocking wait (the gate's re-acquire) to a helper thread and runs the
tasks other threads queue until that wait returns. An interloper
therefore runs nested on the same thread and stack, and the yielding
frame keeps its carry, position, step cache and prefix plan.

Each task, queued or inline, is one *execution* with its own id
(:meth:`current`), which is what the fleet's preempt hook keys on
(``fleet/policy.py`` ``EnginePreemptHook``). While a yield is served
(:attr:`yielding`), a nested execution must not yield in turn: its frame
lies above the yielded one, which could then never resume first.

A queued task runs in a copy of its caller's ``contextvars`` context, so
the request context (``obs/spans.py``: the active request, its open spans
and device-time sinks) follows the work onto the device thread.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
from concurrent.futures import Future
from queue import SimpleQueue
from typing import List, Optional

from stable_diffusion_webui_distributed_tpu_torch.runtime.daemon import (
    StoppableDaemon,
)

#: queue markers: wake a serving loop; end the thread
_WAKE = object()
_STOP = object()


class DeviceRunner:
    """One daemon thread running queued callables in order (see the
    module's docstring): a :class:`StoppableDaemon` whose tick serves the
    next task, blocking on the queue until there is one. It holds no
    reference to what it runs once a task has finished, so an engine that
    owns it can be freed."""

    def __init__(self, name: str = "engine") -> None:
        self._tasks: SimpleQueue = SimpleQueue()
        self._ids = itertools.count(1)
        # executions on the thread, outermost first (device thread only)
        self._stack: List[int] = []
        #: yields being served on the thread (device thread only)
        self.yielding = 0
        self._closed = False
        self._daemon = StoppableDaemon(name, self._next, 0.0,
                                       immediate=True)
        self._daemon.start()

    def on_thread(self) -> bool:
        return self._daemon.is_current()

    def current(self) -> Optional[int]:
        """The id of the innermost execution, None off the device thread
        or between tasks."""
        if not self.on_thread() or not self._stack:
            return None
        return self._stack[-1]

    def run(self, fn, *args):
        """``fn(*args)`` on the device thread as one execution; returns
        its result or raises its error. Inline on the device thread."""
        if self.on_thread():
            return self._execute(fn, args)
        if self._closed:
            raise RuntimeError("the device thread is closed")
        fut: Future = Future()
        self._tasks.put((fut, contextvars.copy_context().run, (fn, *args)))
        return fut.result()

    def serve_while(self, wait, *args):
        """On the device thread: ``wait(*args)`` on a helper thread, while
        this thread runs the queued tasks; returns ``wait``'s result (or
        raises its error) once it has returned."""
        assert self.on_thread(), "serve_while runs on the device thread"
        done = threading.Event()
        box = {}

        def waiter():
            try:
                box["result"] = wait(*args)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["error"] = e
            finally:
                done.set()
                self._tasks.put(_WAKE)

        threading.Thread(target=waiter, name=f"{self._daemon.name}-yield",
                         daemon=True).start()
        self.yielding += 1
        try:
            while not done.is_set():
                item = self._tasks.get()
                if item is _STOP:
                    # closed while yielded: end the thread after this task
                    self._tasks.put(_STOP)
                    done.wait()
                elif item is not _WAKE:
                    self._serve(item)
                del item
        finally:
            self.yielding -= 1
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def close(self) -> None:
        """End the thread once the queued tasks have run."""
        self._closed = True
        self._tasks.put(_STOP)

    # -- the thread ----------------------------------------------------------

    def _execute(self, fn, args):
        self._stack.append(next(self._ids))
        try:
            return fn(*args)
        finally:
            self._stack.pop()

    def _serve(self, item) -> None:
        fut, fn, args = item
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(self._execute(fn, args))
        except BaseException as e:  # noqa: BLE001 — delivered to the caller
            fut.set_exception(e)

    def _next(self) -> None:
        """The daemon's tick: the next queued task; a close ends the
        loop."""
        item = self._tasks.get()
        if item is _STOP:
            self._daemon.halt()
        elif item is not _WAKE:
            self._serve(item)
