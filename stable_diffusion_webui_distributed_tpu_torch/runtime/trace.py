"""Stage timings and ``torch.profiler`` captures.

A copy of the JAX package's ``runtime/trace.py`` with its profiler moved
onto ``torch.profiler``. :class:`StageStats` keeps a rolling window of host
seconds per pipeline stage (``text_encode``, ``denoise_chunk``,
``vae_decode_dispatch``, ``vae_decode_fetch``, ``hires_upscale``); each
timed block is also a leaf span on the active request and feeds its
latency histogram (``obs/spans.stage_event``). On the port these are host
seconds: a ``denoise_chunk`` is the time to queue a chunk, not to run it.

:func:`start_trace` / :func:`stop_trace` / :func:`capture` record the CPU
and CUDA activities of the whole process with ``torch.profiler`` and write
a Chrome trace (``trace.json``, loadable in Perfetto) into the directory
named; ``POST /internal/profile`` puts it under
``./profile-traces/<basename>``. The profiler is entered and left on a
thread of its own, whichever threads start and stop it, and records every
thread's ops where torch offers that (``profile_all_threads``); on the
card its CUDA activities hold every kernel, K1's among them.
:func:`annotate` names a region in that timeline
(``torch.profiler.record_function``). torch is imported when a capture
starts, never at import.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterator, Optional


class StageStats:
    """Thread-safe rolling host seconds per stage."""

    def __init__(self, window: int = 64):
        self._window = window
        self._samples: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))  # guarded-by: _lock
        self._lock = threading.Lock()

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._samples[stage].append(seconds)

    @contextlib.contextmanager
    def timer(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self.record(stage, dur)
            _obs_stage(stage, dur, t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """``{stage: {count, mean, p50, last}}`` over the window."""
        with self._lock:
            out = {}
            for stage, samples in self._samples.items():
                if not samples:
                    continue
                ordered = sorted(samples)
                out[stage] = {
                    "count": len(samples),
                    "mean": sum(samples) / len(samples),
                    "p50": ordered[len(ordered) // 2],
                    "last": samples[-1],
                }
            return out

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()


def _obs_stage(stage: str, seconds: float, t0: float) -> None:
    """One timed stage into the obs layer; observability never takes a
    generation down."""
    try:
        from stable_diffusion_webui_distributed_tpu_torch.obs import (
            spans as obs_spans,
        )

        obs_spans.stage_event(stage, seconds, t0)
    except Exception:  # noqa: BLE001 — pragma: no cover
        pass


#: The process-wide stats the engine and the server share.
STATS = StageStats()


_trace_lock = threading.Lock()
#: the capture in progress: its directory and its profiler thread's
#: stop and done events
_running: Optional[tuple] = None  # guarded-by: _trace_lock


def _profile_kwargs() -> dict:
    """The profiler's activities (CPU, and CUDA where there is a card) and,
    where this torch has it, the option that records every thread's ops
    (the engine's device thread and the server's handlers are other
    threads than the capture's)."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kwargs = {"activities": activities}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kwargs["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    return kwargs


def _capture_thread(log_dir: str, started: threading.Event,
                    stop: threading.Event, done: threading.Event) -> None:
    """The profiler is entered and left on one thread of its own, whatever
    threads ask for the start and the stop; it writes the trace."""
    from torch.profiler import profile

    try:
        with profile(**_profile_kwargs()) as prof:
            started.set()
            stop.wait()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    finally:
        started.set()
        done.set()


def start_trace(log_dir: str) -> bool:
    """Start a ``torch.profiler`` capture that :func:`stop_trace` writes
    into ``log_dir`` as ``trace.json``; False when one is running
    already."""
    global _running
    with _trace_lock:
        if _running is not None:
            return False
        started, stop, done = (threading.Event(), threading.Event(),
                               threading.Event())
        threading.Thread(target=_capture_thread,
                         args=(log_dir, started, stop, done),
                         name="profiler", daemon=True).start()
        started.wait()
        _running = (log_dir, stop, done)
        return True


def stop_trace() -> Optional[str]:
    """End the capture once its trace is written; returns its directory
    (None when none ran)."""
    global _running
    with _trace_lock:
        if _running is None:
            return None
        log_dir, stop, done = _running
        _running = None
    stop.set()
    done.wait()
    return log_dir


@contextlib.contextmanager
def capture(log_dir: str) -> Iterator[None]:
    """Capture the block; a no-op when a capture is running already (it
    is not hijacked and stopped)."""
    started = start_trace(log_dir)
    try:
        yield
    finally:
        if started:
            stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the profiler's timeline."""
    import torch

    with torch.profiler.record_function(name):
        yield
