"""Device-memory readers of the JAX package's ``obs/tsdb.py``.

The perf ledger (``obs/perf.py``) keeps each serving group's device-memory
watermark from :func:`dispatch_memory_sample`, read after each dispatch
from ``torch.cuda.memory_stats()``: ``allocated_bytes.all.current`` as
``bytes_in_use``, ``allocated_bytes.all.peak`` as ``peak_bytes_in_use`` and
``active.all.current`` (live allocations) as the buffer census. On the CPU
every reader returns None, never a made-up number. A read is host
bookkeeping of the allocator: it does not wait for the card.

The ring-buffer series store, its sampling daemon, its snapshots and
``GET /internal/tsdb`` are the next slice's.
"""

from __future__ import annotations

from typing import Dict, Optional


def _cuda_stats() -> Optional[Dict]:
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        return torch.cuda.memory_stats()
    except Exception:  # noqa: BLE001 — telemetry stays passive
        return None


def device_memory_stats() -> Optional[Dict[str, int]]:
    """``{bytes_in_use, peak_bytes_in_use, num_allocs}`` of the current
    card, or None without one."""
    stats = _cuda_stats()
    if not stats:
        return None
    out: Dict[str, int] = {}
    for key, src in (("bytes_in_use", "allocated_bytes.all.current"),
                     ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                     ("num_allocs", "allocation.all.allocated")):
        if src in stats:
            out[key] = int(stats[src])
    return out or None


def live_buffer_count() -> Optional[int]:
    """Live allocations on the current card (the caching allocator's
    ``active.all.current``), or None without one."""
    stats = _cuda_stats()
    if not stats or "active.all.current" not in stats:
        return None
    return int(stats["active.all.current"])


def dispatch_memory_sample() -> Optional[Dict[str, int]]:
    """One dispatch's device-memory read for the perf ledger:
    :func:`device_memory_stats` with ``live_buffers``; None on the CPU."""
    mem = device_memory_stats()
    if mem is None:
        return None
    live = live_buffer_count()
    if live is not None:
        mem["live_buffers"] = live
    return mem
