"""Dispatch metrics for the serving layer.

Port of the JAX package's ``serving/metrics.py``. A single process-wide
:data:`METRICS` object counts what the serving dispatcher decides: how many
requests came in, how often a request's shape landed exactly on a bucket,
was padded up to one or bypassed bucketing, how many requests each device
dispatch carried (the coalesce factor), how long requests waited in the
coalesce queue, and how much padding the buckets cost; and, where the JAX
package counted XLA compiles by stage kind, the CUDA graphs the engines
captured, by kind (``runtime/graphs.py``: ``"unet"``, with or without
ControlNet units, ``"ragged"``, and the step cache's ``"deep"``,
``"deep-trunc"``, ``"reuse"`` and ``"reuse-trunc"``); and the dispatches
and requests of each serving precision (``pipeline/precision.py``).
Everything here is host-side counting, safe to assert in CPU tests.

Left out: the JAX package's cache-hit counts, its AOT artifact loads and
its XLA cost-analysis FLOP totals, which have no meaning for eager PyTorch
(the FLOP pricer is ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict


class DispatchMetrics:
    """Thread-safe counters; every mutator is O(1) under one lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.clear()

    def clear(self) -> None:
        with self._lock:
            #: graph kind -> CUDA graphs captured (the JAX package's XLA
            #: compiles by stage kind)
            self.compiles: Dict[str, int] = defaultdict(int)  # guarded-by: _lock
            self.requests = 0  # guarded-by: _lock
            #: request shape already equal to its bucket
            self.bucket_hits = 0  # guarded-by: _lock
            #: request shape padded up to a bucket
            self.bucket_misses = 0  # guarded-by: _lock
            #: request bypassed bucketing (hires, img2img)
            self.bucket_bypasses = 0  # guarded-by: _lock
            #: device batches executed by the dispatcher
            self.dispatches = 0  # guarded-by: _lock
            #: dispatches that merged >= 2 requests
            self.coalesced_dispatches = 0  # guarded-by: _lock
            #: sum over dispatches of requests merged (factor numerator)
            self.coalesced_requests = 0  # guarded-by: _lock
            self.queue_wait_total = 0.0  # guarded-by: _lock
            self.queue_wait_count = 0  # guarded-by: _lock
            #: sum of (bucket px / requested px) per bucketed request
            self.padding_ratio_total = 0.0  # guarded-by: _lock
            self.padding_ratio_count = 0  # guarded-by: _lock
            #: resolved precision name -> dispatches / requests carried
            #: ("" = the caller did not say)
            self.precision_dispatches: Dict[str, int] = defaultdict(int)  # guarded-by: _lock
            self.precision_requests: Dict[str, int] = defaultdict(int)  # guarded-by: _lock

    def record_compile(self, kind: str) -> None:
        with self._lock:
            self.compiles[str(kind)] += 1

    def record_request(self, bucketed: bool, bypassed: bool = False,
                       padding_ratio: float = 1.0) -> None:
        with self._lock:
            self.requests += 1
            if bypassed:
                self.bucket_bypasses += 1
                return
            if bucketed:
                self.bucket_misses += 1
            else:
                self.bucket_hits += 1
            self.padding_ratio_total += float(padding_ratio)
            self.padding_ratio_count += 1

    def record_dispatch(self, n_requests: int, precision: str = "") -> None:
        with self._lock:
            self.dispatches += 1
            self.coalesced_requests += int(n_requests)
            if n_requests >= 2:
                self.coalesced_dispatches += 1
            if precision:
                self.precision_dispatches[str(precision)] += 1
                self.precision_requests[str(precision)] += int(n_requests)

    def record_queue_wait(self, seconds: float) -> None:
        with self._lock:
            self.queue_wait_total += float(seconds)
            self.queue_wait_count += 1

    def summary(self) -> Dict:
        with self._lock:
            total_buckets = self.bucket_hits + self.bucket_misses
            return {
                "compiles": dict(self.compiles),
                "requests": self.requests,
                "bucket_hits": self.bucket_hits,
                "bucket_misses": self.bucket_misses,
                "bucket_bypasses": self.bucket_bypasses,
                "bucket_hit_rate": (self.bucket_hits / total_buckets
                                    if total_buckets else None),
                "dispatches": self.dispatches,
                "coalesced_dispatches": self.coalesced_dispatches,
                "coalesced_requests": self.coalesced_requests,
                "coalesce_factor": (self.coalesced_requests / self.dispatches
                                    if self.dispatches else None),
                "avg_queue_wait_s": (self.queue_wait_total
                                     / self.queue_wait_count
                                     if self.queue_wait_count else None),
                "avg_padding_ratio": (self.padding_ratio_total
                                      / self.padding_ratio_count
                                      if self.padding_ratio_count else None),
                # the per-precision dispatch mix
                "precision": {
                    name: {
                        "dispatches": self.precision_dispatches.get(name, 0),
                        "requests": self.precision_requests.get(name, 0),
                    }
                    for name in sorted(set(self.precision_dispatches)
                                       | set(self.precision_requests))
                },
            }


#: Process-wide metrics instance.
METRICS = DispatchMetrics()
