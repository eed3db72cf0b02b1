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
``"deep-trunc"``, ``"reuse"`` and ``"reuse-trunc"``), and where it
counted cache hits of its compiled stages, the replays of a captured
graph by kind; the dispatches and requests of each serving precision
(``pipeline/precision.py``); and the UNet FLOPs dispatched, priced over
each denoise range's evaluations by ``pipeline/stepcache.py``'s
``FlopsAccountant`` (``torch.utils.flop_counter`` on meta tensors), over
the images decoded (``unet_flops_per_image``). The perf ledger
(``obs/perf.py``) takes a delta of the FLOP total around each dispatch.
Everything here is host-side counting, safe to assert in CPU tests.

Left out: the JAX package's AOT artifact loads (the artifact store is not
ported).
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
            #: graph kind -> replays of a captured graph
            self.cache_hits: Dict[str, int] = defaultdict(int)  # guarded-by: _lock
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
            #: UNet FLOPs dispatched (priced over each range's evaluations)
            self.unet_flops_total = 0.0  # guarded-by: _lock
            #: images decoded (the denominator of FLOPs per image)
            self.unet_images = 0  # guarded-by: _lock
            #: resolved precision name -> dispatches / requests carried
            #: ("" = the caller did not say)
            self.precision_dispatches: Dict[str, int] = defaultdict(int)  # guarded-by: _lock
            self.precision_requests: Dict[str, int] = defaultdict(int)  # guarded-by: _lock

    def record_compile(self, kind: str) -> None:
        with self._lock:
            self.compiles[str(kind)] += 1

    def record_cache_hit(self, kind: str) -> None:
        with self._lock:
            self.cache_hits[str(kind)] += 1

    def record_unet_flops(self, flops: float) -> None:
        """One denoise range's priced UNet FLOPs."""
        with self._lock:
            self.unet_flops_total += float(flops)

    def record_unet_images(self, n: int) -> None:
        with self._lock:
            self.unet_images += int(n)

    def unet_flops_snapshot(self) -> float:
        """The FLOP total now; the perf ledger takes a delta around each
        dispatch."""
        with self._lock:
            return self.unet_flops_total

    def unet_flops_per_image(self) -> float:
        """Mean UNet FLOPs per decoded image (0.0 before both)."""
        with self._lock:
            if not self.unet_images:
                return 0.0
            return self.unet_flops_total / self.unet_images

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

    def avg_queue_wait(self) -> float:
        """Mean coalesce-queue wait (0 before any); the fleet's admission
        prices it in (``ServingDispatcher.eta_overhead``)."""
        with self._lock:
            if not self.queue_wait_count:
                return 0.0
            return self.queue_wait_total / self.queue_wait_count

    def avg_padding_ratio(self) -> float:
        """Mean bucket-px / requested-px over bucketed requests (>= 1)."""
        with self._lock:
            if not self.padding_ratio_count:
                return 1.0
            return self.padding_ratio_total / self.padding_ratio_count

    def summary(self) -> Dict:
        with self._lock:
            total_buckets = self.bucket_hits + self.bucket_misses
            return {
                "compiles": dict(self.compiles),
                "cache_hits": dict(self.cache_hits),
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
                "unet_flops_total": self.unet_flops_total,
                "unet_images": self.unet_images,
                "unet_flops_per_image": (self.unet_flops_total
                                         / self.unet_images
                                         if self.unet_images else None),
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
