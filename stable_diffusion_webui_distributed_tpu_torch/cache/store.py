"""Bounded LRU store and single-flight: the substrate of the caching tier.

Port of the JAX package's ``cache/store.py``. Every layer (the embed,
result and prefix caches of this package, and the registry's adapter
cache) is byte-capped: entries are evicted LRU-first until the cap holds,
never grown unbounded, and every counter is read under the lock that
guards the map.

:class:`SingleFlight` is the result cache's concurrency primitive: N
threads arriving with one key elect one leader (who generates) and N-1
followers (who block on the flight's event and wake with the leader's
published value). A leader that ends without publishing abandons the
flight: its followers wake empty-handed and elect again, so no request
waits forever behind a failed one.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple


class BoundedStore:
    """Byte-capped LRU map with hit, miss, put and eviction counts.

    ``max_bytes <= 0`` disables insertion entirely (a zero-cap layer
    degrades to a pure pass-through, never an unbounded one). A single
    entry larger than the cap is refused for the same reason.
    """

    def __init__(self, name: str, max_bytes: int) -> None:
        self.name = str(name)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # key -> (value, nbytes), LRU order
        self._entries: "OrderedDict[str, Tuple[Any, int]]" = \
            OrderedDict()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        self._puts = 0  # guarded-by: _lock
        self._evictions = 0  # guarded-by: _lock

    def get(self, key: str) -> Optional[Any]:
        """Value for ``key`` (refreshing recency), or None. Counts one hit
        or miss."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return ent[0]

    def peek(self, key: str) -> Optional[Any]:
        """Like :meth:`get`, without touching recency or the counts."""
        with self._lock:
            ent = self._entries.get(key)
            return None if ent is None else ent[0]

    def put(self, key: str, value: Any, nbytes: int) -> bool:
        """Insert/replace ``key``; evicts LRU entries until the byte cap
        holds. Returns False when the entry alone exceeds the cap."""
        nbytes = max(0, int(nbytes))
        if nbytes > self.max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            self._puts += 1
            while self._bytes > self.max_bytes and self._entries:
                _, (_, evicted_bytes) = self._entries.popitem(last=False)
                self._bytes -= evicted_bytes
                self._evictions += 1
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            hits, misses = self._hits, self._misses
            total = hits + misses
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": hits,
                "misses": misses,
                "puts": self._puts,
                "evictions": self._evictions,
                "hit_rate": (hits / total) if total else 0.0,
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._hits = 0
            self._misses = 0
            self._puts = 0
            self._evictions = 0


class Flight:
    """One generation in progress that identical requests can join."""

    __slots__ = ("event", "value")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value: Optional[Any] = None  # published result, None = abandoned


class SingleFlight:
    """Key-level request coalescing for the result cache.

    :meth:`acquire` returns ``("leader", flight)`` once per key and flight;
    every other caller gets ``("wait", flight)`` and blocks on
    ``flight.event``. The leader must end its flight with :meth:`publish`
    (success) or :meth:`abandon` (failure), after which the key is free
    for a new election.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flights: Dict[str, Flight] = {}  # guarded-by: _lock
        self._led = 0  # guarded-by: _lock
        self._joined = 0  # guarded-by: _lock

    def acquire(self, key: str) -> Tuple[str, Flight]:
        with self._lock:
            f = self._flights.get(key)
            if f is not None:
                self._joined += 1
                return "wait", f
            f = Flight()
            self._flights[key] = f
            self._led += 1
            return "leader", f

    def publish(self, key: str, flight: Flight, value: Any) -> None:
        with self._lock:
            if self._flights.get(key) is flight:
                del self._flights[key]
        flight.value = value
        flight.event.set()

    def abandon(self, key: str, flight: Flight) -> None:
        """The leader failed before producing a result: wake its followers
        with nothing, so that they elect again."""
        with self._lock:
            if self._flights.get(key) is flight:
                del self._flights[key]
        flight.value = None
        flight.event.set()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"led": self._led, "joined": self._joined,
                    "inflight": len(self._flights)}

    def clear(self) -> None:
        """Drop the bookkeeping; a live flight is woken empty-handed first,
        so that no follower stays blocked across a reset."""
        with self._lock:
            flights = list(self._flights.values())
            self._flights.clear()
            self._led = 0
            self._joined = 0
        for f in flights:
            f.value = None
            f.event.set()
