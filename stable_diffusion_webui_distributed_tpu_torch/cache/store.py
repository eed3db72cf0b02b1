"""Bounded LRU store.

Port of the JAX package's ``cache/store.py`` ``BoundedStore``, as far as the
adapter cache needs it: every entry is byte-capped, and entries are evicted
LRU-first until the cap holds, never grown unbounded. (The JAX store's
hit/miss accounting and single-flight half wait for the caching tier.)
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional, Tuple


class BoundedStore:
    """Byte-capped LRU map.

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

    def get(self, key: str) -> Optional[Any]:
        """Value for ``key`` (refreshing recency), or None."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            self._entries.move_to_end(key)
            return ent[0]

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
            while self._bytes > self.max_bytes and self._entries:
                _, (_, evicted_bytes) = self._entries.popitem(last=False)
                self._bytes -= evicted_bytes
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
