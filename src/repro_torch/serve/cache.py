"""LRU + TTL memoization of traversal-query results.

Keys are full query descriptors -- ``(graph_id, kind, params, source)`` --
so kinds and parameterizations never collide, and the graph id keys the
cache across engine instances. Entries may carry a time-to-live: every
``get`` past an entry's deadline is a miss (counted in ``expired``);
``ttl=None`` entries never expire. ``len(cache)`` and ``key in cache``
share ``get``'s view of expiry.
"""
from __future__ import annotations

import time
from collections import OrderedDict

_USE_DEFAULT = object()


class LRUCache:
    """Ordered-dict LRU with optional per-entry TTL.

    ``get`` refreshes recency, ``put`` evicts the oldest entry beyond
    ``capacity``; ``capacity <= 0`` disables caching. ``ttl`` (seconds) is
    the default time-to-live stamped at ``put`` (``put(ttl=...)``
    overrides; ``None`` = never expires). ``clock`` is injectable for tests
    (default ``time.monotonic``).
    """

    def __init__(self, capacity: int = 256, ttl: float | None = None,
                 clock=None):
        self.capacity = int(capacity)
        self.ttl = ttl
        self._clock = clock if clock is not None else time.monotonic
        self._data: OrderedDict = OrderedDict()   # key -> (value, deadline)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expired = 0

    def __len__(self) -> int:
        self._purge_expired()
        return len(self._data)

    def __contains__(self, key) -> bool:
        entry = self._data.get(key)
        if entry is None:
            return False
        if self._is_expired(entry):
            del self._data[key]
            self.expired += 1
            return False
        return True

    def _is_expired(self, entry) -> bool:
        deadline = entry[1]
        return deadline is not None and self._clock() >= deadline

    def _purge_expired(self) -> None:
        dead = [k for k, e in self._data.items() if self._is_expired(e)]
        for k in dead:
            del self._data[k]
            self.expired += 1

    def get(self, key):
        """Value for key, refreshing recency; None on miss or expiry."""
        entry = self._data.get(key)
        if entry is None:
            self.misses += 1
            return None
        if self._is_expired(entry):
            del self._data[key]
            self.expired += 1
            self.misses += 1
            return None
        self.hits += 1
        self._data.move_to_end(key)
        return entry[0]

    def put(self, key, value, ttl=_USE_DEFAULT) -> None:
        if self.capacity <= 0:
            return
        if ttl is _USE_DEFAULT:
            ttl = self.ttl
        deadline = None if ttl is None else self._clock() + ttl
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = (value, deadline)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._data.clear()
