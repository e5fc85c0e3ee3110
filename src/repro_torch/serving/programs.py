"""Bounded engine caches for the serving plane.

A serving process sees many (model, capacity bucket, batch size)
combinations over its lifetime; each one owns a batched rollout engine
and its device buffers.  Left unbounded that is a leak — every distinct
scene size ever served would pin an engine forever.  :class:`LRUCache` is
the generic bounded map, and :class:`ProgramCache` specialises it to
:class:`ProgramKey` with a build-on-miss hook so eviction + re-admission
rebuilds exactly once.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional


class LRUCache:
    """Insertion/access-ordered dict bounded to ``maxsize`` entries.

    ``get`` refreshes recency; ``put`` evicts the least-recently-used
    entry once full and returns the evicted ``(key, value)`` pair (or
    ``None``) so callers can release device buffers deterministically.
    """

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def get(self, key, default=None):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return default

    def put(self, key, value):
        evicted = None
        if key in self._d:
            self._d.move_to_end(key)
        elif len(self._d) >= self.maxsize:
            evicted = self._d.popitem(last=False)
            self.evictions += 1
        self._d[key] = value
        return evicted

    def pop(self, key, default=None):
        return self._d.pop(key, default)

    def keys(self):
        return list(self._d.keys())

    def stats(self) -> dict:
        return {"size": len(self._d), "capacity": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


@dataclass(frozen=True)
class ProgramKey:
    """Cache key for one batched-rollout engine.

    ``model`` identifies the parameter set (the service names models
    explicitly).  The CSR layout has no band geometry, so the capacity
    bucket, batch size and physics constants are the whole key.
    """

    model: str
    node_cap: int
    edge_cap: int
    batch_size: int
    r: float
    skin: float
    dt: float
    drop_rate: float
    wrap_box: Optional[float]


class ProgramCache:
    """LRU of live engines (one per key, with their device buffers).

    ``get_or_build(key, factory)`` returns the cached engine or builds
    one, counting ``builds`` so tests and the serving gate can assert
    "evict + re-admit builds exactly once".
    """

    def __init__(self, maxsize: int):
        self._lru = LRUCache(maxsize)
        self.builds = 0

    def __len__(self) -> int:
        return len(self._lru)

    def get_or_build(self, key: ProgramKey, factory: Callable[[], object]):
        eng = self._lru.get(key)
        if eng is not None:
            return eng
        eng = factory()
        self.builds += 1
        self._lru.put(key, eng)
        return eng

    def keys(self):
        return self._lru.keys()

    def stats(self) -> dict:
        s = self._lru.stats()
        s["builds"] = self.builds
        return s
