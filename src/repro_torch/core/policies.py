"""Host caching policies of the serving path, copied from ``repro.core.policies``.

Each exposes the simulator interface ``request(i) -> hit``, ``contains(i)``,
``occupancy()`` and ``batch_end()``.  The port carries the paper's OGB and
LRU; the other kinds of ``repro``'s registry are not ported yet.
"""

from __future__ import annotations

from collections import OrderedDict


class _Base:
    __slots__ = ("N", "C", "hits", "requests")

    def __init__(self, catalog_size: int, capacity: int, **_):
        self.N = int(catalog_size)
        self.C = int(capacity)
        self.hits = 0
        self.requests = 0

    def batch_end(self) -> None:
        pass

    def _account(self, hit: bool) -> bool:
        self.requests += 1
        self.hits += int(hit)
        return hit


class LRU(_Base):
    name = "LRU"
    __slots__ = ("_od",)

    def __init__(self, catalog_size: int, capacity: int, **kw):
        super().__init__(catalog_size, capacity)
        self._od: "OrderedDict[int, None]" = OrderedDict()

    def contains(self, i: int) -> bool:
        return i in self._od

    def occupancy(self) -> int:
        return len(self._od)

    def request(self, i: int) -> bool:
        hit = i in self._od
        if hit:
            self._od.move_to_end(i)
        else:
            if len(self._od) >= self.C:
                self._od.popitem(last=False)
            self._od[i] = None
        return self._account(hit)


def _load_ogb(catalog_size, capacity, **kw):
    from .ogb import OGB

    return OGB(catalog_size, capacity, **kw)


POLICY_REGISTRY = {
    "lru": LRU,
    "ogb": _load_ogb,
}


def make_policy(kind: str, catalog_size: int, capacity: int, **kw):
    kind = kind.lower()
    if kind not in POLICY_REGISTRY:
        raise ValueError(f"unknown policy {kind!r}; registered: {sorted(POLICY_REGISTRY)}")
    return POLICY_REGISTRY[kind](catalog_size, capacity, **kw)
