"""Host caching policies, copied from ``repro.core.policies``.

LRU, FIFO, LFU, GreedyDual-Size (Cao & Irani 1997) and ARC (Megiddo &
Modha 2003), and the paper's OGB and FTPL by lazy loaders.  Each exposes the simulator interface ``request(i) -> hit``,
``contains(i)``, ``occupancy()`` and ``batch_end()``.  The serving path's page
pool decides with OGB or LRU; ARC is the scenario harness's host oracle
(:func:`repro_torch.cachesim.simulator.simulate`); LRU, FIFO, LFU and FTPL
are the oracles the tests hold the slot automata against, and GDS the
tree GDS's (``cachesim.tree_engines``).  ``ogb_cl`` and ``omd_cl`` are the
classic eager baselines (:class:`~.ogb_classic.OGBClassic`,
:class:`~.omd.OMDClassic`), float64 numpy oracles.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np

from .treap import make_store


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


class FIFO(_Base):
    name = "FIFO"
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
        if not hit:
            if len(self._od) >= self.C:
                self._od.popitem(last=False)
            self._od[i] = None
        return self._account(hit)


class LFU(_Base):
    """In-cache LFU with LRU tie-break (perfect-LFU counters kept for all items)."""

    name = "LFU"
    __slots__ = ("_freq", "_cached", "_order", "_tick")

    def __init__(self, catalog_size: int, capacity: int, **kw):
        super().__init__(catalog_size, capacity)
        self._freq: Dict[int, int] = {}
        self._cached: Dict[int, tuple] = {}  # item -> (freq, tick) key in order
        self._order = make_store("sorted")
        self._tick = 0

    def contains(self, i: int) -> bool:
        return i in self._cached

    def occupancy(self) -> int:
        return len(self._cached)

    def request(self, i: int) -> bool:
        self._tick += 1
        f = self._freq.get(i, 0) + 1
        self._freq[i] = f
        hit = i in self._cached
        if hit:
            old = self._cached[i]
            self._order.remove(old, i)
            key = (f, self._tick)
            self._order.insert(key, i)
            self._cached[i] = key
        else:
            if len(self._cached) >= self.C:
                # evict min (freq, tick): least frequent, oldest among ties
                mk, mi = self._order.min()
                # admit only if the newcomer's frequency beats the victim's
                if f >= mk[0]:
                    self._order.pop_min()
                    del self._cached[mi]
                    key = (f, self._tick)
                    self._order.insert(key, i)
                    self._cached[i] = key
            else:
                key = (f, self._tick)
                self._order.insert(key, i)
                self._cached[i] = key
        return self._account(hit)


class GDS(_Base):
    """Greedy-Dual-Size: H_i = L + cost_i / size_i, the least H evicted and
    L raised to it.  Unit sizes and costs make it LRU with aging; per-item
    ``sizes``/``costs`` arrays give the heterogeneous setting.  This is the
    host oracle the tree GDS is held against, so equal H break by the
    sorted store's smallest item id, as on the device's min-pair tree."""

    name = "GDS"
    __slots__ = ("_L", "_cost", "_prio", "_h", "_order")

    def __init__(self, catalog_size: int, capacity: int, cost: float = 1.0, sizes=None,
                 costs=None, **kw):
        super().__init__(catalog_size, capacity)
        self._L = 0.0
        n = int(catalog_size)
        s = np.ones(n) if sizes is None else np.asarray(sizes, np.float64)
        w = np.full(n, float(cost)) if costs is None else np.asarray(costs, np.float64)
        if s.shape != (n,) or w.shape != (n,):
            raise ValueError(f"sizes/costs must be ({n},) arrays")
        if not (np.all(np.isfinite(s)) and float(s.min()) > 0.0):
            raise ValueError("GDS sizes must be finite and > 0")
        if not (np.all(np.isfinite(w)) and float(w.min()) > 0.0):
            raise ValueError("GDS costs must be finite and > 0")
        self._cost = cost
        self._prio = w / s
        self._h: Dict[int, float] = {}
        self._order = make_store("sorted")

    def contains(self, i: int) -> bool:
        return i in self._h

    def occupancy(self) -> int:
        return len(self._h)

    def request(self, i: int) -> bool:
        hit = i in self._h
        if hit:
            self._order.remove(self._h[i], i)
        elif len(self._h) >= self.C:
            hmin, imin = self._order.pop_min()
            self._L = hmin
            del self._h[imin]
        h = self._L + float(self._prio[i])
        self._h[i] = h
        self._order.insert(h, i)
        return self._account(hit)


class ARC(_Base):
    """Adaptive Replacement Cache (Megiddo & Modha, FAST'03) — exact."""

    name = "ARC"
    __slots__ = ("p", "t1", "t2", "b1", "b2")

    def __init__(self, catalog_size: int, capacity: int, **kw):
        super().__init__(catalog_size, capacity)
        self.p = 0.0
        self.t1: "OrderedDict[int, None]" = OrderedDict()  # recent, seen once
        self.t2: "OrderedDict[int, None]" = OrderedDict()  # frequent
        self.b1: "OrderedDict[int, None]" = OrderedDict()  # ghost of t1
        self.b2: "OrderedDict[int, None]" = OrderedDict()  # ghost of t2

    def contains(self, i: int) -> bool:
        return i in self.t1 or i in self.t2

    def occupancy(self) -> int:
        return len(self.t1) + len(self.t2)

    def _replace(self, in_b2: bool) -> None:
        if self.t1 and (
            len(self.t1) > self.p or (in_b2 and len(self.t1) == int(self.p))
        ):
            old, _ = self.t1.popitem(last=False)
            self.b1[old] = None
        elif self.t2:
            old, _ = self.t2.popitem(last=False)
            self.b2[old] = None
        elif self.t1:
            old, _ = self.t1.popitem(last=False)
            self.b1[old] = None

    def request(self, i: int) -> bool:
        C = self.C
        if i in self.t1 or i in self.t2:  # case I: hit
            if i in self.t1:
                del self.t1[i]
            else:
                del self.t2[i]
            self.t2[i] = None
            return self._account(True)
        if i in self.b1:  # case II: ghost hit in b1
            self.p = min(float(C), self.p + max(len(self.b2) / max(len(self.b1), 1), 1.0))
            self._replace(False)
            del self.b1[i]
            self.t2[i] = None
            return self._account(False)
        if i in self.b2:  # case III: ghost hit in b2
            self.p = max(0.0, self.p - max(len(self.b1) / max(len(self.b2), 1), 1.0))
            self._replace(True)
            del self.b2[i]
            self.t2[i] = None
            return self._account(False)
        # case IV: full miss
        if len(self.t1) + len(self.b1) == C:
            if len(self.t1) < C:
                self.b1.popitem(last=False)
                self._replace(False)
            else:
                self.t1.popitem(last=False)
        elif len(self.t1) + len(self.b1) < C:
            total = len(self.t1) + len(self.t2) + len(self.b1) + len(self.b2)
            if total >= C:
                if total == 2 * C:
                    self.b2.popitem(last=False)
                self._replace(False)
        self.t1[i] = None
        return self._account(False)


def _load_ogb(catalog_size, capacity, **kw):
    from .ogb import OGB

    return OGB(catalog_size, capacity, **kw)


def _load_ogb_cl(catalog_size, capacity, **kw):
    from .ogb_classic import OGBClassic

    return OGBClassic(catalog_size, capacity, **kw)


def _load_ftpl(catalog_size, capacity, **kw):
    from .ftpl import FTPL

    return FTPL(catalog_size, capacity, **kw)


def _load_omd_cl(catalog_size, capacity, **kw):
    from .omd import OMDClassic

    return OMDClassic(catalog_size, capacity, **kw)


#: the host policy registry: callables ``(catalog_size, capacity, **kw) ->
#: policy``; the gradient and perturbed policies are lazy loaders
POLICY_REGISTRY = {
    "lru": LRU,
    "fifo": FIFO,
    "lfu": LFU,
    "gds": GDS,
    "arc": ARC,
    "ogb": _load_ogb,
    "ogb_cl": _load_ogb_cl,
    "ftpl": _load_ftpl,
    "omd_cl": _load_omd_cl,
}


def policy_kinds() -> tuple:
    """All registered kind strings (host-side per-request policies)."""
    return tuple(POLICY_REGISTRY)


def make_policy(kind: str, catalog_size: int, capacity: int, **kw):
    kind = kind.lower()
    if kind not in POLICY_REGISTRY:
        raise ValueError(f"unknown policy {kind!r}; registered: {sorted(POLICY_REGISTRY)}")
    return POLICY_REGISTRY[kind](catalog_size, capacity, **kw)
