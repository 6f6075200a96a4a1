"""Order-statistic balanced BST (treap) — the O(log N) ordered multiset of the paper.

A copy of ``repro.core.treap`` for the port's host OGB policy.

The paper's Algorithms 2 and 3 each rely on an ordered data structure over float
keys ("z", the positive unadjusted coefficients, and "d", the cached-item
differences).  The operations needed are:

  * insert(key, item)            O(log N)
  * remove(key, item)            O(log N)
  * min() / pop_min()            O(log N)
  * __len__                      O(1)

We provide two interchangeable implementations:

  * :class:`Treap` — a from-scratch randomized treap.  This is the artifact that
    substantiates the paper's O(log N) claim without leaning on library code.
  * :class:`SortedKeyStore` — backed by ``sortedcontainers.SortedList`` (a
    fan-out list with O(log N) amortized ops and far better constants).  Used as
    the default engine for large-trace benchmarks.

Both store (key: float, item: hashable) pairs, ordered by (key, tiebreak), and
both are exercised by the same test suite.
"""

from __future__ import annotations

import random
from typing import Any, Iterator, Optional, Tuple

try:  # pragma: no cover - import guard
    from sortedcontainers import SortedList

    _HAVE_SORTEDCONTAINERS = True
except ImportError:  # pragma: no cover
    _HAVE_SORTEDCONTAINERS = False

    import bisect

    class SortedList:  # type: ignore[no-redef]
        """Minimal bisect-backed fallback with SortedList's used surface.

        O(n) insertion/removal (list shifting) — correct but slow; production
        runs should prefer the treap engine (``make_store`` already falls back
        to it) or install sortedcontainers.
        """

        __slots__ = ("_l",)

        def __init__(self):
            self._l = []

        def __len__(self):
            return len(self._l)

        def __getitem__(self, i):
            return self._l[i]

        def __iter__(self):
            return iter(self._l)

        def add(self, v):
            bisect.insort(self._l, v)

        def remove(self, v):
            i = bisect.bisect_left(self._l, v)
            if i == len(self._l) or self._l[i] != v:
                raise ValueError(f"{v!r} not in list")
            del self._l[i]

        def pop(self, i=-1):
            return self._l.pop(i)

        def bisect_left(self, v):
            return bisect.bisect_left(self._l, v)


class _Node:
    __slots__ = ("key", "item", "prio", "left", "right", "size")

    def __init__(self, key: float, item: Any, prio: float):
        self.key = key
        self.item = item
        self.prio = prio
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None
        self.size = 1


def _size(n: Optional[_Node]) -> int:
    return n.size if n is not None else 0


def _pull(n: _Node) -> None:
    n.size = 1 + _size(n.left) + _size(n.right)


class Treap:
    """Randomized treap keyed by ``(key, id(item-slot))`` with subtree sizes.

    Duplicate keys are allowed; ties are broken arbitrarily but deterministically
    per (key, item) pair so ``remove`` can find the exact entry.
    """

    __slots__ = ("_root", "_rng")

    def __init__(self, seed: int = 0):
        self._root: Optional[_Node] = None
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return _size(self._root)

    # -- internal rotations ------------------------------------------------
    @staticmethod
    def _cmp(key_a: float, item_a: Any, key_b: float, item_b: Any) -> int:
        if key_a < key_b:
            return -1
        if key_a > key_b:
            return 1
        ha, hb = hash(item_a), hash(item_b)
        if ha < hb:
            return -1
        if ha > hb:
            return 1
        return 0

    def _merge(self, a: Optional[_Node], b: Optional[_Node]) -> Optional[_Node]:
        # every key in a <= every key in b
        if a is None:
            return b
        if b is None:
            return a
        if a.prio < b.prio:
            a.right = self._merge(a.right, b)
            _pull(a)
            return a
        b.left = self._merge(a, b.left)
        _pull(b)
        return b

    def _split(self, n: Optional[_Node], key: float, item: Any):
        """Split into (< (key,item), >= (key,item))."""
        if n is None:
            return None, None
        if self._cmp(n.key, n.item, key, item) < 0:
            l, r = self._split(n.right, key, item)
            n.right = l
            _pull(n)
            return n, r
        l, r = self._split(n.left, key, item)
        n.left = r
        _pull(n)
        return l, n

    # -- public API --------------------------------------------------------
    def insert(self, key: float, item: Any) -> None:
        node = _Node(key, item, self._rng.random())
        l, r = self._split(self._root, key, item)
        self._root = self._merge(self._merge(l, node), r)

    def remove(self, key: float, item: Any) -> bool:
        """Remove one entry equal to (key, item). Returns True if found."""

        def _rm(n: Optional[_Node]) -> Tuple[Optional[_Node], bool]:
            if n is None:
                return None, False
            c = self._cmp(key, item, n.key, n.item)
            if c == 0 and n.item == item:
                return self._merge(n.left, n.right), True
            if c < 0:
                n.left, ok = _rm(n.left)
            else:
                n.right, ok = _rm(n.right)
            if not ok and c == 0:
                # hash tie with a different item: probe the other side too
                n.right, ok = _rm(n.right)
            _pull(n)
            return n, ok

        self._root, ok = _rm(self._root)
        return ok

    def min(self) -> Tuple[float, Any]:
        n = self._root
        if n is None:
            raise IndexError("min of empty treap")
        while n.left is not None:
            n = n.left
        return n.key, n.item

    def pop_min(self) -> Tuple[float, Any]:
        if self._root is None:
            raise IndexError("pop_min of empty treap")

        def _pop(n: _Node) -> Tuple[Optional[_Node], Tuple[float, Any]]:
            if n.left is None:
                return n.right, (n.key, n.item)
            n.left, kv = _pop(n.left)
            _pull(n)
            return n, kv

        self._root, kv = _pop(self._root)
        return kv

    def count_below(self, key: float) -> int:
        """Number of entries with entry.key < key (strict)."""
        n, acc = self._root, 0
        while n is not None:
            if n.key < key:
                acc += 1 + _size(n.left)
                n = n.right
            else:
                n = n.left
        return acc

    def __iter__(self) -> Iterator[Tuple[float, Any]]:
        def _walk(n):
            if n is None:
                return
            yield from _walk(n.left)
            yield (n.key, n.item)
            yield from _walk(n.right)

        yield from _walk(self._root)


class SortedKeyStore:
    """sortedcontainers-backed drop-in with the same API as :class:`Treap`."""

    __slots__ = ("_sl",)

    def __init__(self, seed: int = 0):  # seed ignored; signature parity
        self._sl = SortedList()

    def __len__(self) -> int:
        return len(self._sl)

    def insert(self, key: float, item: Any) -> None:
        self._sl.add((key, item))

    def remove(self, key: float, item: Any) -> bool:
        try:
            self._sl.remove((key, item))
            return True
        except ValueError:
            return False

    def min(self) -> Tuple[float, Any]:
        if not self._sl:
            raise IndexError("min of empty store")
        return self._sl[0]

    def pop_min(self) -> Tuple[float, Any]:
        if not self._sl:
            raise IndexError("pop_min of empty store")
        return self._sl.pop(0)

    def count_below(self, key: float) -> int:
        return self._sl.bisect_left((key, -1 << 62))

    def __iter__(self) -> Iterator[Tuple[float, Any]]:
        return iter(self._sl)


def make_store(kind: str = "sorted", seed: int = 0):
    """Factory: ``kind in {"treap", "sorted"}``."""
    if kind == "treap":
        return Treap(seed=seed)
    if kind == "sorted":
        if _HAVE_SORTEDCONTAINERS:
            return SortedKeyStore(seed=seed)
        return Treap(seed=seed)
    raise ValueError(f"unknown ordered-store kind: {kind!r}")
