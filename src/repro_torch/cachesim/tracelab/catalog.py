"""Streaming raw-id -> dense-id catalog remapping.

Raw logs carry sparse 64-bit ids (hashes, block addresses, anonymized
keys); the replay engines want a dense catalog ``0..N-1`` so policy state
is plain arrays.  :class:`CatalogRemap` performs that densification as a
streaming pass: ids are assigned in **first-seen order**, chunk by chunk,
so the mapping is a pure function of the request stream (and therefore
independent of how the stream is chunked).

Copied from ``repro.cachesim.tracelab.catalog`` (numpy only), with its errors
on a full catalog.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

#: table sentinels (dense ids are >= 0)
_UNSEEN = -2
_DROPPED = -1


class CatalogRemap:
    """Sparse raw ids -> dense ``0..N-1``, first-seen order, streaming.

    ``max_items`` bounds the dense catalog; once it is full, a raw id never
    seen before follows ``overflow``:

    * ``"raise"`` (default) — fail loudly; the caller sized the catalog.
    * ``"drop"``  — remove those requests from the stream (they can never
      be cache hits for an N-bounded policy anyway); ``dropped`` counts.
    * ``"clamp"`` — map them all onto the reserved last dense id
      ``max_items - 1`` (a shared "everything else" bucket; that id is
      never assigned to a real item).

    ``apply(chunk)`` remaps one chunk; ``remap(chunks)`` lifts it over an
    iterator.  ``len(remap)`` is the dense catalog size so far, and
    ``raw_ids[d]`` recovers the raw id behind dense id ``d``.

    Sized traces: ``apply(chunk, sizes=...)`` additionally records each
    item's size (bytes) the first time a sized request for it is seen, so
    the mapping stays a pure function of the request stream (chunking
    cannot change which size wins).  ``item_sizes`` densifies them to a
    ``(len(self),)`` array for the policy engines; ids never observed with
    a size (and the clamp bucket) read the unit default ``1.0``.
    """

    def __init__(
        self, max_items: Optional[int] = None, overflow: str = "raise"
    ):
        if overflow not in ("raise", "drop", "clamp"):
            raise ValueError(
                f"overflow must be 'raise'/'drop'/'clamp', got {overflow!r}"
            )
        if max_items is not None and max_items < (
            2 if overflow == "clamp" else 1
        ):
            raise ValueError(f"max_items too small: {max_items}")
        self.max_items = max_items
        self.overflow = overflow
        self.dropped = 0  # requests removed under overflow="drop"
        self.clamped = 0  # requests folded into the bucket under "clamp"
        self._table: Dict[int, int] = {}
        self._raw: List[int] = []  # dense -> raw, first-seen order
        self._sizes: Dict[int, float] = {}  # dense -> first-seen size
        #: reserved bucket id under "clamp" (assigned lazily on first spill)
        self._bucket: Optional[int] = None

    def __len__(self) -> int:
        n = len(self._raw)
        return n + (1 if self._bucket is not None else 0)

    @property
    def raw_ids(self) -> np.ndarray:
        """Raw id behind each dense id (the clamp bucket, if any, reads -1)."""
        out = np.asarray(self._raw, dtype=np.int64)
        if self._bucket is not None:
            out = np.concatenate([out, np.asarray([-1], np.int64)])
        return out

    def _capacity_left(self) -> bool:
        if self.max_items is None:
            return True
        cap = self.max_items - (1 if self.overflow == "clamp" else 0)
        return len(self._raw) < cap

    @property
    def item_sizes(self) -> np.ndarray:
        """Per-dense-id sizes (bytes), unit default for never-sized ids."""
        out = np.ones(len(self), np.float64)
        for d, s in self._sizes.items():
            out[d] = s
        return out

    def apply(
        self, chunk: np.ndarray, sizes: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Remap one chunk of raw ids to dense ids (possibly shorter under
        ``overflow="drop"``); ``sizes`` records per-item first-seen sizes."""
        chunk = np.asarray(chunk, dtype=np.int64)
        if chunk.ndim != 1:
            raise ValueError("CatalogRemap.apply expects a 1-D id chunk")
        if sizes is not None:
            sizes = np.asarray(sizes, np.float64)
            if sizes.shape != chunk.shape:
                raise ValueError(
                    f"sizes shape {sizes.shape} != chunk shape {chunk.shape}"
                )
        if chunk.size == 0:
            return chunk.copy()
        # per-chunk vectorization: resolve each distinct raw id once
        uniq, first_idx, inv = np.unique(
            chunk, return_index=True, return_inverse=True
        )
        vals = np.fromiter(
            (self._table.get(k, _UNSEEN) for k in uniq.tolist()),
            dtype=np.int64,
            count=len(uniq),
        )
        new = np.flatnonzero(vals == _UNSEEN)
        if new.size:
            # assign dense ids in order of first appearance *in the stream*
            for j in new[np.argsort(first_idx[new], kind="stable")]:
                raw = int(uniq[j])
                if self._capacity_left():
                    dense = len(self._raw)
                    self._raw.append(raw)
                    self._table[raw] = dense
                elif self.overflow == "raise":
                    raise ValueError(
                        f"catalog overflow: {raw} is the "
                        f"{len(self._raw) + 1}-th distinct id but "
                        f"max_items={self.max_items}"
                    )
                elif self.overflow == "drop":
                    # NOT recorded in the table: once the catalog is full
                    # every unseen id drops, and remembering each one would
                    # make memory O(distinct raw ids) — unbounded on hashed
                    # out-of-core streams, the exact case drop exists for
                    dense = _DROPPED
                else:  # clamp — same reasoning, the bucket is a constant
                    if self._bucket is None:
                        self._bucket = self.max_items - 1
                    dense = self._bucket
                vals[j] = dense
        if sizes is not None:
            # first-seen-size rule, in stream order (first_idx), skipping
            # dropped requests and the shared clamp bucket
            for j in np.argsort(first_idx, kind="stable"):
                d = int(vals[j])
                if d >= 0 and d != self._bucket and d not in self._sizes:
                    self._sizes[d] = float(sizes[first_idx[j]])
        mapped = vals[inv]
        if self.overflow == "drop":
            keep = mapped >= 0
            self.dropped += int(chunk.size - keep.sum())
            mapped = mapped[keep]
        elif self._bucket is not None:
            self.clamped += int(np.sum(mapped == self._bucket))
        return mapped

    def remap(self, chunks: Iterable) -> Iterator[np.ndarray]:
        """Lift :meth:`apply` over a chunk iterator (skips emptied chunks).

        Accepts plain id chunks or the ``(ids, sizes)`` pairs yielded by
        ``open_trace(..., with_sizes=True)`` — sizes are recorded into
        :attr:`item_sizes` and the densified id chunks are yielded."""
        for chunk in chunks:
            if isinstance(chunk, tuple):
                out = self.apply(chunk[0], sizes=chunk[1])
            else:
                out = self.apply(chunk)
            if out.size:
                yield out


def remap_trace(trace: np.ndarray, **kw) -> np.ndarray:
    """One-shot convenience: densify a whole in-memory trace."""
    return CatalogRemap(**kw).apply(np.asarray(trace))
