"""Plain PyTorch version of the slot automata: LRU, FIFO, LFU and FTPL.

Counterparts of ``repro.cachesim.engines``' per-request steps
(``_lru_step``, ``_fifo_step``, ``_lfu_step``, ``_ftpl_step``), which the
reference scans over a chunk with ``lax.scan``.  Each step here does what
the reference's does, op for op, and updates the carry's tensors in place;
:func:`slot_automaton_ref` runs a chunk of them, one request at a time, and
is what :func:`repro_torch.kernels.slot_automaton.ops.slot_automaton` runs
on a CPU tensor.  On the card ``chip_smoke.py`` and the ``cuda`` tests hold
``csrc/slot_automaton.cu`` against it.

The rules the reference relies on, and the kernel with it:

* ties go to the first slot index (``argmin``/``argmax`` take the first);
  empty slots (id -1) fill lowest index first;
* LRU and FIFO: a match outranks every stamp; FIFO never refreshes a stamp;
* LFU: the count is incremented before it is read; the victim is the least
  frequency, then the least tick; empty slots rank at frequency -1 and
  inactive ones (id -2) at INT32_MAX; admission is ``hit or f >= minf``;
* FTPL: a score is ``float32(count) + noise`` (one float32 add); the
  victim among equal least scores is the smallest item id; a swap needs
  ``s > mins``;
* inactive slots (padding to ``n_slots`` > C: id -2, stamp INT32_MAX) are
  never matched and never evicted into.

The chunk runs as the kernel runs it: each request's count (LFU, FTPL)
is found for the whole chunk first (the count before the chunk plus the
request's rank among its equal ids), and each slot's eviction key is kept
beside it (LRU, FIFO: the stamp; LFU: frequency and tick as one int64;
FTPL: the float32 score), changed only where a step writes.  A step finds
the requested item's slot through a host map of the slots (the slots hold
distinct items, so this is the reference's ``slots == j``) and the victim by
a PyTorch ``argmin`` over the keys; it reads back the index it writes, one
device read a step on the card: the plain version is the yardstick of
correctness, not of speed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)
#: automaton kinds, in the order of the kernel's ``kind`` argument
KINDS = ("lru", "fifo", "lfu", "ftpl")


#: the LFU key of a slot is freq * 2^32 + (tick + 2^31): (freq, tick) in
#: lexicographic order, in int64 for freq in [-1, 2^31) and any int32 tick
_TICK_BIAS, _FREQ_SCALE = 2**31, 2**32
#: the key that a matching slot takes, below every real key
_MATCH_KEY = -(2**62)


def _lfu_key(freq: int, tick: int) -> int:
    return freq * _FREQ_SCALE + tick + _TICK_BIAS


class _Slots:
    """A chunk's view of the slot arrays: the tensors, updated in place,
    and host copies of the slot ids and a map item -> slot."""

    def __init__(self, slots: torch.Tensor):
        self.slots = slots
        self.ids = slots.tolist()
        self.where = {s: k for k, s in enumerate(self.ids) if s >= 0}

    def put(self, k: int, j: int) -> None:
        self.where.pop(self.ids[k], None)
        self.ids[k] = j
        self.where[j] = k
        self.slots[k] = j


def _lru_step(sl: _Slots, stamps: torch.Tensor, j: int, t: int) -> bool:
    # a matching slot outranks every stamp (the reference's argmin over
    # where(match, INT32_MIN, stamps)); else the oldest or first empty slot
    k = sl.where.get(j)
    hit = k is not None
    if not hit:
        k = int(torch.argmin(stamps))
        sl.put(k, j)
    stamps[k] = t  # refresh on a hit == LRU
    return hit


def _fifo_step(sl: _Slots, stamps: torch.Tensor, j: int, t: int) -> bool:
    if j in sl.where:  # FIFO never refreshes: on a hit both writes are no-ops
        return True
    k = int(torch.argmin(stamps))
    sl.put(k, j)
    stamps[k] = t
    return False


def _lfu_step(sl: _Slots, keys: torch.Tensor, j: int, f: int, t: int) -> bool:
    """``f`` is j's count after this request's increment; ``keys`` the
    slots' (freq, tick) keys (empty: freq -1, inactive: INT32_MAX)."""
    k = sl.where.get(j)
    if k is not None:
        keys[k] = _lfu_key(f, t)
        return True
    k = int(torch.argmin(keys))  # least frequency, then least tick, then index
    minf = int(keys[k]) // _FREQ_SCALE
    if f >= minf:  # admission: the newcomer must match the victim's frequency
        sl.put(k, j)
        keys[k] = _lfu_key(f, t)
    return False


def _ftpl_step(sl: _Slots, scores: torch.Tensor, j: int, s: torch.Tensor) -> bool:
    """``s`` is j's float32 score after this request's count; ``scores``
    the slots' scores (inactive: +inf)."""
    k = sl.where.get(j)
    if k is not None:
        scores[k] = s
        return True
    mins = scores.min()
    if bool(s > mins):  # strict >, as the host policy
        # ties break by item id, as the host policy's (score, item) store does
        k = int(torch.argmin(torch.where(scores == mins, sl.slots, I32_MAX)))
        sl.put(k, j)
        scores[k] = s
    return False


def request_counts(counts: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each request's count after its own increment: the count before the
    chunk plus the request's rank among the equal ids up to it (int32)."""
    ids64 = ids.long()
    order = torch.argsort(ids64, stable=True)
    sid = ids64[order]
    pos = torch.arange(sid.numel(), device=ids.device)
    head = torch.ones_like(sid, dtype=torch.bool)
    head[1:] = sid[1:] != sid[:-1]
    first = torch.cummax(torch.where(head, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - first
    return (counts[ids64].long() + rank + 1).to(torch.int32)


def slot_automaton_ref(
    kind: str,
    slots: torch.Tensor,
    keys: Optional[torch.Tensor],
    counts: Optional[torch.Tensor],
    noise: Optional[torch.Tensor],
    t: Optional[torch.Tensor],
    ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of automaton ``kind``, request by request, in place.

    ``slots`` (K,) int32; ``keys`` the (K,) int32 stamps (lru, fifo) or
    ticks (lfu); ``counts`` (N,) int32 (lfu, ftpl); ``noise`` (N,) float32
    (ftpl); ``t`` the () int32 request clock (lru, fifo, lfu), advanced by
    the chunk's length.  Returns ``(hits, stats)``: the chunk's () int32 hit
    count and a (3,) float32 tensor (reward = hits, aux = 0, occupancy =
    slots holding an item)."""
    if kind not in KINDS:
        raise ValueError(f"unknown automaton kind {kind!r} (have {KINDS})")
    t0 = int(t) if t is not None else 0
    sl = _Slots(slots)
    hits = 0
    if kind in ("lru", "fifo"):
        step = _lru_step if kind == "lru" else _fifo_step
        for r, j in enumerate(ids.tolist()):
            hits += step(sl, keys, j, t0 + r)
    else:
        f = request_counts(counts, ids)
        held = slots >= 0
        item = torch.clamp(slots, min=0).long()
        if kind == "lfu":
            freq = torch.where(held, counts[item], torch.where(slots == -1, -1, I32_MAX))
            lk = freq.long() * _FREQ_SCALE + keys.long() + _TICK_BIAS
            for r, (j, fj) in enumerate(zip(ids.tolist(), f.tolist())):
                hits += _lfu_step(sl, lk, j, fj, t0 + r)
            keys.copy_((lk % _FREQ_SCALE - _TICK_BIAS).to(torch.int32))
        else:
            scores = torch.where(held, counts[item].to(torch.float32) + noise[item],
                                 float("inf"))
            s = f.to(torch.float32) + noise[ids.long()]
            for r, j in enumerate(ids.tolist()):
                hits += _ftpl_step(sl, scores, j, s[r])
        counts.index_add_(0, ids.long(), torch.ones_like(ids))
    if t is not None:
        t.fill_(t0 + ids.numel())
    occ = int((slots >= 0).sum())
    dev = slots.device
    return (torch.tensor(hits, dtype=torch.int32, device=dev),
            torch.tensor([hits, 0.0, occ], dtype=torch.float32, device=dev))
