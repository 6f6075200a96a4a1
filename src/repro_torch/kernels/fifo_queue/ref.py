"""Plain version of the FIFO queue: a chunk of requests, at any capacity.

Counterpart of the reference's ``_fifo_step`` (``repro.cachesim.engines``),
which scans a chunk with ``lax.scan``: a request's item is found among the
slots (a hit changes nothing: FIFO never refreshes), and a miss writes the
item and the clock into the slot of ``argmin(stamps)``, the first index
among equal stamps.  Empty slots (-1) carry stamp -1, inactive ones (-2,
capacity padding) INT32_MAX, and a written slot takes the clock t, above
every stamp before it.

So a miss only ever takes the head of the active slots ordered by (stamp,
index), the empty ones first, and moves it to the tail: the victims walk
that order round and round.  A run derives, once, the state that makes a
request O(1) (:func:`derive_queue`): the order (``order``, the active slots
by (stamp, index)), the position of its head (``head``), an item -> slot map
(``imap``, -1 where the item is not held) and the slots that hold an item
(``occ``).  A chunk then is, per request: ``imap[j] >= 0`` is a hit; a miss
takes ``v = order[head]``, drops the item it held from ``imap``, writes j
and the clock into slot v, and advances ``head`` by one, modulo the active
slots.  The carry's ``slots``, ``stamps`` and ``t`` are the reference's,
bit for bit, after every chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

I32_MAX = 2**31 - 1


class FIFOQueue(NamedTuple):
    """What a run derives from a FIFO carry, on the carry's device."""

    order: torch.Tensor  # (A,) int32 the active slots by (stamp, index)
    head: torch.Tensor  # () int32 position in ``order`` of the next victim
    imap: torch.Tensor  # (M,) int32 item -> slot (-1 where not held), M > every id
    occ: torch.Tensor  # () int32 slots that hold an item


def derive_queue(slots: torch.Tensor, stamps: torch.Tensor, id_bound: int) -> FIFOQueue:
    """The queue of a FIFO carry, on its device, for items in [0, id_bound)
    (raised to cover the items the slots hold, which it reads)."""
    dev = slots.device
    active = torch.nonzero(slots != -2).reshape(-1)
    if active.numel() == 0:
        raise ValueError("a FIFO carry needs at least one active slot")
    # a stable sort by stamp keeps the index order among equal stamps
    by_stamp = torch.argsort(stamps.index_select(0, active).to(torch.int64), stable=True)
    order = active.index_select(0, by_stamp).to(torch.int32)
    held = torch.nonzero(slots >= 0).reshape(-1)
    items = slots.index_select(0, held).to(torch.int64)
    bound = max(int(id_bound), int(items.max()) + 1 if items.numel() else 0)
    imap = torch.full((bound,), -1, dtype=torch.int32, device=dev)
    imap.index_put_((items,), held.to(torch.int32))
    return FIFOQueue(order=order, head=torch.zeros((), dtype=torch.int32, device=dev),
                     imap=imap,
                     occ=torch.full((), held.numel(), dtype=torch.int32, device=dev))


def fifo_queue_ref(
    slots: torch.Tensor,
    stamps: torch.Tensor,
    t: torch.Tensor,
    queue: FIFOQueue,
    ids: torch.Tensor,
    flags: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk over int32 ``ids``, request by request on the host, every
    tensor updated in place (on whatever device it lies).

    Returns ``(hits, stats)``: the () int32 hit count and the (3,) float32
    (reward = hits, aux = 0, occupancy = slots holding an item); ``flags``,
    a (window,) bool tensor where given, gets each request's hit."""
    sl = slots.cpu().numpy().copy()
    st = stamps.cpu().numpy().copy()
    order = queue.order.cpu().numpy()
    im = queue.imap.cpu().numpy().copy()
    head, occ, t0 = int(queue.head), int(queue.occ), int(t)
    a = order.shape[0]
    hit_flags = np.zeros(ids.numel(), bool)
    for r, j in enumerate(ids.cpu().numpy().tolist()):
        if im[j] >= 0:
            hit_flags[r] = True
            continue
        v = order[head]
        head = head + 1 if head + 1 < a else 0
        old = sl[v]
        if old >= 0:
            im[old] = -1
        else:
            occ += 1
        im[j] = v
        sl[v] = j
        st[v] = t0 + r
    slots.copy_(torch.from_numpy(sl))
    stamps.copy_(torch.from_numpy(st))
    queue.imap.copy_(torch.from_numpy(im))
    queue.head.fill_(head)
    queue.occ.fill_(occ)
    t.fill_(t0 + ids.numel())
    n_hits = int(hit_flags.sum())
    if flags is not None:
        flags.copy_(torch.from_numpy(hit_flags))
    dev = slots.device
    return (torch.tensor(n_hits, dtype=torch.int32, device=dev),
            torch.tensor([n_hits, 0.0, occ], dtype=torch.float32, device=dev))
