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
by (stamp, index)), the position of its head (``head``), each item's
admission ticket (``imap``), the slots that hold an item (``occ``) and the
misses since the queue was derived (``misses``).

Admission tickets.  Number the misses after the derivation 0, 1, 2, ...:
the g-th takes ``order[g mod A]`` (A the active slots), so the item it
admits is evicted by miss g + A.  An item's ticket is the number of the
miss that admitted it; an item held at the derivation, at position p of
the order, gets p - A (miss p evicts it), and an item not held
TICKET_NONE, below every ticket.  After M misses item j is held iff
``M - A <= imap[j]``.  A chunk then is, per request: that test; a hit
changes nothing; a miss takes ``v = order[head]``, writes j and the clock
into slot v and M into ``imap[j]``, and advances ``head`` (M mod A) and M.
Nothing of the evicted item is read or written: its ticket falls behind by
itself.  The empty slots come first in the order (stamp -1, below every
written stamp), so the occupancy is ``min(A, occ + misses)``.

Tickets and M are int32, and M grows by at most one a request: a queue
serves MAX_REQUESTS requests after its derivation (a run derives it anew
and raises for a longer trace).  The carry's ``slots``, ``stamps`` and
``t`` are the reference's, bit for bit, after every chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

I32_MAX = 2**31 - 1
#: the ticket of an item not held: below every ticket (M - A >= -A)
TICKET_NONE = -2**31
#: requests a queue serves after its derivation before M could overflow
MAX_REQUESTS = I32_MAX


class FIFOQueue(NamedTuple):
    """What a run derives from a FIFO carry, on the carry's device."""

    order: torch.Tensor  # (A,) int32 the active slots by (stamp, index)
    head: torch.Tensor  # () int32 position in ``order`` of the next victim: misses mod A
    imap: torch.Tensor  # (M,) int32 item -> admission ticket, M > every id
    occ: torch.Tensor  # () int32 slots that hold an item
    misses: torch.Tensor  # () int32 misses since the derivation


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
    a = order.numel()
    at = torch.nonzero(slots.index_select(0, order) >= 0).reshape(-1)  # held, by position
    items = slots.index_select(0, order.index_select(0, at)).to(torch.int64)
    bound = int(id_bound)
    if at.numel():
        top, first = torch.stack([items.max(), at[0]]).tolist()
        if first != a - at.numel():
            raise ValueError("a FIFO carry's empty slots must come first in its order (an "
                             "empty slot's stamp -1 below every held slot's)")
        bound = max(bound, top + 1)
    imap = torch.full((bound,), TICKET_NONE, dtype=torch.int32, device=dev)
    imap.index_put_((items,), (at - a).to(torch.int32))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return FIFOQueue(order=order, head=zero, imap=imap,
                     occ=torch.full((), at.numel(), dtype=torch.int32, device=dev),
                     misses=zero.clone())


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
    head, occ, m0, t0 = int(queue.head), int(queue.occ), int(queue.misses), int(t)
    a = order.shape[0]
    m = m0
    hit_flags = np.zeros(ids.numel(), bool)
    for r, j in enumerate(ids.cpu().numpy().tolist()):
        if m - a <= im[j]:
            hit_flags[r] = True
            continue
        v = order[head]
        head = head + 1 if head + 1 < a else 0
        im[j] = m
        sl[v] = j
        st[v] = t0 + r
        m += 1
    occ = min(a, occ + m - m0)
    slots.copy_(torch.from_numpy(sl))
    stamps.copy_(torch.from_numpy(st))
    queue.imap.copy_(torch.from_numpy(im))
    queue.head.fill_(head)
    queue.occ.fill_(occ)
    queue.misses.fill_(m)
    t.fill_(t0 + ids.numel())
    n_hits = int(hit_flags.sum())
    if flags is not None:
        flags.copy_(torch.from_numpy(hit_flags))
    dev = slots.device
    return (torch.tensor(n_hits, dtype=torch.int32, device=dev),
            torch.tensor([n_hits, 0.0, occ], dtype=torch.float32, device=dev))


def fifo_queue_rows_ref(slots: torch.Tensor, stamps: torch.Tensor, t: torch.Tensor,
                        queue: FIFOQueue, ids: torch.Tensor, flags: Optional[torch.Tensor],
                        active: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fifo_queue_ref` over a grid's rows, one row at a time: the
    carry and the queue stacked a row a combo (combo r's first ``active[r]``
    entries of ``order`` its order), ``ids`` one (window,) chunk for every
    row (a sweep) or (R, window), a row of ids each (a fleet's tenants);
    ``flags`` (R, window).  Returns hits (R,) and stats (R, 3)."""
    outs = [fifo_queue_ref(slots[r], stamps[r], t[r],
                           FIFOQueue(queue.order[r, :active[r]], queue.head[r], queue.imap[r],
                                     queue.occ[r], queue.misses[r]),
                           ids[r] if ids.dim() == 2 else ids,
                           flags[r] if flags is not None else None)
            for r in range(slots.shape[0])]
    return torch.stack([h for h, _ in outs]), torch.stack([st for _, st in outs])
