"""Plain PyTorch version of the tree LRU's chunk: LRU by reuse distance.

Counterpart of ``repro.cachesim.tree_engines.make_lru_tree_chunk``, which
the reference scans with ``lax.scan`` (no Pallas kernel).  Its carry is a
ring of request positions: ``last[j]`` is the position of item j's last
request (-1 never seen, or dropped by a compaction; index N is scratch and
stays -1), ``tree`` a radix-16 int32 count tree over the ring's ``m``
positions with a mark at each ``last``, ``pos`` the next free position,
``nseen`` the requests that found no mark and ``cap`` the capacity.  A
request hits iff its previous request lies within the reuse distance
``cap - 1``: at most ``cap - 1`` distinct items requested in between.

After a chunk the carry does not depend on how the reference blocks it
(its sub-chunks and delayed writes): each request takes the next position,
and the marks sit at each item's last one.  So this version computes the
hits as LRU itself, one request at a time in an ``OrderedDict`` of the
``cap`` newest marks (the items an LRU cache holds), and moves each
distinct item's mark once with one int32 tree update.  A **ring
compaction** runs first when ``pos + window > m``, as the reference's
``lax.cond`` decides: the newest ``min(marks, cap)`` marks keep their order
at positions 0, 1, ... (a mark's rank is the count of marks up to it), the
rest are dropped (-1), the tree is rebuilt over the kept prefix and ``pos``
restarts at the kept count rounded up to 16.  Dropping is exact: a reuse
window reaching past the kept marks holds at least ``cap`` distinct items.

It reads the carry on the host, so on the card it is the yardstick of
correctness, not of speed; :func:`repro_torch.kernels.tree_lru.ops.tree_lru`
runs it on a CPU tensor.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.prefix_tree.ref import tree_build_ref, tree_update_ref

#: radix of the ring's count tree
RING_RADIX = 16


def max_window(m: int) -> int:
    """The longest chunk a ring of ``m`` positions takes: after a compaction
    ``pos`` is at most m/4 + 16, and the chunk must fit behind it."""
    return 3 * (m // 4) - RING_RADIX


def check_window(window: int, m: int) -> None:
    if window > max_window(m):
        raise ValueError(
            f"window {window} too large for ring {m}; pass a larger ring= to init "
            f"(need window <= 3*ring/4 - {RING_RADIX})"
        )


def compact_ref(tree: torch.Tensor, last: torch.Tensor, pos: torch.Tensor,
                cap: torch.Tensor, m: int) -> None:
    """Keep the newest ``min(marks, cap)`` marks, rank-remapped to 0, 1, ...;
    rebuild the tree over them and restart ``pos``, in place."""
    marked = last >= 0
    at = last[marked].long()
    nmarks = int(at.numel())
    kept = min(nmarks, int(cap))
    leaf = torch.zeros(m, dtype=torch.int64, device=last.device)
    leaf[at] = 1
    rank = leaf.cumsum(0)[at] - 1 - (nmarks - kept)
    last[marked] = torch.where(rank >= 0, rank, -1).to(last.dtype)
    ones = (torch.arange(m, device=tree.device) < kept).to(torch.int32)
    tree.copy_(tree_build_ref(ones, RING_RADIX))
    pos.fill_((kept + RING_RADIX - 1) & ~(RING_RADIX - 1))


def tree_lru_ref(tree: torch.Tensor, last: torch.Tensor, pos: torch.Tensor,
                 nseen: torch.Tensor, cap: torch.Tensor, ids: torch.Tensor, m: int,
                 flags: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the tree LRU over int32 ``ids``, the carry in place.

    Returns ``(hits, stats)``: the () int32 hit count and the (3,) float32
    (reward = hits, aux = 0, occupancy = min(nseen, cap)); ``flags``, where
    given, a (window,) bool tensor, gets each request's hit."""
    window = ids.numel()
    check_window(window, m)
    if int(pos) + window > m:
        compact_ref(tree, last, pos, cap, m)
    p0, c = int(pos), int(cap)
    host = last.cpu()
    lnp = host.numpy()
    req = ids.cpu().numpy().astype(np.int64)

    # the LRU cache at the chunk's start: the newest min(marks, cap) marks
    held = np.flatnonzero(lnp >= 0)
    newest = held[np.argsort(lnp[held], kind="stable")][max(held.size - c, 0):]
    cache = OrderedDict.fromkeys(newest.tolist())
    hit = np.zeros(window, dtype=bool)
    for i, j in enumerate(req.tolist()):
        if j in cache:
            hit[i] = True
            cache.move_to_end(j)
        else:
            cache[j] = None
            if len(cache) > c:
                cache.popitem(last=False)

    # each distinct item's mark moves once: off its last position before
    # the chunk (where it had one), onto its last request in the chunk
    items, first = np.unique(req, return_index=True)
    _, from_end = np.unique(req[::-1], return_index=True)
    before = lnp[items]
    moved = before >= 0
    newpos = p0 + (window - 1 - from_end)
    idx = np.concatenate([before[moved], newpos]).astype(np.int64)
    delta = np.concatenate([np.full(int(moved.sum()), -1), np.ones(items.size)]).astype(np.int32)
    lnp[items] = newpos
    if host is not last:
        last.copy_(host)
    dev = tree.device
    tree_update_ref(tree, m, RING_RADIX, torch.from_numpy(idx).to(dev),
                    torch.from_numpy(delta).to(dev))
    pos.fill_(p0 + window)
    nseen.add_(int((~moved).sum()))
    n_hits = int(hit.sum())
    if flags is not None:
        flags.copy_(torch.from_numpy(hit))
    occ = min(int(nseen), c)
    return (torch.tensor(n_hits, dtype=torch.int32, device=dev),
            torch.tensor([n_hits, 0.0, occ], dtype=torch.float32, device=dev))
