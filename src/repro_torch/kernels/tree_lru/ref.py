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

from repro_torch.kernels.prefix_tree.ref import (
    tree_build_ref,
    tree_offsets,
    tree_sizes,
    tree_update_ref,
)

#: radix of the ring's count tree
RING_RADIX = 16
#: requests a sub-chunk of the kernel (a thread each)
SUBCHUNK = 256


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


def _prefix(tree: np.ndarray, offs, p: int) -> int:
    """Marks at positions [0, p]: at the leaves the group's children up to
    p, above each node's left siblings (the kernel's prefix count)."""
    acc = 0
    for lvl, off in enumerate(offs):
        node = p >> (4 * lvl)
        grp = node & ~(RING_RADIX - 1)
        last = node if lvl == 0 else node - 1
        acc += int(tree[off + grp:off + last + 1].sum())
    return acc


def tree_lru_blocked_ref(tree: torch.Tensor, last: torch.Tensor, pos: torch.Tensor,
                         nseen: torch.Tensor, cap: torch.Tensor, ids: torch.Tensor, m: int,
                         flags: Optional[torch.Tensor] = None,
                         sub: int = SUBCHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the tree LRU computed as the kernel does, in place.

    The chunk goes in sub-chunks of ``sub`` requests.  A request finds its
    previous one in the sub-chunk from a table of the sub-chunk's ids, each
    a mask of the positions that request it (the highest position below the
    request's; the request is its item's last where none is above), else
    from ``last``; its reuse distance is the tree's marks after that
    position (the total less a prefix count) plus the dominance term, the
    requests of the sub-chunk between the two whose own previous request
    lies at or before it; then each item's mark moves once.  The carry and
    the hits are :func:`tree_lru_ref`'s; returns ``(hits, stats)`` as it
    does."""
    window = ids.numel()
    check_window(window, m)
    if int(pos) + window > m:
        compact_ref(tree, last, pos, cap, m)
    p0, c = int(pos), int(cap)
    host = last.cpu()
    lnp = host.numpy()
    offs, sizes = tree_offsets(m, RING_RADIX), tree_sizes(m, RING_RADIX)
    tr = tree.cpu().numpy().astype(np.int64)
    total = int(tr[offs[-1]:offs[-1] + sizes[-1]].sum())
    req = ids.cpu().numpy().astype(np.int64)
    hit = np.zeros(window, dtype=bool)
    unseen = 0

    def add_path(q, delta):
        for off in offs:
            tr[off + q] += delta
            q >>= 4

    for base in range(0, window, sub):
        js = req[base:base + sub].tolist()
        at = p0 + base
        table = {}
        for t, j in enumerate(js):
            table[j] = table.get(j, 0) | (1 << t)
        prev_in = [(table[j] & ((1 << t) - 1)).bit_length() - 1 for t, j in enumerate(js)]
        final = [table[j] >> (t + 1) == 0 for t, j in enumerate(js)]
        lastg = [int(lnp[j]) for j in js]
        prevp = np.asarray([at + pi if pi >= 0 else lg for pi, lg in zip(prev_in, lastg)])
        for t, pp in enumerate(prevp.tolist()):
            if pp < 0:
                unseen += 1
                continue
            d = 0 if pp >= at else total - _prefix(tr, offs, pp)
            d += int(np.count_nonzero(prevp[max(pp - at + 1, 0):t] <= pp))
            hit[base + t] = d <= c - 1
        for t, j in enumerate(js):
            if lastg[t] >= 0 and prev_in[t] < 0:
                add_path(lastg[t], -1)
                total -= 1
            if final[t]:
                add_path(at + t, 1)
                lnp[j] = at + t
                total += 1
    if host is not last:
        last.copy_(host)
    dev = tree.device
    tree.copy_(torch.from_numpy(tr.astype(np.int32)))
    pos.fill_(p0 + window)
    nseen.add_(unseen)
    n_hits = int(hit.sum())
    if flags is not None:
        flags.copy_(torch.from_numpy(hit))
    occ = min(int(nseen), c)
    return (torch.tensor(n_hits, dtype=torch.int32, device=dev),
            torch.tensor([n_hits, 0.0, occ], dtype=torch.float32, device=dev))


def tree_lru_rows_ref(tree: torch.Tensor, last: torch.Tensor, pos: torch.Tensor,
                      nseen: torch.Tensor, cap: torch.Tensor, ids: torch.Tensor, m: int,
                      flags: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tree_lru_ref` over a grid's rows, one row at a time: every
    carry tensor with a leading row axis, ``ids`` one (window,) chunk for
    every row (a sweep) or (R, window), a row of ids each (a fleet's
    tenants); ``flags`` (R, window).  Returns hits (R,) and stats (R, 3)."""
    outs = [tree_lru_ref(tree[r], last[r], pos[r], nseen[r], cap[r],
                         ids[r] if ids.dim() == 2 else ids, m,
                         flags[r] if flags is not None else None)
            for r in range(tree.shape[0])]
    return torch.stack([h for h, _ in outs]), torch.stack([st for _, st in outs])
