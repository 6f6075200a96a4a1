"""Plain PyTorch version of the tree LFU, FTPL and GDS: a chunk of requests.

Counterparts of ``repro.cachesim.tree_engines.make_lfu_tree_chunk`` and
``make_ftpl_tree_chunk``, which the reference scans over a chunk with
``lax.scan`` (no Pallas kernel).  The carry: ``imap`` (N+1,) int32 item ->
slot (-1 out; index N is scratch), ``counts`` (N,) int32, ``slots`` (K,)
int32 slot -> item (-1 empty, -2 inactive), ``tree_hi``/``tree_lo`` the
radix-64 lexicographic min-trees over the slots' eviction keys, and LFU's
request clock ``t`` or FTPL's (N,) float32 ``noise``.  A slot's key is
(frequency, tick) for LFU (empty slots (-1, -1)), (sortable score, item id)
for FTPL; inactive slots (I32_MAX, I32_MAX).  Per request, in order:

* j's count after this request, ``f = counts[j] + 1``;
* a hit (``imap[j] >= 0``) rewrites its slot's key: LFU (f, t), FTPL
  (sortable_f32(float32(f) + noise[j]), j), one float32 add;
* a miss takes the root's key and the argmin leaf (the least key, the
  first slot among equal keys) as the victim; LFU admits when
  ``f >= root_hi``, FTPL swaps when its key's hi is strictly above
  ``root_hi``; the newcomer takes the victim's slot and the evicted item's
  ``imap`` becomes -1.

**The scratch entry imap[N].**  The reference writes each request's two
``imap`` updates as one scatter with N standing in for "no write"; a chunk
starts by writing -1 there, and where both of a request's writes are
no-writes the second (the request's slot index) lands last.  So after a
chunk ``imap[N]`` holds the last such request's slot: -1 where the request
wrote ``imap[j]`` without evicting another item, the slot index where it
wrote no ``imap`` entry (a miss that stays out; an FTPL hit), unchanged
where it evicted one.  The carry is compared bit for bit, so this follows.

**GDS** (:func:`gds_automaton_ref`, the counterpart of the reference's
``make_gds_tree_chunk``) keys a slot (sortable H, item id), H = L + cost/size
in float32 (``prio`` holds cost/size, one float32 a item), empty slots
(-1, -1).  Every request writes: a hit refreshes its H from the current L;
a miss takes the argmin, and where that slot held an item, L becomes its H
and the item leaves ``imap``; then the newcomer is keyed off L.  Its
``imap[N]`` is -1 after every chunk: the reference's first pending write
puts -1 there and no later write puts anything else.

The victim search runs on a heap of (hi, lo, slot) with stale entries
skipped, and the tree is rebuilt from the slots' keys at the end of the
chunk (the min-tree is a function of its leaves).  It reads the carry on
the host, so on the card it is the yardstick of correctness, not of speed;
:func:`repro_torch.kernels.minpair_automaton.ops.minpair_automaton` runs it
on a CPU tensor.
"""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.prefix_tree.ops import minpair_build, sortable_f32
from repro_torch.kernels.slot_automaton.ref import request_counts

#: radix of the slot min-trees
SLOT_RADIX = 64
#: automaton kinds, in the order of the kernel's ``kind`` argument
KINDS = ("lfu", "ftpl")


def minpair_automaton_ref(
    kind: str,
    imap: torch.Tensor,
    counts: torch.Tensor,
    noise: Optional[torch.Tensor],
    slots: torch.Tensor,
    tree_hi: torch.Tensor,
    tree_lo: torch.Tensor,
    t: Optional[torch.Tensor],
    ids: torch.Tensor,
    flags: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the tree LFU (``kind="lfu"``, clock ``t``) or FTPL
    (``"ftpl"``, ``noise``) over int32 ``ids``, in place.

    Returns ``(hits, stats)``: the () int32 hit count and the (3,) float32
    (reward = hits, aux = 0, occupancy = slots holding an item); ``flags``,
    a (window,) bool tensor where given, gets each request's hit."""
    if kind not in KINDS:
        raise ValueError(f"unknown min-pair automaton {kind!r} (have {KINDS})")
    k_slots, n = slots.numel(), counts.numel()
    f = request_counts(counts, ids).tolist()
    req = ids.tolist()
    host = imap.cpu()
    im = host.numpy()
    hi, lo, sl = tree_hi[:k_slots].tolist(), tree_lo[:k_slots].tolist(), slots.tolist()
    heap = [(hi[k], lo[k], k) for k in range(k_slots)]
    heapq.heapify(heap)
    lfu = kind == "lfu"
    t0 = int(t) if lfu else 0
    # FTPL's keys for the whole chunk: float32(count) + noise, one float32 add
    his = f if lfu else sortable_f32(
        torch.tensor(f, dtype=torch.float32) + noise.cpu()[ids.cpu().long()]).tolist()
    scratch, hit_flags = -1, []
    for r, (j, fj, hj) in enumerate(zip(req, f, his)):
        slot = int(im[j])
        hit = slot >= 0
        hit_flags.append(hit)
        key = (fj, t0 + r) if lfu else (hj, j)
        if hit:
            idx, write = slot, True
            scratch = -1 if lfu else slot
        else:
            while (heap[0][0], heap[0][1]) != (hi[heap[0][2]], lo[heap[0][2]]):
                heapq.heappop(heap)
            root_hi, _, idx = heap[0]
            write = key[0] >= root_hi if lfu else key[0] > root_hi
            if write:
                old = sl[idx]
                if old >= 0:
                    im[old] = -1
                else:
                    scratch = -1
                im[j] = idx
                sl[idx] = j
            else:
                scratch = idx
        if write:
            hi[idx], lo[idx] = key
            heapq.heappush(heap, (key[0], key[1], idx))
    im[n] = scratch
    if host is not imap:
        imap.copy_(host)
    counts.index_add_(0, ids.long(), torch.ones_like(ids))
    dev = slots.device
    slots.copy_(torch.tensor(sl, dtype=torch.int32))
    th, tl = minpair_build(torch.tensor(hi, dtype=torch.int32),
                           torch.tensor(lo, dtype=torch.int32), SLOT_RADIX)
    tree_hi.copy_(th)
    tree_lo.copy_(tl)
    if lfu:
        t.fill_(t0 + len(req))
    n_hits = sum(hit_flags)
    if flags is not None:
        flags.copy_(torch.tensor(hit_flags, dtype=torch.bool))
    occ = sum(s >= 0 for s in sl)
    return (torch.tensor(n_hits, dtype=torch.int32, device=dev),
            torch.tensor([n_hits, 0.0, occ], dtype=torch.float32, device=dev))


def least_leaves(tree_hi: torch.Tensor, tree_lo: torch.Tensor, k_slots: int):
    """Every node's least leaf: the first leaf that holds the node's pair,
    the pointers the kernel keeps beside the levels above the leaves (a
    leaf's own is its index).  Returns ``(pointers, root)``: the int64
    pointers of the ``(tree_storage(k_slots, 64),)`` trees' nodes, and the
    root's (the least pair of the top level; its first leaf)."""
    from repro_torch.kernels.prefix_tree.ref import tree_offsets, tree_sizes

    offs, sizes = tree_offsets(k_slots, SLOT_RADIX), tree_sizes(k_slots, SLOT_RADIX)
    hi, lo = tree_hi.cpu().long(), tree_lo.cpu().long()
    key = (hi << 32) + (lo + 2**31)  # the lexicographic order of (hi, lo), int32 each
    ptr = torch.arange(k_slots, dtype=torch.int64)
    parts = [ptr]
    for off, below, size in zip(offs[1:], offs, sizes[1:]):
        n_below = ptr.numel()
        pad = size * SLOT_RADIX - n_below
        child = torch.nn.functional.pad(key[below:below + n_below], (0, pad),
                                        value=torch.iinfo(torch.int64).max).view(size, SLOT_RADIX)
        cptr = torch.nn.functional.pad(ptr, (0, pad), value=torch.iinfo(torch.int64).max)
        cptr = cptr.view(size, SLOT_RADIX)
        held = child == key[off:off + size, None]
        ptr = torch.where(held, cptr, torch.iinfo(torch.int64).max).min(dim=1).values
        parts.append(ptr)
    top_key = key[offs[-1]:offs[-1] + sizes[-1]]
    first = int(torch.nonzero(top_key == top_key.min())[0])
    return torch.cat(parts), int(ptr[first])


def unsortable_f32(b: torch.Tensor) -> torch.Tensor:
    """The float32 whose ``sortable_f32`` is the int32 ``b``: x + 0.0 for
    the x that gave it, so every x but -0.0 and NaN (whose payload the add
    may change) comes back bit for bit.  The kernel's GDS mode takes an
    evicted slot's H this way from the root's hi."""
    b = b.to(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).view(torch.float32)


def _sortable(h: np.float32) -> int:
    """sortable_f32 of one float32."""
    b = int(np.asarray(h + np.float32(0.0), np.float32).view(np.int32))
    return b ^ 0x7FFFFFFF if b < 0 else b


def gds_automaton_ref(
    imap: torch.Tensor,
    prio: torch.Tensor,
    hval: torch.Tensor,
    lval: torch.Tensor,
    slots: torch.Tensor,
    tree_hi: torch.Tensor,
    tree_lo: torch.Tensor,
    ids: torch.Tensor,
    flags: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the tree GDS over int32 ``ids``, in place: ``imap``
    (N+1,) int32, ``prio`` (N,) float32 cost/size, ``hval`` (K,) float32 the
    slots' H, ``lval`` the () float32 inflation value L, ``slots`` (K,) int32
    and the two radix-64 min-trees.

    Returns ``(hits, stats)`` as :func:`minpair_automaton_ref` does."""
    k_slots, n = slots.numel(), prio.numel()
    im = imap.cpu().numpy().copy()
    pr = prio.cpu().numpy()
    hv = hval.cpu().numpy().copy()
    big_l = np.float32(lval.cpu().numpy())
    hi, lo, sl = tree_hi[:k_slots].tolist(), tree_lo[:k_slots].tolist(), slots.tolist()
    heap = [(hi[k], lo[k], k) for k in range(k_slots)]
    heapq.heapify(heap)
    hit_flags = []
    for j in ids.tolist():
        idx = int(im[j])
        hit = idx >= 0
        hit_flags.append(hit)
        if not hit:
            while (heap[0][0], heap[0][1]) != (hi[heap[0][2]], lo[heap[0][2]]):
                heapq.heappop(heap)
            idx = heap[0][2]
            old = sl[idx]
            if old >= 0:  # evict first: L takes the victim's H
                big_l = hv[idx]
                im[old] = -1
            im[j] = idx
            sl[idx] = j
        h = np.float32(big_l + pr[j])  # one float32 add
        hv[idx] = h
        hi[idx], lo[idx] = _sortable(h), j
        heapq.heappush(heap, (hi[idx], j, idx))
    im[n] = -1
    imap.copy_(torch.from_numpy(im))
    hval.copy_(torch.from_numpy(hv))
    lval.fill_(float(big_l))
    slots.copy_(torch.tensor(sl, dtype=torch.int32))
    th, tl = minpair_build(torch.tensor(hi, dtype=torch.int32),
                           torch.tensor(lo, dtype=torch.int32), SLOT_RADIX)
    tree_hi.copy_(th)
    tree_lo.copy_(tl)
    n_hits = sum(hit_flags)
    if flags is not None:
        flags.copy_(torch.tensor(hit_flags, dtype=torch.bool))
    occ = sum(x >= 0 for x in sl)
    dev = slots.device
    return (torch.tensor(n_hits, dtype=torch.int32, device=dev),
            torch.tensor([n_hits, 0.0, occ], dtype=torch.float32, device=dev))


def automaton_rows_ref(fn, slots: torch.Tensor, lead: tuple, carry: tuple, ids: torch.Tensor,
                       flags: Optional[torch.Tensor] = None):
    """The plain version ``fn(*lead, *carry, ids, flags)`` (the min-pair
    automaton's or GDS's) on one combo, or row by row on a grid's (the
    carry's tensors in place): ``ids`` one (window,) chunk for every row (a
    sweep) or (R, window), a row of ids each (a fleet's tenants).  Returns
    (hits, stats), stacked over the rows of a grid."""
    if slots.dim() == 1:
        return fn(*lead, *carry, ids, flags)
    outs = [fn(*lead, *(x[r] if x is not None else None for x in carry),
               ids[r] if ids.dim() == 2 else ids, flags[r] if flags is not None else None)
            for r in range(slots.shape[0])]
    return torch.stack([h for h, _ in outs]), torch.stack([st for _, st in outs])
