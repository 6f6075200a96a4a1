"""Plain PyTorch version of the tree LFU and FTPL: a chunk of requests.

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
