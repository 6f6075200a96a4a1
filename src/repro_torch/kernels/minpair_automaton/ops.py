"""The tree LFU and FTPL: a chunk of requests a launch, on min-pair trees.

The reference runs these automata as ``lax.scan`` over requests
(``repro.cachesim.tree_engines.make_lfu_tree_chunk`` and
``make_ftpl_tree_chunk``); no Pallas kernel is involved.  On a CUDA tensor
:func:`minpair_automaton` launches ``csrc/minpair_automaton.cu`` once for
the whole chunk: one warp walks the requests in order over the slots'
radix-64 (hi, lo) min-tree, the levels above the leaves in shared memory
and the leaves in global memory (L2).  On a CPU tensor it runs the plain
version in :mod:`.ref`.  Either way the carry's tensors are updated in
place.

The kernel takes any slot count K (the tree's leaves), ``n_slots`` above
the capacity padded with inactive slots, as long as the levels above the
leaves fit in one block's shared memory (:data:`MAX_UPPER_NODES`: K up to
about 1.6 million).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.minpair_automaton.ref import KINDS, SLOT_RADIX, minpair_automaton_ref
from repro_torch.kernels.prefix_tree.ref import tree_sizes, tree_storage

#: the min-tree nodes above the leaves that one block's shared memory holds
#: (8 bytes each, within the 227 KB a block can use)
MAX_UPPER_NODES = 28_000
#: the design the wrapper counts its launches under
DESIGN = ("one warp a chunk: the requests in order, root and argmin by warp-wide "
          "lexicographic reductions (redux.sync), upper levels in shared memory, leaves in L2")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("minpair_automaton").repro_minpair_automaton
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, p, i, i, p, p, p, p, p, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _levels(k: int):
    sizes = tree_sizes(k, SLOT_RADIX)
    return len(sizes), (ctypes.c_longlong * len(sizes))(*sizes)


def upper_nodes(k: int) -> int:
    """The min-tree's nodes above the leaves, for ``k`` slots."""
    return tree_storage(k, SLOT_RADIX) - k


def minpair_automaton(
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
    """One chunk of the tree LFU (``t`` its () int32 clock, ``noise`` None)
    or FTPL (``noise`` its (N,) float32 perturbation, ``t`` None) over int32
    ``ids`` in [0, N), in place.  ``imap`` (N+1,), ``counts`` (N,),
    ``slots`` (K,) and the two (tree_storage(K, 64),) min-trees, int32.

    Returns ``(hits, stats)``: the () int32 hit count and the (3,) float32
    (reward, aux, occupancy); ``flags``, a (window,) bool tensor where
    given, gets each request's hit.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown min-pair automaton {kind!r} (have {KINDS})")
    if slots.device.type == "cpu":
        return minpair_automaton_ref(kind, imap, counts, noise, slots, tree_hi, tree_lo, t, ids,
                                     flags)
    dev = slots.device
    lfu = kind == "lfu"
    for name, x in (("slots", slots), ("imap", imap), ("counts", counts), ("tree_hi", tree_hi),
                    ("tree_lo", tree_lo), ("ids", ids)):
        _build.require(x, torch.int32, name, dev)
    if lfu:
        _build.require(t, torch.int32, "t", dev)
    else:
        _build.require(noise, torch.float32, "noise", dev)
        if noise.shape != counts.shape:
            raise ValueError("noise must match counts")
    k, n = slots.numel(), counts.numel()
    if ids.dim() != 1 or ids.numel() < 1:
        raise ValueError(f"ids must be a non-empty 1-D tensor, got shape {tuple(ids.shape)}")
    if imap.numel() != n + 1 or tree_hi.shape != (tree_storage(k, SLOT_RADIX),) or \
            tree_lo.shape != tree_hi.shape:
        raise ValueError(f"imap must hold N+1 = {n + 1} entries and each min-tree "
                         f"{tree_storage(k, SLOT_RADIX)} nodes for {k} slots")
    if upper_nodes(k) > MAX_UPPER_NODES or n >= 2**31 - 1:
        raise ValueError(f"the min-pair kernel holds at most {MAX_UPPER_NODES} nodes above the "
                         f"leaves in shared memory; {k} slots need {upper_nodes(k)}")
    if flags is not None:
        _build.require(flags, torch.bool, "flags", dev)
        if flags.shape != ids.shape:
            raise ValueError("flags must match ids")
    hits = torch.empty((), dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.float32, device=dev)
    count, sizes = _levels(k)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    _build.check(
        _entry()(
            KINDS.index(kind), ids.numel(), ptr(ids), n, count, ctypes.addressof(sizes),
            imap.data_ptr(), counts.data_ptr(), ptr(None if lfu else noise), slots.data_ptr(),
            tree_hi.data_ptr(), tree_lo.data_ptr(), ptr(t if lfu else None), ptr(flags),
            hits.data_ptr(), stats.data_ptr(), _build.stream_of(slots),
        ),
        "minpair_automaton",
    )
    _build.counted(minpair_automaton, DESIGN)
    return hits, stats


minpair_automaton.launches = 0
minpair_automaton.designs = {}
