"""The tree LFU, FTPL and GDS: a chunk of requests a launch, on min-pair trees.

The reference runs these automata as ``lax.scan`` over requests
(``repro.cachesim.tree_engines.make_lfu_tree_chunk``,
``make_ftpl_tree_chunk`` and ``make_gds_tree_chunk``); no Pallas kernel is
involved.  On a CUDA tensor :func:`minpair_automaton` (LFU, FTPL) and
:func:`gds_automaton` launch ``csrc/minpair_automaton.cu`` once for the
whole chunk, both counted as ``minpair_automaton`` launches: one warp walks the requests in order over the slots'
radix-64 (hi, lo) min-tree, the levels above the leaves in shared memory
beside each node's least leaf (the kernel's own pointers, built at the
chunk's start), the leaves in global memory (L2).  On a CPU tensor each
runs its plain version in :mod:`.ref`.  Either way the carry's tensors are
updated in place.

A sweep's grid of combos runs in the same launch, a block a combo: each
carry tensor then has a leading combo axis (the ids one chunk for all, or a
fleet's (R, window), a row of ids a tenant), and each row is bit for bit its
combo's single launch (the same code on its own rows); on the CPU the plain
version runs row by row.

The kernel takes any slot count K (the tree's leaves), ``n_slots`` above
the capacity padded with inactive slots, as long as the levels above the
leaves fit in one block's shared memory (:data:`MAX_UPPER_NODES`: K up to
about 1.7 million).  :func:`design` picks the plan by K: the pointers in
shared memory beside the pairs up to :data:`SHARED_POINTER_NODES` nodes
above the leaves, past that in a global scratch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.minpair_automaton.ref import (
    KINDS,
    SLOT_RADIX,
    automaton_rows_ref,
    gds_automaton_ref,
    minpair_automaton_ref,
)
from repro_torch.kernels.prefix_tree.ref import tree_sizes, tree_storage

#: the min-tree nodes above the leaves that one block's shared memory holds
#: (8 bytes each, within the 227 KB a block can use)
MAX_UPPER_NODES = 28_000
#: the nodes above the leaves whose least-leaf pointers fit in shared memory
#: beside their pairs (12 bytes each; the kernel's kSharedPointerNodes)
SHARED_POINTER_NODES = 19_000
#: the designs the wrapper counts its launches under: the least-leaf
#: pointers in shared memory, and past SHARED_POINTER_NODES in L2
DESIGN = ("one warp a chunk: least-leaf pointers beside the upper levels in shared memory; "
          "a miss takes the root's pointer, the requests that change no node (hits off their "
          "group's least leaf, refused admissions) applied a segment of a tile at once "
          "between events, the root's leaf group in registers; leaves in L2")
DESIGN_L2 = DESIGN.replace("beside the upper levels in shared memory",
                           "in L2, the upper levels' pairs in shared memory")
#: the designs GDS's launches count under (the same kernel, its GDS mode)
DESIGN_GDS = "GDS mode: " + DESIGN
DESIGN_GDS_L2 = "GDS mode: " + DESIGN_L2
#: the kernel's ``kind`` argument of GDS (after KINDS)
_GDS = len(KINDS)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("minpair_automaton").repro_minpair_automaton
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, i, p, ctypes.c_longlong, i, i, p, p, p, p, p, p, p, p, p, p, p, p, p,
                   p, p]
    fn.restype = ctypes.c_int
    return fn


def design(k: int, gds: bool = False) -> str:
    """The plan a chunk over ``k`` slots launches: the least-leaf pointers
    in shared memory up to :data:`SHARED_POINTER_NODES` nodes above the
    leaves, else in a global scratch (L2)."""
    shared = upper_nodes(k) <= SHARED_POINTER_NODES
    if gds:
        return DESIGN_GDS if shared else DESIGN_GDS_L2
    return DESIGN if shared else DESIGN_L2


@functools.lru_cache(maxsize=None)
def _pointer_scratch(device: torch.device, upper: int, rows: int = 1) -> torch.Tensor:
    """The L2 plan's least-leaf pointers, one int32 a node above the leaves
    and a row a combo (the kernel's own: built at each chunk's start, not
    part of the carry)."""
    return torch.empty(rows * upper, dtype=torch.int32, device=device)


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

    A grid of R combos: every carry tensor with a leading axis of R (``t``
    (R,)), ``ids`` one (window,) chunk for all or (R, window), a row of ids
    a combo, ``flags`` (R, window); then hits is (R,) and stats (R, 3),
    still one launch.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown min-pair automaton {kind!r} (have {KINDS})")
    _check_ids(slots, ids)
    if slots.device.type == "cpu":
        return automaton_rows_ref(minpair_automaton_ref, slots, (kind,),
                        (imap, counts, noise, slots, tree_hi, tree_lo, t), ids, flags)
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
    n = counts.shape[-1]
    return _launch(KINDS.index(kind), False, ids, n, imap, counts, None if lfu else noise, slots,
                   tree_hi, tree_lo, t if lfu else None, None, None, flags)


def _check_ids(slots, ids):
    """One (window,) chunk, or for a grid of R (R, window), a row a combo."""
    lead = tuple(slots.shape[:-1])
    if ids.dim() not in (1, 2) or ids.shape[-1] < 1 or (ids.dim() == 2 and (
            not lead or ids.shape[0] != lead[0])):
        raise ValueError(f"ids must be a non-empty (window,) chunk, or (R, window) for a grid of "
                         f"R, got shape {tuple(ids.shape)}")


def _check_slots(imap, slots, tree_hi, tree_lo, ids, n, flags):
    dev = slots.device
    k = slots.shape[-1]
    lead = tuple(slots.shape[:-1])
    if slots.dim() > 2:
        raise ValueError(f"slots must be (K,) or (R, K), got {tuple(slots.shape)}")
    if imap.shape != lead + (n + 1,) or tree_hi.shape != lead + (tree_storage(k, SLOT_RADIX),) or \
            tree_lo.shape != tree_hi.shape:
        raise ValueError(f"imap must hold N+1 = {n + 1} entries and each min-tree "
                         f"{tree_storage(k, SLOT_RADIX)} nodes for {k} slots")
    if upper_nodes(k) > MAX_UPPER_NODES or n >= 2**31 - 1:
        raise ValueError(f"the min-pair kernel holds at most {MAX_UPPER_NODES} nodes above the "
                         f"leaves in shared memory; {k} slots need {upper_nodes(k)}")
    if flags is not None:
        _build.require(flags, torch.bool, "flags", dev)
        if flags.shape != lead + tuple(ids.shape[-1:]):
            raise ValueError("flags must match ids, a row a combo")


def _launch(kind, gds, ids, n, imap, counts, noise, slots, tree_hi, tree_lo, t, hval, lval,
            flags):
    dev = slots.device
    _check_slots(imap, slots, tree_hi, tree_lo, ids, n, flags)
    lead = tuple(slots.shape[:-1])
    rows = lead[0] if lead else 1
    for x, name in ((t, "t"), (lval, "lval")):
        if x is not None and x.shape != lead:
            raise ValueError(f"{name} must be {lead}, a combo's scalar each")
    hits = torch.empty(lead, dtype=torch.int32, device=dev)
    stats = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    k = slots.shape[-1]
    count, sizes = _levels(k)
    plan = design(k, gds)
    upper = upper_nodes(k)
    pointers = None if upper <= SHARED_POINTER_NODES else _pointer_scratch(dev, upper, rows)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    _build.check(
        _entry()(
            kind, rows, ids.shape[-1], ptr(ids), ids.shape[-1] if ids.dim() == 2 else 0, n, count,
            ctypes.addressof(sizes), ptr(pointers),
            imap.data_ptr(), ptr(counts), ptr(noise), slots.data_ptr(), tree_hi.data_ptr(),
            tree_lo.data_ptr(), ptr(t), ptr(hval), ptr(lval), ptr(flags), hits.data_ptr(),
            stats.data_ptr(), _build.stream_of(slots),
        ),
        "minpair_automaton",
    )
    _build.counted(minpair_automaton, plan)
    return hits, stats


minpair_automaton.launches = 0
minpair_automaton.designs = {}


def gds_automaton(
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
    """One chunk of the tree GDS over int32 ``ids`` in [0, N), in place:
    ``imap`` (N+1,) int32, ``prio`` (N,) float32 cost/size, ``hval`` (K,)
    float32 the slots' H, ``lval`` the () float32 inflation value,
    ``slots`` (K,) int32 and the two (tree_storage(K, 64),) int32 min-trees.
    One ``minpair_automaton`` launch on the card (design
    :data:`DESIGN_GDS`, past :data:`SHARED_POINTER_NODES` nodes above the
    leaves :data:`DESIGN_GDS_L2`), the plain version on the CPU.

    Returns ``(hits, stats)`` as :func:`minpair_automaton` does."""
    _check_ids(slots, ids)
    if slots.device.type == "cpu":
        return automaton_rows_ref(gds_automaton_ref, slots, (),
                        (imap, prio, hval, lval, slots, tree_hi, tree_lo), ids, flags)
    dev = slots.device
    for name, x in (("slots", slots), ("imap", imap), ("tree_hi", tree_hi),
                    ("tree_lo", tree_lo), ("ids", ids)):
        _build.require(x, torch.int32, name, dev)
    for name, x in (("prio", prio), ("hval", hval), ("lval", lval)):
        _build.require(x, torch.float32, name, dev)
    if hval.shape != slots.shape or prio.shape != slots.shape[:-1] + prio.shape[-1:]:
        raise ValueError("hval must match slots, and prio be (N,) a combo")
    return _launch(_GDS, True, ids, prio.shape[-1], imap, None, prio, slots, tree_hi,
                   tree_lo, None, hval, lval, flags)
