"""The tree LRU: a chunk of requests a launch, by reuse distance.

The reference runs the tree LRU as ``lax.scan`` over sub-chunks
(``repro.cachesim.tree_engines.make_lru_tree_chunk``); no Pallas kernel is
involved.  On a CUDA tensor :func:`tree_lru` launches ``csrc/tree_lru.cu``
once for the whole chunk (one block, a thread a request of a sub-chunk, the
sub-chunks in order, the ring's count tree updated by integer atomics); on
a CPU tensor it runs the plain version in :mod:`.ref`.  Either way the
carry's tensors are updated in place.

A **ring compaction** is due when ``pos + window > m``.  The card decides
it without a read on the host: where the caller's bound on ``pos`` says a
compaction may be due (``compact=True``), :func:`ring_compaction` launches
a kernel that reads ``pos``, and where it is due remaps ``last`` to the
kept marks' ranks (a mark's rank is the tree's prefix count at its
position) and writes the new leaves; then the int32 tree build
(``prefix_tree/csrc/segsum.cu``) writes the tree from them, and the
chunk's launch restarts ``pos``.  Where it is not due, the leaves are the
tree's own and the build writes the same tree.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefix_tree.ops import tree_build
from repro_torch.kernels.prefix_tree.ref import tree_sizes, tree_storage
from repro_torch.kernels.tree_lru.ref import RING_RADIX, check_window, tree_lru_ref

#: the designs each wrapper counts its launches under
CHUNK, COMPACTION = "chunk: one block, a thread a request of a 256-request sub-chunk", "compaction"


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.library("tree_lru")
    p, i = ctypes.c_void_p, ctypes.c_int
    compact = lib.repro_tree_lru_compact
    compact.argtypes = [p, p, p, p, i, p, i, i, p, p]
    compact.restype = ctypes.c_int
    chunk = lib.repro_tree_lru_chunk
    chunk.argtypes = [p, p, p, p, p, p, i, p, i, p, p, p, p, p]
    chunk.restype = ctypes.c_int
    return compact, chunk


@functools.lru_cache(maxsize=None)
def _ring(m: int):
    """The ring tree's level sizes as the C entry points take them."""
    sizes = tree_sizes(m, RING_RADIX)
    return len(sizes), (ctypes.c_longlong * len(sizes))(*sizes)


@functools.lru_cache(maxsize=None)
def compaction_scratch(device: torch.device, m: int) -> torch.Tensor:
    """The compaction's scratch on ``device`` for a ring of ``m``: the m new
    leaves, then the decision and the new ``pos`` for the chunk's launch."""
    return torch.zeros(m + 2, dtype=torch.int32, device=device)


def _check_carry(tree, last, m, **scalars):
    """Validate the carry's tensors before their pointers go to a kernel:
    the ring's tree, ``last`` and the 0-d int32 ``scalars``."""
    dev = tree.device
    _build.require(tree, torch.int32, "tree")
    _build.require(last, torch.int32, "last", dev)
    for name, x in scalars.items():
        _build.require(x, torch.int32, name, dev)
    if tree.numel() != tree_storage(m, RING_RADIX) or any(x.dim() for x in scalars.values()):
        raise ValueError(f"a ring of {m} positions has {tree_storage(m, RING_RADIX)} tree nodes "
                         f"and 0-d {', '.join(scalars)}; got {tree.numel()} nodes")
    if m >= 2**30 or last.numel() >= 2**31:
        raise ValueError(f"ring {m} or catalog {last.numel() - 1} too large")


def ring_compaction(tree: torch.Tensor, last: torch.Tensor, pos: torch.Tensor,
                    cap: torch.Tensor, window: int, m: int) -> torch.Tensor:
    """On the card, the ring compaction a chunk of ``window`` requests may
    need: one launch that decides it from ``pos`` and remaps ``last``, and
    one int32 tree build into ``tree``.  Returns the scratch whose last two
    entries (decision, new ``pos``) the chunk's launch reads."""
    _check_carry(tree, last, m, pos=pos, cap=cap)
    scratch = compaction_scratch(tree.device, m)
    count, sizes = _ring(m)
    compact, _ = _entries()
    _build.check(
        compact(tree.data_ptr(), last.data_ptr(), pos.data_ptr(), cap.data_ptr(), window,
                ctypes.addressof(sizes), count, last.numel(), scratch.data_ptr(),
                _build.stream_of(tree)),
        "ring_compaction",
    )
    _build.counted(ring_compaction, COMPACTION)
    tree_build(scratch[:m], RING_RADIX, out=tree)
    return scratch


ring_compaction.launches = 0
ring_compaction.designs = {}


def tree_lru(tree: torch.Tensor, last: torch.Tensor, pos: torch.Tensor, nseen: torch.Tensor,
             cap: torch.Tensor, ids: torch.Tensor, m: int, *, compact: bool = True,
             flags: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the tree LRU over int32 ``ids``, in place.

    ``tree`` the (tree_storage(m, 16),) int32 count tree, ``last`` (N+1,)
    int32, ``pos``, ``nseen`` and ``cap`` 0-d int32; ids in [0, N).
    ``compact`` says whether a compaction may be due, from the caller's
    bound on ``pos`` (the card decides; with False it must not be due).
    Returns ``(hits, stats)``: the () int32 hit count and the (3,) float32
    (reward, aux, occupancy); ``flags``, a (window,) bool tensor where
    given, gets each request's hit.
    """
    window = ids.numel()
    check_window(window, m)
    if tree.device.type == "cpu":
        return tree_lru_ref(tree, last, pos, nseen, cap, ids, m, flags)
    dev = tree.device
    _check_carry(tree, last, m, pos=pos, nseen=nseen, cap=cap)
    _build.require(ids, torch.int32, "ids", dev)
    if ids.dim() != 1 or window < 1:
        raise ValueError(f"ids must be a non-empty 1-D tensor, got shape {tuple(ids.shape)}")
    if flags is not None:
        _build.require(flags, torch.bool, "flags", dev)
        if flags.shape != ids.shape:
            raise ValueError("flags must match ids")
    state = None
    if compact:
        scratch = ring_compaction(tree, last, pos, cap, window, m)
        state = scratch[m:]
    hits = torch.empty((), dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.float32, device=dev)
    count, sizes = _ring(m)
    _, chunk = _entries()
    _build.check(
        chunk(tree.data_ptr(), last.data_ptr(), pos.data_ptr(), nseen.data_ptr(), cap.data_ptr(),
              ids.data_ptr(), window, ctypes.addressof(sizes), count,
              state.data_ptr() if state is not None else None,
              flags.data_ptr() if flags is not None else None, hits.data_ptr(),
              stats.data_ptr(), _build.stream_of(tree)),
        "tree_lru",
    )
    _build.counted(tree_lru, CHUNK)
    return hits, stats


tree_lru.launches = 0
tree_lru.designs = {}
