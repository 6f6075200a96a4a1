"""The tree LRU: a chunk of requests a launch, by reuse distance.

The reference runs the tree LRU as ``lax.scan`` over sub-chunks
(``repro.cachesim.tree_engines.make_lru_tree_chunk``); no Pallas kernel is
involved.  On a CUDA tensor :func:`tree_lru` launches ``csrc/tree_lru.cu``
once for the whole chunk (one block, a thread a request of a sub-chunk, the
sub-chunks in order, the ring's count tree updated by integer atomics, its
levels from 1 or 2 up in shared memory for the chunk); on
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

A sweep's grid of combos runs in one chunk launch, a block a combo, each
row of the stacked carry bit for bit its combo's single launch; a single
chunk is the grid of one combo.  A fleet's tenants run the same launch over
a row of ids each, (R, window) ids with a row stride.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefix_tree.ops import tree_build, tree_build_rows_
from repro_torch.kernels.prefix_tree.ref import tree_sizes, tree_storage
from repro_torch.kernels.tree_lru.ref import RING_RADIX, check_window, tree_lru_rows_ref

#: the designs each wrapper counts its launches under
CHUNK = ("chunk: one block, a thread a request of a 256-request sub-chunk; the ring's upper "
         "levels in shared memory, the levels below read in 16-byte sibling groups from L2")
COMPACTION = "compaction"


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.library("tree_lru")
    p, i = ctypes.c_void_p, ctypes.c_int
    compact = lib.repro_tree_lru_compact
    ll = ctypes.c_longlong
    compact.argtypes = [i, p, ll, p, ll, p, p, i, p, i, i, p, ll, p]
    compact.restype = ctypes.c_int
    chunk = lib.repro_tree_lru_chunk
    chunk.argtypes = [i, p, ll, p, ll, p, p, p, p, ll, i, p, i, p, ll, p, p, p, p]
    chunk.restype = ctypes.c_int
    return compact, chunk


@functools.lru_cache(maxsize=None)
def _ring(m: int):
    """The ring tree's level sizes as the C entry points take them."""
    sizes = tree_sizes(m, RING_RADIX)
    return len(sizes), (ctypes.c_longlong * len(sizes))(*sizes)


@functools.lru_cache(maxsize=None)
def compaction_scratch(device: torch.device, m: int, rows: int) -> torch.Tensor:
    """The compaction's scratch on ``device`` for ``rows`` combos' rings of
    ``m``, a row a combo: the m new leaves, then the decision and the new
    ``pos`` for the chunk's launch (which resets the decision to 0 once
    read)."""
    return torch.zeros((rows, m + 2), dtype=torch.int32, device=device)


def _check_carry(tree, last, m, **scalars):
    """Validate the carry's tensors before their pointers go to a kernel:
    the ring's tree, ``last`` and the int32 ``scalars``, for one combo (a
    (TOT,) tree, 0-d scalars) or a grid's rows at once (an (R, TOT) tree of
    unit stride, ``last`` (R, N+1), (R,) scalars)."""
    dev = tree.device
    if dev.type != "cuda":
        raise ValueError(f"tree must be a CUDA tensor, got {dev}")
    lead = tuple(tree.shape[:-1])
    if tree.stride(-1) != 1 or (not lead and not tree.is_contiguous()):
        raise ValueError("the tree's rows must be of unit stride")
    for x, name in ((tree, "tree"), (last, "last"), *((x, k) for k, x in scalars.items())):
        if x.device != dev or x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on {dev}, got {x.dtype} on {x.device}")
    if not last.is_contiguous() or any(not x.is_contiguous() for x in scalars.values()):
        raise ValueError("last and the scalars must be contiguous")
    if tree.shape[-1] != tree_storage(m, RING_RADIX) or last.shape[:-1] != lead or \
            any(x.shape != lead for x in scalars.values()):
        raise ValueError(f"a ring of {m} positions has {tree_storage(m, RING_RADIX)} tree nodes, "
                         f"last and {', '.join(scalars)} a row a combo; got a tree of "
                         f"{tuple(tree.shape)}")
    if m >= 2**30 or last.shape[-1] >= 2**31:
        raise ValueError(f"ring {m} or catalog {last.shape[-1] - 1} too large")


def ring_compaction(tree: torch.Tensor, last: torch.Tensor, pos: torch.Tensor,
                    cap: torch.Tensor, window: int, m: int,
                    scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """On the card, the ring compaction a chunk of ``window`` requests may
    need: one launch that decides it from ``pos`` and remaps ``last``, and
    one int32 tree build into ``tree``.  A grid's (R, TOT) tree, (R, N+1)
    ``last`` and (R,) ``pos`` and ``cap`` take the same two launches for
    every combo, each deciding from its own ``pos`` (one not due copies its
    own leaves, and its tree is rebuilt as it was).  Returns the scratch
    (``scratch`` where given, (m + 2,) or (R, m + 2); else a new one) whose
    last two entries a row (decision, new ``pos``) the chunk's launch
    reads."""
    _check_carry(tree, last, m, pos=pos, cap=cap)
    grid = tree.dim() == 2
    rows = tree.shape[0] if grid else 1
    if scratch is None:
        scratch = torch.zeros(tuple(tree.shape[:-1]) + (m + 2,), dtype=torch.int32,
                              device=tree.device)
    count, sizes = _ring(m)
    compact, _ = _entries()
    _build.check(
        compact(rows, tree.data_ptr(), tree.stride(0) if grid else 0, last.data_ptr(),
                last.stride(0) if grid else 0, pos.data_ptr(), cap.data_ptr(), window,
                ctypes.addressof(sizes), count, last.shape[-1], scratch.data_ptr(),
                scratch.stride(0) if grid else 0, _build.stream_of(tree)),
        "ring_compaction",
    )
    _build.counted(ring_compaction, COMPACTION)
    if rows > 1:
        tree_build_rows_(scratch[:, :m], RING_RADIX, out=tree)
    else:  # one combo: the one-tree build
        tree_build(scratch.reshape(-1)[:m], RING_RADIX, out=tree.reshape(-1))
    return scratch


ring_compaction.launches = 0
ring_compaction.designs = {}


def tree_lru(tree: torch.Tensor, last: torch.Tensor, pos: torch.Tensor, nseen: torch.Tensor,
             cap: torch.Tensor, ids: torch.Tensor, m: int, *, compact=True,
             flags: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the tree LRU over int32 ``ids``, in place.

    ``tree`` the (tree_storage(m, 16),) int32 count tree, ``last`` (N+1,)
    int32, ``pos``, ``nseen`` and ``cap`` 0-d int32; ids in [0, N).
    ``compact`` says whether a compaction may be due, from the caller's
    bound on ``pos`` (the card decides; with False it must not be due).
    Returns ``(hits, stats)``: the () int32 hit count and the (3,) float32
    (reward, aux, occupancy); ``flags``, a (window,) bool tensor where
    given, gets each request's hit.

    A grid of R combos, one launch (a block a combo): ``tree`` (R, TOT)
    whose rows may lie further apart than TOT (a stride of a multiple of 4
    keeps the 16-byte loads), ``last`` (R, N+1), ``pos``, ``nseen`` and
    ``cap`` (R,), ``ids`` one (window,) chunk for every combo (a sweep) or
    (R, window), a row of ids a combo (a fleet's tenants), ``compact`` a
    bool a combo (where any combo may be due, one compaction launch and one
    tree build cover every combo), ``flags`` (R, window); hits (R,) and
    stats (R, 3).
    Each row is bit for bit its combo's single launch over its ids; on the
    CPU the plain version runs row by row.  One combo is the grid of its
    one row.
    """
    if tree.dim() == 1:  # one combo: the grid of its one row
        hits, stats = tree_lru(tree[None], last[None], pos[None], nseen[None], cap[None], ids,
                               m, compact=[compact], flags=None if flags is None else flags[None])
        return hits[0], stats[0]
    window = ids.shape[-1]
    check_window(window, m)
    rows = tree.shape[0]
    if ids.dim() not in (1, 2) or (ids.dim() == 2 and ids.shape[0] != rows) or window < 1:
        raise ValueError(f"ids must be a non-empty (window,) chunk or ({rows}, window), got "
                         f"shape {tuple(ids.shape)}")
    if tree.device.type == "cpu":
        return tree_lru_rows_ref(tree, last, pos, nseen, cap, ids, m, flags)
    dev = tree.device
    _check_carry(tree, last, m, pos=pos, nseen=nseen, cap=cap)
    compact = [compact] * rows if isinstance(compact, bool) else [bool(c) for c in compact]
    _build.require(ids, torch.int32, "ids", dev)
    if flags is not None:
        _build.require(flags, torch.bool, "flags", dev)
        if flags.shape != (rows, window):
            raise ValueError("flags must match ids, a row a combo")
    state = compaction_scratch(dev, m, rows)
    if any(compact):  # one compaction and one build for every combo
        ring_compaction(tree, last, pos, cap, window, m, scratch=state)
    hits = torch.empty(rows, dtype=torch.int32, device=dev)
    stats = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    count, sizes = _ring(m)
    _, chunk = _entries()
    _build.check(
        chunk(rows, tree.data_ptr(), tree.stride(0), last.data_ptr(), last.stride(0),
              pos.data_ptr(), nseen.data_ptr(), cap.data_ptr(), ids.data_ptr(),
              window if ids.dim() == 2 else 0, window,
              ctypes.addressof(sizes), count, state[:, m:].data_ptr(), m + 2,
              flags.data_ptr() if flags is not None else None, hits.data_ptr(),
              stats.data_ptr(), _build.stream_of(tree)),
        "tree_lru",
    )
    _build.counted(tree_lru, CHUNK)
    return hits, stats


tree_lru.launches = 0
tree_lru.designs = {}
